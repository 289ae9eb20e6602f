"""DVGO with TensoRF fields (``nerf/ship.tensorf.py``) as the benchmark
needs it: its numbers in the recipe, its plain forward, the shape of its
model FLOPs, and the hooks into the program's parameters.

The reference is ``reference/tensorf.py``: the bounded forward (the box,
equidistant samples, the occupancy cache, both thresholds) over two VM
fields, density (``n_comp`` components, summed) and k0 (``n_comp``
components projected by ``f_vec`` to ``rgbnet_dim``), and the colour MLP.
The hooks put the benchmark's values into the program's leaves
(``inputs/bounded.py::vm_leaves``, the same values the reference starts
from) and name them as the reference does: ``density.<leaf>``,
``k0.<leaf>``, ``mlp.<i>.weight``, ``mlp.<i>.bias``.
"""

from __future__ import annotations

from benchmark.inputs import bounded, weights
from benchmark.reference import tensorf as T

recipe_fields = T.recipe_fields
reference_model = T.recipe_and_model
forward = T.forward


def flop_shape(cfg: dict) -> tuple:
    """(density components, k0 components, k0 channels, MLP dims) a
    sample's model FLOPs count (``benchmark.counts.vm``)."""
    f = recipe_fields(cfg)
    return f["n_comp"]["density"], f["n_comp"]["k0"], f["k0_dim"], f["mlp_dims"]


def program_fill(params, mcfg, ft, step: int, seed: int) -> None:
    """``act_shift`` lowered once for each ``pg_scale`` boundary passed, the
    scene written into the density's leaves, k0's drawn, the MLP seeded."""
    params.act_shift -= ft.decay_after_scale * sum(1 for b in ft.pg_scale if int(b) <= step)
    for name, shift in (("density", params.act_shift), ("k0", None)):
        field = getattr(params, name)
        vals = bounded.vm_leaves(bounded.VM_STREAMS[name], field.xz_plane.shape[-1],
                                 field.channels, mcfg.xyz_min, mcfg.xyz_max, mcfg.world_size,
                                 shift, seed, field.xy_plane.device)
        for k, v in vals.items():
            getattr(field, k).data.copy_(v)
    weights.fill_mlp([(lin.weight.data, lin.bias.data) for lin in params.rgbnet.layers], seed)


def program_leaves(params) -> dict:
    """The trainable tensors under the reference's names."""
    out = {f"{f}.{k}": v for f in T.FIELDS for k, v in getattr(params, f).leaves().items()}
    for i, lin in enumerate(params.rgbnet.layers):
        out[f"mlp.{i}.weight"], out[f"mlp.{i}.bias"] = lin.weight, lin.bias
    return out
