"""Carry model weights (FourierGrid, DVGO, DCVGO, DMPIGO, Block-NeRF)
between the JAX package and the port.

The JAX ``FourierGridParams`` is handed over as a nested dict of numpy
arrays keyed by its field names, so this module needs nothing of JAX:

    {"density": {"grid": [B, X, Y, Z, 1], "xyz_min": (3,), "xyz_max": (3,),
                 "num_freqs": K},
     "k0": {... same keys, grid [B, X, Y, Z, k0_dim]},
     "rgbnet": {"weights": [[in, out], ...], "biases": [[out], ...]},
     "act_shift": scalar,
     "mask_cache": {"mask": bool [X, Y, Z], "xyz_min": ..., "xyz_max": ...},
     "vd": {... the density's keys, grid [1, n, n, n, 3]} (the view grid),
     "img_embeddings": [sample_num, img_emb_dim]}

``rgbnet`` is None for the coarse colour head (k0 then one plain bank of 3
channels); ``vd`` and ``img_embeddings`` are absent or None where the model
has none.

The JAX ``DVGOParams``, ``DCVGOParams`` and ``DMPIGOParams`` have the same
keys, their grids
``DenseGrid`` s without ``num_freqs`` and with a grid ``[X, Y, Z, C]`` (the
port's is ``[1, X, Y, Z, C]``), ``rgbnet`` None where the model has no MLP,
and DMPIGO's ``act_shift`` a ``[mpi_depth]`` array. A DVGO field that is a
``TensoRFGrid`` (``nerf/ship.tensorf.py``) is a dict of its leaves instead,
``{"xy_plane", "xz_plane", "yz_plane", "x_vec", "y_vec", "z_vec", "f_vec"
(absent for one channel), "xyz_min", "xyz_max", "channels"}``, the JAX
layouts as they are; its optimizer moments are keyed by the same leaf
names. :func:`params_to_numpy`,
:func:`params_from_numpy`, :func:`config_from_dict` and the optimizer-state
functions take the family (``"FourierGrid"``, ``"dvgo"``, ``"dcvgo"``,
``"dmpigo"``, the names of the JAX package's checkpoints).

``nn.Linear`` keeps its weight as ``[out, in]``, so the MLP kernels are
transposed on the way in and back on the way out.

A Block-NeRF block (the JAX ``BlockNeRFParams``) is the dict
``{"xyz_layers", "xyz_final", "dir_layers", "sigma_head", "rgb_head",
"vis_layers", "vis_head": {"weights": [[in, out], ...], "biases": [...]},
"appearance": [n_images, appearance_dim]}``
(:func:`block_nerf_tree_from_object` reads it off the JAX object, as
``serialization.to_state_dict`` lays it out); :func:`block_nerf_from_numpy`
makes the port's :class:`~unboundednerfpytorch_tpu_torch.models.block_nerf.model.BlockNeRF`
of it, every size read off the arrays, and :func:`block_nerf_to_numpy` goes
back.

A JAX checkpoint directory is read by the port's own ``utils/checkpoint.py``
``load_model`` (no flax, no ``msgpack`` package): the msgpack's arrays, with
the bounds and frequency counts of the model its config builds, make the
dict above, and :func:`params_from_numpy` the port's params;
``save_jax_model`` writes the other way. In a process that has both packages,
the JAX package's ``load_model`` gives (config, params);
:func:`tree_from_params_object` turns the params into the dict above (it
reads attributes and imports no JAX) and :func:`config_from_dict` turns
``dataclasses.asdict(config)`` into the port's config. The other way,
:func:`config_to_dict` and :func:`params_to_numpy` give what the JAX
package's config class and ``params.replace`` take.

The optimizer's state travels the same way, in the layout of the JAX
``MaskedAdamState``:

    {"step": int32, "exp_avg": {"density": {"grid": m}, "k0": {"grid": m},
                                "rgbnet": {"weights": [[in, out], ...],
                                           "biases": [[out], ...]}},
     "exp_avg_sq": {... the same}}

(``vd`` a grid's ``{"grid": m}`` and ``img_embeddings`` the moment array
itself, where the model trains them.)

A JAX checkpoint's ``opt_state.msgpack`` decodes to the dict above, which
:func:`opt_state_from_numpy` turns into the port's ``MaskedAdam.state_dict``
(``utils/checkpoint.py``). With both packages, the JAX package's
``restore_opt_state`` (with the template of its ``create_train_state``) makes
the ``MaskedAdamState``, and :func:`opt_state_tree_from_object` the dict
above. :func:`opt_state_to_numpy` goes back; the JAX side rebuilds its state
with ``MaskedAdamState(step, exp_avg=..., exp_avg_sq=...)`` and ``.replace``
on its template's subtrees.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from unboundednerfpytorch_tpu_torch.fields.grids import (
    TENSORF_LEAVES, DenseGrid, FourierGrid, MaskGrid, TensoRFGrid,
)
from unboundednerfpytorch_tpu_torch.fields.mlp import MLP
from unboundednerfpytorch_tpu_torch.models import dcvgo, dmpigo, dvgo
from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
from unboundednerfpytorch_tpu_torch.models.fourier_grid import (
    FourierGridConfig, FourierGridParams,
)

CONFIGS = {"FourierGrid": FourierGridConfig, "dvgo": dvgo.DVGOConfig,
           "dcvgo": dcvgo.DCVGOConfig, "dmpigo": dmpigo.DMPIGOConfig}
# the model module of each family (create, forward, build_render_cache, ...)
FAMILIES = {"FourierGrid": fg, "dvgo": dvgo, "dcvgo": dcvgo, "dmpigo": dmpigo}


def _tensor(a, device) -> torch.Tensor:
    """numpy -> torch; numpy has no bfloat16 of its own, so a bfloat16 array
    (the ``ml_dtypes`` type) goes through float32, which holds it exactly. A
    torch tensor is moved as it is."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(a, device=device)


def _grid_from(sub: dict, device) -> FourierGrid:
    grid = _tensor(sub["grid"], device)
    return FourierGrid(grid.shape[-1], grid.shape[1:4], sub["xyz_min"], sub["xyz_max"],
                       num_freqs=int(sub["num_freqs"]), grid=grid)


def _mlp_from(sub: dict | None, device) -> MLP | None:
    if sub is None:
        return None
    weights = [np.asarray(w) for w in sub["weights"]]
    biases = [np.asarray(b) for b in sub["biases"]]
    dims = [weights[0].shape[0]] + [w.shape[1] for w in weights]
    rgbnet = MLP(dims[0], dims[1], dims[-1], len(weights), device=device)
    with torch.no_grad():
        for lin, w, b in zip(rgbnet.layers, weights, biases):
            lin.weight.copy_(torch.tensor(w.T))
            lin.bias.copy_(torch.tensor(b))
    return rgbnet


def _mask_from(mc: dict, device) -> MaskGrid:
    mask = _tensor(mc["mask"], device)
    return MaskGrid(mask.shape, mc["xyz_min"], mc["xyz_max"], mask=mask)


def fourier_grid_params_from_numpy(tree: dict, device) -> FourierGridParams:
    """The port's parameters from the JAX ``FourierGridParams`` as numpy."""
    vd = tree.get("vd")
    emb = tree.get("img_embeddings")
    if emb is not None:
        emb = _tensor(emb, device).to(torch.float32)
        if emb.ndim != 2:
            raise ValueError(f"img_embeddings must be [sample_num, img_emb_dim], got "
                             f"{tuple(emb.shape)}")
    return FourierGridParams(_grid_from(tree["density"], device), _grid_from(tree["k0"], device),
                             _mlp_from(tree.get("rgbnet"), device),
                             float(np.asarray(tree["act_shift"])),
                             _mask_from(tree["mask_cache"], device),
                             vd=None if vd is None else _grid_from(vd, device),
                             img_embeddings=emb)


def _dense_from(sub: dict, device) -> DenseGrid:
    grid = _tensor(sub["grid"], device)  # [X, Y, Z, C]
    return DenseGrid(grid.shape[-1], grid.shape[:3], sub["xyz_min"], sub["xyz_max"],
                     grid=grid[None])


def _tensorf_from(sub: dict, device) -> TensoRFGrid:
    leaves = {k: _tensor(sub[k], device) for k in TENSORF_LEAVES if sub.get(k) is not None}
    xy, xz = leaves["xy_plane"], leaves["xz_plane"]
    channels = int(sub.get("channels", leaves["f_vec"].shape[1] if "f_vec" in leaves else 1))
    return TensoRFGrid(channels, (xy.shape[0], xy.shape[1], xz.shape[1]), sub["xyz_min"],
                       sub["xyz_max"], n_comp=xz.shape[-1], n_comp_xy=xy.shape[-1],
                       leaves=leaves)


def _field_from(sub: dict, device):
    return _tensorf_from(sub, device) if "xy_plane" in sub else _dense_from(sub, device)


def params_from_numpy(family: str, tree: dict, device):
    """The port's parameters of ``family`` from the JAX params as numpy."""
    if family == "FourierGrid":
        return fourier_grid_params_from_numpy(tree, device)
    parts = (_field_from(tree["density"], device), _field_from(tree["k0"], device),
             _mlp_from(tree.get("rgbnet"), device))
    mask = _mask_from(tree["mask_cache"], device)
    if family in ("dvgo", "dcvgo"):
        cls = dvgo.DVGOParams if family == "dvgo" else dcvgo.DCVGOParams
        return cls(*parts, float(np.asarray(tree["act_shift"])), mask)
    if family == "dmpigo":
        shift = torch.tensor(np.asarray(tree["act_shift"], np.float32), device=device)
        return dmpigo.DMPIGOParams(*parts, shift, mask)
    raise NotImplementedError(f"the {family} family is not ported yet")


def _grid_to_numpy(g, bf16_bits: bool, t: torch.Tensor | None = None) -> dict:
    if isinstance(g, TensoRFGrid):
        return {**{k: v.detach().float().cpu().numpy() for k, v in g.leaves().items()},
                "xyz_min": g.xyz_min, "xyz_max": g.xyz_max, "channels": g.channels}
    t = g.grid.detach() if t is None else t
    if isinstance(g, DenseGrid):
        t = t[0]
    if bf16_bits and t.dtype == torch.bfloat16:
        arr = t.cpu().view(torch.int16).numpy().view(np.uint16)
    else:
        arr = t.float().cpu().numpy()
    out = {"grid": arr, "xyz_min": g.xyz_min, "xyz_max": g.xyz_max}
    if not isinstance(g, DenseGrid):
        out["num_freqs"] = g.num_freqs
    return out


def params_to_numpy(params, bf16_bits: bool = False, grids: dict | None = None) -> dict:
    """Inverse of :func:`params_from_numpy` (the family read off the params).
    A bfloat16 grid comes as float32 values, or with ``bf16_bits`` as the
    uint16 array of its bit patterns (half the bytes; ``bf16_from_bits``
    undoes it). ``grids`` ({"density" or "k0": tensor [B, X, Y, Z, C]})
    stands in for those fields' own grids (a cut grid assembled whole)."""
    grids = grids or {}
    rgbnet = None
    if params.rgbnet is not None:
        rgbnet = {
            "weights": [lin.weight.detach().cpu().numpy().T for lin in params.rgbnet.layers],
            "biases": [lin.bias.detach().cpu().numpy() for lin in params.rgbnet.layers],
        }
    shift = params.act_shift
    tree = {
        "density": _grid_to_numpy(params.density, bf16_bits, grids.get("density")),
        "k0": _grid_to_numpy(params.k0, bf16_bits, grids.get("k0")),
        "rgbnet": rgbnet,
        "act_shift": (shift.detach().cpu().numpy() if isinstance(shift, torch.Tensor)
                      else np.float32(shift)),
        "mask_cache": {"mask": params.mask_cache.mask.cpu().numpy(),
                       "xyz_min": params.mask_cache.xyz_min,
                       "xyz_max": params.mask_cache.xyz_max},
    }
    if getattr(params, "vd", None) is not None:
        tree["vd"] = _grid_to_numpy(params.vd, bf16_bits)
    if getattr(params, "img_embeddings", None) is not None:
        tree["img_embeddings"] = params.img_embeddings.detach().cpu().numpy()
    return tree


def bf16_from_bits(bits: np.ndarray) -> torch.Tensor:
    """The bfloat16 tensor whose bit patterns are the uint16 array ``bits``."""
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)


def tree_from_params_object(p) -> dict:
    """The nested numpy dict from any object shaped like the JAX
    ``FourierGridParams``, ``DVGOParams``, ``DCVGOParams`` or ``DMPIGOParams``
    (attributes
    ``density``, ``k0``, ``rgbnet``, ``act_shift``, ``mask_cache``, optionally
    ``vd`` / ``img_embeddings``, carried where they are not None)."""

    def grid(g) -> dict:
        if hasattr(g, "xy_plane"):  # a TensoRFGrid
            return {**{k: np.asarray(getattr(g, k)) for k in TENSORF_LEAVES
                       if getattr(g, k) is not None},
                    "xyz_min": tuple(g.xyz_min), "xyz_max": tuple(g.xyz_max),
                    "channels": int(g.channels)}
        out = {"grid": np.asarray(g.grid), "xyz_min": tuple(g.xyz_min),
               "xyz_max": tuple(g.xyz_max)}
        if hasattr(g, "num_freqs"):
            out["num_freqs"] = int(g.num_freqs)
        return out

    return {
        "density": grid(p.density),
        "k0": grid(p.k0),
        "rgbnet": None if p.rgbnet is None else {
            "weights": [np.asarray(w) for w in p.rgbnet.weights],
            "biases": [np.asarray(b) for b in p.rgbnet.biases]},
        "act_shift": np.asarray(p.act_shift),
        "mask_cache": {"mask": np.asarray(p.mask_cache.mask),
                       "xyz_min": tuple(p.mask_cache.xyz_min),
                       "xyz_max": tuple(p.mask_cache.xyz_max)},
        "vd": None if getattr(p, "vd", None) is None else grid(p.vd),
        "img_embeddings": (None if getattr(p, "img_embeddings", None) is None
                           else np.asarray(p.img_embeddings)),
    }


def config_to_dict(cfg) -> dict:
    """``model_kwargs`` of a checkpoint's ``meta.json``: every field of the
    config, tuples as lists once through JSON."""
    return dataclasses.asdict(cfg)


def config_from_dict(d: dict, family: str = "FourierGrid"):
    """The port's config of ``family`` from ``model_kwargs`` (the port's own
    or the JAX package's, whose extra fields name features outside the port
    and are dropped when they hold their defaults' meaning; a checkpoint that
    needs one of them is refused by ``create``/``forward``'s own checks)."""
    cls = CONFIGS[family]
    names = {f.name for f in dataclasses.fields(cls)}
    def fix(v):  # JSON's lists back to the config's tuples, nested ones too
        return tuple(fix(x) for x in v) if isinstance(v, list) else v

    return cls(**{k: fix(v) for k, v in d.items() if k in names})


def _moments_to_numpy(name: str, moments, dense: bool):
    arrays = [m.detach().cpu().numpy() for m in moments]
    if name == "img_embeddings":  # a parameter of its own: the array itself
        return arrays[0]
    if name == "rgbnet":  # the port's order: weight [out, in], bias, per layer
        return {"weights": [w.T for w in arrays[0::2]], "biases": arrays[1::2]}
    if len(arrays) > 1:  # a TensoRF group: its leaves in order
        return dict(zip(TENSORF_LEAVES, arrays))
    (grid,) = arrays
    return {"grid": grid[0] if dense else grid}


def _moments_from_numpy(name: str, sub, dense: bool) -> list:
    if name == "img_embeddings":
        return [np.asarray(sub)]
    if name == "rgbnet":
        return [a for w, b in zip(sub["weights"], sub["biases"])
                for a in (np.asarray(w).T, np.asarray(b))]
    if "grid" not in sub:  # a TensoRF group
        return [np.asarray(sub[k]) for k in TENSORF_LEAVES if sub.get(k) is not None]
    grid = np.asarray(sub["grid"])
    return [grid[None] if dense else grid]


def opt_state_to_numpy(state: dict, family: str = "FourierGrid") -> dict:
    """The port's ``MaskedAdam.state_dict()`` in the JAX layout (above)."""
    out = {"step": np.int32(state["step"])}
    dense = family != "FourierGrid"
    for key in ("exp_avg", "exp_avg_sq"):
        out[key] = {name: _moments_to_numpy(name, ms, dense) for name, ms in state[key].items()}
    return out


def opt_state_from_numpy(tree: dict, family: str = "FourierGrid") -> dict:
    """Inverse of :func:`opt_state_to_numpy`: a state for
    ``MaskedAdam.load_state_dict``, its moments numpy arrays."""
    out = {"step": int(np.asarray(tree["step"]))}
    dense = family != "FourierGrid"
    for key in ("exp_avg", "exp_avg_sq"):
        out[key] = {name: _moments_from_numpy(name, sub, dense) for name, sub in tree[key].items()}
    return out


def opt_state_tree_from_object(s) -> dict:
    """The JAX-layout dict from any object shaped like the JAX
    ``MaskedAdamState`` (``step``, and ``exp_avg`` / ``exp_avg_sq`` dicts of
    grids with ``.grid`` and an MLP with ``.weights`` / ``.biases``)."""

    def sub(x):
        if not hasattr(x, "grid") and not hasattr(x, "weights") and not hasattr(x, "xy_plane"):
            return np.asarray(x)  # a parameter of its own (img_embeddings)
        if hasattr(x, "xy_plane"):
            return {k: np.asarray(getattr(x, k)) for k in TENSORF_LEAVES
                    if getattr(x, k) is not None}
        if hasattr(x, "weights"):
            return {"weights": [np.asarray(w) for w in x.weights],
                    "biases": [np.asarray(b) for b in x.biases]}
        return {"grid": np.asarray(x.grid)}

    return {"step": np.asarray(s.step),
            **{key: {name: sub(x) for name, x in getattr(s, key).items()}
               for key in ("exp_avg", "exp_avg_sq")}}


BLOCK_NERF_MLPS = ("xyz_layers", "xyz_final", "dir_layers", "sigma_head", "rgb_head",
                   "vis_layers", "vis_head")


def block_nerf_tree_from_object(p) -> dict:
    """The Block-NeRF dict (above) from an object shaped like the JAX
    ``BlockNeRFParams`` (MLPs with ``.weights`` / ``.biases``)."""
    tree = {name: {"weights": [np.asarray(w) for w in getattr(p, name).weights],
                   "biases": [np.asarray(b) for b in getattr(p, name).biases]}
            for name in BLOCK_NERF_MLPS}
    tree["appearance"] = np.asarray(p.appearance)
    return tree


def block_nerf_from_numpy(tree: dict, device="cpu"):
    """The port's ``BlockNeRF`` from the Block-NeRF dict: the depth, width,
    skips, frequencies, appearance size and visibility width read off the
    arrays' shapes."""
    from unboundednerfpytorch_tpu_torch.models.block_nerf.model import BlockNeRF

    xyz = [np.asarray(w) for w in tree["xyz_layers"]["weights"]]
    in_xyz, W = xyz[0].shape
    in_dir = np.asarray(tree["vis_layers"]["weights"][0]).shape[0] - in_xyz
    n_app, app_dim = np.asarray(tree["appearance"]).shape
    in_exp = np.asarray(tree["dir_layers"]["weights"][0]).shape[0] - W - in_dir - app_dim
    model = BlockNeRF(n_appearance=n_app, D=len(xyz), W=W,
                      skips=[i for i, w in enumerate(xyz) if i and w.shape[0] == W + in_xyz],
                      xyz_freqs=in_xyz // 6, dir_freqs=in_dir // 6, exposure_freqs=in_exp // 2,
                      appearance_dim=app_dim,
                      vis_width=np.asarray(tree["vis_layers"]["weights"][0]).shape[1],
                      device=device)
    with torch.no_grad():
        for name in BLOCK_NERF_MLPS:
            mod = getattr(model, name)
            layers = mod if name == "xyz_layers" else mod.layers
            sub = tree[name]
            for lin, w, b in zip(layers, sub["weights"], sub["biases"], strict=True):
                lin.weight.copy_(_tensor(np.asarray(w).T, device))
                lin.bias.copy_(_tensor(b, device))
        model.appearance.copy_(_tensor(tree["appearance"], device))
    return model


def block_nerf_to_numpy(model) -> dict:
    """Inverse of :func:`block_nerf_from_numpy`."""
    tree = {}
    for name in BLOCK_NERF_MLPS:
        mod = getattr(model, name)
        layers = mod if name == "xyz_layers" else mod.layers
        tree[name] = {"weights": [lin.weight.detach().cpu().numpy().T.copy() for lin in layers],
                      "biases": [lin.bias.detach().cpu().numpy() for lin in layers]}
    tree["appearance"] = model.appearance.detach().cpu().numpy()
    return tree
