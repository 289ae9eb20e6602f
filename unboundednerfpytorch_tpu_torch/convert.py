"""Carry FourierGrid weights between the JAX package and the port.

The JAX ``FourierGridParams`` is handed over as a nested dict of numpy
arrays keyed by its field names, so this module needs nothing of JAX:

    {"density": {"grid": [B, X, Y, Z, 1], "xyz_min": (3,), "xyz_max": (3,),
                 "num_freqs": K},
     "k0": {... same keys, grid [B, X, Y, Z, k0_dim]},
     "rgbnet": {"weights": [[in, out], ...], "biases": [[out], ...]},
     "act_shift": scalar,
     "mask_cache": {"mask": bool [X, Y, Z], "xyz_min": ..., "xyz_max": ...}}

``nn.Linear`` keeps its weight as ``[out, in]``, so the MLP kernels are
transposed on the way in and back on the way out. The view-direction grid
and appearance embeddings are not part of the ported model; a tree that
carries them is refused.

A whole checkpoint is carried over in a process that has both packages: the
JAX package's ``load_model`` gives (config, params); :func:`tree_from_params_object`
turns the params into the dict above (it reads attributes and imports no
JAX), :func:`config_from_dict` turns ``dataclasses.asdict(config)`` into the
port's config, and the port's ``utils.checkpoint.save_model`` writes them.
The other way, :func:`config_to_dict` and :func:`fourier_grid_params_to_numpy`
give what the JAX package's config class and ``params.replace`` take.

The optimizer's state travels the same way, in the layout of the JAX
``MaskedAdamState``:

    {"step": int32, "exp_avg": {"density": {"grid": m}, "k0": {"grid": m},
                                "rgbnet": {"weights": [[in, out], ...],
                                           "biases": [[out], ...]}},
     "exp_avg_sq": {... the same}}

The JAX package's ``load_model`` gives a checkpoint's ``opt_state.msgpack``
as bytes; its ``restore_opt_state`` (with the template of its
``create_train_state``) makes the ``MaskedAdamState``, and
:func:`opt_state_tree_from_object` the dict above, which
:func:`opt_state_from_numpy` turns into the port's ``MaskedAdam.state_dict``.
:func:`opt_state_to_numpy` goes back; the JAX side rebuilds its state with
``MaskedAdamState(step, exp_avg=..., exp_avg_sq=...)`` and ``.replace`` on its
template's subtrees.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from unboundednerfpytorch_tpu_torch.fields.grids import FourierGrid, MaskGrid
from unboundednerfpytorch_tpu_torch.fields.mlp import MLP
from unboundednerfpytorch_tpu_torch.models.fourier_grid import (
    FourierGridConfig, FourierGridParams,
)


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


def fourier_grid_params_from_numpy(tree: dict, device) -> FourierGridParams:
    """The port's parameters from the JAX ``FourierGridParams`` as numpy."""
    for extra in ("vd", "img_embeddings"):
        if tree.get(extra) is not None:
            raise NotImplementedError(f"{extra} is not part of the ported model")
    weights = [np.asarray(w) for w in tree["rgbnet"]["weights"]]
    biases = [np.asarray(b) for b in tree["rgbnet"]["biases"]]
    dims = [weights[0].shape[0]] + [w.shape[1] for w in weights]
    rgbnet = MLP(dims[0], dims[1], dims[-1], len(weights), device=device)
    with torch.no_grad():
        for lin, w, b in zip(rgbnet.layers, weights, biases):
            lin.weight.copy_(torch.tensor(w.T))
            lin.bias.copy_(torch.tensor(b))
    mc = tree["mask_cache"]
    mask = _tensor(mc["mask"], device)
    mask_cache = MaskGrid(mask.shape, mc["xyz_min"], mc["xyz_max"], mask=mask)
    return FourierGridParams(_grid_from(tree["density"], device), _grid_from(tree["k0"], device),
                             rgbnet, float(np.asarray(tree["act_shift"])), mask_cache)


def fourier_grid_params_to_numpy(params: FourierGridParams, bf16_bits: bool = False) -> dict:
    """Inverse of :func:`fourier_grid_params_from_numpy`. A bfloat16 grid
    comes as float32 values, or with ``bf16_bits`` as the uint16 array of its
    bit patterns (half the bytes; ``bf16_from_bits`` undoes it)."""

    def grid(g: FourierGrid) -> dict:
        t = g.grid.detach()
        if bf16_bits and t.dtype == torch.bfloat16:
            arr = t.cpu().view(torch.int16).numpy().view(np.uint16)
        else:
            arr = t.float().cpu().numpy()
        return {"grid": arr, "xyz_min": g.xyz_min, "xyz_max": g.xyz_max,
                "num_freqs": g.num_freqs}

    return {
        "density": grid(params.density),
        "k0": grid(params.k0),
        "rgbnet": {
            "weights": [lin.weight.detach().cpu().numpy().T for lin in params.rgbnet.layers],
            "biases": [lin.bias.detach().cpu().numpy() for lin in params.rgbnet.layers],
        },
        "act_shift": np.float32(params.act_shift),
        "mask_cache": {"mask": params.mask_cache.mask.cpu().numpy(),
                       "xyz_min": params.mask_cache.xyz_min,
                       "xyz_max": params.mask_cache.xyz_max},
    }


def bf16_from_bits(bits: np.ndarray) -> torch.Tensor:
    """The bfloat16 tensor whose bit patterns are the uint16 array ``bits``."""
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)


def tree_from_params_object(p) -> dict:
    """The nested numpy dict from any object shaped like the JAX
    ``FourierGridParams`` (attributes ``density``, ``k0``, ``rgbnet``,
    ``act_shift``, ``mask_cache``, optionally ``vd`` / ``img_embeddings``)."""

    def grid(g) -> dict:
        return {"grid": np.asarray(g.grid), "xyz_min": tuple(g.xyz_min),
                "xyz_max": tuple(g.xyz_max), "num_freqs": int(g.num_freqs)}

    return {
        "density": grid(p.density),
        "k0": grid(p.k0),
        "rgbnet": {"weights": [np.asarray(w) for w in p.rgbnet.weights],
                   "biases": [np.asarray(b) for b in p.rgbnet.biases]},
        "act_shift": np.asarray(p.act_shift),
        "mask_cache": {"mask": np.asarray(p.mask_cache.mask),
                       "xyz_min": tuple(p.mask_cache.xyz_min),
                       "xyz_max": tuple(p.mask_cache.xyz_max)},
        "vd": getattr(p, "vd", None),
        "img_embeddings": getattr(p, "img_embeddings", None),
    }


def config_to_dict(cfg: FourierGridConfig) -> dict:
    """``model_kwargs`` of a checkpoint's ``meta.json``: every field of the
    config, tuples as lists once through JSON."""
    return dataclasses.asdict(cfg)


def config_from_dict(d: dict) -> FourierGridConfig:
    """The port's config from ``model_kwargs`` (the port's own or the JAX
    package's, whose extra fields name features outside the port and are
    dropped when they hold their defaults' meaning; a checkpoint that needs
    one of them is refused by ``create``/``forward``'s own checks)."""
    names = {f.name for f in dataclasses.fields(FourierGridConfig)}
    fix = lambda v: tuple(v) if isinstance(v, list) else v
    return FourierGridConfig(**{k: fix(v) for k, v in d.items() if k in names})


def _moments_to_numpy(name: str, moments) -> dict:
    arrays = [m.detach().cpu().numpy() for m in moments]
    if name == "rgbnet":  # the port's order: weight [out, in], bias, per layer
        return {"weights": [w.T for w in arrays[0::2]], "biases": arrays[1::2]}
    (grid,) = arrays
    return {"grid": grid}


def _moments_from_numpy(name: str, sub: dict) -> list:
    if name == "rgbnet":
        return [a for w, b in zip(sub["weights"], sub["biases"])
                for a in (np.asarray(w).T, np.asarray(b))]
    return [np.asarray(sub["grid"])]


def opt_state_to_numpy(state: dict) -> dict:
    """The port's ``MaskedAdam.state_dict()`` in the JAX layout (above)."""
    out = {"step": np.int32(state["step"])}
    for key in ("exp_avg", "exp_avg_sq"):
        out[key] = {name: _moments_to_numpy(name, ms) for name, ms in state[key].items()}
    return out


def opt_state_from_numpy(tree: dict) -> dict:
    """Inverse of :func:`opt_state_to_numpy`: a state for
    ``MaskedAdam.load_state_dict``, its moments numpy arrays."""
    out = {"step": int(np.asarray(tree["step"]))}
    for key in ("exp_avg", "exp_avg_sq"):
        out[key] = {name: _moments_from_numpy(name, sub) for name, sub in tree[key].items()}
    return out


def opt_state_tree_from_object(s) -> dict:
    """The JAX-layout dict from any object shaped like the JAX
    ``MaskedAdamState`` (``step``, and ``exp_avg`` / ``exp_avg_sq`` dicts of
    grids with ``.grid`` and an MLP with ``.weights`` / ``.biases``)."""

    def sub(x) -> dict:
        if hasattr(x, "weights"):
            return {"weights": [np.asarray(w) for w in x.weights],
                    "biases": [np.asarray(b) for b in x.biases]}
        return {"grid": np.asarray(x.grid)}

    return {"step": np.asarray(s.step),
            **{key: {name: sub(x) for name, x in getattr(s, key).items()}
               for key in ("exp_avg", "exp_avg_sq")}}
