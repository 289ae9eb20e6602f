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
    (the ``ml_dtypes`` type) goes through float32, which holds it exactly."""
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


def fourier_grid_params_to_numpy(params: FourierGridParams) -> dict:
    """Inverse of :func:`fourier_grid_params_from_numpy`."""

    def grid(g: FourierGrid) -> dict:
        return {"grid": g.grid.detach().float().cpu().numpy(), "xyz_min": g.xyz_min,
                "xyz_max": g.xyz_max, "num_freqs": g.num_freqs}

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
