"""Checkpoints of the port: a directory with ``meta.json`` and ``params.npz``.

Counterpart of ``unboundednerfpytorch_tpu/utils/checkpoint.py`` for the
FourierGrid family: the same directory layout and the same ``meta.json``
keys (global_step, family, model_kwargs, has_opt_state, format_version), so
the model can be re-instantiated from the files alone. The JAX package
writes its parameters as ``params.msgpack`` through flax; the port imports
neither, and writes ``params.npz`` holding the numpy dict of
``convert.fourier_grid_params_to_numpy`` (nested keys joined by ``/``;
bfloat16 grids as the float32 values that hold them exactly, cast back to
``grid_dtype`` at load). ``convert.py`` says how a JAX checkpoint is carried
over.

Not ported yet: optimizer state (``has_opt_state`` is always false),
``merge_blocks`` and the import of reference ``.tar`` files.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from unboundednerfpytorch_tpu_torch import convert
from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg

FAMILY = "FourierGrid"


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, name + "/"))
        elif isinstance(val, (list, tuple)) and val and isinstance(val[0], np.ndarray):
            out.update({f"{name}/{i}": v for i, v in enumerate(val)})
        else:
            out[name] = np.asarray(val)
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for name, val in flat.items():
        node = tree
        parts = name.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val
    mlp = tree["rgbnet"]
    for key in ("weights", "biases"):
        mlp[key] = [mlp[key][str(i)] for i in range(len(mlp[key]))]
    return tree


def save_model(path: str, family: str, cfg: fg.FourierGridConfig, params,
               global_step: int = 0) -> None:
    if family != FAMILY:
        raise NotImplementedError(f"only {FAMILY} checkpoints are ported, got {family!r}")
    os.makedirs(path, exist_ok=True)
    meta = {
        "global_step": int(global_step),
        "family": family,
        "model_kwargs": convert.config_to_dict(cfg),
        "has_opt_state": False,
        "format_version": 1,
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    np.savez(os.path.join(path, "params.npz"),
             **_flatten(convert.fourier_grid_params_to_numpy(params)))


def load_model(path: str, device="cpu"):
    """Re-instantiate from the checkpoint alone, on ``device``. Returns
    (family, cfg, params, global_step, None); the last is the optimizer
    state's place in the JAX package's tuple."""
    if os.path.isfile(path) and path.endswith(".tar"):
        raise NotImplementedError("importing a reference .tar checkpoint is not ported yet")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    family = meta["family"]
    if family != FAMILY:
        raise NotImplementedError(f"only {FAMILY} checkpoints are ported, got {family!r}")
    cfg = convert.config_from_dict(meta["model_kwargs"])
    with np.load(os.path.join(path, "params.npz")) as npz:
        tree = _unflatten({k: npz[k] for k in npz.files})
    params = convert.fourier_grid_params_from_numpy(tree, device)
    dt = fg._DTYPES[cfg.grid_dtype]
    for name in ("density", "k0"):
        grid = getattr(params, name).grid
        grid.data = grid.data.to(dt)
    return family, cfg, params, int(meta["global_step"]), None
