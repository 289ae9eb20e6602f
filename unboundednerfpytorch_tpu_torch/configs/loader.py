"""Python-config loader with ``_base_`` inheritance.

The port's own copy of ``unboundednerfpytorch_tpu/configs/loader.py``.

Replaces the reference's mmengine ``Config.fromfile``
(``run_FourierGrid.py:82``; schema in
``FourierGrid/configs/default.py``): scene configs are python files defining
plain module-level values; ``_base_ = ['../default.py']`` merges parents
depth-first; a child dict with ``_delete_: True`` replaces the parent dict
instead of merging into it.
"""

from __future__ import annotations

import os
import types
from typing import Any

from unboundednerfpytorch_tpu_torch.configs.schema import ExpConfig, exp_config_from_dict

_DELETE_KEY = "_delete_"
_BASE_KEY = "_base_"


def _exec_config_file(path: str) -> dict:
    with open(path) as f:
        src = f.read()
    mod = types.ModuleType("_cfg_")
    mod.__dict__["__file__"] = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return {
        k: v
        for k, v in mod.__dict__.items()
        if not k.startswith("__") and not isinstance(v, types.ModuleType)
        and not callable(v)
    }


def _merge(base: Any, override: Any) -> Any:
    """mmengine merge semantics: dicts merge recursively unless the override
    dict carries _delete_=True; everything else replaces."""
    if isinstance(base, dict) and isinstance(override, dict):
        if override.get(_DELETE_KEY):
            out = {k: v for k, v in override.items() if k != _DELETE_KEY}
            return out
        out = dict(base)
        for k, v in override.items():
            out[k] = _merge(base.get(k), v) if k in base else v
        return out
    return override


def load_config_dict(path: str) -> dict:
    """Load a config file, resolving _base_ inheritance."""
    cfg = _exec_config_file(path)
    bases = cfg.pop(_BASE_KEY, [])
    if isinstance(bases, str):
        bases = [bases]
    merged: dict = {}
    for b in bases:
        bpath = os.path.normpath(os.path.join(os.path.dirname(path), b))
        merged = _merge(merged, load_config_dict(bpath))
    return _merge(merged, cfg)


def load_config(path: str, visualize_poses: bool = False) -> ExpConfig:
    d = load_config_dict(path)
    if visualize_poses:
        d = apply_visualize_poses(d)
    return exp_config_from_dict(d)


def apply_visualize_poses(d: dict) -> dict:
    """The reference's ``visualize_poses`` debug mode
    (``FourierGrid/configs/waymo/waymo_base.py:11-27``),
    applied as a config transformation so it works on ANY scene config (the
    reference requires hand-editing the base file): a short 600-iter coarse
    run, a flat fast_color_thres of stepsize/_mpi_depth/5, and no
    distortion loss — the regime used to eyeball exported cameras/coarse
    geometry before committing to a full run."""
    d = dict(d)
    stepsize = d.get("stepsize", d.get(
        "fine_model_and_render", {}).get("stepsize", 0.5))
    mpi_depth = d.get("_mpi_depth", 256)
    flat_thres = float(stepsize) / float(mpi_depth) / 5.0
    d["coarse_train"] = {**d.get("coarse_train", {}), "N_iters": 600}
    for sec in ("coarse_train", "fine_train"):
        d[sec] = {**d.get(sec, {}), "weight_distortion": 0.0}
    for sec in ("coarse_model_and_render", "fine_model_and_render"):
        d[sec] = {**d.get(sec, {}), "fast_color_thres": flat_thres,
                  "fast_color_thres_schedule": ()}
    return d
