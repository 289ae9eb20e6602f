"""Held-out image panels written during training.

The port's copy of ``unboundednerfpytorch_tpu/utils/observability.py`` (the
reference logs GT / pred / depth images through Lightning's
TensorBoardLogger). At the ``i_panel`` cadence the training loop renders one
held-out view through the current model and writes one side-by-side PNG,
``[ GT | prediction | 4x|error| | depth ]``, with a ``panels.jsonl`` record
(stage, step, view PSNR, path), so the panels' quality is a plottable series.

PNG files are written through PIL, as ``imageio`` writes them (the same
bytes). The depth takes matplotlib's turbo colormap where matplotlib is
installed, else grey, as in the JAX package.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _to8b(x: np.ndarray) -> np.ndarray:
    return (255 * np.clip(np.asarray(x, np.float32), 0.0, 1.0)).astype(np.uint8)


def depth_vis(depth: np.ndarray, bgmap: np.ndarray | None = None) -> np.ndarray:
    """Depth to a [H, W, 3] float image in [0, 1]: robust (2..98 percentile)
    normalization, matplotlib's turbo colormap where matplotlib is
    installed, grey otherwise. Background-dominated pixels (bgmap > 0.5)
    render black so sky does not saturate the scale."""
    d = np.asarray(depth, np.float32)
    fg = None
    if bgmap is not None:
        fg = np.asarray(bgmap) <= 0.5
        sel = d[fg] if fg.any() else d
    else:
        sel = d
    lo, hi = np.percentile(sel, [2.0, 98.0]) if sel.size else (0.0, 1.0)
    n = np.clip((d - lo) / max(hi - lo, 1e-9), 0.0, 1.0)
    try:
        import matplotlib
    except ImportError:
        img = np.repeat(n[..., None], 3, axis=-1)
    else:
        img = np.asarray(matplotlib.colormaps["turbo"](n), np.float32)[..., :3]
    if fg is not None:
        img = img * fg[..., None].astype(np.float32)
    return img


def write_png_file(path: str, img8: np.ndarray) -> None:
    """A uint8 image as a PNG file."""
    from PIL import Image

    Image.fromarray(np.asarray(img8)).save(path, format="PNG")


def write_panel(path: str, gt: np.ndarray, pred: np.ndarray, depth: np.ndarray,
                bgmap: np.ndarray | None = None) -> float:
    """Write the ``[GT | pred | 4x|err| | depth]`` panel PNG; returns the
    view PSNR. All inputs are [H, W, ...] float arrays in [0, 1]."""
    gt = np.asarray(gt, np.float32)
    pred = np.asarray(pred, np.float32)
    mse = float(np.mean((gt - pred) ** 2))
    psnr = -10.0 * np.log10(max(mse, 1e-12))
    err = np.abs(gt - pred) * 4.0
    panel = np.concatenate(
        [_to8b(gt), _to8b(pred), _to8b(err), _to8b(depth_vis(depth, bgmap))], axis=1)
    write_png_file(path, panel)
    return psnr


def record_panel(exp_dir: str, stage: str, step: int, gt, pred, depth, bgmap=None) -> float:
    """Write the panel into ``<exp_dir>/panels/`` and append its record to
    ``panels.jsonl``. Returns the view PSNR."""
    pdir = os.path.join(exp_dir, "panels")
    os.makedirs(pdir, exist_ok=True)
    path = os.path.join(pdir, f"{stage}_{step:06d}.png")
    psnr = write_panel(path, gt, pred, depth, bgmap)
    with open(os.path.join(pdir, "panels.jsonl"), "a") as f:
        f.write(json.dumps({"stage": stage, "step": step, "psnr": round(psnr, 3),
                            "panel": os.path.relpath(path, exp_dir)}) + "\n")
    return psnr
