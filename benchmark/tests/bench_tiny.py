"""Shared by the benchmark's CPU tests: every cell at a tiny size on the
port's plain paths (its CUDA ops fall back to plain PyTorch on the CPU)."""

from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

CELLS = ("bicycle_single.train", "bicycle_dcvgo.train", "bicycle_single.render",
         "bicycle_dcvgo.render")
TINY = {
    "config": {
        "fine_model_and_render": {k: 24**3 for k in (
            "num_voxels_density", "num_voxels_rgb", "num_voxels_base_density",
            "num_voxels_base_rgb")},
        "capture": {"n_views": 10, "H": 24, "W": 32},
        "fine_train": {"N_rand": 64},
    },
    "traffic": {"check_pixels": 64, "check_views": 2, "trace_seconds": 0.3},
}
SEED = 2**31 + 12345  # a seed past 32 signed bits, as a run may be given


def run(cell: str, root=ROOT, trace: bool = False, faults=(), control: bool = False,
        seconds: float = 0.3, seed: int = SEED):
    from benchmark.core import runner

    torch.set_num_threads(2)
    return runner.run(root, cell, seed, seconds, trace, "cpu", overrides=TINY, faults=faults,
                      control=control, log=lambda *a, **k: None)
