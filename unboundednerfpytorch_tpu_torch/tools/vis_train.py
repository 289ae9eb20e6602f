"""Draw the exported cameras and scene box (``--program export_bbox`` writes
``cam.npz``) to a PNG:

    python -m unboundednerfpytorch_tpu_torch.tools.vis_train EXP_DIR/cam.npz [--out cams.png]

The port's copy of the JAX package's ``tools/vis_train.py``, the headless
stand-in for the reference's open3d camera viewer (matplotlib's Agg;
``utils/visualize.py``). Host work only.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", help="cam.npz (xyz_min, xyz_max, poses)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    data = np.load(args.path)
    poses = data["poses"]
    xyz_min, xyz_max = data["xyz_min"], data["xyz_max"]
    print(f"{len(poses)} cameras; bbox {xyz_min} .. {xyz_max}")

    from unboundednerfpytorch_tpu_torch.utils.visualize import plot_cameras

    out = args.out or os.path.splitext(args.path)[0] + ".png"
    plot_cameras(poses, out, xyz_min=xyz_min, xyz_max=xyz_max)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
