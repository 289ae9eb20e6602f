"""Draw an exported coarse volume (``--program export_coarse`` writes
``coarse_volume.npz``) to a PNG: the voxels whose alpha passes a threshold,
coloured by their rgb, the scene box and, with ``cam.npz``, the cameras:

    python -m unboundednerfpytorch_tpu_torch.tools.vis_volume EXP_DIR/coarse_volume.npz 1e-3 \\
        [--cam EXP_DIR/cam.npz] [--out volume.png] [--max_points 200000]

The port's copy of the JAX package's ``tools/vis_volume.py``, the headless
stand-in for the reference's open3d volume viewer (matplotlib's Agg;
``utils/visualize.py``); more active voxels than ``--max_points`` are
subsampled with a fixed seed. Host work only.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    ap.add_argument("path", help="coarse_volume.npz (alpha, rgb)")
    ap.add_argument("thres", type=float, help="alpha threshold")
    ap.add_argument("--cam", help="cam.npz from --program export_bbox")
    ap.add_argument("--out", default=None, help="output PNG path")
    ap.add_argument("--max_points", type=int, default=200_000)
    args = ap.parse_args(argv)

    data = np.load(args.path)
    alpha, rgb = data["alpha"], data["rgb"]
    # export_coarse writes channel-last (alpha [X,Y,Z], rgb [X,Y,Z,3]);
    # tolerate a channel-first rgb from foreign exporters. alpha has no
    # channel axis, so it is never transposed.
    if rgb.ndim == 4 and rgb.shape[0] == 3 and rgb.shape[-1] != 3:
        rgb = np.transpose(rgb, (1, 2, 3, 0))
    print("Shape", alpha.shape, rgb.shape)
    active = alpha > args.thres
    print("Active rate", float(active.mean()))
    print("Active nums", int(active.sum()))

    xyz_min = np.zeros(3)
    xyz_max = np.asarray(alpha.shape, np.float64)
    poses = None
    if args.cam:
        cam = np.load(args.cam)
        xyz_min, xyz_max = cam["xyz_min"], cam["xyz_max"]
        poses = cam.get("poses")

    xyz = np.stack(active.nonzero(), -1)
    color = rgb[xyz[:, 0], xyz[:, 1], xyz[:, 2]][:, :3]
    if len(xyz) > args.max_points:
        sel = np.random.RandomState(0).choice(
            len(xyz), args.max_points, replace=False
        )
        xyz, color = xyz[sel], color[sel]
    pts = xyz / np.asarray(alpha.shape) * (xyz_max - xyz_min) + xyz_min

    from unboundednerfpytorch_tpu_torch.utils.visualize import plot_volume

    out = args.out or os.path.splitext(args.path)[0] + ".png"
    plot_volume(pts, np.clip(color, 0, 1), xyz_min, xyz_max,
                poses=poses, out_path=out)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
