"""Convert a COLMAP reconstruction into training-ready layouts.

The port's copy of the JAX package's ``tools/colmap2standard.py`` (the
reference's ``run_colmap2standard.py`` command line, plus the NeRF++
'standard' layout):

  cams_meta         -> <data_dir>/cams_meta.npy   ([N,27]: 12 pose + 9 K
                       + 4 distortion + 2 bounds, the free-trajectory
                       loader's input format)
  poses_bounds      -> <data_dir>/poses_bounds.npy      ([N,17], NeRF frame)
  poses_bounds_raw  -> <data_dir>/poses_bounds_raw.npy  ([N,17], (-y,x,z))
  standard          -> train/test dirs with rgb/ pose/ intrinsics/ (nerfpp)

Usage: python -m unboundednerfpytorch_tpu_torch.tools.colmap2standard
       --data_dir DIR [--out_mode cams_meta] [--out_dir DIR]
       (out_dir only for --out_mode standard)
"""
from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_dir", required=True,
                   help="scene dir containing sparse/0 (and images/)")
    p.add_argument("--out_mode", default="cams_meta",
                   choices=["cams_meta", "poses_bounds", "poses_bounds_raw", "standard"])
    p.add_argument("--out_dir", default=None,
                   help="output dir for --out_mode standard (default <data_dir>_standard)")
    p.add_argument("--holdout", type=int, default=8,
                   help="every k-th image becomes test (standard mode)")
    args = p.parse_args(argv)

    from unboundednerfpytorch_tpu_torch.data import colmap

    if args.out_mode == "standard":
        out_dir = args.out_dir or args.data_dir.rstrip("/") + "_standard"
        colmap.colmap_to_standard(args.data_dir, out_dir, holdout=args.holdout)
        print(f"wrote nerfpp standard layout to {out_dir}")
    else:
        data = colmap.export_cams_meta(args.data_dir, out_mode=args.out_mode)
        print(f"wrote {args.out_mode}.npy with shape {data.shape} to {args.data_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
