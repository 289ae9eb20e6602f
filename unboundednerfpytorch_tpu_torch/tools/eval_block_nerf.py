"""Block-NeRF composed inference:
``python -m unboundednerfpytorch_tpu_torch.tools.eval_block_nerf --root_dir D
--ckpt_dir logs/<exp_name>``.

The port's counterpart of ``eval_block_nerf_tpu.py``, with its options and
defaults: every block of ``<root_dir>/train/split_block_train.json`` that has
a checkpoint ``<ckpt_dir>/<block>/`` (written by ``train_block_nerf``, or by
the JAX package's ``train_block_nerf_tpu.py``: ``params.msgpack``), the
training views from ``--cam_begin`` to ``--cam_end`` (or all of them), each
composed from the blocks that hold it (``models/block_nerf/compose.py``,
rendered in chunks of ``--chunk`` rays with the renderer's defaults, as the
JAX entry point does: 64 + 64 samples, linear depths, appearance id 0) into
``<out_dir>/<view>.png``, and the frames into ``<out_dir>/compose.mp4`` at
10 fps (``render.write_video``). It runs on the card and raises without one
(``main(argv, device="cpu")`` from Python for the plain PyTorch path).
"""

from __future__ import annotations

import argparse
import json
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Block-NeRF composed inference")
    p.add_argument("--root_dir", required=True)
    p.add_argument("--ckpt_dir", required=True, help="dir with per-block params")
    p.add_argument("--out_dir", default="compose_out")
    p.add_argument("--img_downscale", type=int, default=4)
    p.add_argument("--near", type=float, default=0.01)
    p.add_argument("--far", type=float, default=15.0)
    p.add_argument("--cam_begin", default=None)
    p.add_argument("--cam_end", default=None)
    p.add_argument("--chunk", type=int, default=4096)
    return p


def main(argv=None, device=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np

    from unboundednerfpytorch_tpu_torch.data.png import write_png
    from unboundednerfpytorch_tpu_torch.device import resolve_device
    from unboundednerfpytorch_tpu_torch.models.block_nerf import compose, dataset
    from unboundednerfpytorch_tpu_torch.render import write_video
    from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt

    dev = resolve_device(device)
    with open(os.path.join(args.root_dir, "train", "split_block_train.json")) as f:
        block_split = json.load(f)
    with open(os.path.join(args.root_dir, "train", "train_all_meta.json")) as f:
        meta = json.load(f)
    models, centroids = {}, {}
    for block in block_split:
        path = os.path.join(args.ckpt_dir, block)
        if not ckpt.has_block_nerf(path):
            continue
        models[block], _ = ckpt.load_block_nerf(path, device=dev)
        models[block].requires_grad_(False)
        centroids[block] = block_split[block]["centroid"]
    assert models, f"no block checkpoints under {args.ckpt_dir}"

    names = list(meta)
    if args.cam_begin and args.cam_end:
        names = names[names.index(args.cam_begin):names.index(args.cam_end) + 1]
    os.makedirs(args.out_dir, exist_ok=True)
    frames = []
    for name in names:
        candidates = [b for b in compose.filter_blocks(name, block_split) if b in models]
        if not candidates:
            continue
        rays, _, ts, (H, W) = dataset.build_image_rays(meta[name], None, 0, args.img_downscale,
                                                       args.near, args.far)
        rgb, _ = compose.compose_view(models, candidates, centroids, rays, ts, H, W,
                                      chunk=args.chunk)
        if rgb is None:
            continue
        write_png(os.path.join(args.out_dir, f"{name}.png"), rgb["compose"])
        frames.append(rgb["compose"])
        print(f"{name}: composed from {list(rgb)[:-1]}")
    if frames:
        write_video(os.path.join(args.out_dir, "compose.mp4"), np.stack(frames), fps=10)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
