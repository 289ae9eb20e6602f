"""Block-NeRF training of one block:
``python -m unboundednerfpytorch_tpu_torch.tools.train_block_nerf --root_dir D
--block_index block_0``.

The port's counterpart of ``train_block_nerf_tpu.py``, with its options and
defaults: the block's rays (``models/block_nerf/dataset.py``) at
``--img_downscale``, ``--steps`` steps (0: ``--num_epochs`` passes over the
rays) of ``--batch_size`` rays, Adam at ``--lr`` decayed tenfold over 250k
steps, ``--n_samples`` coarse and ``--n_importance`` fine samples, depths
log-linear unless ``--use_disp false``; then the block's ``params.npz`` and
``meta.json`` in ``logs/<exp_name>/<block_index>/`` (``utils/checkpoint.py``),
where ``eval_block_nerf`` reads them. The model is created and the rays
drawn from seed 0, as the JAX entry point does.

It runs on the card and raises without one (``main(argv, device="cpu")``
from Python for the plain PyTorch path, on a gloo group where there is
one). Under ``torchrun --nproc_per_node N`` it trains data-parallel over
the N ranks (``models/block_nerf/training.py``): ``--data_parallel`` 0 (the
default) means every rank, and another value must be the number of ranks.
Rank 0 writes the block. A plain launch on a node with several visible
GPUs says which ``torchrun`` command would use them.
"""

from __future__ import annotations

import argparse
import os

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Block-NeRF per-block training")
    p.add_argument("--root_dir", required=True, help="preprocessed waymo root")
    p.add_argument("--block_index", default="block_0")
    p.add_argument("--exp_name", default="block_nerf")
    p.add_argument("--img_downscale", type=int, default=4)
    p.add_argument("--near", type=float, default=0.01)
    p.add_argument("--far", type=float, default=15.0)
    p.add_argument("--num_epochs", type=int, default=1)
    p.add_argument("--steps", type=int, default=0,
                   help="override total steps (0 = one epoch over rays)")
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--n_samples", type=int, default=64)
    p.add_argument("--n_importance", type=int, default=64)
    p.add_argument("--use_disp", type=lambda s: s.lower() not in ("0", "false"), default=True,
                   help="log-linear depth sampling (the reference's default)")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="ranks of the data mesh (0 = all ranks of the process group)")
    return p


def main(argv=None, device=None) -> int:
    args = build_parser().parse_args(argv)

    import sys

    import torch

    from unboundednerfpytorch_tpu_torch.device import resolve_device
    from unboundednerfpytorch_tpu_torch.models.block_nerf import dataset, training
    from unboundednerfpytorch_tpu_torch.models.block_nerf.model import BlockNeRF
    from unboundednerfpytorch_tpu_torch.parallel import mesh as mesh_mod
    from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt

    dev = resolve_device(device)
    mesh_mod.maybe_initialize_distributed(dev, log_fn=print)
    world = mesh_mod.world_size()
    if args.data_parallel not in (0, world):
        raise ValueError(f"--data_parallel {args.data_parallel} needs a process group of that "
                         f"many ranks (torchrun --nproc_per_node {args.data_parallel}); this "
                         f"run has {world}")
    if dev.type == "cuda":
        hint = mesh_mod.launch_hint(torch.cuda.device_count(),
                                    "unboundednerfpytorch_tpu_torch.tools.train_block_nerf",
                                    sys.argv[1:] if argv is None else argv)
        if hint:
            print(hint)
    mesh = mesh_mod.make_mesh() if world > 1 else None
    main_rank = mesh_mod.is_main()
    log = print if main_rank else (lambda *a, **k: None)
    store_np, n_images = dataset.load_block_ray_store(
        args.root_dir, block=args.block_index, img_downscale=args.img_downscale,
        near=args.near, far=args.far)
    store = {k: torch.as_tensor(v, device=dev) for k, v in store_np.items()}
    n_rays = store["rgbs"].shape[0]
    steps = args.steps or max(1, args.num_epochs * n_rays // args.batch_size)
    log(f"{args.block_index}: {n_images} images, {n_rays} rays, {steps} steps")
    model = BlockNeRF(n_appearance=max(int(store_np["ts"].max()) + 1, 1),
                      generator=torch.Generator().manual_seed(0), device=dev)
    metrics = training.train_block(
        model, store, steps, batch_size=args.batch_size,
        generator=torch.Generator(device=dev).manual_seed(0), lr=args.lr,
        use_disp=args.use_disp, n_samples=args.n_samples, n_importance=args.n_importance,
        mesh=mesh, log_fn=log)
    out = os.path.join("logs", args.exp_name, args.block_index)
    if main_rank:
        ckpt.save_block_nerf(out, model, {"block": args.block_index, "steps": steps,
                                          "psnr": metrics["psnr"]})
        print(f"saved {out} (psnr {metrics['psnr']:.2f})")
    mesh_mod.barrier()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
