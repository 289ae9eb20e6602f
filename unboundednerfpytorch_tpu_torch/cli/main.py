"""The command line: ``python -m unboundednerfpytorch_tpu_torch.cli.main``.

The port's counterpart of ``unboundednerfpytorch_tpu/cli/main.py``, the
``run_FourierGrid.py``: the same options (:func:`build_parser` takes
every flag of the JAX command line), config load, data load, ``args.txt`` in the
experiment directory, and program dispatch. Ported programs: ``train`` (then
``render``, as the JAX command line does), ``render`` (or ``--render_only``),
``export_bbox``, ``export_coarse``, ``export_baked``, ``gen_trace``,
``tune_pose`` (camera-pose refinement against the trained model,
``train/pose_tune.py``), ``linemod_eval`` (the LINEMOD pose metrics of
``--pose_preds`` against a sequence's object poses, or of the ground truth
against itself, which scores 1.0) and ``sfm`` (COLMAP on
``<datadir>/images``, skipped where ``sparse/0`` is whole, then
``poses_bounds.npy``; it runs before the data load, which needs it, and on
no device). ``--ft_path`` may name a reference ``.tar`` checkpoint in
``train``, ``render`` and ``tune_pose`` (``utils/reference_import.py``).
``--num_per_block`` > 0 cuts the training views into
``max(1, len(i_train) // num_per_block)`` blocks; with more than one,
``train`` trains them (``train.loop.run_train_blocks``: ``fine_last_<b>``
and ``fine_last_merged``) and returns without a render, as the JAX command
line does; ``--running_block_id`` is accepted and unused, as there.

Several GPUs: launched by ``torchrun --nproc_per_node N -m
unboundednerfpytorch_tpu_torch.cli.main ...`` the command line joins the
process group (``parallel.mesh.maybe_initialize_distributed``, as the JAX
one calls its rendezvous) and trains data-parallel over the N ranks, with
``--grid_parallel G`` on a (N / G, G) layout whose grids are cut over G
ranks (the halo-exchange sample), and renders cooperatively; with
``--num_per_block`` and ``--block_parallel`` the blocks train concurrently,
one rank each (``train/block_parallel.py``). Rank 0 alone writes files.
``device="cpu"`` joins a gloo group instead of NCCL. A plain launch on a
node with several visible GPUs says which ``torchrun`` command would use
them.
``--sample_num`` and ``--diffuse`` reach the waymo and mega loaders, as in
the JAX command line.

Like every entry point of the port it runs on the GPU and raises without
one; :func:`main` takes ``device="cpu"`` from Python for the plain PyTorch
path. Two departures from the JAX command line, both faults there: after
``train`` the checkpoint the loop saved (step and optimizer state included)
stands, where the JAX command line saves it again without either; and the render
after ``train`` renders what was trained, never ``--ft_path``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="unboundednerfpytorch_tpu_torch command line (PyTorch / CUDA)")
    p.add_argument("--config", required=True, help="scene config file path")
    p.add_argument(
        "--program",
        default="train",
        choices=[
            "export_bbox",
            "export_coarse",
            "render",
            "train",
            "gen_trace",
            "linemod_eval",
            "sfm",
            "tune_pose",
            "export_baked",
        ],
    )
    p.add_argument("--pose_preds", default="",
                   help="linemod_eval: path to [N,3,4] predicted poses (.npy)")
    p.add_argument("--tune_steps", type=int, default=400,
                   help="tune_pose: optimization steps")
    p.add_argument("--tune_lr", type=float, default=1e-3,
                   help="tune_pose: Adam lr on the se(3) deltas")
    p.add_argument("--seed", type=int, default=777)
    p.add_argument("--sample_num", type=int, default=-1,
                   help="truncate dataset for fast debugging")
    p.add_argument("--num_per_block", type=int, default=-1,
                   help="images per block for block training (-1: no blocks)")
    p.add_argument("--running_block_id", type=int, default=-1)
    p.add_argument("--block_parallel", action="store_true",
                   help="train the blocks concurrently, one rank each "
                        "(train/block_parallel.py) instead of in turn")
    p.add_argument("--no_reload", action="store_true")
    p.add_argument("--no_reload_optimizer", action="store_true",
                   help="on resume, rebuild fresh Adam moments instead of "
                        "restoring them (run_FourierGrid.py:36-37)")
    p.add_argument("--ft_path", default="")
    p.add_argument("--export_cam", action="store_true")
    p.add_argument("--export_geometry", action="store_true")
    p.add_argument("--export_bbox_and_cams_only", default="",
                   help="output path for --program export_bbox "
                        "(run_export_bbox.py:14)")
    p.add_argument("--export_coarse_only", default="",
                   help="output path for --program export_coarse "
                        "(run_export_coarse.py:19)")
    p.add_argument("--save_train_imgs", action="store_true",
                   help="dump the training images into the exp folder")
    p.add_argument("--diffuse", action="store_true",
                   help="swap training images for diffusion-generated "
                        "replacements per the config's `diffusion` dict "
                        "(waymo)")
    p.add_argument("--render_only", action="store_true",
                   help="do not optimize; reload weights and render "
                        "(run_FourierGrid.py:45) — alias for --program render")
    p.add_argument("--render_train", action="store_true")
    p.add_argument("--render_test", action="store_true")
    p.add_argument("--render_video", action="store_true")
    p.add_argument("--render_video_flipy", action="store_true")
    p.add_argument("--render_video_rot90", type=int, default=0)
    p.add_argument("--render_video_factor", type=float, default=0,
                   help="downsampling factor for fast render previews "
                        "(4 or 8); GT metrics are skipped")
    p.add_argument("--eval_ssim", action="store_true", default=True)
    p.add_argument("--eval_lpips", "--eval_lpips_alex", dest="eval_lpips",
                   action="store_true",
                   help="LPIPS (AlexNet) eval; reference --eval_lpips_alex")
    p.add_argument("--eval_lpips_vgg", action="store_true",
                   help="LPIPS (VGG) eval")
    p.add_argument("--i_print", type=int, default=500)
    p.add_argument("--i_weights", type=int, default=0,
                   help="periodic checkpoint cadence in steps (0 = stage end only)")
    p.add_argument("--dump_images", action="store_true")
    p.add_argument("--style_root", default="",
                   help="ARF style image dir (stylized rendering)")
    p.add_argument("--style_id", default="0")
    p.add_argument("--bake_render", action="store_true",
                   help="bake the Fourier banks into a single-bank grid "
                        "before rendering (APPROXIMATE, ~7x fewer gather "
                        "rows; fourier_grid.bake_for_rendering)")
    p.add_argument("--bake_scale", type=float, default=1.26,
                   help="linear resolution multiplier for --bake_render")
    p.add_argument("--auto_budget", action="store_true",
                   help="size the render sample/color budgets from this "
                        "scene's measured per-ray occupancy statistics and "
                        "enable the hierarchical occupancy probe when the "
                        "mask is sparse (fourier_grid.suggest_budgets) — "
                        "big speedups on converged/sparse scenes, exactness "
                        "tracked by the budgets' far-tail-truncation "
                        "contract (refused: not ported)")
    p.add_argument("--grid_parallel", type=int, default=1,
                   help="shard voxel grids (+ Adam moments) spatially over "
                        "this many ranks of the process group (torchrun)")
    p.add_argument("--visualize_poses", action="store_true",
                   help="debug pose-visualization mode (reference "
                        "waymo_base.py:11-27): 600-iter coarse run, flat "
                        "fast_color_thres, no distortion loss — pair with "
                        "--program export_bbox / export_coarse to eyeball "
                        "cameras and coarse geometry")
    p.add_argument("--constant_baked", action="store_true",
                   help="the JAX command line's render tables as compile-time "
                        "constants; here the kernels take them as arguments, and "
                        "a two-stage FourierGrid render composites on the data's "
                        "background, as the JAX staged renderer does")
    return p


def main(argv=None, device=None) -> int:
    """Run one program. ``device``: None -> ``cuda`` (raises without a GPU),
    ``"cpu"`` for the plain PyTorch path."""
    import sys

    import torch

    from unboundednerfpytorch_tpu_torch.parallel import mesh as mesh_mod

    args = build_parser().parse_args(argv)
    if args.render_only:
        args.program = "render"

    from unboundednerfpytorch_tpu_torch.configs.loader import load_config
    from unboundednerfpytorch_tpu_torch.data.common import load_everything
    from unboundednerfpytorch_tpu_torch.device import resolve_device

    cfg = load_config(args.config, visualize_poses=args.visualize_poses)
    np.random.seed(args.seed)
    if args.program == "sfm":
        # custom-scene reconstruction (imgs2poses.py): COLMAP on the capture's
        # images/, then poses_bounds.npy, which load_everything needs
        from unboundednerfpytorch_tpu_torch.data import colmap

        colmap.gen_poses(cfg.data.datadir)
        print(f"sfm: wrote {os.path.join(cfg.data.datadir, 'poses_bounds.npy')}")
        return 0
    dev = resolve_device(device)
    mesh_mod.maybe_initialize_distributed(dev, log_fn=print)
    if dev.type == "cuda":
        hint = mesh_mod.launch_hint(torch.cuda.device_count(), "unboundednerfpytorch_tpu_torch"
                                    ".cli.main", sys.argv[1:] if argv is None else argv)
        if hint:
            print(hint)
    main_rank = mesh_mod.is_main()
    data_dict = load_everything(cfg, sample_num=args.sample_num, diffuse=args.diffuse)

    # the block count of --num_per_block (run_FourierGrid.py:101-103)
    block_num = 1
    if args.num_per_block > 0:
        block_num = max(1, len(data_dict["i_train"]) // args.num_per_block)

    exp_dir = os.path.join(cfg.basedir, cfg.expname)
    os.makedirs(exp_dir, exist_ok=True)
    if main_rank:
        with open(os.path.join(exp_dir, "args.txt"), "w") as f:
            for k in sorted(vars(args)):
                f.write(f"{k} = {getattr(args, k)}\n")

    if args.save_train_imgs and data_dict.get("images") is not None and main_rank:
        # the training images as loaded: resized, or swapped by --diffuse
        from unboundednerfpytorch_tpu_torch.data.png import write_png

        outdir = os.path.join(exp_dir, "train_imgs")
        os.makedirs(outdir, exist_ok=True)
        images = data_dict["images"]
        for i in np.asarray(data_dict["i_train"]):
            write_png(os.path.join(outdir, f"{int(i):04d}.png"),
                      (np.clip(np.asarray(images[int(i)]), 0, 1) * 255).astype(np.uint8))
        print(f"saved {len(data_dict['i_train'])} training images to {outdir}")

    if args.program == "train":
        from unboundednerfpytorch_tpu_torch.train import loop

        if block_num > 1:
            if args.block_parallel:
                from unboundednerfpytorch_tpu_torch.train import block_parallel

                block_parallel.run_train_blocks_parallel(
                    cfg, data_dict, block_num, exp_dir, seed=args.seed,
                    no_reload=args.no_reload, save_every=args.i_weights, device=dev,
                    log_every=args.i_print)
            else:
                loop.run_train_blocks(cfg, data_dict, block_num, exp_dir, seed=args.seed,
                                      no_reload=args.no_reload, save_every=args.i_weights,
                                      device=dev, log_every=args.i_print)
            print(f"block training finished ({block_num} blocks)")
            return 0
        _, _, _, psnr = loop.run_train(
            cfg, data_dict, seed=args.seed, device=dev, log_every=args.i_print,
            exp_dir=exp_dir, no_reload=args.no_reload,
            no_reload_optimizer=args.no_reload_optimizer, save_every=args.i_weights,
            ft_path=args.ft_path, grid_parallel=args.grid_parallel)
        if main_rank:
            print(f"train finished: psnr {psnr:.2f}")
        args.program, args.ft_path = "render", ""  # render <exp_dir>/fine_last

    if args.program == "render":
        from unboundednerfpytorch_tpu_torch.render import run_render

        run_render(args, cfg, data_dict, exp_dir, device=dev)
        return 0
    if args.program == "export_bbox":
        from unboundednerfpytorch_tpu_torch.train import bbox as bbox_mod
        from unboundednerfpytorch_tpu_torch.train.loop import model_family_name

        xyz_min, xyz_max = bbox_mod.compute_bbox_by_cam_frustrm(
            cfg, data_dict, model_family_name(cfg), device=dev)
        out = args.export_bbox_and_cams_only or os.path.join(exp_dir, "cam.npz")
        if main_rank:
            np.savez_compressed(out, xyz_min=np.asarray(xyz_min), xyz_max=np.asarray(xyz_max),
                                poses=np.asarray(data_dict["poses"]))
        print(f"exported bbox+cams to {out}")
        return 0
    if args.program == "export_coarse":
        from unboundednerfpytorch_tpu_torch.render import export_coarse_geometry

        export_coarse_geometry(cfg, exp_dir, out_path=args.export_coarse_only, device=dev)
        return 0
    if args.program == "tune_pose":
        from unboundednerfpytorch_tpu_torch.train.pose_tune import run_tune_pose

        run_tune_pose(args, cfg, data_dict, exp_dir, device=dev)
        return 0
    if args.program == "linemod_eval":
        from unboundednerfpytorch_tpu_torch.utils import pose_eval

        seq = cfg.data.seq_name
        model_pts = pose_eval.load_model_points(os.path.join(cfg.data.datadir, seq))
        gts = np.asarray(data_dict["object_poses"])[np.asarray(data_dict["i_test"])]
        # without --pose_preds, the sanity mode: the ground truth against
        # itself must score 1.0 everywhere
        preds = np.load(args.pose_preds) if args.pose_preds else gts
        summary = pose_eval.evaluate_linemod_sequence(seq, model_pts, preds, gts,
                                                      K=np.asarray(data_dict["Ks"])[0])
        out = os.path.join(exp_dir, "linemod_metrics.json")
        with open(out, "w") as f:
            json.dump(summary, f, indent=2)
        print(json.dumps({"sequence": seq, **summary}))
        return 0
    if args.program == "gen_trace":
        from unboundednerfpytorch_tpu_torch.render import cam_paths

        out_dir = os.path.join(exp_dir, "cam_paths")
        paths = cam_paths.gen_cam_paths(cfg, data_dict, out_dir, write_video=args.dump_images)
        out = os.path.join(exp_dir, "render_poses.json")
        with open(out, "w") as f:
            json.dump(np.asarray(data_dict["render_poses"]).tolist(), f)
        print(f"wrote camera paths to {out_dir} ({len(paths['combined'])} combined views) "
              f"and trace to {out}")
        return 0
    if args.program == "export_baked":
        # bake the 2K+1 Fourier banks into one grid, saved as a checkpoint to
        # render with --program render --ft_path <exp_dir>/baked_last
        from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
        from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt

        family, mcfg, params, step, _ = ckpt.load_model(
            os.path.join(exp_dir, "fine_last"), device=dev, with_opt_state=False)
        if family != "FourierGrid" or mcfg.fourier_freq_num <= 0:
            raise SystemExit("export_baked needs a trained FourierGrid model with Fourier banks")
        params.requires_grad_(False)
        pb, cb = fg.bake_for_rendering(params, mcfg, scale=args.bake_scale)
        out = os.path.join(exp_dir, "baked_last")
        ckpt.save_model(out, family, cb, pb, global_step=step)
        print(f"export_baked: wrote single-bank servable checkpoint to {out} (bake_scale "
              f"{args.bake_scale}); render it with --program render --ft_path {out}")
        return 0
    raise NotImplementedError(f"program {args.program} is not implemented")


if __name__ == "__main__":
    raise SystemExit(main())
