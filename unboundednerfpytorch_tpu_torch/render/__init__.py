"""Rendering and evaluation: ``run_render`` and the video writer.

Counterpart of ``unboundednerfpytorch_tpu/render/__init__.py`` for the
FourierGrid family.
"""

from __future__ import annotations

import os

import numpy as np

from unboundednerfpytorch_tpu_torch.render.renderer import (
    DEFAULT_CHUNK, depth_to_vis, render_image, render_viewpoints,
)


def write_video(path: str, frames, fps: int = 30) -> str:
    """mp4 via imageio-ffmpeg, falling back to a directory of PNG frames when
    no video backend is available (a long render must never die at the final
    write). Returns the path actually written."""
    import imageio.v2 as imageio

    frames = np.asarray(frames)
    try:
        imageio.mimwrite(path, frames, fps=fps, quality=8)
        return path
    except Exception as e:  # noqa: BLE001: a missing ffmpeg/pyav backend
        if os.path.exists(path):
            os.remove(path)  # a mid-write failure leaves a corrupt container
        outdir = os.path.splitext(path)[0] + "_frames"
        os.makedirs(outdir, exist_ok=True)
        for i, f in enumerate(frames):
            imageio.imwrite(os.path.join(outdir, f"{i:04d}.png"), f)
        print(f"video backend unavailable ({type(e).__name__}); wrote "
              f"{len(frames)} frames to {outdir} instead of {path}")
        return outdir


# options of the JAX package's run_render that wait for a later slice of the
# port, each with the ROADMAP item it waits for
_NOT_PORTED = {
    "auto_budget": "suggest_budgets and the hierarchical probe (ROADMAP A16)",
    "constant_baked": "no counterpart: tables as compile-time constants are an XLA "
                      "device (ROADMAP A18 records the decision)",
    "style_root": "ARF stylization (ROADMAP A18)",
}


def run_render(args, cfg, data_dict, exp_dir: str, device=None, log_fn=print) -> dict:
    """Post-train render program: load ``fine_last`` (or ``args.ft_path``),
    build the render cache, render the train/test/video splits, dump pngs and
    videos, print PSNR. Returns ``{split: render_viewpoints' dict}``.

    ``args`` is any object with the program's options as attributes
    (``render_train``, ``render_test``, ``render_video``, ``dump_images``,
    ``bake_render``, ``bake_scale``, ``eval_lpips``, ``eval_lpips_vgg``,
    ``render_video_factor``, ``render_video_flipy``, ``render_video_rot90``,
    ``ft_path``, ``chunk``); absent ones take the defaults.

    ``device``: ``None`` -> ``cuda`` (raises without a GPU); ``"cpu"`` for the
    plain path.
    """
    from unboundednerfpytorch_tpu_torch.device import resolve_device
    from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
    from unboundednerfpytorch_tpu_torch.train.loop import make_forward
    from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt
    from unboundednerfpytorch_tpu_torch.utils import metrics as M

    dev = resolve_device(device)
    for name, why in _NOT_PORTED.items():
        if getattr(args, name, None):
            raise NotImplementedError(f"--{name} is not ported: {why}")

    path = os.path.join(exp_dir, "fine_last")
    if getattr(args, "ft_path", ""):
        path = args.ft_path  # explicit checkpoint, e.g. a baked export
    elif os.path.exists(os.path.join(exp_dir, "fine_last_merged", "meta.json")) or (
            not os.path.exists(os.path.join(path, "meta.json"))
            and os.path.exists(os.path.join(exp_dir, "fine_last_0", "meta.json"))):
        raise NotImplementedError(
            "block checkpoints (run_render_blocks, merge_blocks) are not ported "
            "(ROADMAP A14)")
    family, mcfg, params, _, _ = ckpt.load_model(path, device=dev)
    params.requires_grad_(False)
    render_kwargs = {
        "near": float(data_dict["near"]),
        "far": float(data_dict["far"]),
        "bg": 1.0 if cfg.data.white_bkgd else 0.0,
        "stepsize": cfg.fine_model_and_render.stepsize,
    }
    if getattr(args, "bake_render", False) and mcfg.fourier_freq_num > 0:
        # single-bank bake: ~(2K+1)x fewer gather rows, approximate
        params, mcfg = fg.bake_for_rendering(params, mcfg,
                                             scale=getattr(args, "bake_scale", 1.26))
        log_fn(f"baked render grids: {mcfg.world_size_density} single-bank")
    cache = fg.build_render_cache(params, mcfg, log_fn=log_fn)
    if cache is None:
        log_fn("render cache: none (packed tables off or over the memory guard); "
               "rendering from the grids")
    fwd_core = make_forward(mcfg, render_kwargs)
    fwd = lambda aux, ro, rd, vd: fwd_core(aux[0], ro, rd, vd, None, cache=aux[1])
    aux = (params, cache)

    splits = []
    if getattr(args, "render_train", False):
        splits.append(("train", data_dict["i_train"], None))
    if getattr(args, "render_test", True) or not splits:
        splits.append(("test", data_dict["i_test"], None))
    if getattr(args, "render_video", False) and data_dict.get("render_poses") is not None:
        splits.append(("video", None, np.asarray(data_dict["render_poses"])))

    results = {}
    for name, idx, poses_override in splits:
        if poses_override is not None:
            poses = poses_override
            HW = np.repeat(np.asarray(data_dict["HW"])[:1], len(poses), axis=0)
            Ks = np.repeat(np.asarray(data_dict["Ks"])[:1], len(poses), axis=0)
            gt = None
        else:
            idx = np.asarray(idx)
            if idx.size == 0:
                continue
            poses = np.asarray(data_dict["poses"])[idx]
            HW = np.asarray(data_dict["HW"])[idx]
            Ks = np.asarray(data_dict["Ks"])[idx]
            gt = (np.asarray(data_dict["images"])[idx]
                  if data_dict.get("images") is not None else None)
        is_video = name == "video"
        out = render_viewpoints(
            fwd, poses=poses, HW=HW, Ks=Ks, gt_imgs=gt,
            ndc=cfg.data.ndc, inverse_y=cfg.data.inverse_y,
            flip_x=cfg.data.flip_x, flip_y=cfg.data.flip_y,
            chunk=getattr(args, "chunk", DEFAULT_CHUNK),
            eval_lpips=(getattr(args, "eval_lpips", False)
                        or getattr(args, "eval_lpips_vgg", False)),
            lpips_nets=tuple(net for net, on in (
                ("alex", getattr(args, "eval_lpips", False)),
                ("vgg", getattr(args, "eval_lpips_vgg", False))) if on) or ("alex",),
            aux=aux, log_fn=log_fn, device=dev,
            render_factor=getattr(args, "render_video_factor", 0) if is_video else 0,
            render_video_flipy=getattr(args, "render_video_flipy", False) if is_video else False,
            render_video_rot90=getattr(args, "render_video_rot90", 0) if is_video else 0,
        )
        results[name] = out
        rgbs = out["rgbs"]
        if getattr(args, "dump_images", False):
            import imageio.v2 as imageio

            outdir = os.path.join(exp_dir, f"render_{name}")
            os.makedirs(outdir, exist_ok=True)
            for i, rgb in enumerate(rgbs):
                imageio.imwrite(os.path.join(outdir, f"{i:03d}.png"), M.to8b(rgb))
                imageio.imwrite(os.path.join(outdir, f"{i:03d}_depth.png"),
                                depth_to_vis(out["depths"][i]))
        if is_video and len(rgbs):
            write_video(os.path.join(exp_dir, "render_video.mp4"), M.to8b(rgbs))
            write_video(os.path.join(exp_dir, "render_video_depth.mp4"),
                        np.stack([depth_to_vis(d) for d in out["depths"]]))
        if out["psnrs"]:
            log_fn(f"{name}: psnr {np.mean(out['psnrs']):.2f}")
    return results


def run_render_blocks(args, cfg, data_dict, exp_dir: str) -> None:
    raise NotImplementedError("per-block rendering is not ported (ROADMAP A14)")


def export_coarse_geometry(cfg, exp_dir: str, out_path: str = "") -> None:
    raise NotImplementedError("the coarse-geometry export is not ported (ROADMAP A14: "
                              "it needs the coarse stage)")


__all__ = [
    "render_image",
    "render_viewpoints",
    "depth_to_vis",
    "write_video",
    "run_render",
]
