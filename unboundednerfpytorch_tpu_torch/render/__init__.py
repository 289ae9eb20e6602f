"""Rendering and evaluation: ``run_render`` and the video writer.

Counterpart of ``unboundednerfpytorch_tpu/render/__init__.py`` for the
FourierGrid, DVGO, DCVGO and DMPIGO families, with ``export_coarse_geometry``,
a reference ``.tar`` as ``ft_path`` (the scene config's render knobs laid
over it, ``utils.reference_import.overlay_render_knobs``), the
occupancy-adaptive budgets of ``--auto_budget`` (:func:`auto_budgets`) and the
ARF stylization of ``--style_root`` (``render/arf.py``), and the block
checkpoints of ``--num_per_block`` (``fine_last_merged``, else each block's
``fine_last_<b>`` through :func:`run_render_blocks`), and ``--constant_baked``.
That flag's counterpart in the JAX package, ``render/staged_const.py``, packs
the render cache's tables into XLA executables as compile-time constants
(faster gathers on a TPU than tables passed as arguments) and computes the
two-stage cached forward's values; without a two-stage cache the JAX flag
renders through the ordinary cached forward. The port's kernels read tables
passed as arguments, so the flag adds no layout here: the render goes
through the forward and cache it takes without the flag
(``models/fourier_grid.py::_forward_two_stage`` where FourierGrid's cache is
two-stage: ``sample_budget``, ``fast_color_thres`` and ``color_budget`` all
set). One value differs, as in the JAX package: the staged renderer
composites on the data's background (``white_bkgd``), where the ordinary
FourierGrid render composites on black (ROADMAP C), so the flag's
two-stage render does too. Inside a process group
every view renders cooperatively over all its ranks (the JAX render's
``mesh``, ``renderer.render_image(mesh=...)``) and rank 0 alone writes the
images and videos. One departure: a view whose index
lies past the end of ``images`` (the generated test trajectories of the
waymo and mega loaders) is rendered without ground truth and gets no
metrics, where the JAX package's ``images[i_test]`` raises an
``IndexError``; views that have an image keep their metrics.
"""

from __future__ import annotations

import os

import numpy as np

from unboundednerfpytorch_tpu_torch.data.png import write_png
from unboundednerfpytorch_tpu_torch.render.renderer import (
    DEFAULT_CHUNK, depth_to_vis, render_image, render_viewpoints,
)


def write_video(path: str, frames, fps: int = 30) -> str:
    """mp4 via imageio-ffmpeg, falling back to a directory of PNG frames when
    imageio or its video backend is missing (a long render must never die at
    the final write). Returns the path actually written."""
    frames = np.asarray(frames)
    try:
        import imageio.v2 as imageio

        imageio.mimwrite(path, frames, fps=fps, quality=8)
        return path
    except Exception as e:  # noqa: BLE001: no imageio, or no ffmpeg/pyav backend
        if os.path.exists(path):
            os.remove(path)  # a mid-write failure leaves a corrupt container
        outdir = os.path.splitext(path)[0] + "_frames"
        os.makedirs(outdir, exist_ok=True)
        for i, f in enumerate(frames):
            write_png(os.path.join(outdir, f"{i:04d}.png"), f)
        print(f"video backend unavailable ({type(e).__name__}); wrote "
              f"{len(frames)} frames to {outdir} instead of {path}")
        return outdir


# --auto_budget: the occupied share of the mask under which the hierarchical
# probe is switched on, the training views and the rays a view it probes
AUTO_BUDGET_OCCUPANCY = 0.45
AUTO_BUDGET_VIEWS, AUTO_BUDGET_RAYS = 4, 1024


def auto_budgets(params, mcfg, data_dict, flags: dict, device, log_fn=print):
    """The ``--auto_budget`` branch of the JAX ``run_render``: the budgets
    sized by ``fourier_grid.suggest_budgets`` from the scene's own occupancy
    on about ``AUTO_BUDGET_RAYS`` rays of each of the first
    ``AUTO_BUDGET_VIEWS`` training views, and the hierarchical probe switched
    on where the mask's occupied share is under ``AUTO_BUDGET_OCCUPANCY``.
    Returns (the config with the budgets, the record). Unlike the JAX
    branch, the probe rays take the data's ray flags (``flags``), and the
    full-march forward reads a single-stage render cache built first, as
    ``suggest_budgets`` asks (the JAX branch passes none); where that cache
    does not apply (over the memory guard), from the grids."""
    import dataclasses

    import torch

    from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
    from unboundednerfpytorch_tpu_torch.ops import rays as ray_ops

    rays = []
    for i in np.asarray(data_dict["i_train"]).reshape(-1)[:AUTO_BUDGET_VIEWS]:
        H, W = (int(v) for v in np.asarray(data_dict["HW"])[i])
        view = ray_ops.get_rays_of_a_view(
            H, W, torch.as_tensor(np.asarray(data_dict["Ks"][i]), device=device),
            torch.as_tensor(np.asarray(data_dict["poses"][i])[:3, :4], device=device), **flags)
        sl = slice(0, H * W, max(1, (H * W) // AUTO_BUDGET_RAYS))
        rays.append([x.reshape(-1, 3)[sl] for x in view])
    ro, rd, vd = (torch.cat(parts) for parts in zip(*rays))
    full = fg.build_render_cache(params, dataclasses.replace(
        mcfg, color_budget=0, density_bake_scale=0.0))
    rec = fg.suggest_budgets(params, mcfg, ro, rd, vd, chunk=1024, cache=full)
    del full
    occ = float(params.mask_cache.mask.float().mean())
    knobs = {"sample_budget": rec["sample_budget"],
             "color_budget": rec["color_budget"] if mcfg.color_budget > 0 else 0}
    hierarchical = occ < AUTO_BUDGET_OCCUPANCY
    if hierarchical:
        knobs.update(probe_coarse_stride=rec["probe_coarse_stride"],
                     probe_candidate_groups=rec["probe_candidate_groups"])
    rec.update(occupancy=occ, hierarchical=hierarchical)
    log_fn(f"auto budgets (occupancy {occ:.3f}): sample {rec['sample_budget']}, color "
           f"{knobs['color_budget']}, hierarchical probe {'on' if hierarchical else 'off'}")
    return dataclasses.replace(mcfg, **knobs), rec


def _ground_truth(images, idx):
    """The image of each view of ``idx``, None for a view past the end of
    ``images``; None for no view with an image."""
    if images is None or not (idx < len(images)).any():
        return None
    return [images[i] if i < len(images) else None for i in idx]


def run_render(args, cfg, data_dict, exp_dir: str, device=None, log_fn=print) -> dict:
    """Post-train render program: load ``fine_last`` (or ``args.ft_path``),
    build the render cache, render the train/test/video splits, dump pngs and
    videos, print PSNR. Returns ``{split: render_viewpoints' dict}``, or
    where only block checkpoints stand :func:`run_render_blocks`' dict.

    ``args`` is any object with the program's options as attributes
    (``render_train``, ``render_test``, ``render_video``, ``dump_images``,
    ``bake_render``, ``bake_scale``, ``eval_lpips``, ``eval_lpips_vgg``,
    ``render_video_factor``, ``render_video_flipy``, ``render_video_rot90``,
    ``ft_path``, ``chunk``, ``style_root``, ``style_id``); absent ones take the
    defaults.

    ``device``: ``None`` -> ``cuda`` (raises without a GPU); ``"cpu"`` for the
    plain path.
    """
    from unboundednerfpytorch_tpu_torch.device import resolve_device
    from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
    from unboundednerfpytorch_tpu_torch.train.loop import FAMILIES, make_forward
    from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt
    from unboundednerfpytorch_tpu_torch.utils import metrics as M

    dev = resolve_device(device)

    # as the JAX run_render: --ft_path, else the merged block checkpoint,
    # else fine_last; without fine_last but with block checkpoints, each
    # block renders its own slice of the training views
    path = os.path.join(exp_dir, "fine_last")
    merged = os.path.join(exp_dir, "fine_last_merged")
    if getattr(args, "ft_path", ""):
        path = args.ft_path  # explicit checkpoint, e.g. a baked export
    elif os.path.exists(os.path.join(merged, "meta.json")):
        path = merged
    elif not os.path.exists(os.path.join(path, "meta.json")) and os.path.exists(
            os.path.join(exp_dir, "fine_last_0", "meta.json")):
        return run_render_blocks(args, cfg, data_dict, exp_dir, device=dev, log_fn=log_fn)
    mesh, writer = _render_mesh(log_fn)
    if not writer:
        log_fn = lambda *a, **k: None  # noqa: E731: rank 0 alone logs
    family, mcfg, params, _, _ = ckpt.load_model(path, device=dev, with_opt_state=False)
    if str(path).endswith(".tar"):
        # reference checkpoints carry no render-time knobs: the scene
        # config's values (stepsize, t_boundary, budgets) win
        from unboundednerfpytorch_tpu_torch.utils.reference_import import overlay_render_knobs

        mcfg = overlay_render_knobs(mcfg, cfg.fine_model_and_render)
    params.requires_grad_(False)
    render_kwargs = {
        "near": float(data_dict["near"]),
        "far": float(data_dict["far"]),
        "bg": 1.0 if cfg.data.white_bkgd else 0.0,
        "stepsize": cfg.fine_model_and_render.stepsize,
    }
    if (getattr(args, "bake_render", False) and family == "FourierGrid"
            and mcfg.fourier_freq_num > 0):
        # single-bank bake: ~(2K+1)x fewer gather rows, approximate
        params, mcfg = fg.bake_for_rendering(params, mcfg,
                                             scale=getattr(args, "bake_scale", 1.26))
        log_fn(f"baked render grids: {mcfg.world_size_density} single-bank")
    if getattr(args, "auto_budget", False) and family == "FourierGrid" and mcfg.sample_budget > 0:
        mcfg, _ = auto_budgets(params, mcfg, data_dict, dict(
            ndc=cfg.data.ndc, inverse_y=cfg.data.inverse_y, flip_x=cfg.data.flip_x,
            flip_y=cfg.data.flip_y), dev, log_fn=log_fn)
    # each family's packed-table cache, as the JAX package picks it
    cache = FAMILIES[family].build_render_cache(params, mcfg, log_fn=log_fn)
    if getattr(args, "constant_baked", False):
        log_fn("--constant_baked: the tables are the CUDA kernels' arguments; the render goes "
               "through the cached forward, whose values the JAX staged renderer computes")
    if cache is None:
        log_fn("render cache: none (packed tables off or over the memory guard); "
               "rendering from the grids")
    fwd_core = make_forward(mcfg, render_kwargs)
    fwd = lambda aux, ro, rd, vd: fwd_core(aux[0], ro, rd, vd, None, cache=aux[1])
    if (getattr(args, "constant_baked", False) and family == "FourierGrid"
            and cache is not None and cache.density_tables is not None
            and mcfg.sample_budget > 0 and mcfg.fast_color_thres > 0):
        # the JAX staged renderer's case: its values on the data's background
        fwd = lambda aux, ro, rd, vd: fg.forward(aux[0], mcfg, ro, rd, vd, cache=aux[1],
                                                 stepsize=render_kwargs["stepsize"],
                                                 bg=render_kwargs["bg"])
    aux = (params, cache)

    # optional ARF stylization of the render set (run_render.py:119-122,170-172)
    stylizer = None
    if getattr(args, "style_root", ""):
        from unboundednerfpytorch_tpu_torch.render.arf import ARF

        H0, W0 = (int(v) for v in np.asarray(data_dict["HW"])[0])
        stylizer = ARF(args.style_root, getattr(args, "style_id", 0), H0, W0, device=dev)

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
            gt = _ground_truth(data_dict.get("images"), idx)
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
            aux=aux, log_fn=log_fn, device=dev, mesh=mesh,
            render_factor=getattr(args, "render_video_factor", 0) if is_video else 0,
            render_video_flipy=getattr(args, "render_video_flipy", False) if is_video else False,
            render_video_rot90=getattr(args, "render_video_rot90", 0) if is_video else 0,
        )
        rgbs = out["rgbs"]
        if stylizer is not None and len(rgbs):
            rgbs, color_tf = stylizer.match_colors_for_image_set(rgbs, exp_dir)
            out = {**out, "rgbs": rgbs, "color_tf": color_tf}
        results[name] = out
        if not writer:
            continue
        if getattr(args, "dump_images", False):
            outdir = os.path.join(exp_dir, f"render_{name}")
            os.makedirs(outdir, exist_ok=True)
            for i, rgb in enumerate(rgbs):
                write_png(os.path.join(outdir, f"{i:03d}.png"), M.to8b(rgb))
                write_png(os.path.join(outdir, f"{i:03d}_depth.png"),
                          depth_to_vis(out["depths"][i]))
        if is_video and len(rgbs):
            write_video(os.path.join(exp_dir, "render_video.mp4"), M.to8b(rgbs))
            write_video(os.path.join(exp_dir, "render_video_depth.mp4"),
                        np.stack([depth_to_vis(d) for d in out["depths"]]))
        if out["psnrs"]:
            log_fn(f"{name}: psnr {np.mean(out['psnrs']):.2f}")
    return results


def _render_mesh(log_fn):
    """(the data mesh of all ranks or None, whether this rank writes)."""
    from unboundednerfpytorch_tpu_torch.parallel import mesh as mesh_mod

    import torch.distributed as dist

    if not dist.is_initialized():
        return None, True
    mesh = mesh_mod.make_mesh()
    if mesh.rank == 0:
        log_fn(f"render: cooperative over {mesh.data} devices")
    return mesh, mesh.rank == 0


def block_checkpoints(exp_dir: str) -> list:
    """The ``fine_last_<b>`` directories of ``exp_dir`` in the order of their
    block numbers. The JAX ``run_render_blocks`` sorts their names as strings,
    which from eleven blocks on pairs ``fine_last_10`` with block 2's views;
    that is not reproduced (ROADMAP C)."""
    prefix = "fine_last_"
    names = [n for n in os.listdir(exp_dir)
             if n.startswith(prefix) and n[len(prefix):].isdigit()]
    return [os.path.join(exp_dir, n)
            for n in sorted(names, key=lambda n: int(n[len(prefix):]))]


def run_render_blocks(args, cfg, data_dict, exp_dir: str, device=None, log_fn=print) -> dict:
    """The JAX ``run_render_blocks``: each block's checkpoint (in
    :func:`block_checkpoints`' order) renders its slice of the training
    views, ``ceil(len(i_train) / blocks)`` a block, on the background of
    ``white_bkgd`` (a FourierGrid block through its render cache); the frames
    go to ``<exp_dir>/render_blocks.mp4`` at 15 fps. Returns {"paths": the
    checkpoints, "views": each block's view indices, "outs": each block's
    ``render_viewpoints`` dict}. ``device``: ``None`` -> ``cuda``."""
    from unboundednerfpytorch_tpu_torch.device import resolve_device
    from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
    from unboundednerfpytorch_tpu_torch.train.loop import make_forward
    from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt
    from unboundednerfpytorch_tpu_torch.utils import metrics as M

    dev = resolve_device(device)
    paths = block_checkpoints(exp_dir)
    i_train = np.asarray(data_dict["i_train"])
    per_block = int(np.ceil(len(i_train) / max(len(paths), 1)))
    render_kwargs = {
        "near": float(data_dict["near"]),
        "far": float(data_dict["far"]),
        "bg": 1.0 if cfg.data.white_bkgd else 0.0,
        "stepsize": cfg.fine_model_and_render.stepsize,
    }
    result = {"paths": [], "views": [], "outs": []}
    psnrs = []
    mesh, writer = _render_mesh(log_fn)
    if not writer:
        log_fn = lambda *a, **k: None  # noqa: E731: rank 0 alone logs
    for b, path in enumerate(paths):
        idx = i_train[b * per_block:(b + 1) * per_block]
        if idx.size == 0:
            continue
        family, mcfg, params, _, _ = ckpt.load_model(path, device=dev, with_opt_state=False)
        params.requires_grad_(False)
        cache = fg.build_render_cache(params, mcfg) if family == "FourierGrid" else None
        fwd_core = make_forward(mcfg, render_kwargs)
        out = render_viewpoints(
            lambda aux, ro, rd, vd: fwd_core(aux[0], ro, rd, vd, None, cache=aux[1]),
            poses=np.asarray(data_dict["poses"])[idx], HW=np.asarray(data_dict["HW"])[idx],
            Ks=np.asarray(data_dict["Ks"])[idx],
            gt_imgs=_ground_truth(data_dict.get("images"), idx),
            ndc=cfg.data.ndc, inverse_y=cfg.data.inverse_y, flip_x=cfg.data.flip_x,
            flip_y=cfg.data.flip_y, chunk=getattr(args, "chunk", DEFAULT_CHUNK),
            verbose=False, aux=(params, cache), log_fn=log_fn, device=dev, mesh=mesh)
        del params, cache
        result["paths"].append(path)
        result["views"].append(idx)
        result["outs"].append(out)
        psnrs.extend(out["psnrs"])
        log_fn(f"block {b}: rendered {len(idx)} views")
    if result["outs"] and writer:
        video = np.concatenate([out["rgbs"] for out in result["outs"]])
        write_video(os.path.join(exp_dir, "render_blocks.mp4"), M.to8b(video), fps=15)
        if psnrs:
            log_fn(f"blocks: psnr {np.mean(psnrs):.2f}")
    return result


def export_coarse_geometry(cfg, exp_dir: str, out_path: str = "", device=None,
                           log_fn=print) -> str:
    """The coarse volume of ``<exp_dir>/coarse_last`` (else ``fine_last``)
    into ``out_path`` (default ``<exp_dir>/coarse_volume.npz``): ``alpha``
    [X, Y, Z] (the family's activation of the density at the lattice's
    nodes) and ``rgb`` [X, Y, Z, 3] (the sigmoid of k0's first three
    channels), both f32, a multi-bank grid's banks averaged. Returns the
    path written. ``device``: ``None`` -> ``cuda``."""
    import torch

    from unboundednerfpytorch_tpu_torch.device import resolve_device
    from unboundednerfpytorch_tpu_torch.train.loop import FAMILIES
    from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt

    dev = resolve_device(device)
    path = os.path.join(exp_dir, "coarse_last")
    if not os.path.exists(path):
        path = os.path.join(exp_dir, "fine_last")
    family, mcfg, params, _, _ = ckpt.load_model(path, device=dev, with_opt_state=False)
    with torch.no_grad():
        dense = params.density.get_dense_grid().float()
        if dense.ndim == 5:  # a FourierGrid's banks, averaged
            dense = dense.mean(0)
        alpha = FAMILIES[family].activate_density(params, mcfg, dense[..., 0])
        rgb = torch.sigmoid(params.k0.get_dense_grid().float())
        if rgb.ndim == 5:
            rgb = rgb.mean(0)
    out = out_path or os.path.join(exp_dir, "coarse_volume.npz")
    np.savez_compressed(out, alpha=alpha.cpu().numpy(), rgb=rgb[..., :3].cpu().numpy())
    log_fn(f"exported coarse geometry to {out}")
    return out


__all__ = [
    "render_image",
    "render_viewpoints",
    "depth_to_vis",
    "write_video",
    "run_render",
    "run_render_blocks",
    "block_checkpoints",
    "auto_budgets",
    "export_coarse_geometry",
]
