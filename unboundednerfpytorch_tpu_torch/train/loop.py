"""Training orchestration: the FourierGrid fine stage.

Counterpart of ``unboundednerfpytorch_tpu/train/loop.py``: ``build_model``,
``gather_training_rays``, ``make_forward``, the stage loop with the
step-keyed ``fast_color_thres`` schedule, and ``run_train`` with the coarse
stage at ``N_iters=0`` (the ``*_single`` configs).

With ``exp_dir`` the stage ends by writing ``<exp_dir>/fine_last`` through
the port's ``utils.checkpoint.save_model``, which ``render.run_render``
loads.

Not ported yet, and refused rather than skipped: ``pg_scale`` boundaries
(grid upsampling and the occupancy refresh), a coarse stage, samplers other
than ``flatten``, per-voxel lr, ``maskout_near_cam_vox``, resuming from a
checkpoint and periodic saves (the optimizer state is not saved), and the
other model families.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from unboundednerfpytorch_tpu_torch.configs.schema import (
    ExpConfig, ModelRenderConfig, TrainStageConfig, normalize_fast_color_thres,
)
from unboundednerfpytorch_tpu_torch.device import resolve_device
from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
from unboundednerfpytorch_tpu_torch.ops import rays as ray_ops
from unboundednerfpytorch_tpu_torch.train import bbox as bbox_mod
from unboundednerfpytorch_tpu_torch.train.step import (
    FlattenSampler, create_train_state, make_train_step,
)


def model_family_name(cfg: ExpConfig) -> str:
    if cfg.data.dataset_type in ("waymo", "mega", "nerfpp") or cfg.model == "FourierGrid":
        return "FourierGrid"
    raise NotImplementedError("only the FourierGrid family is ported yet")


def build_model(cfg: ExpConfig, cfg_model: ModelRenderConfig, cfg_train: TrainStageConfig,
                xyz_min, xyz_max, generator: torch.Generator, device, n_train: int = -1):
    """(family, model config, params). pg_scale shrinks the initial voxel
    count by 2^len(pg_scale)."""
    nvd = cfg_model.num_voxels_density
    nvr = cfg_model.num_voxels_rgb
    if cfg_train.pg_scale:
        nvd = int(nvd / (2 ** len(cfg_train.pg_scale)))
        nvr = int(nvr / (2 ** len(cfg_train.pg_scale)))
    model_family_name(cfg)
    mcfg = fg.config_from(cfg_model, xyz_min, xyz_max, nvd, nvr, sample_num=n_train)
    return "FourierGrid", mcfg, fg.create(mcfg, generator, device=device)


def gather_training_rays(cfg: ExpConfig, data_dict: dict, device) -> dict:
    """The flattened ray store on ``device``: rgb, rays_o, rays_d, viewdirs
    ([N*H*W, 3] each) and img_index."""
    i_train = np.asarray(data_dict["i_train"])
    HW = np.asarray(data_dict["HW"])
    H, W = int(HW[i_train[0]][0]), int(HW[i_train[0]][1])
    if not (HW[i_train] == (H, W)).all():
        raise ValueError("mixed per-view image sizes in one training stage are unsupported")
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
    rgb, rays_o, rays_d, viewdirs, img_index = ray_ops.get_training_rays_flatten(
        as_t(np.asarray(data_dict["images"])[i_train]),
        as_t(np.asarray(data_dict["poses"])[i_train][:, :3, :4]), H, W,
        as_t(np.asarray(data_dict["Ks"])[i_train]),
        ndc=cfg.data.ndc, inverse_y=cfg.data.inverse_y,
        flip_x=cfg.data.flip_x, flip_y=cfg.data.flip_y,
    )
    return {"rgb": rgb, "rays_o": rays_o, "rays_d": rays_d, "viewdirs": viewdirs,
            "img_index": img_index}


def make_forward(mcfg: fg.FourierGridConfig, render_kwargs: dict, cache=None) -> Callable:
    """(params, rays_o, rays_d, viewdirs, bg_color, cache=...) -> RenderResult.

    As the JAX package's FourierGrid branch: ``render_kwargs["stepsize"]``
    reaches the forward and ``render_kwargs["bg"]`` does NOT, so without a
    random background the forward composites on its default ``bg=0.0``
    (reproduced from the reference package, where it looks like an oversight;
    see ROADMAP queue C). ``cache`` is a ``RenderCache`` for rendering with
    frozen params; it may also be given per call."""

    def fwd(params, ro, rd, vd, bg_color=None, cache=cache):
        return fg.forward(params, mcfg, ro, rd, vd, stepsize=render_kwargs["stepsize"],
                          bg_color=bg_color, cache=cache)

    return fwd


def scene_rep_reconstruction(
    cfg: ExpConfig,
    cfg_model: ModelRenderConfig,
    cfg_train: TrainStageConfig,
    xyz_min,
    xyz_max,
    data_dict: dict,
    stage: str,
    device,
    seed: int = 777,
    log_every: int = 500,
    log_fn: Callable[[str], None] = print,
    callback: Callable[[int, dict], None] | None = None,
    coarse_mask_fn=None,
    exp_dir: str | None = None,
):
    """One training stage; returns (family, model config, params, psnr).
    With ``exp_dir`` the trained model is saved as ``<exp_dir>/<stage>_last``.

    ``coarse_mask_fn(world_size, xyz_min, xyz_max) -> bool [X, Y, Z]`` seeds
    the occupancy cache (in the full recipe, from the coarse stage); with it
    the cache is trusted and ``sample_budget`` is on from the first step.
    ``callback(step, metrics)`` runs after every step.
    """
    n_iters = cfg_train.N_iters
    if any(int(b) <= n_iters for b in cfg_train.pg_scale):
        raise NotImplementedError(
            "pg_scale boundaries (grid upsampling + occupancy refresh) are not ported yet")
    if cfg_train.ray_sampler != "flatten":
        raise NotImplementedError(f"ray_sampler={cfg_train.ray_sampler!r} is not ported yet")
    if cfg_train.pervoxel_lr:
        raise NotImplementedError("pervoxel_lr is not ported yet")
    if cfg.data.load2gpu_on_the_fly:
        raise NotImplementedError("load2gpu_on_the_fly is not ported yet")
    if cfg_model.maskout_near_cam_vox:
        raise NotImplementedError("maskout_near_cam_vox is not ported yet")

    xyz_min = np.asarray(xyz_min, np.float64)
    xyz_max = np.asarray(xyz_max, np.float64)
    if abs(cfg_model.world_bound_scale - 1) > 1e-9:
        shift = (xyz_max - xyz_min) * (cfg_model.world_bound_scale - 1) / 2
        xyz_min = xyz_min - shift
        xyz_max = xyz_max + shift

    # CPU generator for the model init (device-independent values); a
    # device generator for the per-step draws (ray permutation, backgrounds)
    gen_init = torch.Generator().manual_seed(seed)
    gen_step = torch.Generator(device=device).manual_seed(seed + 1)

    family, mcfg, params = build_model(
        cfg, cfg_model, cfg_train, xyz_min, xyz_max, gen_init, device,
        n_train=len(np.asarray(data_dict["i_train"])))
    if coarse_mask_fn is not None:
        ws = params.mask_cache.mask.shape
        params.mask_cache.mask = torch.as_tensor(
            coarse_mask_fn(ws, mcfg.xyz_min, mcfg.xyz_max), dtype=torch.bool, device=device)

    render_kwargs = {
        "bg": 1.0 if cfg.data.white_bkgd else 0.0,
        "rand_bkgd": cfg.data.rand_bkgd,
        "stepsize": cfg_model.stepsize,
    }
    store = gather_training_rays(cfg, data_dict, device)
    state = create_train_state(params, cfg_train)

    near_thres = 0.0
    if cfg_train.weight_nearclip > 0 and data_dict.get("near_clip"):
        near_thres = float(data_dict["near_clip"]) / float(mcfg.scene_radius[0])

    lr_decay_enabled = not (cfg.model == "FourierGrid" and cfg.data.dataset_type == "tankstemple")
    sampler = FlattenSampler(store["rgb"].shape[0], cfg_train.N_rand, gen_step, device)

    # the occupancy cache is all-true at init, where a sample budget would cut
    # every ray to its first `budget` samples: hold the budget off until the
    # cache holds geometry (a coarse seed; the pg_scale refresh is not ported)
    deferred_budget = 0
    if mcfg.sample_budget > 0 and coarse_mask_fn is None:
        deferred_budget = mcfg.sample_budget
        mcfg = dataclasses.replace(mcfg, sample_budget=0)

    def compile_step(mcfg_now):
        return make_train_step(
            make_forward(mcfg_now, render_kwargs), cfg_train,
            world_size_max=float(max(mcfg_now.world_size)), near_thres=near_thres,
            lr_anchor=1, lr_decay_enabled=lr_decay_enabled)

    step_fn = compile_step(mcfg)
    thres_schedule = dict(normalize_fast_color_thres(cfg_model)[1])
    last_psnr = 0.0
    t0 = time.time()
    for global_step in range(1, n_iters + 1):
        if global_step in thres_schedule:
            new_thres = float(thres_schedule[global_step])
            if new_thres != mcfg.fast_color_thres:
                mcfg = dataclasses.replace(mcfg, fast_color_thres=new_thres)
                step_fn = compile_step(mcfg)
        with record_function("train_loop/batch"):
            idx = sampler.next_indices()
            batch = {k: v[idx] for k, v in store.items()}
            bg_color = None
            if render_kwargs["rand_bkgd"]:
                bg_color = torch.rand((idx.shape[0], 3), generator=gen_step, device=device)
        metrics = step_fn(state, batch, bg_color)
        if global_step % log_every == 0 or global_step == n_iters:
            last_psnr = float(metrics["psnr"])
            log_fn(f"{stage} iter {global_step:6d} / loss {float(metrics['loss']):.6f} / "
                   f"psnr {last_psnr:5.2f} / {time.time() - t0:6.1f}s")
        if callback is not None:
            callback(global_step, metrics)
    if deferred_budget:  # never hand on (or persist) a deferral-zeroed budget
        mcfg = dataclasses.replace(mcfg, sample_budget=deferred_budget)
    if exp_dir is not None:
        from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt_mod

        ckpt_mod.save_model(os.path.join(exp_dir, f"{stage}_last"), family, mcfg,
                            state.params, global_step=n_iters)
    return family, mcfg, state.params, last_psnr


def run_train(cfg: ExpConfig, data_dict: dict, seed: int = 777, log_fn=print,
              device=None, log_every: int = 500, callback=None, coarse_mask_fn=None,
              exp_dir: str | None = None):
    """The fine stage of a ``*_single`` recipe (coarse ``N_iters=0``).
    Returns (family, model config, params, last logged psnr).

    ``device``: ``None`` -> ``cuda`` (raises without a GPU); pass ``"cpu"``
    for the plain PyTorch path. ``coarse_mask_fn``: optional occupancy seed,
    standing in for the coarse stage's (see scene_rep_reconstruction).
    ``exp_dir``: where ``fine_last`` is written at the end (not at all if None).
    """
    dev = resolve_device(device)
    if cfg.coarse_train.N_iters > 0:
        raise NotImplementedError("a coarse stage (coarse_train.N_iters > 0) is not ported yet")
    xyz_min, xyz_max = bbox_mod.compute_bbox_by_cam_frustrm(
        cfg, data_dict, model_family_name(cfg), device=dev)
    return scene_rep_reconstruction(
        cfg, cfg.fine_model_and_render, cfg.fine_train, xyz_min, xyz_max, data_dict,
        stage="fine", device=dev, seed=seed, log_every=log_every, log_fn=log_fn,
        callback=callback, coarse_mask_fn=coarse_mask_fn, exp_dir=exp_dir)
