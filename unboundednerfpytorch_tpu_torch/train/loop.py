"""Training orchestration: the coarse and fine stages of the DVGO family and
the fine stage of the FourierGrid, DCVGO and DMPIGO families.

Counterpart of ``unboundednerfpytorch_tpu/train/loop.py``:
``model_family_name``, ``build_model``, ``gather_training_rays`` (on the
device, or in host memory for ``load2gpu_on_the_fly``), ``make_forward``,
``scale_model``, the stage loop with the step-keyed ``fast_color_thres``
schedule and the ``pg_scale`` boundaries (:func:`pg_scale_boundary`: both
grids upsampled, the occupancy cache refreshed from the trained density,
``act_shift`` lowered, a deferred ``sample_budget`` switched on, the
optimizer rebuilt and the lr decay re-anchored), the ``flatten``, ``random``
and ``in_maskcache`` ray samplers, and ``run_train``: for a config with
a coarse stage (DVGO: ``nerf/*``, ``nsvf/*``, ``deepvoxels/*``,
``blendedmvs/*``, ``co3d/*``, ``tankstemple/<Scene>.py``; DMPIGO:
``custom/*`` forward-facing), the coarse stage on the camera-frustum box with
``maskout_near_cam_vox`` and ``pervoxel_lr``, then the fine stage on the box
of the coarse geometry, its occupancy cache seeded from the coarse alpha and
its rays filtered to those that meet it (``in_maskcache``); else the fine
stage alone (the ``*_single``, ``nerf_unbounded/<scene>``,
``tankstemple_unbounded/<scene>``, ``llff/*``, ``free_dataset/*``,
``nerf_studio/*``, ``waymo/*`` and ``mega/*`` configs).

With ``exp_dir`` a stage ends by writing ``<exp_dir>/<stage>_last``
(``coarse_last``, ``fine_last``) through the port's
``utils.checkpoint.save_model``, with the optimizer's state; ``save_every``
saves it there every so many steps too, and a run started again with the
same ``exp_dir`` resumes each stage from its own checkpoint (``ft_path``
names another checkpoint, ``no_reload`` starts afresh). A stage whose
checkpoint stands at its last step trains nothing and builds no ray store.
``<exp_dir>/<stage>_metrics.jsonl`` gets a record of every scalar the step
emits at each logged step, and the record of each ``pg_scale`` boundary.
``render.run_render`` loads ``fine_last``. :func:`run_train_blocks` (the
command line's ``--num_per_block``) trains contiguous blocks of the training
views, each through :func:`run_train` in its own ``<exp_dir>/block_<b>``, and
merges them into ``fine_last_merged``.

With ``fine_train.i_panel`` (or ``coarse_train.i_panel``) the stage renders
the first held-out view that has an image through the current model every
``i_panel`` steps and at its last step, and writes the
``[GT | pred | err | depth]`` panel and its PSNR
(``utils/observability.py``) under ``<exp_dir>/panels/``. The panel renders
with the data's ray flags (``ndc``, ``inverse_y``, ``flip_x``, ``flip_y``),
which the JAX loop does not pass (ROADMAP C). A reference ``.tar`` as
``ft_path`` resumes with fresh moments and the config's render knobs
(``utils.reference_import.overlay_render_knobs``), as in the JAX package.

A ``train_survivor_budget`` (the two-stage training forward) is held at 0
until the last ``pg_scale`` boundary, where the grids reach their final
resolution, as in the JAX loop; the held-out panel renders without it, and
the saves store the configured value.

As in the JAX package, ``pervoxel_lr`` and the ``in_maskcache`` filter act
on the DVGO family only (elsewhere the first is ignored and the second
samples as ``flatten`` does), and ``maskout_near_cam_vox`` on the DVGO and
FourierGrid families only; a coarse stage runs for any family (the DMPIGO
configs of ``custom/`` have one).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable

import numpy as np
import torch

from unboundednerfpytorch_tpu_torch import convert
from unboundednerfpytorch_tpu_torch.configs.schema import (
    ExpConfig, ModelRenderConfig, TrainStageConfig, normalize_fast_color_thres,
)
from unboundednerfpytorch_tpu_torch.convert import FAMILIES
from unboundednerfpytorch_tpu_torch.device import resolve_device, seconds_since
from unboundednerfpytorch_tpu_torch.models import dcvgo, dmpigo, dvgo
from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
from unboundednerfpytorch_tpu_torch.ops import rays as ray_ops
from unboundednerfpytorch_tpu_torch.optim import factory as opt_factory
from unboundednerfpytorch_tpu_torch.optim.masked_adam import make_per_lr
from unboundednerfpytorch_tpu_torch.parallel import mesh as mesh_mod
from unboundednerfpytorch_tpu_torch.parallel.blocks import my_blocks
from unboundednerfpytorch_tpu_torch.train import bbox as bbox_mod
from unboundednerfpytorch_tpu_torch.train.step import (
    FlattenSampler, HostRayStoreSampler, RandomSampler, TrainState, create_train_state,
    make_train_step,
)
from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt
from unboundednerfpytorch_tpu_torch.utils.profiling import span

# rays a call of the in_maskcache filter takes at a time
FILTER_CHUNK = 65536


def model_family_name(cfg: ExpConfig) -> str:
    """The JAX package's dispatch: FourierGrid for the waymo, mega and nerfpp
    datasets and where the config names it, else DMPIGO for NDC scenes,
    DCVGO for unbounded inward ones and DVGO for the rest."""
    if cfg.data.dataset_type in ("waymo", "mega", "nerfpp") or cfg.model == "FourierGrid":
        return "FourierGrid"
    if cfg.data.ndc:
        return "dmpigo"
    if cfg.data.unbounded_inward:
        return "dcvgo"
    return "dvgo"


_CONFIG_FAMILY = {cls: name for name, cls in convert.CONFIGS.items()}


def family_of(mcfg) -> str:
    """The family of a model config."""
    if type(mcfg) not in _CONFIG_FAMILY:
        raise TypeError(f"no ported family has the config {type(mcfg).__name__}")
    return _CONFIG_FAMILY[type(mcfg)]


def build_model(cfg: ExpConfig, cfg_model: ModelRenderConfig, cfg_train: TrainStageConfig,
                xyz_min, xyz_max, generator: torch.Generator, device, n_train: int = -1):
    """(family, model config, params). pg_scale shrinks the initial voxel
    count by 2^len(pg_scale); DVGO, DCVGO and DMPIGO size both grids by
    ``num_voxels_rgb``."""
    nvd = cfg_model.num_voxels_density
    nvr = cfg_model.num_voxels_rgb
    if cfg_train.pg_scale:
        nvd = int(nvd / (2 ** len(cfg_train.pg_scale)))
        nvr = int(nvr / (2 ** len(cfg_train.pg_scale)))
    family = model_family_name(cfg)
    mod = FAMILIES[family]
    if family == "FourierGrid":
        mcfg = fg.config_from(cfg_model, xyz_min, xyz_max, nvd, nvr, sample_num=n_train)
    else:
        mcfg = mod.config_from(cfg_model, xyz_min, xyz_max, nvr)
    return family, mcfg, mod.create(mcfg, generator, device=device)


def gather_training_rays(cfg: ExpConfig, data_dict: dict, device, host: bool = False) -> dict:
    """The flattened ray store: rgb, rays_o, rays_d, viewdirs ([N*H*W, 3]
    each) and img_index. On ``device``, or with ``host`` (the
    ``load2gpu_on_the_fly`` mode) as numpy arrays in host memory, the rays
    made on ``device`` a view at a time."""
    i_train = np.asarray(data_dict["i_train"])
    HW = np.asarray(data_dict["HW"])
    H, W = int(HW[i_train[0]][0]), int(HW[i_train[0]][1])
    if not (HW[i_train] == (H, W)).all():
        raise ValueError("mixed per-view image sizes in one training stage are unsupported")
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
    images = np.asarray(data_dict["images"])[i_train]
    poses = np.asarray(data_dict["poses"])[i_train][:, :3, :4]
    Ks = np.asarray(data_dict["Ks"])[i_train]
    flags = dict(ndc=cfg.data.ndc, inverse_y=cfg.data.inverse_y, flip_x=cfg.data.flip_x,
                 flip_y=cfg.data.flip_y)
    if host:
        views = [[t.reshape(-1, 3).cpu().numpy() for t in ray_ops.get_rays_of_a_view(
                 H, W, as_t(K), as_t(c2w), **flags)] for c2w, K in zip(poses, Ks)]
        return {"rgb": images.reshape(-1, 3).astype(np.float32),
                **{k: np.concatenate([v[i] for v in views])
                   for i, k in enumerate(("rays_o", "rays_d", "viewdirs"))},
                "img_index": np.repeat(np.arange(len(poses), dtype=np.int32), H * W)}
    rgb, rays_o, rays_d, viewdirs, img_index = ray_ops.get_training_rays_flatten(
        as_t(images), as_t(poses), H, W, as_t(Ks), **flags)
    return {"rgb": rgb, "rays_o": rays_o, "rays_d": rays_d, "viewdirs": viewdirs,
            "img_index": img_index}


def make_forward(mcfg, render_kwargs: dict, cache=None) -> Callable:
    """(params, rays_o, rays_d, viewdirs, bg_color, cache=..., img_index=...)
    -> RenderResult, for the family of ``mcfg``; ``img_index`` (the rays'
    views) reaches the FourierGrid forward only, whose appearance embeddings
    read it, as in the JAX package.

    As the JAX package's branches: ``render_kwargs["stepsize"]`` reaches
    every forward; ``render_kwargs["bg"]`` reaches DVGO's, DCVGO's and
    DMPIGO's (``near`` too, which DCVGO ignores) but NOT FourierGrid's, so
    DVGO composites on ``bg`` whatever ``bg_color`` says (its JAX forward
    takes no random background), and without a
    random background a FourierGrid forward composites on its default
    ``bg=0.0`` (reproduced from the reference package, where it looks like an
    oversight; see ROADMAP queue C). ``cache`` is a render cache for
    rendering with frozen params; it may also be given per call.

    Every caller reads the colours through the weights alone (the composite,
    rgbper), so the DVGO, DCVGO and DMPIGO forwards colour only the samples
    over both thresholds (``compact``; raw_rgb [K, 3] at ``rgb_rows``)."""
    family = family_of(mcfg)

    def fwd(params, ro, rd, vd, bg_color=None, cache=cache, img_index=None):
        kw = dict(stepsize=render_kwargs["stepsize"], bg_color=bg_color, cache=cache)
        if family == "FourierGrid":
            return fg.forward(params, mcfg, ro, rd, vd, img_index=img_index, **kw)
        if family == "dvgo":
            return dvgo.forward(params, mcfg, ro, rd, vd, near=render_kwargs["near"],
                                stepsize=render_kwargs["stepsize"], bg=render_kwargs["bg"],
                                cache=cache, compact=True)
        if family == "dcvgo":
            kw["near"] = render_kwargs["near"]
        return FAMILIES[family].forward(params, mcfg, ro, rd, vd, bg=render_kwargs["bg"],
                                        compact=True, **kw)

    return fwd


def scale_model(family: str, params, mcfg, num_voxels_density: int, num_voxels_rgb: int,
                report: dict | None = None):
    """The family's ``scale_volume_grid``: (params, new config)."""
    if family == "FourierGrid":
        return fg.scale_volume_grid(params, mcfg, num_voxels_density, num_voxels_rgb,
                                    report=report)
    return FAMILIES[family].scale_volume_grid(params, mcfg, num_voxels_rgb, report=report)


def tv_axis_scale(family: str, mcfg) -> tuple | None:
    """DMPIGO weighs the TV of x and y by the plane's resolution and that of
    z by its depth (over 128); the others by the largest world size."""
    if family != "dmpigo":
        return None
    wxy = float(max(mcfg.world_size[:2])) / 128.0
    return (wxy, wxy, float(mcfg.mpi_depth) / 128.0)


def pg_scale_boundary(state: TrainState, mcfg, cfg_model: ModelRenderConfig,
                      cfg_train: TrainStageConfig, global_step: int, deferred_budget: int = 0,
                      report: dict | None = None, mesh: mesh_mod.Mesh | None = None):
    """The work of the ``pg_scale`` boundary at ``global_step``, which must be
    one of ``cfg_train.pg_scale``. Returns (new train state, new model config,
    record).

    The voxel count becomes the final one over 2^(boundaries left); both grids
    are resampled to it and the occupancy cache is refreshed from the density
    as trained so far (the family's ``scale_volume_grid``); ``act_shift``
    falls by ``decay_after_scale``; a ``deferred_budget`` becomes the config's
    ``sample_budget`` (the cache now holds geometry); and the optimizer is
    built anew, so its moments and its step count restart and, with
    ``lr_anchor = global_step`` at the caller, the lr returns to its base.

    The model is changed in place: ``state.params`` gets new grid parameters
    and a new mask, and ``state`` itself is void afterwards. Its moments are
    freed before the larger grids and the new moments are allocated, so the
    boundary's peak memory is the new size's alone. ``record`` holds the
    step, the new world sizes, the share of the new lattice that the old cache
    holds (``occupancy_carried``) and that the refreshed one keeps
    (``occupancy``), the budget in force before and after, and the seconds of
    resize, refresh and rebuild. ``report``, if given, receives what the
    family's ``scale_volume_grid`` reports (FourierGrid's pooled alpha of the
    refresh included).

    With ``mesh``, a grid cut over its grid group stays cut where the group
    divides its new X: each rank resizes and refreshes its own slab (the
    family's ``scale_volume_grid``); where the group does not divide it, the
    grid is joined and stands whole on every rank (the JAX rule). A whole
    grid that the group now divides is cut. ``record["sharded"]`` names the
    fields cut after the boundary and ``record["layout"]`` says of each field
    whether the boundary "kept cut", "joined", "cut" or kept it "whole"."""
    pg_scale = [int(b) for b in cfg_train.pg_scale]
    n_rest = len(pg_scale) - pg_scale.index(global_step) - 1
    cur_vox_density = int(cfg_model.num_voxels_density / (2**n_rest))
    cur_vox_rgb = int(cfg_model.num_voxels_rgb / (2**n_rest))
    params = state.params
    dev = params.mask_cache.mask.device
    state.optimizer = None  # the old grids' moments go first
    for p in params.parameters():
        p.grad = None
    report = {} if report is None else report
    budget_before = getattr(mcfg, "sample_budget", 0)
    was_cut = mesh_mod.sharded_names(params)
    _, mcfg = scale_model(family_of(mcfg), params, mcfg, cur_vox_density, cur_vox_rgb,
                          report=report)
    seconds = {part: report[part] for part in ("resize", "refresh")}
    params.act_shift -= cfg_train.decay_after_scale
    if mesh is not None:
        mesh_mod.shard_params(mesh, params)
    if deferred_budget:
        # the cache was just refreshed from trained density: cutting every
        # ray to a fixed budget of occupied samples is safe from here on
        mcfg = dataclasses.replace(mcfg, sample_budget=deferred_budget)
    t0 = time.perf_counter()
    state = create_train_state(params, cfg_train, start_step=global_step - 1)
    seconds["rebuild"] = seconds_since(t0, dev)
    record = {
        "step": global_step,
        "world_size_density": tuple(params.density.world_size),
        "world_size_rgb": tuple(params.k0.world_size),
        "occupancy_carried": report["carried"],
        "occupancy": float(params.mask_cache.mask.float().mean()),
        "sample_budget_before": budget_before,
        "sample_budget": getattr(mcfg, "sample_budget", 0),
        "seconds": seconds,
    }
    if mesh is not None:
        cut = mesh_mod.sharded_names(params)  # the fields cut over the grid axis
        record["sharded"] = cut
        record["layout"] = {
            name: ("kept cut" if name in cut else "joined") if name in was_cut
            else ("cut" if name in cut else "whole") for name in mesh_mod.SHARDED_FIELDS}
    return state, mcfg, record


def filter_in_maskcache(params, mcfg, store: dict, render_kwargs: dict, device):
    """The ``in_maskcache`` ray store: the rays whose samples meet the
    occupancy cache (``dvgo.hit_coarse_geo``, ``FILTER_CHUNK`` rays a call
    on ``device``), all of them where none or every ray does, as in the JAX
    package. The store may lie on the device or in host memory (numpy); the
    filtered one lies where it did. Returns (store, {"rays", "kept",
    "seconds"})."""
    t0 = time.perf_counter()
    ro, rd = store["rays_o"], store["rays_d"]
    n = int(ro.shape[0])
    as_dev = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    hit = torch.cat([dvgo.hit_coarse_geo(params, mcfg, as_dev(ro[a:a + FILTER_CHUNK]),
                                         as_dev(rd[a:a + FILTER_CHUNK]),
                                         near=render_kwargs["near"],
                                         stepsize=render_kwargs["stepsize"])
                     for a in range(0, n, FILTER_CHUNK)])
    kept = int(hit.sum())
    if 0 < kept < n:
        if isinstance(ro, np.ndarray):
            idx = np.nonzero(hit.cpu().numpy())[0]
        else:
            idx = torch.nonzero(hit)[:, 0]
        store = {k: v[idx] for k, v in store.items()}
    return store, {"rays": n, "kept": kept, "seconds": seconds_since(t0, torch.device(device))}


def apply_pervoxel_lr(state: TrainState, mcfg, cfg_train: TrainStageConfig, store: dict,
                      data_dict: dict, render_kwargs: dict) -> dict:
    """``pervoxel_lr`` on a DVGO stage, in place: every
    ``pervoxel_lr_downrate``-th ray of each training view (the store read as
    [views, H * W]) counted into the voxels by ``dvgo.voxel_count_views``;
    ``count / max(count.max(), 1)`` becomes the density grid's per-element
    lr, and voxels of a count of 2 or less leave the occupancy cache. Returns {"views", "seconds",
    "occupancy"}."""
    params = state.params
    dev = params.mask_cache.mask.device
    t0 = time.perf_counter()
    n_img = len(np.asarray(data_dict["i_train"]))
    H, W = (int(v) for v in np.asarray(data_dict["HW"])[0])
    down = max(1, cfg_train.pervoxel_lr_downrate)
    rays_o = store["rays_o"].reshape(n_img, H * W, 3)[:, ::down]
    rays_d = store["rays_d"].reshape(n_img, H * W, 3)[:, ::down]
    count = dvgo.voxel_count_views(params, mcfg, rays_o, rays_d, near=render_kwargs["near"],
                                   stepsize=render_kwargs["stepsize"])
    per_lr = count / torch.clamp_min(count.max(), 1.0)
    per_lr = mesh_mod.x_slab(per_lr[None], getattr(params.density, "shard", None))
    trainable = opt_factory.split_trainable(params, cfg_train)
    state.optimizer.set_per_lr(make_per_lr(trainable, {"density": [per_lr]}))
    params.mask_cache.mask = params.mask_cache.mask & (count[..., 0] > 2)
    return {"views": n_img, "seconds": seconds_since(t0, dev),
            "occupancy": float(params.mask_cache.mask.float().mean())}


def _jsonable(x):
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [_jsonable(v) for v in x]
    return float(x) if isinstance(x, (torch.Tensor, np.generic)) else x


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
    no_reload: bool = False,
    no_reload_optimizer: bool = False,
    save_every: int = 0,
    ft_path: str = "",
    mesh: mesh_mod.Mesh | None = None,
):
    """One training stage; returns (family, model config, params, psnr).

    With ``exp_dir`` the trained model is saved as ``<exp_dir>/<stage>_last``
    with the optimizer's state, every ``save_every`` steps (0: at the end
    only) and at the end; a ``<stage>_last`` found there is resumed from,
    unless ``no_reload``. ``ft_path`` names the checkpoint to resume from
    instead. A resume loads the model and its config from the checkpoint
    (no new model, no seed mask), the optimizer's step count and moments
    unless ``no_reload_optimizer``, and continues from the checkpoint's step
    as the uninterrupted run would: boundaries at or before it are passed, the
    lr decay is anchored at the last of them, the sampler and the background
    draws stand where that run's stand, and the sample budget is on where
    the first boundary has passed.

    A DVGO stage (the JAX package's branches): at step 0 the density near
    the training cameras is masked out (``maskout_near_cam_vox``); with the
    ``in_maskcache`` sampler the ray store keeps the rays that meet the
    occupancy cache (:func:`filter_in_maskcache`); with ``pervoxel_lr`` and
    another sampler the density grid's Adam steps are scaled by its voxels'
    normalised view counts and voxels seen by 2 views or fewer leave the
    occupancy cache (:func:`apply_pervoxel_lr`, computed anew on resume: it
    is not saved).

    ``coarse_mask_fn(world_size, xyz_min, xyz_max) -> bool [X, Y, Z]`` seeds
    the occupancy cache (in the full recipe, from the coarse stage); with it
    the cache is trusted and ``sample_budget`` is on from the first step.
    Without it a configured ``sample_budget`` is held at 0 until the first
    ``pg_scale`` boundary has refreshed the cache from trained density (for
    the whole stage where ``pg_scale`` is empty). ``callback(step, metrics)``
    runs after every step; at a boundary's step ``metrics["pg_scale"]`` is
    the record of :func:`pg_scale_boundary`.

    ``mesh`` (a :class:`..parallel.mesh.Mesh` over the process group): the
    stage trains data-parallel over its data axis where that divides
    ``N_rand`` (else every rank trains the whole batch alone, the JAX
    loop's single-device fallback, with its log line), with the density and
    k0 grids cut over its grid axis (:func:`..parallel.mesh.shard_params`)
    where that is larger than 1; rank 0 alone writes the metrics and the
    panels. Once cut, a grid and its moments stand whole on no card again
    (but where a boundary's new X is not divisible, the JAX rule): the
    boundaries resize and refresh slab by slab, a save assembles the whole
    arrays in host memory of rank 0, which writes them
    (``utils.checkpoint.save_model``), a resume reads the checkpoint on the
    host, cuts it there and moves this rank's slabs to the card, and the
    stage hands on its grids cut. A caller that needs a whole field reads
    the checkpoint.
    """
    n_iters = cfg_train.N_iters
    if cfg_train.ray_sampler not in ("flatten", "random", "in_maskcache"):
        raise ValueError(f"unknown ray_sampler {cfg_train.ray_sampler!r}")

    xyz_min = np.asarray(xyz_min, np.float64)
    xyz_max = np.asarray(xyz_max, np.float64)
    if abs(cfg_model.world_bound_scale - 1) > 1e-9:
        shift = (xyz_max - xyz_min) * (cfg_model.world_bound_scale - 1) / 2
        xyz_min = xyz_min - shift
        xyz_max = xyz_max + shift

    dp = None  # the mesh this stage trains over
    if mesh is not None:
        if cfg_train.N_rand % mesh.data == 0:
            dp = mesh
            if mesh.grid > 1:
                log_fn(f"{stage}: 2D mesh {{'data': {mesh.data}, 'grid': {mesh.grid}}} — grids "
                       "sharded spatially (halo-exchange sampling), rays data-parallel")
            else:
                log_fn(f"{stage}: DP over {mesh.data} devices (mesh axis 'data')")
        elif mesh.grid > 1:
            raise ValueError(f"{stage}: N_rand={cfg_train.N_rand} does not divide over "
                             f"{mesh.data} data ranks of the --grid_parallel mesh")
        else:
            log_fn(f"{stage}: N_rand={cfg_train.N_rand} not divisible by {mesh.data} devices "
                   "— training single-device")
    writer = mesh is None or mesh.rank == 0  # the rank that writes files

    # implicit resume from the stage's last checkpoint; ft_path wins over it
    reload_path = None
    if exp_dir:
        os.makedirs(exp_dir, exist_ok=True)
        cand = os.path.join(exp_dir, f"{stage}_last")
        if os.path.exists(os.path.join(cand, "meta.json")):
            reload_path = cand
    if ft_path:
        reload_path = ft_path
    if no_reload:
        reload_path = None
    start_step, opt_state = 0, None
    grid_cut = dp is not None and dp.grid > 1
    if reload_path is not None:
        t0 = time.perf_counter()
        # under --grid_parallel the checkpoint is read and cut on the host:
        # only this rank's slabs and their moments reach the card
        family, mcfg, params, start_step, opt_state = ckpt.load_model(
            reload_path, device="cpu" if grid_cut else device,
            with_opt_state=not no_reload_optimizer)
        if grid_cut:
            mesh_mod.shard_params(dp, params)
            opt_state = mesh_mod.shard_opt_state(params, opt_state)
            params = params.to(device)
        if str(reload_path).endswith(".tar"):
            # a reference checkpoint carries no render/train-time knobs: the
            # scene config's values win
            from unboundednerfpytorch_tpu_torch.utils.reference_import import (
                overlay_render_knobs,
            )

            mcfg = overlay_render_knobs(mcfg, cfg_model)
        log_fn(f"{stage}: resumed from {reload_path} at step {start_step} "
               f"({'with' if opt_state else 'without'} the optimizer's state, "
               f"{time.perf_counter() - t0:.2f} s)")
    else:
        # CPU generator for the model init (device-independent values)
        family, mcfg, params = build_model(
            cfg, cfg_model, cfg_train, xyz_min, xyz_max, torch.Generator().manual_seed(seed),
            device, n_train=len(np.asarray(data_dict["i_train"])))
        if coarse_mask_fn is not None:
            ws = params.mask_cache.mask.shape
            params.mask_cache.mask = torch.as_tensor(
                coarse_mask_fn(ws, mcfg.xyz_min, mcfg.xyz_max), dtype=torch.bool, device=device)
    # as the JAX package: DVGO and FourierGrid mask the density near the
    # cameras; DCVGO and DMPIGO, which define no such step, train on
    if cfg_model.maskout_near_cam_vox and start_step == 0 and family in ("dvgo", "FourierGrid"):
        cam_o = np.asarray(data_dict["poses"])[np.asarray(data_dict["i_train"])][:, :3, 3]
        FAMILIES[family].maskout_near_cam_vox(params, mcfg, cam_o, float(data_dict["near"]))

    render_kwargs = {
        "near": float(data_dict["near"]),
        "far": float(data_dict["far"]),
        "bg": 1.0 if cfg.data.white_bkgd else 0.0,
        "rand_bkgd": cfg.data.rand_bkgd,
        "stepsize": cfg_model.stepsize,
    }
    state = create_train_state(params, cfg_train, start_step=start_step, opt_state=opt_state)
    if n_iters <= start_step:  # a finished stage: nothing to train
        log_fn(f"{stage}: the checkpoint stands at its last step {start_step}")
        return family, mcfg, state.params, 0.0

    near_thres = 0.0
    radius = getattr(mcfg, "scene_radius", None)  # DMPIGO has none
    if cfg_train.weight_nearclip > 0 and data_dict.get("near_clip") and radius is not None:
        near_thres = float(data_dict["near_clip"]) / float(radius[0])

    lr_decay_enabled = not (cfg.model == "FourierGrid" and cfg.data.dataset_type == "tankstemple")
    host = bool(cfg.data.load2gpu_on_the_fly)
    store = gather_training_rays(cfg, data_dict, device, host=host)
    if cfg_train.ray_sampler == "in_maskcache" and family == "dvgo":
        store, report = filter_in_maskcache(params, mcfg, store, render_kwargs, device)
        log_fn(f"{stage}: in_maskcache kept {report['kept']} of {report['rays']} rays "
               f"({report['seconds']:.2f} s)")
    if cfg_train.pervoxel_lr and family == "dvgo" and cfg_train.ray_sampler != "in_maskcache":
        report = apply_pervoxel_lr(state, mcfg, cfg_train, store, data_dict, render_kwargs)
        log_fn(f"{stage}: pervoxel_lr from {report['views']} views, "
               f"{report['seconds']:.2f} s; occupancy {report['occupancy']:.4f}")
    if grid_cut:
        mesh_mod.shard_params(dp, state.params, state.optimizer)  # a resume's are cut already
        cut = mesh_mod.sharded_names(state.params)
        log_fn(f"{stage}: grids cut over {dp.grid} ranks: {cut or 'none'} (a grid whose X "
               f"{dp.grid} does not divide stays whole)")
    part = None if dp is None else dp.batch_slice(cfg_train.N_rand)
    # a device generator for the per-step draws (ray indices or backgrounds);
    # the host store draws its indices with numpy, as the JAX package's does
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    mode = "random" if cfg_train.ray_sampler == "random" else "flatten"
    if host:
        sampler = HostRayStoreSampler(
            store, cfg_train.N_rand, seed, device,
            bg_generator=gen if render_kwargs["rand_bkgd"] else None, mode=mode, part=part)
        next_batch = sampler.next_batch
    else:
        sampler = (RandomSampler if mode == "random" else FlattenSampler)(
            store["rgb"].shape[0], cfg_train.N_rand, gen, device,
            rand_bkgd=render_kwargs["rand_bkgd"])

        def next_batch():
            idx, bg = sampler.next_batch()
            if part is not None:  # this rank's slice of the global batch
                idx, bg = idx[part], None if bg is None else bg[part]
            return {k: v[idx] for k, v in store.items()}, bg

    sampler.fast_forward(start_step)

    # the occupancy cache is all-true at init, where a sample budget would cut
    # every ray to its first `budget` samples: hold the budget off until the
    # cache holds geometry (a coarse seed, or the first pg_scale refresh, which
    # a resumed run may have passed already)
    pg_scale = [int(b) for b in cfg_train.pg_scale]
    deferred_budget = 0
    cache_trusted = coarse_mask_fn is not None or (bool(pg_scale) and start_step >= min(pg_scale))
    if getattr(mcfg, "sample_budget", 0) > 0 and not cache_trusted:
        deferred_budget = mcfg.sample_budget
        mcfg = dataclasses.replace(mcfg, sample_budget=0)
    # the two-stage training forward waits for the last boundary: before the
    # final resolution the density has not sharpened, the threshold keeps
    # more samples a ray than the survivor budget, and the far tail it
    # drops would be real content
    deferred_survivors = 0
    if getattr(mcfg, "train_survivor_budget", 0) > 0 and start_step < max(pg_scale, default=0):
        deferred_survivors = mcfg.train_survivor_budget
        mcfg = dataclasses.replace(mcfg, train_survivor_budget=0)

    def undeferred(mcfg_now):
        """The config with every deferred budget as configured: what a save
        stores and what the stage hands on."""
        if deferred_budget:
            mcfg_now = dataclasses.replace(mcfg_now, sample_budget=deferred_budget)
        if deferred_survivors:
            mcfg_now = dataclasses.replace(mcfg_now, train_survivor_budget=deferred_survivors)
        return mcfg_now

    def compile_step(mcfg_now, lr_anchor_now):
        return make_train_step(
            make_forward(mcfg_now, render_kwargs), cfg_train,
            world_size_max=float(max(mcfg_now.world_size)), near_thres=near_thres,
            tv_axis_scale=tv_axis_scale(family, mcfg_now), lr_anchor=lr_anchor_now,
            lr_decay_enabled=lr_decay_enabled, mesh=dp)

    def save(step: int) -> None:
        # cut grids and moments are assembled on rank 0's host: every rank
        # of its grid group takes part
        if writer or (grid_cut and dp.data_index == 0 and mesh_mod.sharded_names(state.params)):
            # never persist a deferral-zeroed budget: a resume must re-enter
            # the deferral with the configured one
            ckpt.save_model(os.path.join(exp_dir, f"{stage}_last"), family, undeferred(mcfg),
                            state.params, global_step=step,
                            opt_state=state.optimizer.state_dict())

    def record(rec: dict) -> None:
        if not writer:
            return
        with open(os.path.join(exp_dir, f"{stage}_metrics.jsonl"), "a") as f:
            f.write(json.dumps(_jsonable(rec)) + "\n")

    i_panel = int(cfg_train.i_panel)
    n_images = len(data_dict["images"]) if data_dict.get("images") is not None else 0
    panel_views = [int(i) for i in np.asarray(data_dict["i_test"]).reshape(-1) if i < n_images]
    panel_kwargs = {k: v for k, v in render_kwargs.items() if k != "rand_bkgd"}

    def write_eval_panel(mcfg_now, step_now: int) -> None:
        """Render the first held-out view through the current model and
        write its panel (the JAX loop's ``_write_eval_panel``)."""
        from unboundednerfpytorch_tpu_torch.render.renderer import DEFAULT_CHUNK, render_image
        from unboundednerfpytorch_tpu_torch.utils import observability

        if not panel_views:
            return
        view = panel_views[0]
        if getattr(mcfg_now, "train_survivor_budget", 0):  # a render: every survivor
            mcfg_now = dataclasses.replace(mcfg_now, train_survivor_budget=0)
        fwd = make_forward(mcfg_now, panel_kwargs)
        H, W = (int(v) for v in np.asarray(data_dict["HW"])[view])
        rgb, depth, bgmap = render_image(
            lambda ro, rd, vd: fwd(state.params, ro, rd, vd, None), H, W,
            np.asarray(data_dict["Ks"])[view], np.asarray(data_dict["poses"])[view][:3, :4],
            ndc=cfg.data.ndc, inverse_y=cfg.data.inverse_y, flip_x=cfg.data.flip_x,
            flip_y=cfg.data.flip_y, chunk=min(DEFAULT_CHUNK, H * W), device=device)
        if not writer:
            return
        psnr = observability.record_panel(exp_dir, stage, step_now,
                                          np.asarray(data_dict["images"][view]), rgb, depth,
                                          bgmap)
        log_fn(f"{stage} panel @ {step_now}: view {view} psnr {psnr:.2f}")

    # the lr decays after each update and returns to the base lr wherever the
    # optimizer is rebuilt: the decay is anchored at the last boundary
    lr_anchor = max([1] + [b for b in pg_scale if b <= start_step])
    step_fn = compile_step(mcfg, lr_anchor)
    thres_schedule = dict(normalize_fast_color_thres(cfg_model)[1])
    last_psnr = 0.0
    t0 = time.time()
    for global_step in range(start_step + 1, n_iters + 1):
        if global_step in thres_schedule:
            new_thres = float(thres_schedule[global_step])
            if new_thres != mcfg.fast_color_thres:
                mcfg = dataclasses.replace(mcfg, fast_color_thres=new_thres)
                step_fn = compile_step(mcfg, lr_anchor)
        boundary = None
        if global_step in pg_scale:
            state, mcfg, boundary = pg_scale_boundary(state, mcfg, cfg_model, cfg_train,
                                                      global_step, deferred_budget, mesh=dp)
            deferred_budget = 0
            if deferred_survivors and global_step == max(pg_scale):
                mcfg = dataclasses.replace(mcfg, train_survivor_budget=deferred_survivors)
                deferred_survivors = 0
            lr_anchor = global_step
            step_fn = compile_step(mcfg, lr_anchor)
            sec = boundary["seconds"]
            log_fn(f"{stage} iter {global_step:6d} / pg_scale: grids "
                   f"{boundary['world_size_density']}, occupancy "
                   f"{boundary['occupancy_carried']:.4f} -> {boundary['occupancy']:.4f}, "
                   f"sample_budget {boundary['sample_budget_before']} -> "
                   f"{boundary['sample_budget']}, resize {sec['resize']:.3f}s "
                   f"refresh {sec['refresh']:.3f}s rebuild {sec['rebuild']:.3f}s")
            if exp_dir is not None:
                record({"step": global_step, "pg_scale": boundary})
        with span("train_loop/batch"):
            batch, bg_color = next_batch()
        metrics = step_fn(state, batch, bg_color)
        if boundary is not None:
            metrics["pg_scale"] = boundary
        if global_step % log_every == 0 or global_step == n_iters:
            last_psnr = float(metrics["psnr"])
            elapsed = time.time() - t0
            log_fn(f"{stage} iter {global_step:6d} / loss {float(metrics['loss']):.6f} / "
                   f"psnr {last_psnr:5.2f} / {elapsed:6.1f}s")
            if exp_dir is not None:
                record({"step": global_step, "elapsed_s": elapsed,
                        **{k: v for k, v in metrics.items() if k != "pg_scale"}})
        # a sharded model renders on every rank of its grid groups together
        if i_panel and exp_dir is not None and (global_step % i_panel == 0
                                                 or global_step == n_iters) and \
                (writer or mesh_mod.sharded_names(state.params)):
            write_eval_panel(mcfg, global_step)
        if save_every and exp_dir is not None and global_step % save_every == 0 \
                and global_step < n_iters:
            save(global_step)
        if callback is not None:
            callback(global_step, metrics)
    if exp_dir is not None and n_iters > start_step:
        save(n_iters)
    if mesh is not None:
        mesh_mod.barrier()  # the checkpoint stands before any rank reads it
    # never hand on a deferral-zeroed budget
    return family, undeferred(mcfg), state.params, last_psnr


def run_train(cfg: ExpConfig, data_dict: dict, seed: int = 777, log_fn=print,
              device=None, log_every: int = 500, callback=None, coarse_mask_fn=None,
              exp_dir: str | None = None, no_reload: bool = False,
              no_reload_optimizer: bool = False, save_every: int = 0, ft_path: str = "",
              grid_parallel: int = 1, use_mesh: bool | None = None, bbox=None):
    """The recipe: the coarse stage where ``coarse_train.N_iters`` > 0 (the
    DVGO configs of ``nerf/`` and the like, and the DMPIGO ones of
    ``custom/``), then the fine stage. Returns the fine stage's (family,
    model config, params, last logged psnr); under ``grid_parallel`` its
    grids come cut, as the stage trained them.

    As the JAX ``run_train``: the coarse stage trains on the camera-frustum
    box; the fine stage, except for waymo captures, on the box of the coarse
    lattice's nodes whose alpha passes ``bbox_thres``
    (``bbox.compute_bbox_by_coarse_geo``), its occupancy cache seeded with
    the pooled coarse alpha at the fine lattice ``>= mask_cache_thres``
    (``dvgo.coarse_mask_fn``). Both take the alpha of
    ``dvgo.activate_density`` whatever the family, as the JAX package does:
    for DMPIGO its per-plane ``act_shift`` [mpi_depth] is added along the
    lattice's last axis (ROADMAP queue C). Of the coarse model only its density grid is
    kept for that seed: the rest, its optimizer and its ray store are freed
    before the fine model is built.

    ``device``: ``None`` -> ``cuda`` (raises without a GPU); pass ``"cpu"``
    for the plain PyTorch path. ``coarse_mask_fn``: optional occupancy seed
    of a recipe without a coarse stage, standing in for the coarse stage's.
    ``callback(step, metrics)`` runs after every step of either stage (the
    step counts from 1 in each). ``exp_dir``, ``no_reload``,
    ``no_reload_optimizer``, ``save_every``, ``ft_path``: checkpoints and
    resume of each stage (see scene_rep_reconstruction; ``ft_path`` reaches
    both stages, as in the JAX package); nothing is saved where ``exp_dir``
    is None.

    Inside a process group (``parallel.mesh.maybe_initialize_distributed``,
    e.g. under ``torchrun``) the stages train over a mesh of its ranks, as the
    JAX ``run_train`` over the visible chips: data-parallel, and with
    ``grid_parallel`` > 1 on a (data, grid) layout with the grids cut over
    the grid axis (see :func:`scene_rep_reconstruction`); only rank 0 logs.
    ``use_mesh=False`` trains on this rank alone whatever the group (the
    JAX ``use_mesh``). ``bbox`` = (xyz_min, xyz_max): the box the first
    stage trains in, in place of the camera-frustum box (block-parallel
    training shares one).
    """
    dev = resolve_device(device)
    family = model_family_name(cfg)
    mesh = None
    auto = mesh_mod.world_size() > 1 if use_mesh is None else bool(use_mesh)
    if auto and torch.distributed.is_initialized():
        mesh = mesh_mod.make_mesh(grid_parallel)
        if mesh.rank != 0:
            log_fn = lambda *a, **k: None  # noqa: E731: rank 0 alone logs
    elif grid_parallel > 1:
        raise ValueError(f"--grid_parallel {grid_parallel} needs a process group of a "
                         "multiple of that many ranks (torchrun --nproc_per_node N)")
    if bbox is None:
        xyz_min, xyz_max = bbox_mod.compute_bbox_by_cam_frustrm(cfg, data_dict, family,
                                                                device=dev)
    else:
        xyz_min, xyz_max = (np.asarray(b) for b in bbox)
    kw = dict(device=dev, seed=seed, log_every=log_every, log_fn=log_fn, callback=callback,
              exp_dir=exp_dir, no_reload=no_reload, no_reload_optimizer=no_reload_optimizer,
              save_every=save_every, ft_path=ft_path, mesh=mesh)
    if cfg.coarse_train.N_iters > 0:
        _, mcfg_c, params_c, _ = scene_rep_reconstruction(
            cfg, cfg.coarse_model_and_render, cfg.coarse_train, xyz_min, xyz_max, data_dict,
            stage="coarse", **kw)
        if cfg.data.dataset_type != "waymo":
            # the box and the seed read the whole coarse density: a cut one
            # is joined here (the coarse lattice, some 100^3 f32 voxels)
            mesh_mod.unshard_params(params_c)
            fm = cfg.fine_model_and_render
            xyz_min, xyz_max = bbox_mod.compute_bbox_by_coarse_geo(
                params_c, mcfg_c, lambda d: dvgo.activate_density(params_c, mcfg_c, d),
                fm.bbox_thres)
            log_fn(f"fine box from the coarse geometry: {np.round(xyz_min, 4).tolist()} to "
                   f"{np.round(xyz_max, 4).tolist()}")
            coarse_mask_fn = dvgo.coarse_mask_fn(params_c.density.requires_grad_(False),
                                                 params_c.act_shift, mcfg_c, fm.mask_cache_thres)
        del params_c
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return scene_rep_reconstruction(
        cfg, cfg.fine_model_and_render, cfg.fine_train, xyz_min, xyz_max, data_dict,
        stage="fine", coarse_mask_fn=coarse_mask_fn, **kw)


def run_train_blocks(cfg: ExpConfig, data_dict: dict, block_num: int, exp_dir: str,
                     seed: int = 777, log_fn=print, merge: bool = True, no_reload: bool = False,
                     save_every: int = 0, device=None, log_every: int = 500, bbox=None,
                     parallel: bool = False) -> list:
    """Block training (``--num_per_block``), as the JAX ``run_train_blocks``:
    the training views cut into ``block_num`` contiguous slices of
    ``ceil(len(i_train) / block_num)``; block ``b`` trains through
    :func:`run_train` with ``seed + b`` in ``<exp_dir>/block_<b>``, which
    resumes from its own checkpoints, then is saved without the optimizer's
    state as ``<exp_dir>/fine_last_<b>``. A block whose ``fine_last_<b>``
    stands is skipped unless ``no_reload``. With two blocks or more the
    blocks are merged into ``<exp_dir>/fine_last_merged``
    (``utils.checkpoint.merge_blocks``). Returns the ``fine_last_<b>``
    paths. ``device``: ``None`` -> ``cuda``. ``bbox``: the box every block
    trains in (None: each its own camera box).

    Inside a process group each block trains over all its ranks
    (:func:`run_train`'s mesh) and rank 0 writes; with ``parallel``
    (``train/block_parallel.py``) block ``b`` trains on rank ``b % world``
    alone, with no collective, and rank 0 merges once every rank is done."""
    dev = resolve_device(device)
    world, me = mesh_mod.world_size(), mesh_mod.rank()
    mine = set(my_blocks(block_num, me, world)) if parallel else set(range(block_num))
    writes = parallel or me == 0
    i_train = np.asarray(data_dict["i_train"])
    per_block = int(np.ceil(len(i_train) / block_num))
    paths = []
    for b in range(block_num):
        ids = i_train[b * per_block:(b + 1) * per_block]
        if ids.size == 0:
            continue
        path = os.path.join(exp_dir, f"fine_last_{b}")
        paths.append(path)
        if b not in mine:
            continue
        if not no_reload and os.path.exists(os.path.join(path, "meta.json")):
            log_fn(f"block {b}: already complete ({path}), skipping")
            continue
        log_fn(f"block {b}: training on {len(ids)} views")
        family, mcfg, params, psnr = run_train(
            cfg, {**data_dict, "i_train": ids}, seed=seed + b, log_fn=log_fn, device=dev,
            log_every=log_every, exp_dir=os.path.join(exp_dir, f"block_{b}"),
            no_reload=no_reload, save_every=save_every, bbox=bbox,
            use_mesh=False if parallel else None)
        if writes:
            ckpt.save_model(path, family, mcfg, params)
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        log_fn(f"block {b}: psnr {psnr:.2f} -> {path}")
    mesh_mod.barrier()  # every block stands before the merge
    if merge and len(paths) > 1 and me == 0:
        merged = os.path.join(exp_dir, "fine_last_merged")
        ckpt.merge_blocks(paths, merged, device=dev)
        log_fn(f"merged {len(paths)} blocks -> {merged}")
    mesh_mod.barrier()
    return paths
