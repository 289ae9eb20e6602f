"""Config schema: the reference's mmengine template as frozen dataclasses.

The port's own copy of ``unboundednerfpytorch_tpu/configs/schema.py`` (kept
byte-for-byte in its definitions so scene configs load identically in both
packages; the port imports nothing of the JAX package).

Keys and defaults mirror ``FourierGrid/configs/default.py``
(data :9-40, coarse/fine train :44-81, coarse/fine model_and_render :85-125)
so reference scene configs translate mechanically. Scene files are python
dicts with ``_base_`` inheritance, loaded by
:mod:`unboundednerfpytorch_tpu_torch.configs.loader`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import field


@dataclasses.dataclass(frozen=True)
class DataConfig:
    datadir: str | None = None
    dataset_type: str | None = None
    inverse_y: bool = False
    flip_x: bool = False
    flip_y: bool = False
    annot_path: str = ""
    split_path: str = ""
    sequence_name: str = ""
    load2gpu_on_the_fly: bool = False
    testskip: int = 1
    white_bkgd: bool = False
    rand_bkgd: bool = False
    half_res: bool = False
    bd_factor: float = 0.75
    movie_render_kwargs: tuple = ()
    ndc: bool = False
    spherify: bool = False
    factor: int = 4
    width: int | None = None
    height: int | None = None
    llffhold: int = 8
    dvgohold: int = 8
    load_depths: bool = False
    unbounded_inward: bool = False
    unbounded_inner_r: float = 1.0
    boundary_ratio: float = 0.01
    sort_by_cam_position: bool = False
    training_ids: tuple = ()
    test_ids: tuple = ()
    # near/far/near_clip overrides (waymo/mega/linemod scene configs set
    # these; None = use the loader's heuristic)
    near: float | None = None
    far: float | None = None
    near_clip: float | None = None
    # waymo camera/view subsetting + test trajectory controls
    # (load_waymo.py:83-150, :343-345)
    sample_cam: int = -1
    sample_interval: int = 1
    test_rotate_angle: int = 360
    num_per_block: int = -1
    # linemod sequences (configs/linemod/*): object name + crop bounds
    seq_name: str = ""
    seq_id: int = -1
    width_max: int = -1
    height_max: int = -1


@dataclasses.dataclass(frozen=True)
class TrainStageConfig:
    N_iters: int = 5000
    N_rand: int = 8192
    lrate_density: float = 1e-1
    lrate_k0: float = 1e-1
    lrate_rgbnet: float = 1e-3
    lrate_vd: float = 0.0
    lrate_img_embeddings: float = 0.0
    lrate_decay: int = 20
    pervoxel_lr: bool = True
    pervoxel_lr_downrate: int = 1
    ray_sampler: str = "random"
    weight_main: float = 1.0
    weight_entropy_last: float = 0.01
    weight_nearclip: float = 0.0
    weight_distortion: float = 0.0
    weight_rgbper: float = 0.1
    weight_freq: float = 0.0
    tv_every: int = 1
    tv_after: int = 0
    tv_before: int = 0
    tv_dense_before: int = 0
    weight_tv_density: float = 0.0
    weight_tv_k0: float = 0.0
    pg_scale: tuple = ()
    decay_after_scale: float = 1.0
    skip_zero_grad_fields: tuple = ()
    maskout_lt_nviews: int = 0
    # eval-image panel cadence in steps (0 = off): every i_panel steps the
    # loop renders the first held-out view and writes a [GT|pred|err|depth]
    # PNG + panels.jsonl record under <exp_dir>/panels/ — the reference's
    # TensorBoardLogger val-image capability (block_nerf_lightning.py:128-137)
    i_panel: int = 0


@dataclasses.dataclass(frozen=True)
class ModelRenderConfig:
    num_voxels_rgb: int = 1024000
    num_voxels_density: int = 1024000
    num_voxels_viewdir: int = -1
    num_voxels_base_density: int = 1024000
    num_voxels_base_rgb: int = 1024000
    density_type: str = "DenseGrid"
    k0_type: str = "DenseGrid"
    density_config: tuple = ()
    k0_config: tuple = ()
    mpi_depth: int = 128
    nearest: bool = False
    pre_act_density: bool = False
    in_act_density: bool = False
    bbox_thres: float = 1e-3
    mask_cache_thres: float = 1e-3
    rgbnet_dim: int = 0
    rgbnet_full_implicit: bool = False
    rgbnet_direct: bool = True
    rgbnet_depth: int = 3
    rgbnet_width: int = 128
    alpha_init: float = 1e-6
    fast_color_thres: float = 1e-7
    # step-keyed schedule {step: thres} (garden_single.py:12-21); empty = use
    # the scalar fast_color_thres.
    fast_color_thres_schedule: tuple = ()
    maskout_near_cam_vox: bool = True
    world_bound_scale: float = 1.0
    stepsize: float = 0.5
    fourier_freq_num: int = 0
    bg_len: float = 0.2
    contracted_norm: str = "inf"
    img_emb_dim: int = -1
    t_boundary: float = 1.5
    # TPU fast path: fixed per-ray sample budget for occupancy-guided
    # compaction before expensive grid queries (0 = off / full parity).
    sample_budget: int = 0
    # Grid parameter dtype ("float32" | "bfloat16"); bf16 halves the HBM
    # bandwidth of the trilinear gathers on the hot path.
    grid_dtype: str = "float32"
    # Packed-corner gather engine (ops/packed.py): 1 gathered row per sample
    # per bank instead of 8. Costs 8x grid memory for the packed tables;
    # auto-disabled for grids past the memory guard.
    packed_gather: bool = True
    # Occupancy probe stride for the sample-budget pre-pass (see
    # models/fourier_grid.FourierGridConfig.budget_probe_stride).
    budget_probe_stride: int = 1
    # 2-level hierarchical occupancy probe for sparse scenes (see
    # models/fourier_grid.FourierGridConfig.probe_coarse_stride): coarse
    # block-pooled probe at this sample stride, fine strided probe only in
    # the accepted candidate groups. 0 = off (flat strided probe).
    probe_coarse_stride: int = 0
    # candidate budget in coarse stride groups (0 = auto).
    probe_candidate_groups: int = 0
    # Two-stage render engine: after the density pass + transmittance scan,
    # compact each ray to its first `color_budget` surviving samples
    # (weights > fast_color_thres) before the expensive color-bank gathers +
    # rgb MLP — the TPU fixed-shape analog of the reference's second
    # weights-threshold compaction (FourierGrid_model.py:602-614). 0 = off.
    color_budget: int = 0
    # Render-only density bake for the two-stage engine: resample the
    # 2K+1-bank density field onto ONE f32 bank at this linear scale, so the
    # render density pass costs 1 gathered row per sample instead of 2K+1.
    # Color stays exact; training is unaffected. ~2.4x render throughput at
    # >40dB vs the exact render (bench.py measures per scene). 0 = off.
    density_bake_scale: float = 0.0
    # dtype of the baked density table ("float32" | "bfloat16"): bf16 halves
    # the baked density pass's bytes/row; quality cost measured per scene.
    density_bake_dtype: str = "float32"
    # Two-stage TRAINING forward (models/fourier_grid.FourierGridConfig
    # .train_survivor_budget): stop-grad density probe -> fixed survivor
    # budget -> differentiable fused gather on survivors only. Active once
    # the fast_color_thres schedule reaches train_two_stage_thres. 0 = off.
    train_survivor_budget: int = 0
    train_two_stage_thres: float = 1e-4


@dataclasses.dataclass(frozen=True)
class ExpConfig:
    """Top-level experiment config (the reference cfg object)."""

    expname: str = "exp"
    basedir: str = "./logs/"
    model: str | None = None  # None -> auto-dispatch like create_new_model
    data: DataConfig = field(default_factory=DataConfig)
    coarse_train: TrainStageConfig = field(default_factory=TrainStageConfig)
    fine_train: TrainStageConfig = field(
        default_factory=lambda: TrainStageConfig(
            N_iters=20000,
            pervoxel_lr=False,
            ray_sampler="in_maskcache",
            weight_entropy_last=0.001,
            weight_rgbper=0.01,
            pg_scale=(1000, 2000, 3000, 4000),
            skip_zero_grad_fields=("density", "k0"),
        )
    )
    # diffusion-image replacement table for --diffuse (waymo_no_block.py:119:
    # dict(diff_root=..., diff_replace={stem: replacement_stem})), frozen
    diffusion: tuple = ()
    coarse_model_and_render: ModelRenderConfig = field(default_factory=ModelRenderConfig)
    fine_model_and_render: ModelRenderConfig = field(
        default_factory=lambda: ModelRenderConfig(
            num_voxels_density=160**3,
            num_voxels_rgb=160**3,
            num_voxels_base_density=160**3,
            num_voxels_base_rgb=160**3,
            rgbnet_dim=12,
            alpha_init=1e-2,
            fast_color_thres=1e-4,
            maskout_near_cam_vox=False,
            world_bound_scale=1.05,
            fourier_freq_num=3,
        )
    )


def normalize_fast_color_thres(cfg_model: "ModelRenderConfig"):
    """Return (initial_thres: float, schedule: tuple[(step, thres)]) whatever
    form fast_color_thres takes — scalar, dict (direct construction), or the
    already-split schedule field."""
    fct = cfg_model.fast_color_thres
    sched = dict(cfg_model.fast_color_thres_schedule or ())
    if isinstance(fct, (dict, tuple)) and not isinstance(fct, (int, float)):
        d = dict(fct)
        d.pop("_delete_", None)
        sched = {int(k): float(v) for k, v in d.items()}
        fct = sched.get(0, 0.0)
    return float(fct), tuple(sorted(sched.items()))


def _freeze(value):
    """dict -> sorted tuple items, list -> tuple (hashable config leaves)."""
    if isinstance(value, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in value.items()))
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    return value


def _build(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    d = dict(d)
    # A dict-valued fast_color_thres is the step-keyed schedule
    # (garden_single.py:12-21) — route it to the schedule field (pulled out
    # first so the default empty schedule key can't clobber it).
    fct = d.get("fast_color_thres")
    kwargs = {}
    if isinstance(fct, dict):
        sched = {int(s): t for s, t in fct.items() if s != "_delete_"}
        kwargs["fast_color_thres_schedule"] = tuple(sorted(sched.items()))
        kwargs["fast_color_thres"] = sched.get(0, 0.0)
        d.pop("fast_color_thres")
        d.pop("fast_color_thres_schedule", None)
    for k, v in d.items():
        if k not in names:
            continue  # tolerate unknown keys like the reference's mmengine
        if v is None and not _accepts_none(cls, k):
            # tolerate explicit None for non-optional fields (e.g. the
            # reference nerf_studio/stump.py sets bd_factor=None): keep the
            # schema default instead
            continue
        kwargs[k] = _freeze(v)
    return cls(**kwargs)


def _accepts_none(cls, name: str) -> bool:
    f = cls.__dataclass_fields__[name]
    t = str(f.type)
    return "None" in t or f.default is None


def exp_config_from_dict(d: dict) -> ExpConfig:
    """Build an ExpConfig from a (merged) plain-dict scene config."""
    kwargs: dict = {}
    for key, cls in (
        ("data", DataConfig),
        ("coarse_train", TrainStageConfig),
        ("fine_train", TrainStageConfig),
        ("coarse_model_and_render", ModelRenderConfig),
        ("fine_model_and_render", ModelRenderConfig),
    ):
        if key in d:
            scene = dict(d[key])
            # dvgo-style single-resolution aliases (reference llff/
            # tankstemple/nerf configs say `num_voxels=256**3`): expand to
            # the per-grid keys unless the scene gives those explicitly.
            if "num_voxels" in scene:
                for tgt in ("num_voxels_rgb", "num_voxels_density"):
                    scene.setdefault(tgt, scene["num_voxels"])
            if "num_voxels_base" in scene:
                for tgt in ("num_voxels_base_rgb", "num_voxels_base_density"):
                    scene.setdefault(tgt, scene["num_voxels_base"])
            base = dataclasses.asdict(getattr(ExpConfig(), key))
            base.update(scene)
            kwargs[key] = _build(cls, base)
    for key in ("expname", "basedir", "model"):
        if key in d:
            kwargs[key] = d[key]
    if "diffusion" in d:
        kwargs["diffusion"] = _freeze(d["diffusion"])
    return ExpConfig(**kwargs)
