"""FourierGrid: the paper model: the single-stage training forward and the
cached render forwards.

Counterpart of ``unboundednerfpytorch_tpu/models/fourier_grid.py``:
``FourierGridConfig``, ``config_from``, ``create``, ``sample_ray``,
``budget_select`` (flat strided probe), ``forward`` with ``_bank_coords01``
(the march and the colour head are :mod:`.common`'s, which DCVGO and DMPIGO
share), and the render half: ``RenderCache``,
``build_render_cache``, the two-stage cached forward
(``_forward_two_stage``), the single-stage cache branch,
``_eval_field_on_lattice`` and ``bake_for_rendering``; and the ``pg_scale``
boundary: ``scale_volume_grid`` (both grids upsampled, the occupancy cache
refreshed from the trained density) and ``update_occupancy_cache``; and
``maskout_near_cam_vox`` (each bank's density near the cameras set to -100).
Its fast paths: the hierarchical probe of ``budget_select``
(``probe_coarse_stride``: ``_coarse_occupancy``, ``_coarse_lookup``,
``_probe_points_at``), the two-stage training forward
(``train_survivor_budget``, ``_forward_train_two_stage``),
``suggest_budgets`` and the adaptive render (``render_rays_adaptive``); and
the colour heads of ``create``: the coarse one (``rgbnet_dim <= 0``), the
view-direction grid (``num_voxels_viewdir``) and the appearance embeddings
(``img_emb_dim`` with ``sample_num``).

A training forward (no cache) gathers the eight corners from the grids
themselves (one gather over all banks of a grid, one index-add in the
backward); its values equal the JAX forward's packed-corner tables. A render
forward with a :class:`RenderCache` reads the pre-packed tables of
:mod:`..ops.packed`, in the JAX package's layout. The raw2alpha + early-exit
scan runs as the fused CUDA march (:mod:`..ops.cuda.march`) on every path;
the ``alpha > thres`` mask that the JAX forward builds before the scan is
computed here without grad and handed to it.

Three faults of the JAX ``suggest_budgets`` and of its caller are not
reproduced: every probe ray is taken (the JAX loop drops the last
``len % chunk`` rays and raises with fewer than ``chunk``), the default
coarse stride is rounded up to a multiple of ``2 * budget_probe_stride``
(which ``budget_select`` requires), and ``render.run_render`` hands it the
single-stage render cache its docstring asks for.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unboundednerfpytorch_tpu_torch.configs.schema import normalize_fast_color_thres
from unboundednerfpytorch_tpu_torch.device import constant, seconds_since
from unboundednerfpytorch_tpu_torch.fields.grids import FourierGrid, MaskGrid, nerf_pos_embed_coords
from unboundednerfpytorch_tpu_torch.fields.mlp import MLP
from unboundednerfpytorch_tpu_torch.models import common
from unboundednerfpytorch_tpu_torch.ops import alpha as alpha_ops
from unboundednerfpytorch_tpu_torch.ops import interp, sampling
from unboundednerfpytorch_tpu_torch.ops import packed as packed_ops
from unboundednerfpytorch_tpu_torch.parallel import mesh as mesh_mod
from unboundednerfpytorch_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class FourierGridConfig:
    scene_center: tuple
    scene_radius: tuple
    num_voxels_density: int
    num_voxels_rgb: int
    num_voxels_base_density: int
    num_voxels_base_rgb: int
    num_voxels_viewdir: int = -1
    alpha_init: float = 1e-6
    fast_color_thres: float = 0.0
    bg_len: float = 0.2
    contracted_norm: str = "inf"
    fourier_freq_num: int = 3
    rgbnet_dim: int = 0
    rgbnet_depth: int = 3
    rgbnet_width: int = 128
    viewbase_pe: int = 4
    img_emb_dim: int = -1
    sample_num: int = -1
    stepsize: float = 0.5
    t_boundary: float = 1.5
    # occupancy-guided compaction to a fixed per-ray budget (0 = off)
    sample_budget: int = 0
    grid_dtype: str = "float32"
    # render cache: pre-packed corner tables (ops/packed.py); turned off by
    # the memory guards when the tables would not fit
    packed_gather: bool = True
    # flat probe: test every k-th sample against the mask cache
    budget_probe_stride: int = 1
    # hierarchical probe: one probe a group of this many samples against a
    # block-pooled coarse mask, the fine probe only inside the first
    # `probe_candidate_groups` accepted groups (0 = auto); 0 = flat probe
    probe_coarse_stride: int = 0
    probe_candidate_groups: int = 0
    # two-stage render (cache path only): after the density pass and the
    # scan, each ray keeps its first `color_budget` samples with
    # weights > fast_color_thres for the k0 gathers and the rgb MLP (0 = off)
    color_budget: int = 0
    # render-only density bake (two-stage cache): the [2K+1]-bank density
    # resampled onto ONE bank at `scale`x linear resolution. Approximate;
    # color stays exact; never affects training (0 = off)
    density_bake_scale: float = 0.0
    density_bake_dtype: str = "float32"  # or "bfloat16"
    # two-stage training forward: a no-grad density probe keeps each ray's
    # first `train_survivor_budget` samples over the threshold, and only
    # those are gathered with a gradient (0 = off); on from this threshold
    train_survivor_budget: int = 0
    train_two_stage_thres: float = 1e-4

    @property
    def xyz_min(self) -> tuple:
        b = 1.0 + self.bg_len
        return (-b, -b, -b)

    @property
    def xyz_max(self) -> tuple:
        b = 1.0 + self.bg_len
        return (b, b, b)

    def _voxel_size(self, num_voxels: int) -> float:
        ext = np.prod(np.array(self.xyz_max) - np.array(self.xyz_min))
        return float((ext / num_voxels) ** (1.0 / 3.0))

    def _world_size(self, num_voxels: int) -> tuple:
        ext = np.array(self.xyz_max) - np.array(self.xyz_min)
        vs = self._voxel_size(num_voxels)
        return tuple(int(v) for v in (ext / vs).astype(np.int64))

    @property
    def world_size_density(self) -> tuple:
        return self._world_size(self.num_voxels_density)

    @property
    def world_size_rgb(self) -> tuple:
        return self._world_size(self.num_voxels_rgb)

    @property
    def world_size(self) -> tuple:
        return self.world_size_density

    @property
    def voxel_size_ratio_density(self) -> float:
        return self._voxel_size(self.num_voxels_density) / self._voxel_size(
            self.num_voxels_base_density)

    @property
    def n_inner(self) -> int:
        return int(2 / (2 + 2 * self.bg_len) * self.world_size_density[0] / self.stepsize) + 1

    @property
    def act_shift(self) -> float:
        return common.act_shift_from_alpha_init(self.alpha_init)

    @property
    def k0_dim(self) -> int:
        return 3 if self.rgbnet_dim <= 0 else self.rgbnet_dim

    @property
    def use_view_grid(self) -> bool:
        return self.num_voxels_viewdir > 0

    @property
    def world_size_viewdir(self) -> tuple:
        n = int(2.0 / float((8.0 / self.num_voxels_viewdir) ** (1.0 / 3.0)))
        return (n, n, n)

    @property
    def rgbnet_in_dim(self) -> int:
        return 3 + 3 * self.viewbase_pe * 2 + self.k0_dim + max(self.img_emb_dim, 0)

    def with_num_voxels(self, num_voxels_density, num_voxels_rgb) -> "FourierGridConfig":
        return dataclasses.replace(self, num_voxels_density=num_voxels_density,
                                   num_voxels_rgb=num_voxels_rgb)


def config_from(cfg_model, xyz_min, xyz_max, num_voxels_density, num_voxels_rgb,
                sample_num: int = -1) -> FourierGridConfig:
    xyz_min = np.asarray(xyz_min, np.float64)
    xyz_max = np.asarray(xyz_max, np.float64)
    return FourierGridConfig(
        scene_center=tuple(((xyz_min + xyz_max) * 0.5).tolist()),
        scene_radius=tuple(((xyz_max - xyz_min) * 0.5).tolist()),
        num_voxels_density=num_voxels_density,
        num_voxels_rgb=num_voxels_rgb,
        num_voxels_base_density=cfg_model.num_voxels_base_density,
        num_voxels_base_rgb=cfg_model.num_voxels_base_rgb,
        num_voxels_viewdir=cfg_model.num_voxels_viewdir,
        alpha_init=cfg_model.alpha_init,
        fast_color_thres=normalize_fast_color_thres(cfg_model)[0],
        bg_len=cfg_model.bg_len,
        contracted_norm=cfg_model.contracted_norm,
        fourier_freq_num=cfg_model.fourier_freq_num,
        rgbnet_dim=cfg_model.rgbnet_dim,
        rgbnet_depth=cfg_model.rgbnet_depth,
        rgbnet_width=cfg_model.rgbnet_width,
        img_emb_dim=cfg_model.img_emb_dim,
        sample_num=sample_num,
        stepsize=cfg_model.stepsize,
        t_boundary=cfg_model.t_boundary,
        sample_budget=cfg_model.sample_budget,
        grid_dtype=cfg_model.grid_dtype,
        packed_gather=cfg_model.packed_gather,
        budget_probe_stride=cfg_model.budget_probe_stride,
        probe_coarse_stride=cfg_model.probe_coarse_stride,
        probe_candidate_groups=cfg_model.probe_candidate_groups,
        color_budget=cfg_model.color_budget,
        density_bake_scale=cfg_model.density_bake_scale,
        density_bake_dtype=cfg_model.density_bake_dtype,
        train_survivor_budget=cfg_model.train_survivor_budget,
        train_two_stage_thres=cfg_model.train_two_stage_thres,
    )


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class FourierGridParams(nn.Module):
    """density [2K+1, X, Y, Z, 1], k0 [2K+1, X, Y, Z, k0_dim] (one plain bank
    of 3 channels for the coarse head), the rgb MLP (None for the coarse
    head), the occupancy cache and ``act_shift``; ``vd`` the view-direction
    grid [1, n, n, n, 3] on [-1, 1]^3 and ``img_embeddings`` [sample_num,
    img_emb_dim], each None when off. ``act_shift`` is a host float: it
    changes only between stages, and the march kernel takes it as a launch
    argument (a device scalar would cost a sync per step)."""

    def __init__(self, density: FourierGrid, k0: FourierGrid, rgbnet: MLP | None,
                 act_shift: float, mask_cache: MaskGrid, vd: FourierGrid | None = None,
                 img_embeddings: torch.Tensor | None = None):
        super().__init__()
        self.density = density
        self.k0 = k0
        self.rgbnet = rgbnet
        self.act_shift = float(act_shift)
        self.mask_cache = mask_cache
        self.vd = vd
        if img_embeddings is not None and not isinstance(img_embeddings, nn.Parameter):
            img_embeddings = nn.Parameter(img_embeddings)
        self.img_embeddings = img_embeddings


def create(cfg: FourierGridConfig, generator: torch.Generator | None = None,
           device=None) -> FourierGridParams:
    """Zero grids, an all-true occupancy cache, a U(+-1/sqrt(fan_in)) MLP and
    N(0, 1) appearance embeddings drawn from ``generator``, in that order (a
    CPU generator; values are then moved). As the JAX ``create``: without an
    MLP (``rgbnet_dim <= 0``) k0 is one plain bank of 3 channels; with the
    view-direction grid the MLP is built all the same (the head never reads
    it)."""
    dt = _DTYPES[cfg.grid_dtype]
    density = FourierGrid(1, cfg.world_size_density, cfg.xyz_min, cfg.xyz_max,
                          num_freqs=cfg.fourier_freq_num, dtype=dt, device=device)
    if cfg.rgbnet_dim <= 0:
        k0 = FourierGrid(3, cfg.world_size_rgb, cfg.xyz_min, cfg.xyz_max, num_freqs=0,
                         dtype=dt, device=device)
        rgbnet = None
    else:
        k0 = FourierGrid(cfg.k0_dim, cfg.world_size_rgb, cfg.xyz_min, cfg.xyz_max,
                         num_freqs=cfg.fourier_freq_num, dtype=dt, device=device)
        rgbnet = MLP(cfg.rgbnet_in_dim, cfg.rgbnet_width, 3, cfg.rgbnet_depth,
                     generator=generator, device=device)
    vd = None
    if cfg.use_view_grid:
        vd = FourierGrid(3, cfg.world_size_viewdir, (-1.0,) * 3, (1.0,) * 3, num_freqs=0,
                         device=device)
    img_embeddings = None
    if cfg.img_emb_dim > 0 and cfg.sample_num > 0:
        img_embeddings = torch.randn((cfg.sample_num, cfg.img_emb_dim),
                                     generator=generator).to(device)
    mask_cache = MaskGrid(cfg.world_size_density, cfg.xyz_min, cfg.xyz_max, device=device)
    return FourierGridParams(density, k0, rgbnet, cfg.act_shift, mask_cache, vd=vd,
                             img_embeddings=img_embeddings)


def sample_ray(cfg: FourierGridConfig, rays_o: torch.Tensor, rays_d: torch.Tensor):
    """Contracted sampling with t_boundary: (pts [N, S, 3], inner [N, S], t [S])."""
    center = constant(cfg.scene_center, rays_o.dtype, rays_o.device)
    radius = constant(cfg.scene_radius, rays_o.dtype, rays_o.device)
    o = (rays_o - center) / radius
    d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    t = sampling.contracted_t_values(cfg.n_inner, cfg.n_inner, t_boundary=cfg.t_boundary,
                                     dtype=rays_o.dtype, device=rays_o.device)
    pts = o[:, None, :] + d[:, None, :] * t[None, :, None]
    pts, inner = sampling.contract(pts, bg_len=cfg.bg_len, norm_type=cfg.contracted_norm)
    return pts, inner, t


def _flat_probe(params: FourierGridParams, cfg: FourierGridConfig,
                pts: torch.Tensor) -> torch.Tensor:
    """Every ``budget_probe_stride``-th sample tested against the mask
    cache, its verdict repeated over its stride group: bool [N, S]."""
    S = pts.shape[1]
    stride = max(1, cfg.budget_probe_stride)
    if stride > 1:
        return params.mask_cache(pts[:, ::stride]).repeat_interleave(stride, dim=1)[:, :S]
    return params.mask_cache(pts)


def _probe_points_at(cfg: FourierGridConfig, rays_o: torch.Tensor, rays_d: torch.Tensor,
                     t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Contracted points at per-ray sample indices ``idx`` [N, M], computed
    from the ray equation as :func:`sample_ray` computes them (so each equals
    that sample's point to the bit): [N, M, 3]."""
    center = constant(cfg.scene_center, rays_o.dtype, rays_o.device)
    radius = constant(cfg.scene_radius, rays_o.dtype, rays_o.device)
    o = (rays_o - center) / radius
    d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    pts = o[:, None, :] + d[:, None, :] * t[idx][..., None]
    return sampling.contract(pts, bg_len=cfg.bg_len, norm_type=cfg.contracted_norm)[0]


def _coarse_occupancy(mask: torch.Tensor, p: int, window: int) -> torch.Tensor:
    """The occupancy mask [X, Y, Z] max-pooled in blocks of ``p`` (the last
    block of an axis partial), then dilated by a ``window``-wide max-pool:
    bool [ceil(X/p), ceil(Y/p), ceil(Z/p)]."""
    m = F.max_pool3d(mask.to(torch.float32)[None, None], kernel_size=p, stride=p,
                     ceil_mode=True)[0, 0]
    return interp.max_pool_3d_same(m, window) > 0.0


def _coarse_lookup(coarse: torch.Tensor, mask_cache: MaskGrid, pts: torch.Tensor,
                   p: int) -> torch.Tensor:
    """The coarse mask at the block of each point's nearest fine voxel
    (``fine_index // p``, the fine lookup's own rounding); a point outside
    the fine lattice is false."""
    scale, shift = mask_cache.scale_shift()
    ijk = torch.round(pts * scale + shift).to(torch.int64)
    fsz = constant(mask_cache.mask.shape, torch.int64, pts.device)
    in_box = ((ijk >= 0) & (ijk < fsz)).all(dim=-1)
    blk = torch.minimum(ijk.clamp_min(0), fsz - 1) // p
    X, Y, Z = coarse.shape
    flat = (blk[..., 0] * Y + blk[..., 1]) * Z + blk[..., 2]
    return coarse.reshape(-1)[flat.clamp(0, X * Y * Z - 1)] & in_box


def budget_select(params: FourierGridParams, cfg: FourierGridConfig, pts: torch.Tensor,
                  rays_o: torch.Tensor, rays_d: torch.Tensor, t: torch.Tensor):
    """The sample-budget pre-pass: (sel [N, sample_budget], sel_mask).

    Flat (``probe_coarse_stride`` <= 1): :func:`_flat_probe`, then each ray's
    first ``sample_budget`` occupied samples.

    Hierarchical (``probe_coarse_stride`` = cs): the centre of each group of
    cs samples is looked up in the block-pooled, dilated coarse mask; the
    first ``probe_candidate_groups`` accepted groups of a ray (auto: ceil(1.5
    sample_budget / cs)) get the fine strided probe, at points recomputed
    from the ray equation; the first ``sample_budget`` fine-accepted samples
    are selected. Groups start on stride boundaries and the coarse dilation
    covers a group's reach, so with enough candidate groups the selection is
    the flat probe's; a ray with more accepted groups loses its far tail."""
    N, S = pts.shape[:2]
    stride = max(1, cfg.budget_probe_stride)
    cs = int(cfg.probe_coarse_stride)
    if cs <= 1:
        return sampling.compact_samples(_flat_probe(params, cfg, pts), cfg.sample_budget)
    if cs % stride or cs % 2:
        raise ValueError(f"probe_coarse_stride {cs} must be an even multiple of "
                         f"budget_probe_stride {stride}")
    dev = pts.device
    n_g = -(-S // cs)
    c_g = int(cfg.probe_candidate_groups) or -(-int(1.5 * cfg.sample_budget) // cs)
    c_g = min(c_g, n_g)
    # the coarse dilation makes a centre's verdict cover its group: cs/2
    # steps of at most a stepsize of voxels each way, the block (p) and a
    # voxel of rounding
    p = max(2, cs // 2)
    reach_vox = int(np.ceil((cs / 2) * cfg.stepsize)) + 1
    window = 2 * int(np.ceil((reach_vox + p) / p)) + 1
    coarse = _coarse_occupancy(params.mask_cache.mask, p, window)
    c_idx = torch.clamp_max(torch.arange(n_g, device=dev) * cs + cs // 2, S - 1)
    probe = _probe_points_at(cfg, rays_o, rays_d, t, c_idx.expand(N, n_g))
    sel_g, m_g = sampling.compact_samples(_coarse_lookup(coarse, params.mask_cache, probe, p),
                                          c_g)
    # the fine strided probe inside the candidate groups, at the flat probe's
    # points (group starts are multiples of the stride)
    off_p = torch.arange(0, cs, stride, device=dev)
    p_idx = torch.clamp_max((sel_g[:, :, None] * cs + off_p).reshape(N, -1), S - 1)
    fine = params.mask_cache(_probe_points_at(cfg, rays_o, rays_d, t, p_idx))
    fine = fine.reshape(N, c_g, -1).repeat_interleave(stride, dim=2)[:, :, :cs]
    samp_idx = sel_g[:, :, None] * cs + torch.arange(cs, device=dev)  # [N, c_g, cs]
    valid = m_g[:, :, None] & (samp_idx < S) & fine
    inner = min(cfg.sample_budget, c_g * cs)
    sel2, sel_mask = sampling.compact_samples(valid.reshape(N, c_g * cs), inner)
    sel = torch.gather(samp_idx.reshape(N, c_g * cs), 1, sel2)
    sel = torch.where(sel_mask, sel, torch.zeros_like(sel))
    if inner < cfg.sample_budget:  # a candidate budget smaller than the sample budget
        pad = cfg.sample_budget - inner
        sel = F.pad(sel, (0, pad))
        sel_mask = F.pad(sel_mask, (0, pad))
    return sel, sel_mask


def _bank_coords01(cfg: FourierGridConfig, pts: torch.Tensor,
                   num_freqs: int | None = None) -> torch.Tensor:
    """Per-bank query coords in [0, 1]: [..., B, 3]."""
    mn = constant(cfg.xyz_min, pts.dtype, pts.device)
    mx = constant(cfg.xyz_max, pts.dtype, pts.device)
    coords = ((pts - mn) / (mx - mn)) * 2.0 - 1.0
    freqs = cfg.fourier_freq_num if num_freqs is None else num_freqs
    return (nerf_pos_embed_coords(coords, freqs) + 1.0) * 0.5


def _query(params: FourierGridParams, cfg: FourierGridConfig, pts: torch.Tensor):
    """(density [N, S], k0 [N, S, k0_dim]) in f32 from the grids themselves.
    When both grids share bank structure and resolution (the fine config),
    the bank coords are computed once for both."""
    dg, kg = params.density.grid, params.k0.grid
    if _fused_banks(params):
        c01 = _bank_coords01(cfg, pts, params.density.num_freqs)
        B = dg.shape[0]
        density = interp.grid_sample_banks(dg, c01)[..., 0] / B
        k0 = interp.grid_sample_banks(kg, c01) / B
        return density, k0
    return params.density(pts)[..., 0], params.k0(pts)


def rgb_of(params: FourierGridParams, cfg: FourierGridConfig, k0: torch.Tensor,
           viewdirs: torch.Tensor, img_index: torch.Tensor | None = None) -> torch.Tensor:
    """The colour head (the JAX ``_rgb_head``): the sigmoid of k0 without an
    MLP; with the view-direction grid, the sigmoid of k0 plus the grid's
    colour at the ray's direction; else the MLP, its input extended by the
    ray's appearance embedding where the model has them and ``img_index``
    [N] is given."""
    vcol = emb = None
    if params.rgbnet is not None and params.vd is not None:
        vcol = params.vd(viewdirs)
    elif params.img_embeddings is not None and img_index is not None:
        emb = params.img_embeddings[img_index.to(torch.int64)]
    return common.rgb_head(params.rgbnet, k0, viewdirs, cfg.viewbase_pe, vcol=vcol, emb=emb)


# ---------------------------------------------------------------------------
# render cache


@dataclasses.dataclass(frozen=True)
class RenderCache:
    """Pre-packed corner tables for rendering (frozen params), built once per
    render run (ops/packed.py) and shared by every chunk.

    Single-stage layout (``color_budget == 0``): ``tables`` holds one fused
    [T, 8*(1+k0_dim)] density+color table per bank: one gathered row serves
    both fields.

    Two-stage layout (``color_budget > 0``): ``density_tables``
    [T/fold, fold*8] per bank and ``k0_tables`` [T, 8*k0_dim] per bank, the
    latter touched only by each ray's color_budget survivors of the weights
    threshold. With the density bake there is ONE density table, of the baked
    lattice (``density_dims``), addressed with plain coordinates
    (``density_num_freqs == 0``)."""

    tables: tuple | None = None
    density_tables: tuple | None = None
    k0_tables: tuple | None = None
    density_fold: int = 1
    density_dims: tuple | None = None
    density_num_freqs: int | None = None

    @property
    def branch(self) -> str:
        """Which layout build_render_cache took, for logs."""
        if self.tables is not None:
            return "single-stage fused tables"
        if self.density_dims is not None:
            return "two-stage, baked density %dx%dx%d" % tuple(self.density_dims)
        return "two-stage, exact density"

    def nbytes(self) -> int:
        every = (self.tables or ()) + (self.density_tables or ()) + (self.k0_tables or ())
        return sum(t.numel() * t.element_size() for t in every)


# Fractions of the device's memory for the packed-table guards (bytes of one
# bank's packed table / of the full cached table set), the JAX package's.
_PACK_HBM_FRAC = 0.1625
_CACHE_HBM_FRAC = 0.5625


@functools.lru_cache(maxsize=None)
def _hbm_bytes(device: torch.device) -> int:
    """The device's memory, read from the card; on the CPU the 16 GB that the
    JAX package falls back to there, so that both packages take the same
    branches in the CPU tests."""
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return int(16e9)


def _pack_bytes_limit(device: torch.device) -> int:
    return int(_hbm_bytes(device) * _PACK_HBM_FRAC)


def _cache_bytes_limit(device: torch.device) -> int:
    return int(_hbm_bytes(device) * _CACHE_HBM_FRAC)


def _baked_density_dims(cfg: FourierGridConfig, device: torch.device) -> tuple | None:
    """Lattice dims of the render-only density bake, or None when it is off,
    does not apply (a single-bank model gains nothing) or is over the memory
    guard. This decides between an approximate and an exact density, so it
    changes values, not only speed."""
    if cfg.density_bake_scale <= 0 or cfg.fourier_freq_num <= 0:
        return None
    dims = cfg._world_size(int(cfg.num_voxels_density * cfg.density_bake_scale**3))
    # guarded with the f32 row bytes (conservative for a bfloat16 bake)
    if int(np.prod([d + 1 for d in dims])) * 8 * 4 > _pack_bytes_limit(device):
        return None
    return dims


def _fused_banks(params: FourierGridParams) -> bool:
    """Density and k0 can share one gathered row when their bank structure
    and resolution match, single-bank (num_freqs == 0) models included.
    Never for grids cut over a grid group: as the JAX forward with a
    spatial mesh, each field is then queried through the halo sample, and
    the fused, packed and two-stage paths, which all need this test, are
    off."""
    if params.density.shard is not None or params.k0.shard is not None:
        return False
    dg, kg = params.density.grid, params.k0.grid
    return params.k0.num_freqs == params.density.num_freqs and dg.shape[:4] == kg.shape[:4]


def _use_packed(params: FourierGridParams, cfg: FourierGridConfig) -> bool:
    if not (cfg.packed_gather and _fused_banks(params)):
        return False
    grid = params.density.grid
    need = packed_ops.packed_table_bytes(grid.shape[1:4], 1 + cfg.k0_dim, grid.element_size())
    return need <= _pack_bytes_limit(grid.device)


def build_render_cache(params: FourierGridParams, cfg: FourierGridConfig,
                       log_fn=None) -> RenderCache | None:
    """Pack the corner tables for all banks (rendering with frozen params).

    Fused layout when ``color_budget == 0``, split density/k0 layout for the
    two-stage forward otherwise. Returns None when the packed tables do not
    apply (banks of different structure, packing off, or tables too large to
    cache). ``log_fn`` is told which layout was taken and its size."""
    if not _use_packed(params, cfg):
        return None
    dgrid, kgrid = params.density.grid.detach(), params.k0.grid.detach()
    B = dgrid.shape[0]
    need = B * packed_ops.packed_table_bytes(dgrid.shape[1:4], 1 + cfg.k0_dim,
                                             dgrid.element_size())
    if need > _cache_bytes_limit(dgrid.device):
        return None

    with torch.no_grad(), span("render/cache_build"):
        if cfg.color_budget > 0:
            fold = 16  # a 1-channel row holds 8 values; 16 bases make 128
            bake_dims = _baked_density_dims(cfg, dgrid.device)
            if bake_dims is not None:
                # ONE folded table at the scaled resolution: one row per
                # sample in the density pass instead of 2K+1; color exact
                dt = torch.bfloat16 if cfg.density_bake_dtype == "bfloat16" else torch.float32
                baked = _eval_field_on_lattice(params.density, cfg.xyz_min, cfg.xyz_max,
                                               bake_dims, 1).to(dt)
                density_tables = (packed_ops.pack_corners_folded_chunked(baked, fold),)
                del baked
                addressing = dict(density_dims=tuple(bake_dims), density_num_freqs=0)
            else:
                density_tables = tuple(packed_ops.pack_corners_folded(dgrid[b], fold)
                                       for b in range(B))
                addressing = {}
            cache = RenderCache(
                density_tables=density_tables,
                k0_tables=tuple(packed_ops.pack_corners(kgrid[b]) for b in range(B)),
                density_fold=fold, **addressing)
        else:
            cache = RenderCache(tables=tuple(
                packed_ops.pack_corners(torch.cat([dgrid[b], kgrid[b]], dim=-1))
                for b in range(B)))
    if log_fn is not None:
        log_fn(f"render cache: {cache.branch}, {cache.nbytes() / 1e9:.3f} GB of tables")
    return cache


def _packed_bank_sum(tables, c01, dims, channels: int, fold: int = 0) -> torch.Tensor:
    """sum_b packed_trilerp(tables[b], c01[..., b, :]) in bank order. The
    banks share their dims, so bases and weights are computed for all of them
    in one pass (a seventh of the small launches of a per-bank loop)."""
    base, w = packed_ops.corner_base_and_weights(c01, dims)  # [..., B], [..., B, 8]
    total = None
    for b, table in enumerate(tables):
        if fold:
            v = packed_ops.packed_trilerp_folded(table, base[..., b], w[..., b, :], channels,
                                                 fold)
        else:
            v = packed_ops.packed_trilerp(table, base[..., b], w[..., b, :], channels)
        total = v if total is None else total + v
    return total


def _cache_density(cfg: FourierGridConfig, cache: RenderCache, pts, fallback_dims):
    """Raw density from the two-stage cache's folded tables, with the
    density-bake addressing (single bank, plain coords, baked dims) when the
    cache was built with ``density_bake_scale``."""
    dims = cache.density_dims or tuple(fallback_dims)
    c01 = _bank_coords01(cfg, pts, num_freqs=cache.density_num_freqs)
    density = _packed_bank_sum(cache.density_tables, c01, dims, 1, cache.density_fold)
    return density[..., 0] / len(cache.density_tables)


def _colour_survivors(params, cfg, cache, pts, weights, mask, alphainv_last, viewdirs,
                      img_index, bg, cb: int):
    """Stage 2 of the two-stage render: each ray's first ``cb`` live samples
    of ``mask`` (near -> far) coloured from the cache's k0 tables and
    composited with their weights: (rgb_marched [N, 3], rgb [N, cb, 3])."""
    with span("forward/compact"):
        sel2, sel2_mask = sampling.compact_samples(mask, cb)
        g = sampling.gather_samples(
            torch.cat([pts, weights[..., None].to(pts.dtype)], dim=-1), sel2)
        w_c = g[..., 3].to(weights.dtype) * sel2_mask.to(weights.dtype)
    with span("forward/k0"):
        k0 = _packed_bank_sum(cache.k0_tables, _bank_coords01(cfg, g[..., :3]),
                              params.density.grid.shape[1:4], cfg.k0_dim) / len(cache.k0_tables)
    with span("forward/rgb"):
        rgb = rgb_of(params, cfg, k0, viewdirs, img_index)
        return common.composite(w_c, rgb, alphainv_last, bg), rgb


def _forward_two_stage(params, cfg, cache, pts, t2, mask, viewdirs, interval, thres,
                       bg, img_index, n_max):
    """Two-stage cached render: narrow density rows -> alpha -> weights ->
    per-ray color_budget compaction -> color rows + MLP -> composite.

    Exact w.r.t. the single-stage path whenever no ray has more than
    ``color_budget`` samples with weights > thres (near->far order is kept,
    so any truncation drops the lowest-transmittance tail)."""
    S = pts.shape[1]
    dims = params.density.grid.shape[1:4]

    # stage 1: density from the narrow packed rows
    with span("forward/density"):
        density = _cache_density(cfg, cache, pts, dims)
    with span("forward/march"):
        alpha, weights, alphainv_last, mask = common.march(
            density, mask, params.act_shift, interval, thres)

    # stage 2: color only for each ray's survivors
    cb = min(cfg.color_budget, S)
    overflow_frac = (mask.sum(dim=-1) > cb).to(torch.float32).mean()
    rgb_marched, rgb = _colour_survivors(params, cfg, cache, pts, weights, mask, alphainv_last,
                                         viewdirs, img_index, bg, cb)

    s = 1.0 - 1.0 / (1.0 + t2)
    depth = torch.sum(weights * s, dim=-1)
    return common.RenderResult(
        rgb_marched=rgb_marched, alphainv_last=alphainv_last, weights=weights,
        raw_alpha=alpha, raw_rgb=rgb,  # compacted [N, color_budget, 3]
        raw_density=density, mask=mask, t=t2, s=s, depth=depth, n_max=n_max,
        color_overflow_frac=overflow_frac, rgb_compacted=True)


def _probe_density(params: FourierGridParams, cfg: FourierGridConfig,
                   pts: torch.Tensor) -> torch.Tensor:
    """Stage A of the two-stage training forward: the raw density [N, S]
    from each bank's folded 1-channel corner table, packed from the grid
    as it stands (no gradient). The eight corners and the banks are summed
    in the order of the gather of :func:`_query`, so the value is that of
    stage B's differentiable gather to the bit and the two agree on every
    ``alpha > thres``."""
    fold = 16  # the JAX package's: 16 bases of a 1-channel row make 128 values
    grid = params.density.grid.detach()
    dims = grid.shape[1:4]
    c01 = _bank_coords01(cfg, pts, params.density.num_freqs)
    total = None
    for b in range(grid.shape[0]):
        table = packed_ops.pack_corners_folded(grid[b], fold).reshape(-1, 8)
        base, w = packed_ops.corner_base_and_weights(c01[..., b, :], dims)
        rows = table.index_select(0, base.reshape(-1).clamp(0, table.shape[0] - 1))
        rows = rows.reshape(*base.shape, 8).to(torch.float32)
        v = rows[..., 0] * w[..., 0]
        for k in range(1, 8):
            v = v + rows[..., k] * w[..., k]
        total = v if total is None else total + v
    return total / grid.shape[0]


def _forward_train_two_stage(params, cfg, pts, t2, mask, viewdirs, interval, thres, bg,
                             bg_color, img_index, n_max):
    """Two-stage training forward (the JAX ``_forward_train_two_stage``):
    a no-grad density probe (:func:`_probe_density`) marks the samples with
    alpha > thres, each ray keeps its first ``train_survivor_budget`` of them
    (near -> far), and only those are gathered with a gradient, marched by
    the CUDA march at [N, train_survivor_budget] and coloured. A dropped
    sample has alpha 0 in the single-stage forward, which leaves the
    transmittance as it is and gets no gradient, so the outputs and every
    gradient equal the single-stage forward's wherever no ray has more
    survivors than the budget; a ray with more loses its far tail
    (``color_overflow_frac``). Every per-sample output is compacted to
    [N, train_survivor_budget] alike, so the training losses pair them."""
    tb = cfg.train_survivor_budget
    with torch.no_grad(), span("forward/probe"):
        alpha_probe = alpha_ops.raw2alpha(_probe_density(params, cfg, pts.detach()),
                                          params.act_shift, interval)
        mask1 = mask & (alpha_probe > thres)
        overflow_frac = (mask1.sum(dim=-1) > tb).to(torch.float32).mean()
        sel, sel_mask = sampling.compact_samples(mask1, tb)
    with span("forward/density_k0"):
        g = sampling.gather_samples(torch.cat([pts, t2[..., None]], dim=-1), sel)
        pts_c, t_c = g[..., :3], g[..., 3]
        density, k0 = _query(params, cfg, pts_c)
    with span("forward/march"):
        alpha, weights, alphainv_last, mask_c = common.march(
            density, sel_mask, params.act_shift, interval, thres)
    with span("forward/rgb"):
        rgb = rgb_of(params, cfg, k0, viewdirs, img_index)
        rgb_marched = common.composite(weights, rgb, alphainv_last,
                                       bg if bg_color is None else bg_color)
    s_c = 1.0 - 1.0 / (1.0 + t_c)
    return common.RenderResult(
        rgb_marched=rgb_marched, alphainv_last=alphainv_last, weights=weights,
        raw_alpha=alpha, raw_rgb=rgb, raw_density=density, mask=mask_c, t=t_c, s=s_c,
        depth=torch.sum(weights * s_c, dim=-1), n_max=n_max,
        color_overflow_frac=overflow_frac)


def forward(
    params: FourierGridParams,
    cfg: FourierGridConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs: torch.Tensor,
    *,
    stepsize: float | None = None,
    bg: float = 0.0,
    bg_color: torch.Tensor | None = None,
    fast_color_thres: float | None = None,
    cache: RenderCache | None = None,
    img_index: torch.Tensor | None = None,
) -> common.RenderResult:
    """Volume rendering. ``bg_color`` [N, 3] is the random background of
    ``rand_bkgd`` training (drawn by the caller); otherwise the constant
    ``bg`` is composited. ``stepsize`` and ``fast_color_thres`` override the
    config's values. ``img_index`` [N] picks each ray's appearance embedding.
    ``cache`` (rendering with frozen params) routes the field queries through
    pre-packed tables: the two-stage forward when the cache has split
    tables, ``color_budget > 0`` and the threshold is on, else the
    single-stage forward over fused tables. Without a cache, a
    ``train_survivor_budget`` under the sample count and a threshold at
    ``train_two_stage_thres`` or over take the two-stage training forward."""
    stepsize = cfg.stepsize if stepsize is None else stepsize
    thres = cfg.fast_color_thres if fast_color_thres is None else fast_color_thres
    N = rays_o.shape[0]
    interval = stepsize * cfg.voxel_size_ratio_density

    with common.sample_grad(rays_o, rays_d), span("forward/sample"):
        pts, _, t = sample_ray(cfg, rays_o, rays_d)
        S = pts.shape[1]
        n_max = S
        t2 = t.expand(N, S)
        mask = torch.ones((N, S), dtype=torch.bool, device=rays_o.device)
        if 0 < cfg.sample_budget < S:
            sel, mask = budget_select(params, cfg, pts, rays_o, rays_d, t)
            stacked = sampling.gather_samples(torch.cat([pts, t2[..., None]], dim=-1), sel)
            pts = stacked[..., :3]
            t2 = stacked[..., 3]

    # thres <= 0 keeps every sample's weight "surviving", so the color_budget
    # compaction would cut rays to their first color_budget samples: that
    # regime falls through to the single-stage path
    if (cache is not None and cache.density_tables is not None and cfg.color_budget > 0
            and thres > 0 and _fused_banks(params)):
        if bg_color is not None:
            raise ValueError("the two-stage cached forward is a render path: no bg_color")
        return _forward_two_stage(params, cfg, cache, pts, t2, mask, viewdirs, interval,
                                  thres, bg, img_index, n_max)
    if (cache is None and 0 < cfg.train_survivor_budget < pts.shape[1] and thres > 0
            and thres >= cfg.train_two_stage_thres and _fused_banks(params)
            and cfg.fourier_freq_num > 0):
        return _forward_train_two_stage(params, cfg, pts, t2, mask, viewdirs, interval, thres,
                                        bg, bg_color, img_index, n_max)

    with span("forward/density_k0"):
        if cache is not None and cache.tables is not None and _use_packed(params, cfg):
            # rendering: tables packed once, one row gather per bank. (A
            # two-stage cache has tables=None and takes the grids below.)
            B = params.density.grid.shape[0]
            c01 = _bank_coords01(cfg, pts, params.density.num_freqs)
            vals = _packed_bank_sum(cache.tables, c01, params.density.grid.shape[1:4],
                                    1 + cfg.k0_dim) / B
            density, k0 = vals[..., 0], vals[..., 1:]
        else:
            density, k0 = _query(params, cfg, pts)
    with span("forward/march"):
        alpha, weights, alphainv_last, mask = common.march(
            density, mask, params.act_shift, interval, thres)
    with span("forward/rgb"):
        rgb = rgb_of(params, cfg, k0, viewdirs, img_index)
        rgb_marched = common.composite(weights, rgb, alphainv_last,
                                       bg if bg_color is None else bg_color)
    s = 1.0 - 1.0 / (1.0 + t2)
    depth = torch.sum(weights * s, dim=-1)
    return common.RenderResult(
        rgb_marched=rgb_marched,
        alphainv_last=alphainv_last,
        weights=weights,
        raw_alpha=alpha,
        raw_rgb=rgb,
        raw_density=density,
        mask=mask,
        t=t2,
        s=s,
        depth=depth,
        n_max=n_max,
    )


# ---------------------------------------------------------------------------
# occupancy-adaptive budgets and the adaptive render


def _round8(v: float, lo: int, hi: int) -> int:
    return int(np.clip(-(-int(v) // 8) * 8, lo, hi))


def _default_coarse_stride(cfg: FourierGridConfig) -> int:
    """The hierarchical probe's stride that :func:`suggest_budgets` proposes
    where the config sets none: 8, rounded up to a multiple of
    ``2 * budget_probe_stride`` (which :func:`budget_select` requires; the
    JAX function proposes 8 whatever the probe stride)."""
    m = 2 * max(1, cfg.budget_probe_stride)
    return -(-8 // m) * m


@torch.no_grad()
def suggest_budgets(params: FourierGridParams, cfg: FourierGridConfig, rays_o, rays_d,
                    viewdirs, *, quantile: float = 0.999, chunk: int = 1024, slack: int = 8,
                    cache: RenderCache | None = None) -> dict:
    """Budgets sized from the trained scene's own occupancy over a set of
    probe rays (the JAX ``suggest_budgets``): per ray the flat probe's
    occupied samples (for ``sample_budget``), the full-march forward's
    survivors of the weights threshold (``color_budget``) and the stride
    groups of ``probe_coarse_stride`` samples that hold an occupied sample
    (``probe_candidate_groups``, widened by half and 2 for the coarse mask's
    dilation), each at ``quantile`` plus ``slack``, the budgets rounded up
    to multiples of 8. Rays past the quantile lose their far tail.

    ``cache``: a single-stage render cache (``build_render_cache`` of the
    config with ``color_budget`` 0), through which the full-march forward
    reads its corner tables; without one it gathers from the grids. Every
    ray is taken, ``chunk`` at a time (the last chunk may be short).

    Returns dict(sample_budget, color_budget, probe_coarse_stride,
    probe_candidate_groups, occ_q, surv_q, groups_q, occ_max, surv_max,
    groups_max, n_rays)."""
    cfg_full = dataclasses.replace(cfg, sample_budget=0, color_budget=0,
                                   train_survivor_budget=0, density_bake_scale=0.0,
                                   probe_coarse_stride=0)
    S = 2 * cfg.n_inner
    cs = max(2, int(cfg.probe_coarse_stride) or _default_coarse_stride(cfg))
    n_g = -(-S // cs)
    n_occ, n_sur, n_grp = [], [], []
    for a in range(0, rays_o.shape[0], chunk):
        ro, rd, vd = (x[a:a + chunk] for x in (rays_o, rays_d, viewdirs))
        pre = _flat_probe(params, cfg_full, sample_ray(cfg_full, ro, rd)[0])
        res = forward(params, cfg_full, ro, rd, vd, bg=1.0, cache=cache)
        groups = F.pad(pre, (0, n_g * cs - S)).reshape(-1, n_g, cs).any(-1).sum(-1)
        n_occ.append(pre.sum(-1))
        n_sur.append(res.mask.sum(-1))
        n_grp.append(groups)
    n_occ, n_sur, n_grp = (torch.cat(v).cpu().numpy() for v in (n_occ, n_sur, n_grp))
    occ_q, sur_q, grp_q = (float(np.quantile(v, quantile)) for v in (n_occ, n_sur, n_grp))
    sb = _round8(occ_q + slack, 16, S)
    return {
        "sample_budget": sb,
        "color_budget": _round8(sur_q + slack, 8, sb),
        "probe_coarse_stride": cs,
        "probe_candidate_groups": int(np.clip(np.ceil(grp_q * 1.5) + 2, 4, n_g)),
        "occ_q": occ_q, "surv_q": sur_q, "groups_q": grp_q,
        "occ_max": int(n_occ.max()), "surv_max": int(n_sur.max()),
        "groups_max": int(n_grp.max()), "n_rays": int(n_occ.size),
    }


@torch.no_grad()
def render_rays_adaptive(params: FourierGridParams, cfg: FourierGridConfig,
                         cache: RenderCache, rays_o, rays_d, viewdirs, *, bg: float = 0.0,
                         seg: int = 32, img_index=None, report: dict | None = None):
    """The adaptive render (the JAX ``render_rays_adaptive``): the render's
    counterpart of the reference renderer's per-ray early exit.

    Phase A takes every ray's ``sample_budget`` samples (the flat probe) and
    the density of its first ``seg`` of them from the two-stage cache; a ray
    stays alive while the transmittance after them is at least the early
    exit's 1e-3 and it has budget samples left. One host sync reads the
    count of live rays and picks the smallest power-of-two bucket (N/16 to
    N) that holds them; phase B takes the density of the rest of the samples
    for that bucket of rays only (``topk`` on the live flag). The march runs
    on the assembled densities through the CUDA march (``common.march``),
    the live mask being the budget's selection, and for the tail the ray's
    being alive: a dead ray's tail enters at a transmittance under 1e-3 and
    gets no weight either way, so the result is the two-stage cached
    forward's. Then each ray's first ``color_budget`` survivors are
    coloured, as there. Plain Python: nothing is compiled, so nothing is
    cached per shape.

    Needs a two-stage cache (split tables) and ``0 < seg < sample_budget``.
    Returns (rgb [N, 3], depth [N], alphainv_last [N]); ``report``, if
    given, receives "alive" (the live rays after phase A), "bucket" and
    "mask" (the live samples after the march's thresholds, [N, S])."""
    if cache is None or cache.density_tables is None:
        raise ValueError("render_rays_adaptive needs a two-stage render cache")
    S = cfg.sample_budget
    if not 0 < seg < S:
        raise ValueError(f"seg {seg} must lie in (0, sample_budget {S})")
    N = rays_o.shape[0]
    interval = cfg.stepsize * cfg.voxel_size_ratio_density
    thres = cfg.fast_color_thres
    dims = params.density.grid.shape[1:4]

    with span("adaptive/phase_a"):
        pts_all, _, t = sample_ray(cfg, rays_o, rays_d)
        sel, sel_mask = sampling.compact_samples(_flat_probe(params, cfg, pts_all), S)
        g = sampling.gather_samples(
            torch.cat([pts_all, t.expand(N, t.shape[0])[..., None]], dim=-1), sel)
        pts, t2 = g[..., :3], g[..., 3]
        del pts_all, g
        density_a = _cache_density(cfg, cache, pts[:, :seg], dims)
        alpha_a = alpha_ops.raw2alpha(density_a, params.act_shift, interval)
        live_a = sel_mask[:, :seg] & (alpha_a > thres) if thres > 0 else sel_mask[:, :seg]
        t_after = torch.prod(1.0 - torch.where(live_a, alpha_a, torch.zeros_like(alpha_a)),
                             dim=-1)
        alive = (t_after >= alpha_ops.EARLY_EXIT_T) & sel_mask[:, seg:].any(-1)
    n_alive = int(alive.sum())  # the one host sync of a call
    bucket = next((b for b in (N // 16, N // 8, N // 4, N // 2) if b >= n_alive and b > 0), N)
    if report is not None:
        report.update(alive=n_alive, bucket=bucket)

    with span("adaptive/phase_b"):
        idx = torch.topk(alive.to(torch.int32), bucket).indices
        density_b = _cache_density(cfg, cache, pts[idx, seg:], dims)
    with span("adaptive/finish"):
        density = torch.zeros((N, S), dtype=density_a.dtype, device=density_a.device)
        density[:, :seg] = density_a
        density[idx, seg:] = density_b
        mask = torch.zeros_like(sel_mask)
        mask[:, :seg] = sel_mask[:, :seg]
        mask[idx, seg:] = sel_mask[idx, seg:] & alive[idx, None]
        _, weights, alphainv_last, mask = common.march(density, mask, params.act_shift,
                                                       interval, thres)
        if report is not None:
            report["mask"] = mask
        cb = min(cfg.color_budget if cfg.color_budget > 0 else S, S)
        rgb_marched, _ = _colour_survivors(params, cfg, cache, pts, weights, mask,
                                           alphainv_last, viewdirs, img_index, bg, cb)
        depth = torch.sum(weights * (1.0 - 1.0 / (1.0 + t2)), dim=-1)
    return rgb_marched, depth, alphainv_last


# ---------------------------------------------------------------------------
# dense field evaluation and the single-bank bake


def _linspace(lo: float, hi: float, n: int, device) -> torch.Tensor:
    """``jnp.linspace(lo, hi, n)`` in f32, by its formula
    (lo * (1 - i/(n-1)) + hi * i/(n-1), the end point exact), so that lattice
    nodes agree with the JAX package's to the last bit where possible."""
    if n == 1:
        return torch.tensor([lo], dtype=torch.float32, device=device)
    step = torch.arange(n - 1, dtype=torch.float32, device=device) / float(n - 1)
    body = lo * (1.0 - step) + hi * step
    return torch.cat([body, torch.tensor([hi], dtype=torch.float32, device=device)])


def _bank_coord(coords: torch.Tensor, bank: int) -> torch.Tensor:
    """Bank ``bank`` of ``nerf_pos_embed_coords(coords, K)`` without the others."""
    if bank == 0:
        return coords
    scaled = coords * (2.0 ** ((bank - 1) // 2))
    return torch.sin(scaled) if bank % 2 == 1 else torch.cos(scaled)


def _eval_field_on_lattice(field, xyz_min, xyz_max, ws, out_ch: int,
                           max_pts_per_slab: int = 1 << 20) -> torch.Tensor:
    """Dense multi-bank field evaluation on a [X, Y, Z] world lattice through
    the packed tables, in x-slabs that bound peak memory. f32 throughout
    (``packed_trilerp`` promotes); the caller casts once at the end."""
    X, Y, Z = (int(v) for v in ws)
    grid = field.grid.detach()
    dev = grid.device
    slab = max(1, min(X, max_pts_per_slab // max(Y * Z, 1)))
    xs = _linspace(xyz_min[0], xyz_max[0], X, dev)
    ys = _linspace(xyz_min[1], xyz_max[1], Y, dev)
    zs = _linspace(xyz_min[2], xyz_max[2], Z, dev)
    B = grid.shape[0]
    dims = grid.shape[1:4]
    mn = torch.tensor(field.xyz_min, dtype=torch.float32, device=dev)
    mx = torch.tensor(field.xyz_max, dtype=torch.float32, device=dev)
    acc = torch.zeros((X, Y, Z, out_ch), dtype=torch.float32, device=dev)
    with torch.no_grad():
        for b in range(B):
            table = packed_ops.pack_corners(grid[b])
            for a in range(0, X, slab):
                xyz = torch.stack(torch.meshgrid(xs[a:a + slab], ys, zs, indexing="ij"), -1)
                coords = ((xyz - mn) / (mx - mn)) * 2.0 - 1.0
                c01 = (_bank_coord(coords, b) + 1.0) * 0.5
                base, w = packed_ops.corner_base_and_weights(c01, dims)
                acc[a:a + slab] += packed_ops.packed_trilerp(table, base, w, out_ch)
            del table
    return acc / B


def bake_for_rendering(params: FourierGridParams, cfg: FourierGridConfig,
                       scale: float = 1.26, max_pts_per_slab: int = 1 << 20):
    """Bake the Fourier-bank field into a single-bank grid for fast rendering
    (APPROXIMATE: a "baking"-style export).

    Evaluates density and k0 of the full [2K+1]-bank model on a dense world
    lattice (``scale`` upsamples the linear resolution to absorb the content
    of the high-frequency banks) and returns (params_baked, cfg_baked) with
    ``fourier_freq_num=0``: ONE bank instead of 2K+1. The rgb MLP, act_shift
    and the occupancy cache carry over (shared, not copied), and so do the view-direction grid and the
    appearance embeddings."""
    new_cfg = dataclasses.replace(
        cfg, fourier_freq_num=0,
        num_voxels_density=int(cfg.num_voxels_density * scale**3),
        num_voxels_rgb=int(cfg.num_voxels_rgb * scale**3))
    dt = _DTYPES[cfg.grid_dtype]
    fields = {}
    for name, ws, ch in (("density", new_cfg.world_size_density, 1),
                         ("k0", new_cfg.world_size_rgb, cfg.k0_dim)):
        src = getattr(params, name)
        baked = _eval_field_on_lattice(src, cfg.xyz_min, cfg.xyz_max, ws, ch,
                                       max_pts_per_slab).to(dt)
        fields[name] = FourierGrid(ch, ws, src.xyz_min, src.xyz_max, num_freqs=0,
                                   grid=baked[None])
    baked_params = FourierGridParams(fields["density"], fields["k0"], params.rgbnet,
                                     params.act_shift, params.mask_cache, vd=params.vd,
                                     img_embeddings=params.img_embeddings)
    return baked_params, new_cfg


# ---------------------------------------------------------------------------
# the pg_scale boundary: progressive upsampling and the occupancy refresh


def activate_density(params: FourierGridParams, cfg: FourierGridConfig,
                     density: torch.Tensor) -> torch.Tensor:
    return alpha_ops.raw2alpha(density, params.act_shift, cfg.voxel_size_ratio_density)


def _dense_alpha_chunked(params: FourierGridParams, cfg: FourierGridConfig, ws,
                         max_pts_per_slab: int = 1 << 21) -> torch.Tensor:
    """Alpha on the full [X, Y, Z] world lattice, evaluated in x-slabs: one
    query of 199^3 nodes over 7 banks holds 10 GB of corner indices, weights
    and rows; a slab of 2M nodes about 1.3 GB. The values do not depend on
    the slab, which is why it may be smaller here than the JAX package's
    default of 1 << 24 nodes: eager PyTorch holds every intermediate of the
    query at once, where a compiled query fuses them. On a density cut over
    a grid group every rank queries the whole lattice (the halo sample), in
    slabs of ``max_pts_per_slab`` over the group's size, so that a rank's
    transient shrinks with its share of the grid."""
    X, Y, Z = (int(v) for v in ws)
    dev = params.density.grid.device
    shard = params.density.shard
    if shard is not None:
        max_pts_per_slab //= shard.count
    slab = max(1, min(X, max_pts_per_slab // max(Y * Z, 1)))
    xs = _linspace(cfg.xyz_min[0], cfg.xyz_max[0], X, dev)
    ys = _linspace(cfg.xyz_min[1], cfg.xyz_max[1], Y, dev)
    zs = _linspace(cfg.xyz_min[2], cfg.xyz_max[2], Z, dev)
    out = torch.empty((X, Y, Z), dtype=torch.float32, device=dev)
    with torch.no_grad():
        for a in range(0, X, slab):
            xyz = torch.stack(torch.meshgrid(xs[a:a + slab], ys, zs, indexing="ij"), -1)
            out[a:a + slab] = activate_density(params, cfg, params.density(xyz)[..., 0])
    return out


def _occupancy_dilation_window(cfg: FourierGridConfig) -> int:
    """Max-pool window of the occupancy refresh: the reference's 3^3, widened
    so that a strided budget probe stays conservative. The probe's verdict is
    repeated over its stride group, whose last sample sits stride - 1 steps
    past the probe, so the mask is dilated by that many voxels (at a stepsize
    of at most one voxel a step)."""
    stride = max(1, cfg.budget_probe_stride)
    if stride <= 2:
        return 3
    return 2 * (stride - 1) + 1


def _pooled_alpha(params: FourierGridParams, cfg: FourierGridConfig, ws) -> torch.Tensor:
    return interp.max_pool_3d_same(_dense_alpha_chunked(params, cfg, ws),
                                   window=_occupancy_dilation_window(cfg))


def scale_volume_grid(params: FourierGridParams, cfg: FourierGridConfig,
                      num_voxels_density: int, num_voxels_rgb: int,
                      report: dict | None = None):
    """Progressive upsampling of both grids and the occupancy refresh that
    follows it. Returns (params, new config); ``params`` is changed in place:
    its two grids become new parameters at the new size (so an optimizer
    built on the old ones is void) and its occupancy cache a mask on the new
    density lattice: the OLD mask looked up at the new lattice's nodes, and
    the 3^3-or-wider max-pool of the new alpha above ``fast_color_thres``.
    ``report``, if given, receives the seconds of the two halves ("resize",
    "refresh"), each ended by a device synchronise, "carried": the share
    of the new lattice's nodes that the old mask holds, which the refresh can
    only lower, and "pooled_alpha": the tensor [X, Y, Z] that the refresh held
    against ``fast_color_thres``.

    Grids cut along x over a grid group (``--grid_parallel``) are resized
    slab by slab (``FourierGrid.scale_volume_grid``), and the refresh's
    queries go through the halo sample that the forward takes on a cut
    grid: every rank of the group makes them together and gets the whole
    alpha, so the mask stays whole on every rank."""
    new_cfg = cfg.with_num_voxels(num_voxels_density, num_voxels_rgb)
    dev = params.density.grid.device
    t0 = time.perf_counter()
    params.density.scale_volume_grid(new_cfg.world_size_density)
    params.k0.scale_volume_grid(new_cfg.world_size_rgb)
    if report is not None:
        report["resize"] = seconds_since(t0, dev)
    t0 = time.perf_counter()
    ws = new_cfg.world_size_density
    with torch.no_grad():
        pooled = _pooled_alpha(params, new_cfg, ws)
        axes = [_linspace(mn, mx, n, dev) for mn, mx, n in zip(cfg.xyz_min, cfg.xyz_max, ws)]
        xyz = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)
        carried = params.mask_cache(xyz)
        new_mask = carried & (pooled > new_cfg.fast_color_thres)
    params.mask_cache = MaskGrid(ws, cfg.xyz_min, cfg.xyz_max, mask=new_mask)
    if report is not None:
        report["refresh"] = seconds_since(t0, dev)
        report["carried"] = float(carried.float().mean())
        report["pooled_alpha"] = pooled
    return params, new_cfg


def update_occupancy_cache(params: FourierGridParams, cfg: FourierGridConfig):
    """The occupancy cache ANDed with the pooled alpha of the density as it
    stands, on the cache's own lattice; in place, returns ``params``."""
    mask = params.mask_cache.mask
    with torch.no_grad():
        pooled = _pooled_alpha(params, cfg, mask.shape)
    params.mask_cache.mask = mask & (pooled > cfg.fast_color_thres)
    return params


@torch.no_grad()
def maskout_near_cam_vox(params: FourierGridParams, cfg: FourierGridConfig, cam_o,
                         near_clip: float) -> FourierGridParams:
    """The JAX ``maskout_near_cam_vox`` of this family: in every bank, the
    density of each node of the [-1, 1] lattice within ``near_clip`` of a
    camera centre (``cam_o`` [C, 3]) at that bank's embedded coordinate set
    to -100, in place; returns ``params``. Nearest distances are kept a
    camera at a time."""
    grid = params.density.grid
    dev = grid.device
    mn = torch.tensor(cfg.xyz_min, dtype=torch.float32, device=dev)
    mx = torch.tensor(cfg.xyz_max, dtype=torch.float32, device=dev)
    cams = torch.as_tensor(np.asarray(cam_o), dtype=torch.float32, device=dev)
    ind_norm = (cams - mn) / (mx - mn) * 2.0 - 1.0
    if cfg.fourier_freq_num > 0:
        bank_cams = nerf_pos_embed_coords(ind_norm, cfg.fourier_freq_num).permute(1, 0, 2)
    else:
        bank_cams = ind_norm[None]
    axes = [_linspace(-1.0, 1.0, int(n), dev) for n in cfg.world_size_density]
    xyz = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)
    for b, cams_b in enumerate(bank_cams):
        d2 = None
        for c in cams_b:
            diff = xyz - c
            s = diff[..., 0] ** 2 + diff[..., 1] ** 2 + diff[..., 2] ** 2
            d2 = s if d2 is None else torch.minimum(d2, s)
        near = mesh_mod.x_slab(torch.sqrt(d2) <= near_clip, params.density.shard, axis=0)
        grid.data[b][near] = -100.0
    return params
