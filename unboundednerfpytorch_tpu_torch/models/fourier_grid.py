"""FourierGrid: the paper model: the single-stage training forward and the
cached render forwards.

Counterpart of ``unboundednerfpytorch_tpu/models/fourier_grid.py``:
``FourierGridConfig``, ``config_from``, ``create``, ``sample_ray``,
``budget_select`` (flat strided probe), ``forward`` with ``_rgb_head`` and
``_bank_coords01``, and the render half: ``RenderCache``,
``build_render_cache``, the two-stage cached forward
(``_forward_two_stage``), the single-stage cache branch,
``_eval_field_on_lattice`` and ``bake_for_rendering``.

A training forward (no cache) gathers the eight corners from the grids
themselves (one gather over all banks of a grid, one index-add in the
backward); its values equal the JAX forward's packed-corner tables. A render
forward with a :class:`RenderCache` reads the pre-packed tables of
:mod:`..ops.packed`, in the JAX package's layout. The raw2alpha + early-exit
scan runs as the fused CUDA march (:mod:`..ops.cuda.march`) on every path;
the ``alpha > thres`` mask that the JAX forward builds before the scan is
computed here without grad and handed to it.

Not ported yet (and refused rather than ignored): the hierarchical probe
(``probe_coarse_stride``), the two-stage training forward
(``train_survivor_budget``), the view-direction grid, appearance
embeddings and the coarse (``rgbnet_dim <= 0``) color head.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from unboundednerfpytorch_tpu_torch.configs.schema import normalize_fast_color_thres
from unboundednerfpytorch_tpu_torch.fields.grids import FourierGrid, MaskGrid, nerf_pos_embed_coords
from unboundednerfpytorch_tpu_torch.fields.mlp import MLP
from unboundednerfpytorch_tpu_torch.models import common
from unboundednerfpytorch_tpu_torch.ops import alpha as alpha_ops
from unboundednerfpytorch_tpu_torch.ops import interp, sampling
from unboundednerfpytorch_tpu_torch.ops import packed as packed_ops
from unboundednerfpytorch_tpu_torch.ops.cuda.march import fused_alpha2weights


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
    probe_coarse_stride: int = 0
    # two-stage render (cache path only): after the density pass and the
    # scan, each ray keeps its first `color_budget` samples with
    # weights > fast_color_thres for the k0 gathers and the rgb MLP (0 = off)
    color_budget: int = 0
    # render-only density bake (two-stage cache): the [2K+1]-bank density
    # resampled onto ONE bank at `scale`x linear resolution. Approximate;
    # color stays exact; never affects training (0 = off)
    density_bake_scale: float = 0.0
    density_bake_dtype: str = "float32"  # or "bfloat16"
    train_survivor_budget: int = 0

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
    def rgbnet_in_dim(self) -> int:
        return 3 + 3 * self.viewbase_pe * 2 + self.k0_dim + max(self.img_emb_dim, 0)


def config_from(cfg_model, xyz_min, xyz_max, num_voxels_density, num_voxels_rgb,
                sample_num: int = -1) -> FourierGridConfig:
    xyz_min = np.asarray(xyz_min, np.float64)
    xyz_max = np.asarray(xyz_max, np.float64)
    cfg = FourierGridConfig(
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
        color_budget=cfg_model.color_budget,
        density_bake_scale=cfg_model.density_bake_scale,
        density_bake_dtype=cfg_model.density_bake_dtype,
        train_survivor_budget=cfg_model.train_survivor_budget,
    )
    _check_supported(cfg)
    return cfg


def _check_supported(cfg: FourierGridConfig) -> None:
    unsupported = {
        "probe_coarse_stride > 1 (hierarchical probe)": cfg.probe_coarse_stride > 1,
        "train_survivor_budget > 0 (two-stage training forward)":
            cfg.train_survivor_budget > 0,
        "num_voxels_viewdir > 0 (view-direction grid)": cfg.num_voxels_viewdir > 0,
        "img_emb_dim > 0 with sample_num > 0 (appearance embeddings)":
            cfg.img_emb_dim > 0 and cfg.sample_num > 0,
        "rgbnet_dim <= 0 (coarse color head)": cfg.rgbnet_dim <= 0,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError("not ported yet: " + "; ".join(bad))


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class FourierGridParams(nn.Module):
    """density [2K+1, X, Y, Z, 1], k0 [2K+1, X, Y, Z, k0_dim], the rgb MLP,
    the occupancy cache and ``act_shift``. ``act_shift`` is a host float: it
    changes only between stages, and the march kernel takes it as a launch
    argument (a device scalar would cost a sync per step)."""

    def __init__(self, density: FourierGrid, k0: FourierGrid, rgbnet: MLP,
                 act_shift: float, mask_cache: MaskGrid):
        super().__init__()
        self.density = density
        self.k0 = k0
        self.rgbnet = rgbnet
        self.act_shift = float(act_shift)
        self.mask_cache = mask_cache


def create(cfg: FourierGridConfig, generator: torch.Generator | None = None,
           device=None) -> FourierGridParams:
    """Zero grids, an all-true occupancy cache and a U(+-1/sqrt(fan_in)) MLP
    drawn from ``generator`` (a CPU generator; values are then moved)."""
    _check_supported(cfg)
    dt = _DTYPES[cfg.grid_dtype]
    density = FourierGrid(1, cfg.world_size_density, cfg.xyz_min, cfg.xyz_max,
                          num_freqs=cfg.fourier_freq_num, dtype=dt, device=device)
    k0 = FourierGrid(cfg.k0_dim, cfg.world_size_rgb, cfg.xyz_min, cfg.xyz_max,
                     num_freqs=cfg.fourier_freq_num, dtype=dt, device=device)
    rgbnet = MLP(cfg.rgbnet_in_dim, cfg.rgbnet_width, 3, cfg.rgbnet_depth,
                 generator=generator, device=device)
    mask_cache = MaskGrid(cfg.world_size_density, cfg.xyz_min, cfg.xyz_max, device=device)
    return FourierGridParams(density, k0, rgbnet, cfg.act_shift, mask_cache)


def sample_ray(cfg: FourierGridConfig, rays_o: torch.Tensor, rays_d: torch.Tensor):
    """Contracted sampling with t_boundary: (pts [N, S, 3], inner [N, S], t [S])."""
    center = torch.tensor(cfg.scene_center, dtype=rays_o.dtype, device=rays_o.device)
    radius = torch.tensor(cfg.scene_radius, dtype=rays_o.dtype, device=rays_o.device)
    o = (rays_o - center) / radius
    d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    t = sampling.contracted_t_values(cfg.n_inner, cfg.n_inner, t_boundary=cfg.t_boundary,
                                     dtype=rays_o.dtype, device=rays_o.device)
    pts = o[:, None, :] + d[:, None, :] * t[None, :, None]
    pts, inner = sampling.contract(pts, bg_len=cfg.bg_len, norm_type=cfg.contracted_norm)
    return pts, inner, t


def budget_select(params: FourierGridParams, cfg: FourierGridConfig, pts: torch.Tensor):
    """Flat strided occupancy probe: (sel [N, budget], sel_mask). Every
    ``budget_probe_stride``-th sample is tested against the mask cache and
    its verdict is repeated over its stride group."""
    S = pts.shape[1]
    stride = max(1, cfg.budget_probe_stride)
    if stride > 1:
        pre = params.mask_cache(pts[:, ::stride]).repeat_interleave(stride, dim=1)[:, :S]
    else:
        pre = params.mask_cache(pts)
    return sampling.compact_samples(pre, cfg.sample_budget)


def _bank_coords01(cfg: FourierGridConfig, pts: torch.Tensor,
                   num_freqs: int | None = None) -> torch.Tensor:
    """Per-bank query coords in [0, 1]: [..., B, 3]."""
    mn = torch.tensor(cfg.xyz_min, dtype=pts.dtype, device=pts.device)
    mx = torch.tensor(cfg.xyz_max, dtype=pts.dtype, device=pts.device)
    coords = ((pts - mn) / (mx - mn)) * 2.0 - 1.0
    freqs = cfg.fourier_freq_num if num_freqs is None else num_freqs
    return (nerf_pos_embed_coords(coords, freqs) + 1.0) * 0.5


def _rgb_head(params: FourierGridParams, cfg: FourierGridConfig, k0, viewdirs):
    N, S = k0.shape[:2]
    vemb = common.viewdir_embedding(viewdirs, cfg.viewbase_pe)
    feats = torch.cat([k0, vemb[:, None, :].expand(N, S, vemb.shape[-1])], dim=-1)
    return torch.sigmoid(params.rgbnet(feats))


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
    and resolution match, single-bank (num_freqs == 0) models included."""
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

    with torch.no_grad(), record_function("render/cache_build"):
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


def _march(params, density, mask, interval, thres):
    """alpha -> threshold mask -> fused scan -> weights threshold: (raw alpha,
    weights, alphainv_last, mask)."""
    shift = params.act_shift
    with torch.no_grad():
        alpha = alpha_ops.raw2alpha(density, shift, interval)
        if thres > 0:
            mask = mask & (alpha > thres)
    weights, alphainv_last, _ = fused_alpha2weights(density, mask, shift, interval)
    if thres > 0:
        mask = mask & (weights > thres)
        weights = weights * mask.to(weights.dtype)
    return alpha, weights, alphainv_last, mask


def _forward_two_stage(params, cfg, cache, pts, t2, mask, viewdirs, interval, thres,
                       bg, n_max):
    """Two-stage cached render: narrow density rows -> alpha -> weights ->
    per-ray color_budget compaction -> color rows + MLP -> composite.

    Exact w.r.t. the single-stage path whenever no ray has more than
    ``color_budget`` samples with weights > thres (near->far order is kept,
    so any truncation drops the lowest-transmittance tail)."""
    S = pts.shape[1]
    dims = params.density.grid.shape[1:4]

    # stage 1: density from the narrow packed rows
    with record_function("forward/density"):
        density = _cache_density(cfg, cache, pts, dims)
    with record_function("forward/march"):
        alpha, weights, alphainv_last, mask = _march(params, density, mask, interval, thres)

    # stage 2: color only for each ray's survivors
    with record_function("forward/compact"):
        cb = min(cfg.color_budget, S)
        overflow_frac = (mask.sum(dim=-1) > cb).to(torch.float32).mean()
        sel2, sel2_mask = sampling.compact_samples(mask, cb)
        g = sampling.gather_samples(
            torch.cat([pts, weights[..., None].to(pts.dtype)], dim=-1), sel2)
        pts_c = g[..., :3]
        w_c = g[..., 3].to(weights.dtype) * sel2_mask.to(weights.dtype)
    with record_function("forward/k0"):
        c01c = _bank_coords01(cfg, pts_c)
        k0 = _packed_bank_sum(cache.k0_tables, c01c, dims, cfg.k0_dim) / len(cache.k0_tables)
    with record_function("forward/rgb"):
        rgb = _rgb_head(params, cfg, k0, viewdirs)
        rgb_marched = common.composite(w_c, rgb, alphainv_last, bg)

    s = 1.0 - 1.0 / (1.0 + t2)
    depth = torch.sum(weights * s, dim=-1)
    return common.RenderResult(
        rgb_marched=rgb_marched, alphainv_last=alphainv_last, weights=weights,
        raw_alpha=alpha, raw_rgb=rgb,  # compacted [N, color_budget, 3]
        raw_density=density, mask=mask, t=t2, s=s, depth=depth, n_max=n_max,
        color_overflow_frac=overflow_frac, rgb_compacted=True)


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
) -> common.RenderResult:
    """Volume rendering. ``bg_color`` [N, 3] is the random background of
    ``rand_bkgd`` training (drawn by the caller); otherwise the constant
    ``bg`` is composited. ``stepsize`` and ``fast_color_thres`` override the
    config's values. ``cache`` (rendering with frozen params) routes the
    field queries through pre-packed tables: the two-stage forward when the
    cache has split tables, ``color_budget > 0`` and the threshold is on,
    else the single-stage forward over fused tables."""
    stepsize = cfg.stepsize if stepsize is None else stepsize
    thres = cfg.fast_color_thres if fast_color_thres is None else fast_color_thres
    N = rays_o.shape[0]
    interval = stepsize * cfg.voxel_size_ratio_density

    with torch.no_grad(), record_function("forward/sample"):
        pts, _, t = sample_ray(cfg, rays_o, rays_d)
        S = pts.shape[1]
        n_max = S
        t2 = t.expand(N, S)
        mask = torch.ones((N, S), dtype=torch.bool, device=rays_o.device)
        if 0 < cfg.sample_budget < S:
            sel, mask = budget_select(params, cfg, pts)
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
                                  thres, bg, n_max)

    with record_function("forward/density_k0"):
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
    with record_function("forward/march"):
        alpha, weights, alphainv_last, mask = _march(params, density, mask, interval, thres)
    with record_function("forward/rgb"):
        rgb = _rgb_head(params, cfg, k0, viewdirs)
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
    and the occupancy cache carry over (shared, not copied)."""
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
                                     params.act_shift, params.mask_cache)
    return baked_params, new_cfg
