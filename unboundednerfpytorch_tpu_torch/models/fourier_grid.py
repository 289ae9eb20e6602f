"""FourierGrid: the paper model, single-stage training forward.

Counterpart of ``unboundednerfpytorch_tpu/models/fourier_grid.py``:
``FourierGridConfig``, ``config_from``, ``create``, ``sample_ray``,
``budget_select`` (flat strided probe) and ``forward`` on its single-stage
path, with ``_rgb_head`` and ``_bank_coords01``.

The JAX forward's packed-corner tables are a TPU gather layout; their values
equal ``grid_sample_3d``, which is what this port computes (one gather over
all banks of a grid, one index-add in the backward). Step 4 of the forward
(raw2alpha + early-exit scan) runs as the fused CUDA march
(:mod:`..ops.cuda.march`); the ``alpha > thres`` mask that the JAX forward
builds before the scan is computed here without grad and handed to it.

Not ported yet (and refused rather than ignored): the hierarchical probe
(``probe_coarse_stride``), the two-stage training forward
(``train_survivor_budget``), the view-direction grid, appearance
embeddings and the coarse (``rgbnet_dim <= 0``) color head. The render-cache
knobs of the JAX config (packed tables, ``color_budget``, density bake) are
never read by a training forward and are not part of this config.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from unboundednerfpytorch_tpu_torch.configs.schema import normalize_fast_color_thres
from unboundednerfpytorch_tpu_torch.fields.grids import FourierGrid, MaskGrid, nerf_pos_embed_coords
from unboundednerfpytorch_tpu_torch.fields.mlp import MLP
from unboundednerfpytorch_tpu_torch.models import common
from unboundednerfpytorch_tpu_torch.ops import alpha as alpha_ops
from unboundednerfpytorch_tpu_torch.ops import interp, sampling
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
    # flat probe: test every k-th sample against the mask cache
    budget_probe_stride: int = 1
    probe_coarse_stride: int = 0
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
        budget_probe_stride=cfg_model.budget_probe_stride,
        probe_coarse_stride=cfg_model.probe_coarse_stride,
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


def _bank_coords01(cfg: FourierGridConfig, pts: torch.Tensor) -> torch.Tensor:
    """Per-bank query coords in [0, 1]: [..., B, 3]."""
    mn = torch.tensor(cfg.xyz_min, dtype=pts.dtype, device=pts.device)
    mx = torch.tensor(cfg.xyz_max, dtype=pts.dtype, device=pts.device)
    coords = ((pts - mn) / (mx - mn)) * 2.0 - 1.0
    return (nerf_pos_embed_coords(coords, cfg.fourier_freq_num) + 1.0) * 0.5


def _rgb_head(params: FourierGridParams, cfg: FourierGridConfig, k0, viewdirs):
    N, S = k0.shape[:2]
    vemb = common.viewdir_embedding(viewdirs, cfg.viewbase_pe)
    feats = torch.cat([k0, vemb[:, None, :].expand(N, S, vemb.shape[-1])], dim=-1)
    return torch.sigmoid(params.rgbnet(feats))


def _query(params: FourierGridParams, cfg: FourierGridConfig, pts: torch.Tensor):
    """(density [N, S], k0 [N, S, k0_dim]) in f32. When both grids share bank
    structure and resolution (the fine config), the bank coords are computed
    once for both."""
    dg, kg = params.density.grid, params.k0.grid
    if dg.shape[:4] == kg.shape[:4] and params.density.num_freqs == params.k0.num_freqs:
        c01 = _bank_coords01(cfg, pts)
        B = dg.shape[0]
        density = interp.grid_sample_banks(dg, c01)[..., 0] / B
        k0 = interp.grid_sample_banks(kg, c01) / B
        return density, k0
    return params.density(pts)[..., 0], params.k0(pts)


def forward(
    params: FourierGridParams,
    cfg: FourierGridConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs: torch.Tensor,
    *,
    bg: float = 0.0,
    bg_color: torch.Tensor | None = None,
) -> common.RenderResult:
    """Volume rendering. ``bg_color`` [N, 3] is the random background of
    ``rand_bkgd`` training (drawn by the caller); otherwise the constant
    ``bg`` is composited."""
    thres = cfg.fast_color_thres
    N = rays_o.shape[0]
    interval = cfg.stepsize * cfg.voxel_size_ratio_density

    with torch.no_grad():
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

    density, k0 = _query(params, cfg, pts)

    shift = params.act_shift
    with torch.no_grad():
        alpha = alpha_ops.raw2alpha(density, shift, interval)
        if thres > 0:
            mask = mask & (alpha > thres)
    weights, alphainv_last, _ = fused_alpha2weights(density, mask, shift, interval)
    if thres > 0:
        mask = mask & (weights > thres)
        weights = weights * mask.to(weights.dtype)

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
