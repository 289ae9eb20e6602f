"""Ray sampling: bounded marching through a box, contracted and NDC
sampling, the oversample skip and fixed-budget sample compaction.

Counterpart of the parts of ``unboundednerfpytorch_tpu/ops/sampling.py``
that the FourierGrid, DVGO, DCVGO and DMPIGO forwards run. Everything is fixed
shape ``[N_rays, N_samples, ...]`` with validity masks.
:func:`cumdist_thres_plain` is the plain version of the CUDA kernel behind
:func:`..ops.cuda.ub360.cumdist_thres`.
"""

from __future__ import annotations

import numpy as np
import torch

from unboundednerfpytorch_tpu_torch.device import constant


def ray_aabb(rays_o: torch.Tensor, rays_d: torch.Tensor, xyz_min, xyz_max, near: float,
             far: float = 1e9) -> tuple[torch.Tensor, torch.Tensor]:
    """The slab test: per ray [t_min, t_max], each clamped to [near, far]
    (the maximum with ``near`` first, then the minimum with ``far``). A zero
    component of a direction counts as 1e-6."""
    mn = constant(xyz_min, rays_o.dtype, rays_o.device)
    mx = constant(xyz_max, rays_o.dtype, rays_o.device)
    vec = torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)
    rate_a = (mx - rays_o) / vec
    rate_b = (mn - rays_o) / vec
    t_min = torch.clamp(torch.minimum(rate_a, rate_b).amax(-1), near, far)
    t_max = torch.clamp(torch.maximum(rate_a, rate_b).amin(-1), near, far)
    return t_min, t_max


def n_samples_cap(world_size, stepsize: float) -> int:
    """The fixed sample count of bounded marching: the lattice's diagonal in
    steps, int(|world_size + 1| / stepsize) + 1."""
    return int(np.linalg.norm(np.asarray(world_size, dtype=np.float64) + 1) / stepsize) + 1


def _norm(x: torch.Tensor) -> torch.Tensor:
    """The Euclidean norm of the last axis of 3, summed in index order."""
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2])


def sample_pts_on_rays(rays_o: torch.Tensor, rays_d: torch.Tensor, xyz_min, xyz_max,
                       near: float, stepdist: float, n_samples: int, far: float = 1e9):
    """Equidistant marching through the box (DVGO): from the entry point at
    t_min, ``n_samples`` points ``stepdist`` apart along the unit direction.
    Returns (pts [N, S, 3], mask [N, S], t [N, S]): a sample is live where
    its index is below the ray's step count max(ceil((t_max - t_min) |d| /
    stepdist), 1) and it lies in the box; ``t`` is along the unnormalised
    direction."""
    t_min, t_max = ray_aabb(rays_o, rays_d, xyz_min, xyz_max, near, far)
    d_norm = torch.clamp_min(_norm(rays_d), 1e-12)
    n_steps = torch.clamp_min(torch.ceil((t_max - t_min) * d_norm / stepdist), 1.0)
    start = rays_o + rays_d * t_min[:, None]
    dirn = rays_d / d_norm[:, None]
    step = torch.arange(n_samples, dtype=rays_o.dtype, device=rays_o.device)
    dist = step * stepdist
    pts = start[:, None, :] + dirn[:, None, :] * dist[None, :, None]
    mn = constant(xyz_min, pts.dtype, pts.device)
    mx = constant(xyz_max, pts.dtype, pts.device)
    in_range = step[None, :] < n_steps[:, None]
    in_bbox = ((pts >= mn) & (pts <= mx)).all(dim=-1)
    t = t_min[:, None] + dist[None, :] / torch.clamp_min(d_norm[:, None], 1e-12)
    return pts, in_range & in_bbox, t


def contracted_t_values(
    n_inner: int,
    n_outer: int,
    t_boundary: float = 1.5,
    outer_ratio: float = 1.0 / 128.0,
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """Bin-center t values: inner bins linspace(0, t_boundary, n_inner+1),
    outer bins t_boundary / linspace(1, outer_ratio, n_outer+1)."""
    b_inner = torch.linspace(0.0, t_boundary, n_inner + 1, dtype=dtype, device=device)
    b_outer = t_boundary / torch.linspace(1.0, outer_ratio, n_outer + 1, dtype=dtype,
                                          device=device)
    return torch.cat([(b_inner[1:] + b_inner[:-1]) * 0.5,
                      (b_outer[1:] + b_outer[:-1]) * 0.5])


def contract(
    pts: torch.Tensor,
    bg_len: float,
    norm_type: str = "inf",
    boundary: float = 1.0,
    order: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Unbounded -> cube contraction. Points with ||p|| <= boundary stay;
    beyond, p -> p/||p|| * (B - A/||p||^k), B = 1+bg_len,
    A = B b^k - b^(k+1). Returns (contracted points, inner mask)."""
    if norm_type == "inf":
        norm = pts.abs().amax(dim=-1, keepdim=True)
    elif norm_type == "l2":
        norm = torch.linalg.norm(pts, dim=-1, keepdim=True)
    else:
        raise NotImplementedError(f"unknown contracted_norm {norm_type!r}")
    B = 1.0 + bg_len
    A = B * (boundary**order) - boundary ** (order + 1)
    inner = norm <= boundary
    safe_norm = torch.clamp_min(norm, 1e-10)
    contracted = torch.where(inner, pts, pts / safe_norm * (B - A / (safe_norm**order)))
    return contracted, inner[..., 0]


def sample_ndc_pts_on_rays(rays_o: torch.Tensor, rays_d: torch.Tensor, xyz_min, xyz_max,
                           n_samples: int):
    """Equidistant NDC sampling of the multiplane model: (pts [N, S, 3] at
    o + d * i / (S - 1), in-bbox mask [N, S], t [N, S] = i / (S - 1))."""
    dist = torch.arange(n_samples, dtype=rays_o.dtype, device=rays_o.device) / (n_samples - 1)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * dist[None, :, None]
    mn = constant(xyz_min, pts.dtype, pts.device)
    mx = constant(xyz_max, pts.dtype, pts.device)
    in_bbox = ((pts >= mn) & (pts <= mx)).all(dim=-1)
    return pts, in_bbox, dist.expand(in_bbox.shape)


def cumdist_thres_plain(dist: torch.Tensor, thres: float) -> torch.Tensor:
    """Per ray, a running sum of the step distances ``dist`` [N, S] that
    emits True and restarts from 0 wherever it exceeds ``thres``: bool [N, S].
    The JAX package's ``lax.scan``, as a loop over samples vectorised over
    rays (the reference's ``ub360_utils_kernel.cu:12-32``)."""
    cum = torch.zeros(dist.shape[0], dtype=dist.dtype, device=dist.device)
    out = torch.empty(dist.shape, dtype=torch.bool, device=dist.device)
    for i in range(dist.shape[1]):
        cum = cum + dist[:, i]
        over = cum > thres
        cum = cum * (1.0 - over.to(dist.dtype))
        out[:, i] = over
    return out


def compact_samples(mask: torch.Tensor, budget: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per ray, the first ``budget`` live samples (near -> far) of a [N, S]
    mask as (sel [N, budget] int64, sel_mask [N, budget]). Live samples get
    unique descending scores, so ``topk`` returns them in near -> far order."""
    n, s = mask.shape
    order = torch.arange(s, dtype=torch.int64, device=mask.device)
    score = torch.where(mask, s - order, torch.full_like(order, -1))
    top_scores, sel = torch.topk(score, budget, dim=-1, largest=True, sorted=True)
    sel_mask = top_scores > 0
    sel = torch.where(sel_mask, sel, torch.zeros_like(sel))
    return sel, sel_mask


def gather_samples(x: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """x [N, S, ...] + sel [N, B] -> [N, B, ...] as one flat row gather."""
    n, s = x.shape[0], x.shape[1]
    flat = x.reshape(n * s, *x.shape[2:])
    idx = (torch.arange(n, dtype=sel.dtype, device=sel.device)[:, None] * s + sel).reshape(-1)
    return flat.index_select(0, idx).reshape(n, sel.shape[1], *x.shape[2:])


def maskcache_lookup(
    mask_grid: torch.Tensor,
    xyz: torch.Tensor,
    xyz2ijk_scale: torch.Tensor,
    xyz2ijk_shift: torch.Tensor,
) -> torch.Tensor:
    """Nearest-voxel occupancy lookup: ijk = round(xyz*scale + shift)
    (half to even, as ``jnp.round``); out of bounds -> False."""
    ijk = torch.round(xyz * xyz2ijk_scale + xyz2ijk_shift).to(torch.int64)
    sz = constant(mask_grid.shape, torch.int64, xyz.device)
    in_bounds = ((ijk >= 0) & (ijk < sz)).all(dim=-1)
    ijk_c = torch.minimum(torch.clamp_min(ijk, 0), sz - 1)
    flat_idx = (ijk_c[..., 0] * sz[1] + ijk_c[..., 1]) * sz[2] + ijk_c[..., 2]
    vals = mask_grid.reshape(-1)[flat_idx]
    return vals & in_bounds
