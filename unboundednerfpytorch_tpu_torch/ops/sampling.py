"""Contracted ray sampling and fixed-budget sample compaction.

Counterpart of the parts of ``unboundednerfpytorch_tpu/ops/sampling.py``
that the FourierGrid train step runs. Everything is fixed shape
``[N_rays, N_samples, ...]`` with validity masks.
"""

from __future__ import annotations

import torch


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
    sz = torch.tensor(mask_grid.shape, dtype=torch.int64, device=xyz.device)
    in_bounds = ((ijk >= 0) & (ijk < sz)).all(dim=-1)
    ijk_c = torch.minimum(torch.clamp_min(ijk, 0), sz - 1)
    flat_idx = (ijk_c[..., 0] * sz[1] + ijk_c[..., 1]) * sz[2] + ijk_c[..., 2]
    vals = mask_grid.reshape(-1)[flat_idx]
    return vals & in_bounds
