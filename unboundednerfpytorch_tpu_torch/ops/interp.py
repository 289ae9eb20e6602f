"""Trilinear voxel-grid interpolation over channel-last tables.

Counterpart of ``unboundednerfpytorch_tpu/ops/interp.py``. Semantics match
``F.grid_sample(mode='bilinear', align_corners=True, padding_mode='zeros')``
as the reference DenseGrid uses it: a corner contributes only when its
integer index lies inside the grid. Grids are channel-last ``[X, Y, Z, C]``
(banks leading for FourierGrid: ``[B, X, Y, Z, C]``), so a sample gathers 8
contiguous C-vectors.

The gather is a ``torch.autograd.Function`` whose backward is one
``index_add_`` into an f32 buffer the size of the table (cast once to the
table's dtype), rather than autograd's per-index scatter, which would
allocate a table-sized zero buffer for every corner.
"""

from __future__ import annotations

import torch


def trilerp_corners(xyz01: torch.Tensor, dims: tuple):
    """Corner indices + weights for trilinear interpolation.

    xyz01 [..., 3] in [0, 1], dims (X, Y, Z). Returns (flat_idx [..., 8]
    int64 clamped in range, w [..., 8] with out-of-bounds corners zeroed).
    """
    X, Y, Z = (int(d) for d in dims)
    scale = torch.tensor([X - 1, Y - 1, Z - 1], dtype=xyz01.dtype, device=xyz01.device)
    c = xyz01 * scale
    c0 = torch.floor(c)
    f = c - c0
    c0i = c0.to(torch.int64)
    idx_list, w_list = [], []
    for dx in (0, 1):
        xi = c0i[..., 0] + dx
        wx = f[..., 0] if dx else 1.0 - f[..., 0]
        vx = (xi >= 0) & (xi < X)
        for dy in (0, 1):
            yi = c0i[..., 1] + dy
            wy = f[..., 1] if dy else 1.0 - f[..., 1]
            vy = (yi >= 0) & (yi < Y)
            for dz in (0, 1):
                zi = c0i[..., 2] + dz
                wz = f[..., 2] if dz else 1.0 - f[..., 2]
                vz = (zi >= 0) & (zi < Z)
                w = wx * wy * wz * (vx & vy & vz).to(xyz01.dtype)
                flat = (
                    xi.clamp(0, X - 1) * (Y * Z)
                    + yi.clamp(0, Y - 1) * Z
                    + zi.clamp(0, Z - 1)
                )
                idx_list.append(flat)
                w_list.append(w)
    return torch.stack(idx_list, -1), torch.stack(w_list, -1)


class GatherTrilerp(torch.autograd.Function):
    """out[m] = sum_k w[m, k] * table[idx[m, k]] in f32 (table may be bf16).

    table [T, C]; idx [M, K] int64; w [M, K] f32. Differentiable w.r.t.
    ``table`` (index-add backward) and ``w``.
    """

    @staticmethod
    def forward(ctx, table, idx, w):
        rows = table.index_select(0, idx.reshape(-1)).reshape(*idx.shape, table.shape[-1])
        out_dtype = torch.promote_types(table.dtype, torch.float32)
        out = None
        for k in range(idx.shape[-1]):
            contrib = rows[:, k].to(out_dtype) * w[:, k : k + 1].to(out_dtype)
            out = contrib if out is None else out + contrib
        ctx.save_for_backward(table, idx, w)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        table, idx, w = ctx.saved_tensors
        g_table = g_w = None
        if ctx.needs_input_grad[0]:
            acc_dtype = torch.promote_types(table.dtype, torch.float32)
            acc = torch.zeros(table.shape, dtype=acc_dtype, device=table.device)
            contrib = grad_out.to(acc_dtype)[:, None, :] * w.to(acc_dtype)[..., None]
            acc.index_add_(0, idx.reshape(-1), contrib.reshape(-1, table.shape[-1]))
            g_table = acc.to(table.dtype)
        if ctx.needs_input_grad[2]:
            rows = table.index_select(0, idx.reshape(-1)).reshape(*idx.shape, table.shape[-1])
            g_w = (rows.to(grad_out.dtype) * grad_out[:, None, :]).sum(-1).to(w.dtype)
        return g_table, None, g_w


def gather_trilerp(flat_grid: torch.Tensor, flat_idx: torch.Tensor, w: torch.Tensor):
    """Weighted corner gather over a flat [T, C] table; [..., K] idx/w."""
    batch = flat_idx.shape[:-1]
    K = flat_idx.shape[-1]
    out = GatherTrilerp.apply(flat_grid, flat_idx.reshape(-1, K), w.reshape(-1, K))
    return out.reshape(*batch, flat_grid.shape[-1])


def grid_sample_3d(grid: torch.Tensor, xyz01: torch.Tensor) -> torch.Tensor:
    """Trilinearly sample a channel-last grid [X, Y, Z, C] at xyz01 [..., 3]
    in [0, 1] (align_corners=True, zeros padding). Returns [..., C] (f32 for
    bf16 grids)."""
    X, Y, Z, C = grid.shape
    idx, w = trilerp_corners(xyz01, (X, Y, Z))
    return gather_trilerp(grid.reshape(X * Y * Z, C), idx, w)


def grid_sample_banks(grids: torch.Tensor, xyz01_banks: torch.Tensor) -> torch.Tensor:
    """Sum over banks of ``grid_sample_3d(grids[b], xyz01_banks[..., b, :])``.

    grids [B, X, Y, Z, C]; xyz01_banks [..., B, 3]. One gather over the
    whole [B*X*Y*Z, C] table, so the backward is one index-add. The sum over
    banks runs in bank order, as the per-bank loop of the JAX package does.
    """
    B, X, Y, Z, C = grids.shape
    idx, w = trilerp_corners(xyz01_banks, (X, Y, Z))  # [..., B, 8]
    offs = torch.arange(B, device=idx.device, dtype=idx.dtype) * (X * Y * Z)
    idx = idx + offs[:, None]
    batch = idx.shape[:-2]
    vals = GatherTrilerp.apply(
        grids.reshape(B * X * Y * Z, C), idx.reshape(-1, 8), w.reshape(-1, 8)
    ).reshape(*batch, B, C)
    out = vals[..., 0, :]
    for b in range(1, B):
        out = out + vals[..., b, :]
    return out
