"""Trilinear voxel-grid interpolation over channel-last tables.

Counterpart of ``unboundednerfpytorch_tpu/ops/interp.py``. Semantics match
``F.grid_sample(mode='bilinear', align_corners=True, padding_mode='zeros')``
as the reference DenseGrid uses it: a corner contributes only when its
integer index lies inside the grid. Grids are channel-last ``[X, Y, Z, C]``
(banks leading for FourierGrid: ``[B, X, Y, Z, C]``), so a sample gathers 8
contiguous C-vectors.

:func:`grid_sample_2d` samples the planes and lines of a TensoRF grid
through the same gather.

The gather is a ``torch.autograd.Function`` whose backward is one
``index_add_`` into an f32 buffer the size of the table (cast once to the
table's dtype), rather than autograd's per-index scatter, which would
allocate a table-sized zero buffer for every corner. Its backward runs under
a span (``utils/profiling.py::span``) that the caller names:
``backward/gather`` for the voxel grids, ``backward/vm`` for a TensoRF
grid's planes and lines (:func:`grid_sample_2d`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from unboundednerfpytorch_tpu_torch.device import constant
from unboundednerfpytorch_tpu_torch.utils.profiling import span


def trilerp_corners(xyz01: torch.Tensor, dims: tuple):
    """Corner indices + weights for trilinear interpolation.

    xyz01 [..., 3] in [0, 1], dims (X, Y, Z). Returns (flat_idx [..., 8]
    int64 clamped in range, w [..., 8] with out-of-bounds corners zeroed).
    """
    X, Y, Z = (int(d) for d in dims)
    scale = constant([X - 1, Y - 1, Z - 1], xyz01.dtype, xyz01.device)
    return corners_at(xyz01 * scale, dims)


def corners_at(c: torch.Tensor, dims: tuple):
    """:func:`trilerp_corners` of a point given in voxel units, ``c`` [..., 3]
    (``xyz01 * (dims - 1)``): a shard of a grid cut along x finds its corners
    at ``c`` less its first plane, with the global weights to the bit."""
    X, Y, Z = (int(d) for d in dims)
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
                w = wx * wy * wz * (vx & vy & vz).to(c.dtype)
                flat = (
                    xi.clamp(0, X - 1) * (Y * Z)
                    + yi.clamp(0, Y - 1) * Z
                    + zi.clamp(0, Z - 1)
                )
                idx_list.append(flat)
                w_list.append(w)
    return torch.stack(idx_list, -1), torch.stack(w_list, -1)


# the gather runs over slices of samples whose [samples, K, C] f32 block
# stays under this many bytes: an unbudgeted full-width step (7 banks of
# 319^3, 4096 rays of 1064 samples) would otherwise hold 11.7 GB of gathered
# rows in the forward and as many of products in the backward
SLICE_BYTES = 1 << 30


def _slices(n: int, k: int, c: int) -> list:
    step = max(1, SLICE_BYTES // (4 * k * c))
    return [slice(i, min(i + step, n)) for i in range(0, n, step)] or [slice(0, 0)]


class GatherTrilerp(torch.autograd.Function):
    """out[m] = sum_k w[m, k] * table[idx[m, k]] in f32 (table may be bf16).

    table [T, C]; idx [M, K] int64; w [M, K] f32. Differentiable w.r.t.
    ``table`` (index-add backward) and ``w``. Both directions run over
    slices of the M samples (``SLICE_BYTES``), each sample's sum in the same
    order whatever the slicing. ``span_name``: the span its backward runs
    under.
    """

    @staticmethod
    def forward(ctx, table, idx, w, span_name="backward/gather"):
        K, C = idx.shape[-1], table.shape[-1]
        out_dtype = torch.promote_types(table.dtype, torch.float32)
        parts = []
        for sl in _slices(idx.shape[0], K, C):
            rows = table.index_select(0, idx[sl].reshape(-1)).reshape(-1, K, C)
            out = None
            for k in range(K):
                contrib = rows[:, k].to(out_dtype) * w[sl, k : k + 1].to(out_dtype)
                out = contrib if out is None else out + contrib
            parts.append(out)
        ctx.save_for_backward(table, idx, w)
        ctx.span_name = span_name
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    @staticmethod
    def backward(ctx, grad_out):
        with span(ctx.span_name):
            table, idx, w = ctx.saved_tensors
            K, C = idx.shape[-1], table.shape[-1]
            slices = _slices(idx.shape[0], K, C)
            g_table = g_w = None
            if ctx.needs_input_grad[0]:
                acc_dtype = torch.promote_types(table.dtype, torch.float32)
                acc = torch.zeros(table.shape, dtype=acc_dtype, device=table.device)
                for sl in slices:
                    contrib = (grad_out[sl].to(acc_dtype)[:, None, :]
                               * w[sl].to(acc_dtype)[..., None])
                    acc.index_add_(0, idx[sl].reshape(-1), contrib.reshape(-1, C))
                g_table = acc.to(table.dtype)
            if ctx.needs_input_grad[2]:
                parts = []
                for sl in slices:
                    rows = table.index_select(0, idx[sl].reshape(-1)).reshape(-1, K, C)
                    parts.append((rows.to(grad_out.dtype) * grad_out[sl, None, :]).sum(-1))
                g_w = torch.cat(parts).to(w.dtype)
            return g_table, None, g_w, None


def gather_trilerp(flat_grid: torch.Tensor, flat_idx: torch.Tensor, w: torch.Tensor,
                   span_name: str = "backward/gather"):
    """Weighted corner gather over a flat [T, C] table; [..., K] idx/w."""
    batch = flat_idx.shape[:-1]
    K = flat_idx.shape[-1]
    out = GatherTrilerp.apply(flat_grid, flat_idx.reshape(-1, K), w.reshape(-1, K), span_name)
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


def bilerp_corners(xy01: torch.Tensor, dims: tuple):
    """Corner indices + weights for bilinear interpolation on an [H, W]
    lattice: xy01 [..., 2] in [0, 1] (the first coordinate indexes H).
    Returns (flat_idx [..., K] int64 clamped in range, w [..., K] with
    out-of-bounds corners zeroed), the corners in the JAX order (h, w) =
    (0, 0), (0, 1), (1, 0), (1, 1). A line (W == 1) keeps only its two
    corners of w = 0: the other two never lie in range, and the JAX sum adds
    them as exact zeros."""
    H, W = (int(d) for d in dims)
    ch = xy01[..., 0] * (H - 1)
    cw = xy01[..., 1] * (W - 1)
    h0 = torch.floor(ch)
    w0 = torch.floor(cw)
    fh, fw = ch - h0, cw - w0
    h0i, w0i = h0.to(torch.int64), w0.to(torch.int64)
    idx_list, w_list = [], []
    for dh in (0, 1):
        wh = fh if dh else 1.0 - fh
        hi = h0i + dh
        vh = (hi >= 0) & (hi < H)
        for dw in ((0,) if W == 1 else (0, 1)):
            ww = fw if dw else 1.0 - fw
            wi = w0i + dw
            vw = (wi >= 0) & (wi < W)
            w_list.append((wh * ww) * (vh & vw).to(xy01.dtype))
            idx_list.append(hi.clamp(0, H - 1) * W + wi.clamp(0, W - 1))
    return torch.stack(idx_list, -1), torch.stack(w_list, -1)


def grid_sample_2d(plane: torch.Tensor, xy01: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample a channel-last plane [H, W, C] at xy01 [..., 2] in
    [0, 1] (align_corners=True, zeros padding): [..., C]. The JAX
    ``grid_sample_2d``, which TensoRF's planes use; a line [A, 1, C] (the
    second coordinate 0) is a plane of width 1. Through the sliced corner
    gather of :class:`GatherTrilerp`, so a plane's gathered rows stay under
    ``SLICE_BYTES`` a slice; its backward runs under ``backward/vm``."""
    H, W, C = plane.shape
    idx, w = bilerp_corners(xy01, (H, W))
    return gather_trilerp(plane.reshape(H * W, C), idx, w, "backward/vm")


def _axis_lerp(n_old: int, n_new: int, first: int, stop: int, device):
    """Output planes [first, stop) of an axis resized from ``n_old`` to
    ``n_new`` (align-corners): (lo, f), the lower input plane of each, int64,
    and its f32 fraction (None where an axis of size 1 repeats plane 0), from
    the global plane indices. Output plane i reads input planes lo and lo + 1
    (:func:`resize_source_planes`)."""
    if n_new == 1 or n_old == 1:
        return torch.zeros(stop - first, dtype=torch.int64, device=device), None
    pos = torch.arange(first, stop, dtype=torch.float32, device=device) * (
        (n_old - 1) / (n_new - 1))
    lo = torch.floor(pos).to(torch.int64).clamp(0, n_old - 2)
    return lo, pos - lo.to(torch.float32)


def resize_source_planes(n_old: int, n_new: int, first: int, stop: int) -> tuple:
    """The input planes [a, b) that output planes [first, stop) of an axis
    resized from ``n_old`` to ``n_new`` by :func:`resize_grid_3d` read."""
    if n_new == n_old:
        return first, stop
    lo, f = _axis_lerp(n_old, n_new, first, stop, "cpu")
    return int(lo.min()), int(lo.max()) + (1 if f is None else 2)


def resize_grid_3d(grid: torch.Tensor, new_size, x_slab: tuple | None = None) -> torch.Tensor:
    """Trilinear resize of a channel-last [X, Y, Z, C] grid to a new spatial
    size, one axis after the other, ``align_corners=True``: output voxel i
    reads input coordinate i * (in - 1) / (out - 1). An axis of size 1, old or
    new, repeats index 0. The JAX package's formula written out
    (``lo * (1 - f) + hi * f`` with an f32 fraction), in f32 whatever the
    grid's dtype: the result is f32 for a bf16 grid too, and the caller
    rounds it once to the dtype it keeps.

    ``x_slab = (a, n_old, first, stop)``: ``grid`` holds input planes
    [a, a + grid.shape[0]) of an ``n_old``-plane x axis, which must cover
    what :func:`resize_source_planes` says output planes [first, stop) read,
    and the result is those output planes alone. Positions and fractions
    come from the global plane indices, so each plane equals the whole
    grid's resize to the bit."""
    out = grid.to(torch.promote_types(grid.dtype, torch.float32))
    for axis, n_new in enumerate(int(n) for n in new_size):
        a, n_old, first, stop = (x_slab if axis == 0 and x_slab is not None
                                 else (0, out.shape[axis], 0, n_new))
        if n_new == n_old:
            if (first - a, stop - first) != (0, out.shape[axis]):
                out = out.narrow(axis, first - a, stop - first)
            continue
        lo, f = _axis_lerp(n_old, n_new, first, stop, out.device)
        lo = lo - a
        if f is None:
            out = out.index_select(axis, lo)
            continue
        shape = [1] * out.ndim
        shape[axis] = stop - first
        f = f.reshape(shape)
        out = out.index_select(axis, lo) * (1.0 - f) + out.index_select(axis, lo + 1) * f
    return out


def max_pool_3d_same(vol: torch.Tensor, window: int = 3) -> torch.Tensor:
    """Max over a ``window``^3 neighbourhood of every voxel of [X, Y, Z],
    stride 1, the outside counting as -inf (``F.max_pool3d`` pads so)."""
    return F.max_pool3d(vol[None, None], kernel_size=window, stride=1,
                        padding=window // 2)[0, 0]
