"""Packed-corner trilinear gather (plain PyTorch).

Counterpart of ``unboundednerfpytorch_tpu/ops/packed.py``. The grid is
pre-packed so that ONE gathered row holds all eight corner vectors of a
query's containing cell:

    P[b, :] = concat_{(dx,dy,dz) in {0,1}^3} padded_grid[b + (dx,dy,dz)]

with base indices b over [-1, dim-1] (stored shifted by +1, with a zero
border, so out-of-range corners read zeros: ``padding_mode='zeros'``). A
trilinear query is then one row gather plus an 8-way weighted sum.

The JAX package built this layout because row gathers on a TPU are bound by
the rate of row requests, whatever the row's width. Whether it pays on a GPU is a
question for measurement (``probes/gather.py`` times both layouts); the
functions are ported for their values, which equal
``ops.interp.grid_sample_3d``. Cost: 8x the grid's memory for the table.

The "folded" tables exist in the JAX package because a TPU pads an array's
trailing dimension to 128 lanes; here a folded table is just another view of
the unfolded one, and :func:`packed_trilerp_folded` reads it as such.
"""

from __future__ import annotations

import torch

from unboundednerfpytorch_tpu_torch.device import constant

# corner enumeration order: must match ops.interp.trilerp_corners
CORNERS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def _pad_xyz(grid: torch.Tensor) -> torch.Tensor:
    """Zero border of one voxel around the three spatial axes of [X, Y, Z, C]."""
    X, Y, Z, C = grid.shape
    padded = grid.new_zeros((X + 2, Y + 2, Z + 2, C))
    padded[1:-1, 1:-1, 1:-1] = grid
    return padded


def pack_corners(grid: torch.Tensor) -> torch.Tensor:
    """Pack a [X, Y, Z, C] grid into the [(X+1)*(Y+1)*(Z+1), 8*C] corner table.

    Row i*(Y+1)*(Z+1) + j*(Z+1) + k belongs to base voxel (i-1, j-1, k-1) and
    holds the 8 corner vectors grid[i-1+dx, j-1+dy, k-1+dz] (zeros outside
    the grid) concatenated in :data:`CORNERS` order.
    """
    X, Y, Z, C = grid.shape
    padded = _pad_xyz(grid)
    out = grid.new_empty((X + 1, Y + 1, Z + 1, 8 * C))
    for k, (dx, dy, dz) in enumerate(CORNERS):
        out[..., k * C:(k + 1) * C] = padded[dx:dx + X + 1, dy:dy + Y + 1, dz:dz + Z + 1]
    return out.reshape((X + 1) * (Y + 1) * (Z + 1), 8 * C)


def packed_table_bytes(dims: tuple, channels: int, itemsize: int = 2) -> int:
    """LOGICAL size of the packed table for a (X, Y, Z) grid of ``channels``
    channels. (The JAX function returns the physical size on a TPU, whose
    arrays pad the trailing dimension to 128 lanes; a GPU tensor has no such
    padding, so rows of 8*channels elements occupy exactly that.)"""
    X, Y, Z = (int(d) for d in dims)
    return (X + 1) * (Y + 1) * (Z + 1) * 8 * channels * itemsize


def corner_base_and_weights(xyz01: torch.Tensor, dims: tuple):
    """Base row index into the packed table + per-corner trilinear weights.

    Same weights as ``ops.interp.trilerp_corners`` (align_corners mapping,
    out-of-bounds corners zero-weighted); returns (base_idx [...] int64,
    w [..., 8]). The base voxel is clamped to the packed range, so every
    index lies inside the table.
    """
    X, Y, Z = (int(d) for d in dims)
    size = constant([X, Y, Z], torch.int64, xyz01.device)
    c = xyz01 * (size.to(xyz01.dtype) - 1)
    c0 = torch.floor(c)
    f = c - c0
    c0i = c0.to(torch.int64)

    # validity of each corner (true, unclamped indices)
    v0 = (c0i >= 0) & (c0i < size)
    v1 = (c0i + 1 >= 0) & (c0i + 1 < size)

    w_list = []
    for dx, dy, dz in CORNERS:
        wx = f[..., 0] if dx else 1.0 - f[..., 0]
        wy = f[..., 1] if dy else 1.0 - f[..., 1]
        wz = f[..., 2] if dz else 1.0 - f[..., 2]
        vx = v1[..., 0] if dx else v0[..., 0]
        vy = v1[..., 1] if dy else v0[..., 1]
        vz = v1[..., 2] if dz else v0[..., 2]
        w_list.append(wx * wy * wz * (vx & vy & vz).to(xyz01.dtype))
    w = torch.stack(w_list, -1)

    # base voxel clamped to the packed range [-1, dim-1], stored shifted +1
    bi = c0i[..., 0].clamp(-1, X - 1) + 1
    bj = c0i[..., 1].clamp(-1, Y - 1) + 1
    bk = c0i[..., 2].clamp(-1, Z - 1) + 1
    base = (bi * (Y + 1) + bj) * (Z + 1) + bk
    return base, w


def _weighted_corner_sum(rows: torch.Tensor, w: torch.Tensor, channels: int) -> torch.Tensor:
    """rows [..., 8*C], w [..., 8] -> [..., C] in at least f32. Written as a
    product and a sum over the 8 corners: as an einsum it becomes one tiny
    matrix-vector product per query, which is several times slower on a GPU."""
    out_dtype = torch.promote_types(rows.dtype, torch.float32)
    rows = rows.reshape(*w.shape, channels).to(out_dtype)
    return (rows * w.to(out_dtype)[..., None]).sum(dim=-2)


def packed_trilerp(table: torch.Tensor, base_idx: torch.Tensor, w: torch.Tensor,
                   channels: int) -> torch.Tensor:
    """One-row-per-query trilinear interpolation from a packed table.

    table [(X+1)(Y+1)(Z+1), 8*C], base_idx [...], w [..., 8] -> [..., C].
    Indices are clamped into the table, as ``jnp.take(mode="clip")`` does.
    """
    idx = base_idx.reshape(-1).clamp(0, table.shape[0] - 1)
    rows = table.index_select(0, idx).reshape(*base_idx.shape, 8 * channels)
    return _weighted_corner_sum(rows, w, channels)


def pack_corners_folded(grid: torch.Tensor, fold: int) -> torch.Tensor:
    """Corner table with ``fold`` consecutive bases per row:
    [ceil(T/fold), fold*8*C], zero rows padding T up to a multiple of fold."""
    C = grid.shape[-1]
    flat = pack_corners(grid)  # [T, 8C]
    t = flat.shape[0]
    pad = (-t) % fold
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad, 8 * C))])
    return flat.reshape((t + pad) // fold, fold * 8 * C)


def pack_corners_folded_chunked(grid: torch.Tensor, fold: int,
                                plane_chunk: int = 16) -> torch.Tensor:
    """:func:`pack_corners_folded` built in chunks of ``plane_chunk`` base
    x-planes, which bounds the transient memory of the build to one chunk
    beside the output. Requires plane_chunk*(Y+1)*(Z+1) % fold == 0
    (plane_chunk=16 works for any fold that divides 16). The result holds
    ceil(T/fold) rows, the last one zero-padded."""
    X, Y, Z, C = grid.shape
    P = (Y + 1) * (Z + 1)
    if (plane_chunk * P) % fold != 0:
        raise ValueError(f"plane_chunk*(Y+1)*(Z+1) = {plane_chunk * P} is not a multiple "
                         f"of fold {fold}")
    padded = _pad_xyz(grid)
    t_rows = -(-((X + 1) * P) // fold)
    out = grid.new_zeros((t_rows * fold, 8 * C))
    for a in range(0, X + 1, plane_chunk):
        b = min(a + plane_chunk, X + 1)
        n = b - a
        view = out[a * P:b * P].reshape(n, Y + 1, Z + 1, 8 * C)
        for k, (dx, dy, dz) in enumerate(CORNERS):
            view[..., k * C:(k + 1) * C] = padded[a + dx:b + dx, dy:dy + Y + 1, dz:dz + Z + 1]
    return out.reshape(t_rows, fold * 8 * C)


def packed_trilerp_folded(table: torch.Tensor, base_idx: torch.Tensor, w: torch.Tensor,
                          channels: int, fold: int) -> torch.Tensor:
    """Trilinear interpolation from a folded corner table.

    table [ceil(T/fold), fold*8*C], base_idx [...] (UNfolded row ids),
    w [..., 8] -> [..., C]. Segment ``base % fold`` of row ``base // fold`` is
    row ``base`` of the table viewed as [rows*fold, 8*C], so the query reads
    that view instead of gathering the whole folded row and masking."""
    if table.shape[1] != fold * 8 * channels:
        raise ValueError(f"folded table has rows of {table.shape[1]}, expected "
                         f"{fold * 8 * channels}")
    return packed_trilerp(table.reshape(-1, 8 * channels), base_idx, w, channels)


def grid_sample_3d_packed(grid: torch.Tensor, xyz01: torch.Tensor) -> torch.Tensor:
    """Drop-in for ``ops.interp.grid_sample_3d`` through the packed tables
    (packs on the fly: for a cached table call :func:`pack_corners` once and
    :func:`packed_trilerp` per batch)."""
    X, Y, Z, C = grid.shape
    base, w = corner_base_and_weights(xyz01, (X, Y, Z))
    return packed_trilerp(pack_corners(grid), base, w, C)
