"""The four gather-probe functions: CUDA kernels' wrappers and plain versions.

Counterparts of the TPU kernels of the JAX package's ``tools/probe_*.py``
(see ``csrc/gather_probe.cu`` for the list). Each function has a wrapper
that launches its kernel for CUDA tensors (or raises) and takes the plain
version only for tensors on the CPU, and a ``*_plain`` version in PyTorch
indexing that the kernel is held against:

  gather_rows(table [T, C], idx [N])            out[i] = table[idx[i]]
  gather_tile_rows(table [nA, C], idx [nA], A)  out[bA+i] = table[bA + idx[bA+i]]
    (both take ``lanes``, the threads that copy one row together: the
    default covers the row in vectors, ``lanes=1`` is one thread per row)
  gather_rows_loop, gather_tile_rows_loop       the same two functions by a
    row loop of bulk copies (the TPU probes' ``kernel2`` and ``p1_rowloop``),
    for rows of a multiple of 16 bytes on 16-byte aligned tables
  box_gather8(box [nb*32, 8, 128] f32, code [nb*R] int32, R)
                                                out[r] = 8 floats of request r
  box_sum(table [X, Y, Z, C] bf16, org [n, 3] int32, (BX, BY, BZ))
                                                out[b] = f32 sum over the box

Indices are clamped into range by kernels and plain versions alike (row ids
into the table or tile, codes modulo 4096, origins into the table). The
launches are ``torch.library`` custom ops and count in ``build.LAUNCHES``.
None has a gradient.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from unboundednerfpytorch_tpu_torch.ops.cuda import build

BOX_SIDE = 16  # box_gather8: a box is 16 x 16 x 16 cells of 8 f32 channels
BOX_ROWS = 32  # stored as [32, 8, 128] f32 per box


# ---------------------------------------------------------------------------
# plain versions


def gather_rows_plain(table: Tensor, idx: Tensor) -> Tensor:
    return table[idx.long().clamp(0, table.shape[0] - 1)]


def gather_tile_rows_plain(table: Tensor, idx: Tensor, tile: int) -> Tensor:
    n = idx.shape[0]
    first = torch.arange(n, device=idx.device) // tile * tile
    return table[(first + idx.long().clamp(0, tile - 1)).clamp(0, table.shape[0] - 1)]


def box_gather8_plain(box: Tensor, code: Tensor, req_per_box: int) -> Tensor:
    n = code.shape[0]
    c = code.long() % 4096
    dx, dy, dz = c // 256, (c // 16) % 16, c % 16
    b = torch.arange(n, device=code.device) // req_per_box
    lanes = dz[:, None] * 8 + torch.arange(8, device=code.device)
    rows = box[b * BOX_ROWS + dx * 2 + dy // 8, dy % 8]  # [n, 128]
    return torch.gather(rows, 1, lanes)


def box_sum_plain(table: Tensor, org: Tensor, box: tuple) -> Tensor:
    """One box at a time (a batched version would gather every box at once,
    hundreds of MB); the sum runs in f32."""
    BX, BY, BZ = box
    X, Y, Z, _ = table.shape
    hi = torch.tensor([X - BX, Y - BY, Z - BZ], device=org.device)
    o = torch.minimum(org.long().clamp_min(0), hi).tolist()
    return torch.stack([
        table[x:x + BX, y:y + BY, z:z + BZ].float().sum(dim=(0, 1, 2)) for x, y, z in o])


# ---------------------------------------------------------------------------
# launches


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _fn(name: str, argtypes):
    lib = build.load("gather_probe")
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return lib, fn


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@torch.library.custom_op("unerf_kernels::gather_rows", mutates_args=())
def _gather_rows_op(table: Tensor, idx: Tensor, lanes: int) -> Tensor:
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    lib, fn = _fn("gather_rows", [_P, _P, _I, _LL, _LL, _I, _I, _P, _P])
    err = fn(table.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64), idx.shape[0],
             table.shape[0], table.shape[1] * table.element_size(), lanes, out.data_ptr(),
             _stream(table))
    build.check(lib, err, "gather_rows")
    build.LAUNCHES["gather_rows"] += 1
    return out


@torch.library.custom_op("unerf_kernels::gather_tile_rows", mutates_args=())
def _gather_tile_rows_op(table: Tensor, idx: Tensor, tile: int, lanes: int) -> Tensor:
    out = torch.empty_like(table)
    lib, fn = _fn("gather_tile_rows", [_P, _P, _I, _LL, _LL, _I, _I, _P, _P])
    err = fn(table.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64), idx.shape[0],
             tile, table.shape[1] * table.element_size(), lanes, out.data_ptr(),
             _stream(table))
    build.check(lib, err, "gather_tile_rows")
    build.LAUNCHES["gather_tile_rows"] += 1
    return out


@torch.library.custom_op("unerf_kernels::gather_rows_loop", mutates_args=())
def _gather_rows_loop_op(table: Tensor, idx: Tensor) -> Tensor:
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    lib, fn = _fn("gather_rows_loop", [_P, _P, _I, _LL, _LL, _I, _P, _P])
    err = fn(table.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64), idx.shape[0],
             table.shape[0], table.shape[1] * table.element_size(), out.data_ptr(),
             _stream(table))
    build.check(lib, err, "gather_rows_loop")
    build.LAUNCHES["gather_rows_loop"] += 1
    return out


@torch.library.custom_op("unerf_kernels::gather_tile_rows_loop", mutates_args=())
def _gather_tile_rows_loop_op(table: Tensor, idx: Tensor, tile: int) -> Tensor:
    out = torch.empty_like(table)
    lib, fn = _fn("gather_tile_rows_loop", [_P, _P, _I, _LL, _LL, _I, _P, _P])
    err = fn(table.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64), idx.shape[0],
             tile, table.shape[1] * table.element_size(), out.data_ptr(), _stream(table))
    build.check(lib, err, "gather_tile_rows_loop")
    build.LAUNCHES["gather_tile_rows_loop"] += 1
    return out


@torch.library.custom_op("unerf_kernels::box_gather8", mutates_args=())
def _box_gather8_op(box: Tensor, code: Tensor, req_per_box: int) -> Tensor:
    out = torch.empty((code.shape[0], 8), dtype=torch.float32, device=box.device)
    lib, fn = _fn("box_gather8", [_P, _P, _LL, _I, _P, _P])
    err = fn(box.data_ptr(), code.data_ptr(), code.shape[0], req_per_box, out.data_ptr(),
             _stream(box))
    build.check(lib, err, "box_gather8")
    build.LAUNCHES["box_gather8"] += 1
    return out


@torch.library.custom_op("unerf_kernels::box_sum", mutates_args=())
def _box_sum_op(table: Tensor, org: Tensor, bx: int, by: int, bz: int, threads: int) -> Tensor:
    X, Y, Z, C = table.shape
    out = torch.empty((org.shape[0], C), dtype=torch.float32, device=table.device)
    lib, fn = _fn("box_sum", [_P, _P] + [_I] * 9 + [_P, _P])
    err = fn(table.data_ptr(), org.data_ptr(), org.shape[0], X, Y, Z, C, bx, by, bz, threads,
             out.data_ptr(), _stream(table))
    build.check(lib, err, "box_sum")
    build.LAUNCHES["box_sum"] += 1
    return out


# ---------------------------------------------------------------------------
# wrappers


def default_lanes(row_bytes: int) -> int:
    """The smallest power of two of threads, at most 32, that covers a row in
    the widest vectors (16, 8, 4 or 2 bytes) that divide it."""
    vec = 16
    while row_bytes % vec:
        vec //= 2
    lanes = 1
    while lanes < row_bytes // vec and lanes < 32:
        lanes *= 2
    return lanes


def _check_tensors(name: str, table: Tensor, idx: Tensor) -> int:
    """Refuses a table and indices that no row gather takes; returns the
    row's bytes."""
    if not (table.is_cuda and idx.is_cuda):
        raise ValueError(f"{name}: tensors must be on the GPU")
    if table.ndim != 2 or idx.ndim != 1:
        raise ValueError(f"{name}: need table [T, C] and idx [N], got {tuple(table.shape)} "
                         f"and {tuple(idx.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: idx must be int32 or int64, got {idx.dtype}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: tensors must be contiguous")
    if table.shape[0] == 0:
        raise ValueError(f"{name}: the table has no row")
    return table.shape[1] * table.element_size()


def _check_rows(name: str, table: Tensor, idx: Tensor, lanes: int | None) -> int:
    """Refuses what the vector kernel does not take; returns the lanes per row."""
    row_bytes = _check_tensors(name, table, idx)
    if row_bytes % 2 or row_bytes == 0:
        raise ValueError(f"{name}: rows of {row_bytes} bytes are not supported (the kernel "
                         "copies 2-, 4-, 8- or 16-byte vectors)")
    if lanes is None:
        return default_lanes(row_bytes)
    if lanes not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"{name}: lanes must be a power of two up to 32, got {lanes}")
    return int(lanes)


LOOP_MAX_ROW_BYTES = 8192  # csrc/gather_probe.cu kLoopMaxRowBytes


def _check_loop(name: str, table: Tensor, idx: Tensor) -> None:
    """Refuses what the row loop of bulk copies does not take: a bulk copy
    moves 16-byte aligned runs of a multiple of 16 bytes."""
    row_bytes = _check_tensors(name, table, idx)
    if row_bytes % 16 or not 0 < row_bytes <= LOOP_MAX_ROW_BYTES:
        raise ValueError(f"{name}: rows of {row_bytes} bytes are not supported (a bulk copy "
                         f"moves a multiple of 16 bytes, at most {LOOP_MAX_ROW_BYTES} a row)")
    if table.data_ptr() % 16:
        raise ValueError(f"{name}: the table does not start on a 16-byte boundary (a view "
                         "into its storage?); a bulk copy needs one")


def gather_rows(table: Tensor, idx: Tensor, lanes: int | None = None) -> Tensor:
    """out[i, :] = table[idx[i], :] for any table dtype with rows of an even
    number of bytes. ``lanes`` threads copy one row together (default:
    :func:`default_lanes`; 1 is the row loop, one thread per row)."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    return _gather_rows_op(table, idx, _check_rows("gather_rows", table, idx, lanes))


def gather_tile_rows(table: Tensor, idx: Tensor, tile: int, lanes: int | None = None) -> Tensor:
    """out[b*A + i, :] = table[b*A + idx[b*A + i], :] with A = ``tile`` and
    idx local to its tile; table and idx have the same number of rows.
    ``lanes`` as in :func:`gather_rows`."""
    if table.device.type == "cpu":
        return gather_tile_rows_plain(table, idx, tile)
    lanes = _check_rows("gather_tile_rows", table, idx, lanes)
    if idx.shape[0] != table.shape[0] or tile <= 0:
        raise ValueError("gather_tile_rows: idx must have one entry per table row, tile > 0")
    return _gather_tile_rows_op(table, idx, int(tile), lanes)


def gather_rows_loop(table: Tensor, idx: Tensor) -> Tensor:
    """out[i, :] = table[idx[i], :], as :func:`gather_rows`, by a row loop of
    bulk copies: rows of a multiple of 16 bytes (at most
    ``LOOP_MAX_ROW_BYTES``), a table on a 16-byte boundary."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    _check_loop("gather_rows_loop", table, idx)
    return _gather_rows_loop_op(table, idx)


def gather_tile_rows_loop(table: Tensor, idx: Tensor, tile: int) -> Tensor:
    """out[b*A + i, :] = table[b*A + idx[b*A + i], :], as
    :func:`gather_tile_rows`, by the row loop of :func:`gather_rows_loop`."""
    if table.device.type == "cpu":
        return gather_tile_rows_plain(table, idx, tile)
    _check_loop("gather_tile_rows_loop", table, idx)
    if idx.shape[0] != table.shape[0] or tile <= 0:
        raise ValueError("gather_tile_rows_loop: idx must have one entry per table row, "
                         "tile > 0")
    return _gather_tile_rows_loop_op(table, idx, int(tile))


def box_gather8(box: Tensor, code: Tensor, req_per_box: int) -> Tensor:
    """Request r (code = dx*256 + dy*16 + dz) reads the 8 channels of cell
    (dx, dy, dz) of box r // req_per_box: out [n, 8] f32."""
    if box.device.type == "cpu":
        return box_gather8_plain(box, code, req_per_box)
    if not (box.is_cuda and code.is_cuda):
        raise ValueError("box_gather8: tensors must be on the GPU")
    if box.dtype != torch.float32 or box.ndim != 3 or box.shape[1:] != (8, 128) \
            or box.shape[0] % BOX_ROWS:
        raise TypeError(f"box_gather8: need f32 box [n_boxes*32, 8, 128], got {box.dtype} "
                        f"{tuple(box.shape)}")
    if code.dtype != torch.int32 or code.ndim != 1:
        raise TypeError("box_gather8: code must be int32 [n]")
    n_boxes = box.shape[0] // BOX_ROWS
    if req_per_box <= 0 or code.shape[0] > n_boxes * req_per_box:
        raise ValueError(f"box_gather8: {code.shape[0]} requests at {req_per_box} per box "
                         f"need more than the {n_boxes} boxes given")
    if not (box.is_contiguous() and code.is_contiguous()):
        raise ValueError("box_gather8: tensors must be contiguous")
    return _box_gather8_op(box, code, int(req_per_box))


def box_sum(table: Tensor, org: Tensor, box: tuple) -> Tensor:
    """out[b, :] = sum of table[ox:ox+BX, oy:oy+BY, oz:oz+BZ, :] in f32 for
    each origin row of ``org`` [n, 3] int32; table [X, Y, Z, C] bf16."""
    BX, BY, BZ = (int(v) for v in box)
    if table.device.type == "cpu":
        return box_sum_plain(table, org, (BX, BY, BZ))
    if not (table.is_cuda and org.is_cuda):
        raise ValueError("box_sum: tensors must be on the GPU")
    if table.dtype != torch.bfloat16 or table.ndim != 4:
        raise TypeError(f"box_sum: need a bf16 table [X, Y, Z, C], got {table.dtype} "
                        f"{tuple(table.shape)}")
    if org.dtype != torch.int32 or org.ndim != 2 or org.shape[1] != 3:
        raise TypeError("box_sum: org must be int32 [n, 3]")
    X, Y, Z, C = table.shape
    if not (0 < BX <= X and 0 < BY <= Y and 0 < BZ <= Z):
        raise ValueError(f"box_sum: box {(BX, BY, BZ)} does not fit the table {(X, Y, Z)}")
    run_vecs = BZ * C // 8  # 16-byte vectors in one contiguous z-run
    if C % 8 or run_vecs > 1024:
        raise ValueError(f"box_sum: C must be a multiple of 8 and BZ*C/8 <= 1024, got C={C}, "
                         f"BZ={BZ}")
    if not (table.is_contiguous() and org.is_contiguous()):
        raise ValueError("box_sum: tensors must be contiguous")
    threads = run_vecs * max(1, 256 // run_vecs)
    return _box_sum_op(table, org, BX, BY, BZ, threads)
