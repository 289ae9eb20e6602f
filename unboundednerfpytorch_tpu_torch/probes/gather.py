"""Gather probes on the GPU: what a row gather, a box-local gather and a box
copy cost at the render engine's shapes.

    python -m unboundednerfpytorch_tpu_torch.probes.gather

Counterpart of the JAX package's ``tools/probe_dynamic_gather.py``,
``probe_pallas_gather.py``, ``probe_vreg_gather.py`` and
``probe_kernel_gather.py``, at their shapes, with the six hand-written
kernels of ``csrc/gather_probe.cu``. One JSON line per probe, as the tools
print: the kernel's device time (``ms``, many launches in one CUDA graph) and
the time of a call through its wrapper (``call_ms``), the plain PyTorch
version's, the device time of the one PyTorch call that computes the same
function where there is one (``torch.index_select``: a yardstick, used
nowhere in the port), the bound (the bytes the function must move over the
card's memory rate: for a row gather each source row its indices touch read
once, each output written once) and the rate. Every kernel output is first held against its plain
version on the same inputs: indexed copies bit-equal, ``box_sum`` within
1e-3 relative of the f32 plain sum.

Two pairs of the TPU kernels compute one function by two mechanisms, a
vector gather against a scalar loop over rows. Each has its kernel here:
lanes copying a row together in vectors (``gather_rows`` and
``gather_tile_rows`` for ``vmem_take`` and ``dynamic_gather``), and a row loop
that issues one bulk copy a row into shared memory and stores the staged rows
whole (``gather_rows_loop`` and ``gather_tile_rows_loop`` for
``vmem_rowloop`` and ``p1_rowloop``).

The XLA baselines of the tools (``xla_take``, ``p3_slice_gather``) become
``torch.index_select`` timings, printed as such. The last probes time the
two layouts the render's k0 query could use at bicycle_single's size: eight
24-byte corner rows per query from a [X*Y*Z, 12] bf16 bank, against one
192-byte packed row from ``ops.packed.pack_corners`` of the same bank.

Inputs are made on the device from a seed. Needs a GPU, unless
``device="cpu"`` is passed to :func:`run_all` (tiny shapes, plain versions,
for tests; the times are then the CPU's and are labelled so).
"""

from __future__ import annotations

import json
import time

import torch

from unboundednerfpytorch_tpu_torch.device import resolve_device
from unboundednerfpytorch_tpu_torch.ops import interp
from unboundednerfpytorch_tpu_torch.ops import packed as packed_ops
from unboundednerfpytorch_tpu_torch.ops.cuda import gather_probe as gp
from unboundednerfpytorch_tpu_torch.probes.timing import (MANY_LAUNCHES, bound_ms, kernel_ms,
                                                           time_ms)

# the shapes of the JAX package's tools
TILE_SHAPES = (  # (probe, A, C, n_blocks)
    ("dynamic_gather", 1024, 128, 4096),
    ("dynamic_gather", 2048, 128, 2048),
    ("dynamic_gather", 4096, 128, 1024),
    ("dynamic_gather", 2048, 256, 2048),
    ("p1_rowloop", 2048, 128, 512),
    ("p1_rowloop", 4096, 128, 256),
)
ROWS_SHAPE = (32 * 1024, 128, 512 * 1024)  # table rows, channels, gathered rows
BOX8_SHAPE = (256, 4096)  # boxes, requests per box
BOX_SUM_TABLE = (161, 161, 161, 128)
BOX_SUM_SHAPES = (((16, 16, 8), 2048), ((16, 16, 16), 1024))
SLICE_SHAPE = (1 << 22, 128, 1 << 19)  # table rows, channels, slices
K0_BANK = (199, 199, 199, 12)  # one k0 bank of bicycle_single
K0_QUERIES = 8192 * 32  # one render chunk's color_budget survivors
TINY = 64  # divisor of the sizes above for a CPU run
ROW_LOOPS = ("p1_rowloop", "vmem_rowloop")  # probes of the row loop of bulk copies


def _timer(device):
    """(ms a launch, ms a call through the wrapper) of a function: on the
    card ``timing.kernel_ms`` (CUDA events; a call under 0.2 ms is timed again
    as many launches in one CUDA graph), or with ``graph=True`` the launch
    always by many launches in one graph; on the CPU the host clock for both."""
    if device.type == "cuda":
        def gpu_ms(fn, iters=20, warmup=3, graph=False):
            if not graph:
                return kernel_ms(fn, iters, warmup)
            return (time_ms(fn, iters, warmup, launches=MANY_LAUNCHES),
                    time_ms(fn, iters, warmup))

        return gpu_ms

    def host_ms(fn, iters=3, warmup=1, graph=False):
        for _ in range(warmup):
            fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        ms = (time.perf_counter() - t0) / iters * 1e3
        return ms, ms

    return host_ms


def _compare(probe, shape, run, plain, exact) -> float:
    """max |run() - plain()|; raises unless bit-equal (``exact``) or within
    1e-3 of the plain result's largest magnitude."""
    got, want = run(), plain()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{probe} {shape}: {got.dtype}{tuple(got.shape)} != "
                             f"{want.dtype}{tuple(want.shape)}")
    err = float((got.float() - want.float()).abs().max())
    ok = torch.equal(got, want) if exact else err <= 1e-3 * float(want.abs().max())
    if not ok:
        raise AssertionError(f"{probe} {shape}: kernel and plain version disagree "
                             f"(max abs err {err})")
    return err


def _record(probe, kernel, ctx, run, plain, library, n_bytes, exact, shape, units):
    """Check ``run()`` against ``plain()``, then time run, plain and library."""
    device, timer = ctx
    err = _compare(probe, shape, run, plain, exact)
    ms, call_ms = timer(run, graph=True)
    plain_ms = timer(plain, iters=3, warmup=1)[0]
    lib_ms = timer(library, graph=True)[0] if library is not None else None
    bnd, by = bound_ms(n_bytes, 0)
    rec = {"probe": probe, "kernel": kernel, "shape": shape, "ok": True,
           "timed_on": "gpu" if device.type == "cuda" else "cpu (plain version)",
           "max_abs_err": err, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": bnd, "bound_by": by,
           "GB_per_s": n_bytes / ms / 1e6}
    rec.update({k: n / ms / 1e3 for k, n in units.items()})  # M units per second
    return rec


def gather_bytes(table, flat_idx) -> int:
    """Bytes a row gather must move: each distinct row of ``table`` that
    ``flat_idx`` (the flat row index of every output row) touches read once,
    each output row written once, the int32 indices read once. A tile's A random
    draws out of its A rows touch about 1 - 1/e of them."""
    row = table.shape[1] * table.element_size()
    n = flat_idx.numel()
    return int(torch.unique(flat_idx).numel()) * row + n * row + n * 4


def probe_tile_rows(ctx, gen, scale=1):
    """Rows 4 and 7a of the kernel table: the tile-local row gather, by lanes
    that share a row (``dynamic_gather``) and by the row loop of bulk copies
    (``p1_rowloop``)."""
    device, timer = ctx
    out = []
    for probe, A, C, n_blocks in TILE_SHAPES:
        A, n_blocks = max(4, A // scale), max(1, n_blocks // scale)
        n = A * n_blocks
        table = torch.randn((n, C), generator=gen, device=device).to(torch.bfloat16)
        idx = torch.randint(0, A, (n,), generator=gen, device=device, dtype=torch.int32)
        flat = (torch.arange(n, device=device) // A * A + idx).long()
        shape = {"A": A, "C": C, "n_blocks": n_blocks}
        if probe in ROW_LOOPS:
            kernel, run = "gather_tile_rows_loop", lambda: gp.gather_tile_rows_loop(table, idx, A)
        else:
            lanes = shape["lanes_per_row"] = gp.default_lanes(C * 2)
            kernel, run = "gather_tile_rows", lambda: gp.gather_tile_rows(table, idx, A, lanes)
        out.append(_record(
            probe, kernel, ctx, run, lambda: gp.gather_tile_rows_plain(table, idx, A),
            lambda: torch.index_select(table, 0, flat), gather_bytes(table, flat), True, shape,
            {"M_rows_per_s": n}))
        del table, idx, flat
    return out


def probe_rows(ctx, gen, scale=1):
    """Rows 5a and 5b: the row gather from a table small enough to stay in
    the L2 cache (8 MB), and the tools' ``xla_take`` baseline as the library
    call. The two TPU kernels compute one function by two mechanisms: here
    lanes that share a row (``vmem_take``) and the row loop of bulk copies
    (``vmem_rowloop``). The bound counts the table rows the indices touch once
    (nearly all of them), the output and the indices."""
    device, timer = ctx
    T, C, N = ROWS_SHAPE[0] // scale, ROWS_SHAPE[1], ROWS_SHAPE[2] // scale
    table = torch.randn((T, C), generator=gen, device=device).to(torch.bfloat16)
    idx = torch.randint(0, T, (N,), generator=gen, device=device, dtype=torch.int32)
    lanes = gp.default_lanes(C * 2)
    n_bytes = gather_bytes(table, idx)
    runs = (("vmem_take", "gather_rows", lambda: gp.gather_rows(table, idx, lanes),
             {"lanes_per_row": lanes}),
            ("vmem_rowloop", "gather_rows_loop", lambda: gp.gather_rows_loop(table, idx), {}))
    return [_record(
        probe, kernel, ctx, run, lambda: gp.gather_rows_plain(table, idx),
        lambda: torch.index_select(table, 0, idx), n_bytes, True,
        {"T": T, "C": C, "N": N, **extra}, {"M_rows_per_s": N})
        for probe, kernel, run, extra in runs]


def probe_box_gather8(ctx, gen, scale=1):
    """Row 6: 8-channel requests into a box staged in shared memory. The
    bound counts the 32-byte runs of the boxes that the requests touch."""
    device, timer = ctx
    n_boxes, R = max(1, BOX8_SHAPE[0] // scale), BOX8_SHAPE[1] // min(scale, 16)
    box = torch.randn((n_boxes * gp.BOX_ROWS, 8, 128), generator=gen, device=device)
    dxyz = torch.randint(0, 16, (n_boxes * R, 3), generator=gen, device=device,
                         dtype=torch.int32)
    code = dxyz[:, 0] * 256 + dxyz[:, 1] * 16 + dxyz[:, 2]
    n = code.shape[0]
    # a request reads one 32-byte run of its box: the runs touched, once each
    touched = torch.unique(torch.arange(n, device=device) // R * 4096 + code).numel()
    return [_record(
        "vreg_gather_f32", "box_gather8", ctx,
        lambda: gp.box_gather8(box, code, R), lambda: gp.box_gather8_plain(box, code, R),
        None, touched * 32 + n * 4 + n * 32, True, {"n_boxes": n_boxes, "R": R},
        {"M_req_per_s": n})]


def probe_box_sum(ctx, gen, scale=1):
    """Row 7b: a box copied from a dynamic origin of a large table and
    reduced. Counted bytes: the boxes read once, origins, the output."""
    device, timer = ctx
    X, Y, Z, C = BOX_SUM_TABLE
    if scale > 1:
        X = Y = Z = 24
        C = 16
    table = torch.randn((X, Y, Z, C), generator=gen, device=device).to(torch.bfloat16)
    out = []
    for (BX, BY, BZ), n_boxes in BOX_SUM_SHAPES:
        n_boxes = max(2, n_boxes // scale)
        org = torch.stack([
            torch.randint(0, hi, (n_boxes,), generator=gen, device=device, dtype=torch.int32)
            for hi in (X - BX, Y - BY, Z - BZ)], dim=-1)
        n_bytes = n_boxes * (BX * BY * BZ * C * 2 + 12 + C * 4)
        out.append(_record(
            "p2_boxdma", "box_sum", ctx,
            lambda: gp.box_sum(table, org, (BX, BY, BZ)),
            lambda: gp.box_sum_plain(table, org, (BX, BY, BZ)), None, n_bytes, False,
            {"table": [X, Y, Z, C], "box": [BX, BY, BZ], "n_boxes": n_boxes},
            {"K_boxes_per_s": n_boxes * 1e3}))
    return out


def probe_slice_gather(ctx, gen, scale=1):
    """The tools' ``p3_slice_gather``: K consecutive rows per index, summed,
    with ``torch.index_select``. Not a kernel of the port: a library timing."""
    device, timer = ctx
    T, C, N = SLICE_SHAPE[0] // scale, SLICE_SHAPE[1], SLICE_SHAPE[2] // scale
    table = torch.randn((T, C), generator=gen, device=device).to(torch.bfloat16)
    out = []
    for K in (1, 2, 4, 8):
        idx = torch.randint(0, T - K, (N,), generator=gen, device=device)
        rows = (idx[:, None] + torch.arange(K, device=device)).reshape(-1)

        def fn():
            return torch.index_select(table, 0, rows).reshape(N, K * C).float().sum(dim=1)

        ms = timer(fn)[0]
        out.append({"probe": "torch_index_select_slices", "kernel": None, "K": K, "ok": True,
                    "timed_on": device.type, "ms": ms, "M_slices_per_s": N / ms / 1e3,
                    "M_rows_per_s": N * K / ms / 1e3})
    return out


def probe_k0_layouts(ctx, gen, scale=1):
    """The render's k0 query, one bank, one chunk: eight 24-byte corner rows
    from the [X*Y*Z, 12] bf16 bank against one 192-byte row of its packed
    table, each with the ``gather_rows`` kernel and with ``torch.index_select``.
    The gather alone is timed (not the weighted sum that follows either)."""
    device, timer = ctx
    X, Y, Z, C = K0_BANK
    if scale > 1:
        X = Y = Z = 12
    N = max(64, K0_QUERIES // scale)
    bank = torch.randn((X, Y, Z, C), generator=gen, device=device).to(torch.bfloat16)
    xyz01 = torch.rand((N, 3), generator=gen, device=device)
    idx8, _ = interp.trilerp_corners(xyz01, (X, Y, Z))
    base, _ = packed_ops.corner_base_and_weights(xyz01, (X, Y, Z))
    flat = bank.reshape(-1, C)
    packed = packed_ops.pack_corners(bank)
    idx8 = idx8.reshape(-1)
    if int(base.max()) >= packed.shape[0] or int(idx8.max()) >= flat.shape[0]:
        raise AssertionError("k0 layout probe: an index leaves its table")
    # both layouts deliver the same eight corner vectors
    if not torch.equal(gp.gather_rows(flat, idx8).reshape(N, 8 * C),
                       gp.gather_rows(packed, base)):
        raise AssertionError("k0 layout probe: the two layouts deliver different corners")
    out = []
    for layout, table, idx in (("8 corner rows of 24 B", flat, idx8),
                               ("1 packed row of 192 B", packed, base)):
        ms = timer(lambda: gp.gather_rows(table, idx))[0]
        lib = timer(lambda: torch.index_select(table, 0, idx))[0]
        out.append({"probe": "k0_layout", "kernel": "gather_rows", "layout": layout, "ok": True,
                    "timed_on": device.type, "bank": [X, Y, Z, C], "queries": N,
                    "table_MB": table.numel() * 2 / 1e6, "ms": ms, "library_ms": lib,
                    "M_queries_per_s": N / ms / 1e3,
                    "library_M_queries_per_s": N / lib / 1e3})
    return out


PROBES = (probe_tile_rows, probe_rows, probe_box_gather8, probe_box_sum, probe_slice_gather,
          probe_k0_layouts)


def run_all(device=None, seed: int = 0, log_fn=None) -> list:
    """Every probe's records, in the order of the kernel table. On the CPU
    the shapes are divided by ``TINY`` and the plain versions run."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ctx = (dev, _timer(dev))
    scale = 1 if dev.type == "cuda" else TINY
    records = []
    for probe in PROBES:
        for rec in probe(ctx, gen, scale):
            records.append(rec)
            if log_fn is not None:
                log_fn(json.dumps(rec))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return records


def main() -> list:
    """Prints one JSON line per probe and returns the records."""
    dev = resolve_device(None)
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "torch": torch.__version__}), flush=True)
    return run_all(dev, log_fn=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
