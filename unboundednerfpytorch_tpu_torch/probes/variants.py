"""Design variants of the redesigned kernels, timed against each other.

    python -m unboundednerfpytorch_tpu_torch.probes.variants [--only cumdist]
    python -m unboundednerfpytorch_tpu_torch.probes.variants --only gather_loop

Each variant is the committed source of ``csrc/tv.cu`` or ``csrc/march.cu``
with one constant replaced (a substitution that no longer finds its text
raises), built beside the others by ``nvcc`` and launched through ``ctypes``
on the same inputs, in two rounds. It answers what the kernels' header notes
state about the roads not taken: the span size, block size and wave count of
``tv_add_grad`` at the train step's k0 shape, what its staging costs without
its arithmetic, and the block and chunk shape of ``march_forward`` at the
train step's and a render chunk's shape, with what its exp/log1p and its scan
cost, and of ``march_backward`` at the train step's shape, with what its
``powf`` and its scan cost, and a cheaper form of the ``powf`` with its error.
One JSON line per variant and round; times are device times (a march launch is timed as many launches
in one CUDA graph); a variant that claims right values carries its worst
error over the tolerance of ``march_backward_tolerance``.

``cumdist_thres`` is timed at DCVGO's train step and render chunk shapes
([4096, 1063] and [8192, 1063], the step distances of bicycle.py's contracted
samples on seeded rays) and on distances that are all equal (no two walks
that start in different places ever reset together): the committed design
(a thread a ray, pieces through shared memory by bulk copies) with other
piece and ring sizes, against the design not taken, ``SPLIT_SOURCE``: k
lanes a ray, each walking its share of the samples from 0 at once, then a
fix-up that re-walks each share in order from the true incoming sum until
the true walk and the speculative one reset at the same sample (from there
on the two agree). Every variant's flags are held equal to the plain
version's.

The row loop of bulk copies (``gather_rows_loop`` and
``gather_tile_rows_loop`` of ``csrc/gather_probe.cu``) is timed at the gather
probe's row-loop shapes (``vmem_rowloop``: 524288 rows from an 8 MB table of
32768 x 128 bf16; ``p1_rowloop``: tiles of 2048 and 4096 rows, 2^20 rows
each): the committed design with other issuing warps a block and a
multiprocessor, other stage sizes, stage counts and copies in flight, and
one issuing lane a block (a block of one warp, two blocks a
multiprocessor), against the vector kernel launched with one thread a row
(the earlier row loop), with 16 lanes a row, and ``torch.index_select``.
Whether the time follows the issuers a multiprocessor says if the bulk
copies' issue or the copy engine and the memory bound a row loop of
256-byte copies. Each is timed as many launches in one CUDA graph, whatever
its length. Every variant's output is held equal to the plain version's.
Needs a GPU and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from unboundednerfpytorch_tpu_torch.device import resolve_device
from unboundednerfpytorch_tpu_torch.ops.cuda import build, march
from unboundednerfpytorch_tpu_torch.probes.timing import MANY_LAUNCHES, bound_ms, time_ms

K0_SHAPE = (7, 199, 199, 199, 12)  # bicycle_single's k0 grid, bf16
MARCH_SHAPES = ((2048, 96, True), (8192, 96, False))  # N, S, residuals kept
CUMDIST_RAYS = (4096, 8192)  # DCVGO's train step and render chunk


def _sub(src: str, *pairs: tuple[str, str]) -> str:
    for old, new in pairs:
        if old not in src:
            raise ValueError(f"variant text not found in the source: {old!r}")
        src = src.replace(old, new)
    return src


def tv_variants() -> dict[str, str]:
    src = build.SOURCES["tv"].read_text()
    span8k = ("constexpr int kSpanBytes = 16384;", "constexpr int kSpanBytes = 8192;")
    return {
        "as committed": src,
        "staging only (no neighbour arithmetic; wrong values)": _sub(
            src, ("const float acc = wx * ax + wy * ay + wz * az;", "const float acc = pc;")),
        "span 8 KB, three blocks a multiprocessor": _sub(
            src, span8k, ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 3)")),
        "1024 threads a block": _sub(
            src, ("constexpr int kThreads = 512;", "constexpr int kThreads = 1024;"),
            ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")),
        "sixteen waves of blocks": _sub(
            src, ("const long long want = (8LL * 2", "const long long want = (16LL * 2")),
    }


def march_variants() -> dict[str, str]:
    src = build.SOURCES["march"].read_text()
    out = {
        "no exp/log1p (alpha = density; wrong values)": _sub(
            src, ("a[c] = live ? 1.0f - expf(-softplus(d + shift) * interval) : 0.0f;",
                  "a[c] = live ? d : 0.0f;")),
        "no scan within a chunk (wrong values)": _sub(
            src, ("for (int o = 1; o < 32; o <<= 1) {", "for (int o = 32; o < 32; o <<= 1) {")),
    }
    for warps in (2, 4, 8):
        for chunks in (3, 4):
            out[f"{warps} warps a block, {chunks} chunks in flight"] = _sub(
                src, ("constexpr int kWarpsPerBlock = 8;",
                      f"constexpr int kWarpsPerBlock = {warps};"),
                ("constexpr int kChunks = 3;", f"constexpr int kChunks = {chunks};"))
    return out


POWF = "return interval * powf(1.0f + e, -interval - 1.0f) * fminf(e, 1e10f);"


def march_backward_variants() -> dict[str, str]:
    src = build.SOURCES["march"].read_text()
    out = {
        "no powf (wrong values)": _sub(src, (POWF, "return interval * fminf(e, 1e10f);")),
        # (1 + e)^(-interval - 1) = exp(-(interval + 1) * log1p(e))
        "powf as expf of log1pf": _sub(
            src, (POWF, "return interval * expf((-interval - 1.0f) * log1pf(e)) * "
                        "fminf(e, 1e10f);")),
        "powf as exp2f of log2f, fast intrinsics": _sub(
            src, (POWF, "return interval * exp2f((-interval - 1.0f) * __log2f(1.0f + e)) * "
                        "fminf(e, 1e10f);")),
        "no scan within a chunk (wrong values)": _sub(
            src, ("for (int o = 1; o < 32; o <<= 1) {\n#pragma unroll\n"
                  "      for (int c = 0; c < kBwdChunks; ++c) {",
                  "for (int o = 32; o < 32; o <<= 1) {\n#pragma unroll\n"
                  "      for (int c = 0; c < kBwdChunks; ++c) {")),
    }
    for warps in (2, 4, 8):
        for chunks in (2, 3, 4):
            out[f"{warps} warps a block, {chunks} chunks in flight"] = _sub(
                src, ("constexpr int kBwdWarpsPerBlock = 8;",
                      f"constexpr int kBwdWarpsPerBlock = {warps};"),
                ("constexpr int kBwdChunks = 3;", f"constexpr int kBwdChunks = {chunks};"))
    return out


def cumdist_variants() -> dict[str, str]:
    src = build.SOURCES["ub360"].read_text()
    piece = ("constexpr int kPiece = 128;", "constexpr int kPiece = {};")
    slots = ("constexpr int kSlots = 4;", "constexpr int kSlots = {};")
    out = {"as committed": src}
    for p, k in ((64, 8), (256, 2), (128, 2), (128, 8)):
        out[f"pieces of {p} samples, a ring of {k} slots"] = _sub(
            src, (piece[0], piece[1].format(p)), (slots[0], slots[1].format(k)))
    for w in (1, 2, 8):
        out[f"{w} producer warps"] = _sub(
            src, ("constexpr int kProducers = 4;", f"constexpr int kProducers = {w};"))
    for g in (4, 16):
        out[f"groups of {g} samples in registers"] = _sub(
            src, ("constexpr int kGroup = 8;", f"constexpr int kGroup = {g};"))
    out["no chain (a sample's flag from its own distance; wrong values)"] = _sub(
        src, ("const float c = __fadd_rn(cum, x[k]);", "const float c = x[k];"))
    return out


def gather_loop_variants() -> dict[str, str]:
    src = build.SOURCES["gather_probe"].read_text()
    consts = {"warps": "kLoopWarps = {};", "stage": "kLoopStageBytes = {};",
              "stages": "kLoopStages = {};", "ahead": "kLoopAhead = {};",
              "per_sm": "kLoopMaxBlocksPerSm = {};"}
    committed = {"warps": 8, "stage": 4096, "stages": 3, "ahead": 2, "per_sm": 1}

    def variant(**kw):
        return _sub(src, *((f"constexpr int {consts[k].format(committed[k])}",
                            f"constexpr int {consts[k].format(v)}") for k, v in kw.items()))

    # issuers a multiprocessor at 256-byte rows; "as many blocks as fit" is
    # set by the shared memory each block takes (227 KB a multiprocessor)
    return {
        "as committed: 8 issuing warps a block, stages of 16 rows, 3 stages, 2 ahead, "
        "one block an SM (8 issuers)": src,
        "as many blocks as fit (2 an SM: 16 issuers)": variant(per_sm=32),
        "4 warps a block (4 issuers)": variant(warps=4),
        "16 warps a block, stages of 8 rows (16 issuers)": variant(warps=16, stage=2048),
        "16 warps a block, stages of 8 rows, as many blocks as fit (2: 32 issuers)": variant(
            warps=16, stage=2048, per_sm=32),
        "stages of 8 rows, 4 stages, 3 ahead (8 issuers)": variant(stage=2048, stages=4, ahead=3),
        "2 stages, 1 ahead (8 issuers)": variant(stages=2, ahead=1),
        "stages of 32 rows, 2 stages, 1 ahead (8 issuers)": variant(stage=8192, stages=2, ahead=1),
        "one issuing lane a block: a block of one warp, 8 stages of 32 rows, 6 ahead, "
        "2 blocks an SM (2 issuers)": variant(warps=1, stage=8192, stages=8, ahead=6, per_sm=2),
    }


# the design not taken for cumdist_thres: k lanes a ray (k divides 32, the
# lanes of a ray neighbours in a warp), distances and flags straight from and
# to device memory
SPLIT_SOURCE = r"""
#include <cuda_runtime.h>

template <int K>
__global__ void split_kernel(const float* __restrict__ dist, float thres, int N, int S,
                             unsigned char* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int sub = lane % K;
  const long long ray = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / K;
  const bool live = ray < N;
  const int L = (S + K - 1) / K;
  const int c0 = min(S, sub * L), c1 = min(S, c0 + L);
  const float* d = dist + ray * S;
  unsigned char* o = out + ray * S;
  float cum = 0.f;  // the speculative walk, from 0
  if (live)
    for (int j = c0; j < c1; ++j) {
      cum = __fadd_rn(cum, d[j]);
      const bool over = cum > thres;
      cum = over ? __fmul_rn(cum, 0.f) : cum;
      o[j] = over;
    }
  float end = cum;  // the true sum leaving this share, once known
  for (int i = 1; i < K; ++i) {
    const float in = __shfl_sync(0xffffffffu, end, (lane - sub) + i - 1);
    if (sub == i && live) {
      float c = in;
      bool merged = false;
      for (int j = c0; j < c1 && !merged; ++j) {
        c = __fadd_rn(c, d[j]);
        const bool over = c > thres;
        c = over ? __fmul_rn(c, 0.f) : c;
        merged = over && o[j];
        o[j] = over;
      }
      if (!merged) end = c;
    }
  }
}

extern "C" int cumdist_split(const void* dist, float thres, int N, int S, void* out, int k,
                             void* stream) {
  if (N <= 0 || S <= 0) return 0;
  const long long threads = (long long)N * k;
  const int blocks = (int)((threads + 127) / 128);
  auto s = (cudaStream_t)stream;
  auto d = (const float*)dist;
  auto o = (unsigned char*)out;
  switch (k) {
    case 4: split_kernel<4><<<blocks, 128, 0, s>>>(d, thres, N, S, o); break;
    case 8: split_kernel<8><<<blocks, 128, 0, s>>>(d, thres, N, S, o); break;
    case 16: split_kernel<16><<<blocks, 128, 0, s>>>(d, thres, N, S, o); break;
    case 32: split_kernel<32><<<blocks, 128, 0, s>>>(d, thres, N, S, o); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
"""
SPLIT_LANES = (4, 8, 16, 32)


def compile_all(variants: dict[str, str], stem: str) -> dict[str, ctypes.CDLL]:
    """One ``nvcc`` per variant, all started together."""
    work = build.BUILD_DIR / "variants"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    procs = {}
    for i, (name, text) in enumerate(variants.items()):
        cu, so = work / f"{stem}_{i}.cu", work / f"{stem}_{i}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def run_tv(gen, emit) -> None:
    libs = compile_all(tv_variants(), "tv")
    p = torch.randn(K0_SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn(K0_SHAPE, generator=gen, device="cuda").to(torch.bfloat16)

    def launch(lib, simple):
        fn = lib.tv_add_grad
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        err = fn(p.data_ptr(), g.data_ptr(), g.data_ptr(), None, None, 1, *K0_SHAPE, 0.05, 0.03,
                 0.02, 1.0, 1, simple, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"tv_add_grad: CUDA error {err}")

    for rnd in range(2):
        for name, lib in libs.items():
            emit({"kernel": "tv_add_grad", "shape": list(K0_SHAPE), "variant": name,
                  "round": rnd, "ms": time_ms(lambda: launch(lib, 0), iters=10)})
        emit({"kernel": "tv_add_grad", "shape": list(K0_SHAPE), "round": rnd,
              "variant": "one thread an element (the first version)",
              "ms": time_ms(lambda: launch(libs["as committed"], 1), iters=10)})


def run_march(gen, emit) -> None:
    libs = compile_all(march_variants(), "march")
    for N, S, residuals in MARCH_SHAPES:
        d = torch.randn((N, S), generator=gen, device="cuda") * 3.0
        mask = torch.rand((N, S), generator=gen, device="cuda") > 0.2
        w, alpha, t_excl = (torch.empty_like(d) for _ in range(3))
        ai = torch.empty(N, device="cuda")

        def launch(lib):
            fn = lib.march_forward
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
                           ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
            err = fn(d.data_ptr(), mask.data_ptr(), -4.0, 0.5, N, S, w.data_ptr(),
                     ai.data_ptr(), alpha.data_ptr(), t_excl.data_ptr() if residuals else None,
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"march_forward: CUDA error {err}")

        for rnd in range(2):
            for name, lib in libs.items():
                emit({"kernel": "march_forward", "shape": [N, S], "residuals": residuals,
                      "variant": name, "round": rnd,
                      "ms": time_ms(lambda: launch(lib), launches=MANY_LAUNCHES)})


def run_march_backward(gen, emit) -> None:
    libs = compile_all(march_backward_variants(), "march_backward")
    N, S, _ = MARCH_SHAPES[0]
    shift, interval = -4.0, 0.5
    # a third of the rays opaque, a third empty, a third mixed
    kind = torch.arange(N, device="cuda") % 3
    d = torch.randn((N, S), generator=gen, device="cuda") * 3.0
    d = d + 12.0 * (kind == 0)[:, None] - 15.0 * (kind == 1)[:, None]
    mask = torch.rand((N, S), generator=gen, device="cuda") > 0.2
    _, ai, alpha, t_excl = march.march_forward(d, mask, shift, interval)
    gw = torch.randn((N, S), generator=gen, device="cuda")
    gl = torch.randn((N,), generator=gen, device="cuda")
    gd = torch.empty_like(d)
    inputs = (alpha, t_excl, ai, gw, gl, shift, interval, d, mask)
    ref = march.march_backward_plain(*inputs)
    tol = march.march_backward_tolerance(*inputs)

    def launch(lib):
        fn = lib.march_backward
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_float] + [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p]
        err = fn(alpha.data_ptr(), t_excl.data_ptr(), ai.data_ptr(), gw.data_ptr(),
                 gl.data_ptr(), shift, interval, d.data_ptr(), mask.data_ptr(), N, S,
                 gd.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"march_backward: CUDA error {err}")

    def record(name, rnd, lib):
        rec = {"kernel": "march_backward", "shape": [N, S], "variant": name, "round": rnd,
               "ms": time_ms(lambda: launch(lib), launches=MANY_LAUNCHES)}
        if "wrong values" not in name:
            launch(lib)
            torch.cuda.synchronize()
            rec["worst_error_over_tolerance"] = float(((gd - ref).abs() / tol).max())
        emit(rec)

    for rnd in range(2):
        for name, lib in libs.items():
            record(name, rnd, lib)


def cumdist_cases(gen) -> list:
    """(label, dist, thres): bicycle.py's step distances at the train step's
    and a render chunk's shape, as ``dcvgo.oversample_mask`` hands them to the
    kernel, and all-equal distances at the train step's shape."""
    from unboundednerfpytorch_tpu_torch.configs import loader
    from unboundednerfpytorch_tpu_torch.models import dcvgo

    fm = loader.load_config(str(build.PACKAGE_DIR.parent / "configs" / "nerf_unbounded" /
                                "bicycle.py")).fine_model_and_render
    dc = dcvgo.config_from(fm, (-1.0,) * 3, (1.0,) * 3, fm.num_voxels_rgb)
    thres = (2 + 2 * dc.bg_len) / dc.world_len * dc.stepsize * 0.95
    out = []
    for n in CUMDIST_RAYS:
        ro = torch.randn((n, 3), generator=gen, device="cuda") * 1.5
        rd = torch.randn((n, 3), generator=gen, device="cuda") * 0.5 - ro
        pts, _, _ = dcvgo.sample_ray(dc, ro, rd)
        diff = pts[:, 1:] - pts[:, :-1]
        out.append((f"bicycle.py distances {[n, pts.shape[1] - 1]}",
                    torch.sqrt((diff * diff).sum(-1)).contiguous(), thres))
    shape = out[0][1].shape
    out.append((f"all distances 0.3 of the threshold {list(shape)}",
                torch.full(shape, 0.3 * thres, device="cuda"), thres))
    return out


def run_cumdist(gen, emit) -> None:
    from unboundednerfpytorch_tpu_torch.ops import sampling

    libs = compile_all(cumdist_variants(), "ub360")
    split = compile_all({"split": SPLIT_SOURCE}, "cumdist_split")["split"]
    split.cumdist_split.restype = ctypes.c_int
    split.cumdist_split.argtypes = [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    for lib in libs.values():
        lib.cumdist_thres.restype = ctypes.c_int
        lib.cumdist_thres.argtypes = [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    for label, dist, thres in cumdist_cases(gen):
        N, S = dist.shape
        want = sampling.cumdist_thres_plain(dist, thres)
        out = torch.empty((N, S), dtype=torch.bool, device="cuda")
        runs = {f"one thread a ray: {name}":
                (lambda lib=lib: lib.cumdist_thres(dist.data_ptr(), thres, N, S, out.data_ptr(),
                                                   torch.cuda.current_stream().cuda_stream))
                for name, lib in libs.items()}
        for k in SPLIT_LANES:
            runs[f"{k} lanes a ray, speculative walk and fix-up"] = (
                lambda k=k: split.cumdist_split(dist.data_ptr(), thres, N, S, out.data_ptr(), k,
                                                torch.cuda.current_stream().cuda_stream))

        def launch(fn):
            err = fn()
            if err != 0:
                raise RuntimeError(f"cumdist_thres variant: CUDA error {err}")

        for rnd in range(2):
            for name, fn in runs.items():
                out.zero_()
                launch(fn)
                torch.cuda.synchronize()
                emit({"kernel": "cumdist_thres", "shape": [N, S], "inputs": label,
                      "variant": name, "round": rnd,
                      "equal_to_plain": bool(torch.equal(out, want)),
                      "ms": time_ms(lambda: launch(fn), launches=MANY_LAUNCHES)})


def gather_loop_cases(gen) -> list:
    """(probe, table, idx, tile or 0, bytes of the bound): the gather
    probe's row-loop shapes and inputs."""
    from unboundednerfpytorch_tpu_torch.probes import gather

    out = []
    T, C, N = gather.ROWS_SHAPE
    table = torch.randn((T, C), generator=gen, device="cuda").to(torch.bfloat16)
    idx = torch.randint(0, T, (N,), generator=gen, device="cuda", dtype=torch.int32)
    out.append(("vmem_rowloop", table, idx, 0, gather.gather_bytes(table, idx)))
    for probe, A, C, n_blocks in gather.TILE_SHAPES:
        if probe in gather.ROW_LOOPS:
            n = A * n_blocks
            table = torch.randn((n, C), generator=gen, device="cuda").to(torch.bfloat16)
            idx = torch.randint(0, A, (n,), generator=gen, device="cuda", dtype=torch.int32)
            flat = torch.arange(n, device="cuda") // A * A + idx
            out.append((probe, table, idx, A, gather.gather_bytes(table, flat)))
    return out


def run_gather_loop(gen, emit) -> None:
    from unboundednerfpytorch_tpu_torch.ops.cuda import gather_probe as gp

    libs = compile_all(gather_loop_variants(), "gather_probe")
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for lib in libs.values():
        for name in ("gather_rows_loop", "gather_tile_rows_loop"):
            getattr(lib, name).restype = I
            getattr(lib, name).argtypes = [P, P, I, LL, LL, I, P, P]
        for name in ("gather_rows", "gather_tile_rows"):
            getattr(lib, name).restype = I
            getattr(lib, name).argtypes = [P, P, I, LL, LL, I, I, P, P]
    vector = libs[next(iter(libs))]  # the committed source's vector kernel
    for probe, table, idx, tile, n_bytes in gather_loop_cases(gen):
        n, row_bytes = idx.shape[0], table.shape[1] * 2
        want = (gp.gather_tile_rows_plain(table, idx, tile) if tile
                else gp.gather_rows_plain(table, idx))
        out = torch.empty_like(want)
        # the flat gather takes the table's rows, the tiled one the tile
        head = (table.data_ptr(), idx.data_ptr(), 0, n, tile or table.shape[0], row_bytes)
        loop = "gather_tile_rows_loop" if tile else "gather_rows_loop"
        vec = "gather_tile_rows" if tile else "gather_rows"

        def stream():
            return torch.cuda.current_stream().cuda_stream

        runs = {f"row loop of bulk copies: {name}":
                (lambda lib=lib: getattr(lib, loop)(*head, out.data_ptr(), stream()))
                for name, lib in libs.items()}
        for lanes, label in ((1, "one thread a row (the earlier row loop)"),
                             (gp.default_lanes(row_bytes), "16 lanes a row")):
            runs[f"vector kernel, {label}"] = (
                lambda lanes=lanes: getattr(vector, vec)(*head, lanes, out.data_ptr(), stream()))
        flat = ((torch.arange(n, device="cuda") // tile * tile + idx).long() if tile
                else idx)
        bnd = bound_ms(n_bytes, 0)[0]

        def launch(fn):
            err = fn()
            if err != 0:
                raise RuntimeError(f"gather loop variant: CUDA error {err}")

        for rnd in range(2):
            for name, fn in runs.items():
                out.zero_()
                launch(fn)
                torch.cuda.synchronize()
                ms = time_ms(lambda: launch(fn), launches=MANY_LAUNCHES)
                emit({"kernel": loop, "probe": probe, "shape": list(table.shape), "N": n,
                      "tile": tile, "variant": name, "round": rnd,
                      "equal_to_plain": bool(torch.equal(out, want)), "ms": ms,
                      "bound_ms": bnd, "share_of_bound": bnd / ms})
            ms = time_ms(lambda: torch.index_select(table, 0, flat), launches=MANY_LAUNCHES)
            emit({"kernel": loop, "probe": probe, "shape": list(table.shape), "N": n,
                  "tile": tile, "variant": "torch.index_select", "round": rnd, "ms": ms,
                  "bound_ms": bnd, "share_of_bound": bnd / ms})


RUNS = {"tv": run_tv, "march": run_march, "march_backward": run_march_backward,
        "cumdist": run_cumdist, "gather_loop": run_gather_loop}


def main(argv=None) -> list:
    """Prints one JSON line per variant and round and returns the records.
    ``--only cumdist`` (or ``tv``, ``march``, ``march_backward``,
    ``gather_loop``) runs one kernel's variants."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=sorted(RUNS), action="append")
    args = ap.parse_args([] if argv is None else argv)
    dev = resolve_device(None)
    gen = torch.Generator(device=dev).manual_seed(0)
    records = []

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    emit({"device": torch.cuda.get_device_name(dev), "torch": torch.__version__})
    for name, run in RUNS.items():
        if not args.only or name in args.only:
            run(gen, emit)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
