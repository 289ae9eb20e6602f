"""Design variants of the redesigned kernels, timed against each other.

    python -m unboundednerfpytorch_tpu_torch.probes.variants

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
error over the tolerance of ``march_backward_tolerance``. Needs a GPU and
``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from unboundednerfpytorch_tpu_torch.device import resolve_device
from unboundednerfpytorch_tpu_torch.ops.cuda import build, march
from unboundednerfpytorch_tpu_torch.probes.timing import MANY_LAUNCHES, time_ms

K0_SHAPE = (7, 199, 199, 199, 12)  # bicycle_single's k0 grid, bf16
MARCH_SHAPES = ((2048, 96, True), (8192, 96, False))  # N, S, residuals kept


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
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        err = fn(p.data_ptr(), g.data_ptr(), g.data_ptr(), 1, *K0_SHAPE, 0.05, 0.03, 0.02, 1.0, 1,
                 simple, torch.cuda.current_stream().cuda_stream)
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


def main() -> list:
    """Prints one JSON line per variant and round and returns the records."""
    dev = resolve_device(None)
    gen = torch.Generator(device=dev).manual_seed(0)
    records = []

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    emit({"device": torch.cuda.get_device_name(dev), "torch": torch.__version__})
    run_tv(gen, emit)
    run_march(gen, emit)
    run_march_backward(gen, emit)
    return records


if __name__ == "__main__":
    main()
