#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--steps 20] [--views 20] [--profile]

Phases, each reported on its own line:
  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  2. build every hand-written kernel from ``unboundednerfpytorch_tpu_torch/csrc``
     (one ``nvcc`` per source, all started together);
  3. hold each kernel against its plain PyTorch version on the card at the
     shapes the train step gives it, and time kernel, plain version and bound;
  4. train the FourierGrid fine stage of
     ``configs/nerf_unbounded/bicycle_single.py`` at full width (``pg_scale=()``,
     so the grids start at their final ~200^3 x 7 banks) on a seeded synthetic
     scene of bicycle's size, with launch counts checked, then compare a
     forward on the card with the plain path on the CPU. ``--profile`` also
     traces the last steps with ``torch.profiler`` and prints the device time
     by kernel.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Any failed phase raises, so the script
exits non-zero and prints no result. It needs a CUDA device and the rest of
the repository beside it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "nerf_unbounded" / "bicycle_single.py"

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s
# and float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

PROFILED_STEPS = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(name: str, got, ref, rtol: float, atol: float) -> float:
    """max |got - ref| must be <= atol + rtol * max |ref| (sums are taken in
    another order by kernel and plain version). Returns the max error."""
    import torch

    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((got - ref).abs().max())
    tol = atol + rtol * float(ref.abs().max())
    log(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")
    return err


def check_each(name: str, got, ref, rtol: float, atol: float) -> float:
    """Every element: |got - ref| <= atol + rtol * |ref|, where ``ref`` is
    the plain version's float32 result. For a bfloat16 ``got`` the bound is
    half a bfloat16 step of ``ref`` (the one rounding the kernel's store may
    add) plus ``rtol * |ref|`` for the float32 sum order. Returns the max
    error."""
    import torch

    rounded = got.dtype == torch.bfloat16
    got = got.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    diff = (got - ref).abs()
    tol = atol + rtol * ref.abs()
    if rounded:  # |ref| = m * 2^e, 0.5 <= m < 1: a bfloat16 step there is 2^(e-8)
        tol += torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 9)
    err = float(diff.max())
    worst = float((diff / tol).max())
    log(f"  {name}: max_abs_err {err:.3e}, worst error / its element's tolerance {worst:.3f}")
    if not worst <= 1.0:
        raise AssertionError(f"{name}: an element exceeds its tolerance ({worst} x)")
    return err


def phase_device() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"[1] card: {smi}")
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    return smi.splitlines()[0]


def phase_build() -> None:
    from unboundednerfpytorch_tpu_torch.ops.cuda import build

    t0 = time.time()
    logs = build.build(ptxas_verbose=True)
    log(f"[2] built {sorted(build.SOURCES)} in {time.time() - t0:.1f} s")
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def slice_config(steps: int):
    """bicycle_single with its fine stage started at the final grid."""
    from unboundednerfpytorch_tpu_torch.configs import loader

    cfg = loader.load_config(str(CONFIG))
    return dataclasses.replace(
        cfg, fine_train=dataclasses.replace(cfg.fine_train, pg_scale=(), N_iters=steps))


def slice_shapes(cfg):
    """The shapes the train step hands the kernels: the density and k0 grids
    [2K+1, X, Y, Z, C] (the world size does not depend on the scene box) and
    the [N_rand, sample_budget] march."""
    from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg

    fm = cfg.fine_model_and_render
    mcfg = fg.config_from(fm, (-1.0,) * 3, (1.0,) * 3, fm.num_voxels_density,
                          fm.num_voxels_rgb)
    banks = 2 * mcfg.fourier_freq_num + 1
    tv_shapes = {"k0": (banks, *mcfg.world_size_rgb, mcfg.k0_dim),
                 "density": (banks, *mcfg.world_size_density, 1)}
    march = (cfg.fine_train.N_rand, mcfg.sample_budget)
    return tv_shapes, march, mcfg.act_shift, mcfg.stepsize * mcfg.voxel_size_ratio_density


def phase_tv(gen, tv_shapes) -> dict:
    import torch

    from unboundednerfpytorch_tpu_torch.ops.cuda import tv

    w = (0.3, 0.2, 0.1)
    err = 0.0
    main = {}
    for label, shape in tv_shapes.items():
        for dtype in (torch.bfloat16, torch.float32):
            p = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            g = torch.randn(shape, generator=gen, device="cuda")
            g = (g * (torch.rand(shape, generator=gen, device="cuda") > 0.4)).to(dtype)
            for gate in (0.0, 1.0):
                for dense in (False, True):
                    got = tv.tv_add_grad(p, g, *w, gate, dense)
                    # float32 result of the same inputs, before any bf16 store
                    ref = tv.tv_add_grad_plain(p.float(), g.float(), *w, gate, dense)
                    torch.cuda.synchronize()
                    err = max(err, check_each(
                        f"tv {label} {tuple(shape)} {str(dtype)[6:]} gate={gate:g} "
                        f"dense={dense}", got, ref, 1e-5, 1e-6))
                    del got, ref
            if dtype == torch.bfloat16:  # the train step's case: bf16, dense, in place
                out = torch.empty_like(g)
                main[label] = (
                    time_ms(lambda: tv.tv_add_grad(p, g, *w, 1.0, True, out=out)),
                    time_ms(lambda: tv.tv_add_grad_plain(p, g, *w, 1.0, True), iters=5),
                    3 * p.numel() * p.element_size(),
                    25 * p.numel(),
                )
                del out
            del p, g
            torch.cuda.empty_cache()
    ms = sum(v[0] for v in main.values())
    plain = sum(v[1] for v in main.values())
    bnd, by = bound_ms(sum(v[2] for v in main.values()), sum(v[3] for v in main.values()))
    log(f"[3] tv_add_grad per step (k0 + density, bf16): {ms:.3f} ms, plain {plain:.3f} ms, "
        f"bound {bnd:.3f} ms ({by})")
    return {"name": "tv_add_grad", "route": "cuda",
            "source": "unboundednerfpytorch_tpu_torch/csrc/tv.cu",
            "replaces": "unboundednerfpytorch_tpu/ops/pallas/tv.py:137",
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bnd,
            "bound_by": by, "library_ms": None}


def march_inputs(gen, shape):
    """[N, S] densities: a third of the rays opaque (the early exit
    fires), a third empty, a third mixed; a fifth of the samples masked."""
    import torch

    N, S = shape
    d = torch.randn((N, S), generator=gen, device="cuda") * 3.0
    kind = torch.arange(N, device="cuda") % 3
    d = torch.where((kind == 0)[:, None], d + 12.0, d)
    d = torch.where((kind == 1)[:, None], d - 15.0, d)
    mask = torch.rand((N, S), generator=gen, device="cuda") > 0.2
    return d, mask


def phase_march(gen, shape, shift: float, interval: float) -> list:
    import torch

    from unboundednerfpytorch_tpu_torch.ops.cuda import march

    N, S = shape
    d, mask = march_inputs(gen, shape)
    w, ai, alpha, t_excl = march.march_forward(d, mask, shift, interval)
    w_ref, ai_ref, alpha_ref = march.fused_alpha2weights_plain(d, mask, shift, interval)
    torch.cuda.synchronize()
    exits = int((t_excl[:, -1] < 1e-3).sum())
    log(f"[3] march inputs: {exits} of {N} rays exit early")
    if exits == 0:
        raise AssertionError("march inputs never reach the early exit")
    err_f = max(check("march_forward weights", w, w_ref, 1e-5, 1e-6),
                check("march_forward alphainv_last", ai, ai_ref, 1e-5, 1e-6),
                check("march_forward alpha", alpha, alpha_ref, 1e-5, 1e-6))

    gw = torch.randn((N, S), generator=gen, device="cuda")
    gl = torch.randn((N,), generator=gen, device="cuda")
    gd = march.march_backward(alpha, t_excl, ai, gw, gl, shift, interval, d, mask)
    gd_ref = march.march_backward_plain(alpha, t_excl, ai, gw, gl, shift, interval, d, mask)
    torch.cuda.synchronize()
    err_b = check("march_backward", gd, gd_ref, 1e-5, 1e-6)

    f_ms = time_ms(lambda: march.march_forward(d, mask, shift, interval), iters=50)
    f_plain = time_ms(lambda: march.fused_alpha2weights_plain(d, mask, shift, interval), iters=50)
    b_ms = time_ms(lambda: march.march_backward(alpha, t_excl, ai, gw, gl, shift, interval,
                                                d, mask), iters=50)
    b_plain = time_ms(lambda: march.march_backward_plain(alpha, t_excl, ai, gw, gl, shift,
                                                         interval, d, mask), iters=50)
    ns = N * S
    # forward: read density + mask, write weights, alpha, t_excl and alphainv;
    # backward: read alpha, t_excl, gw, density, mask, alphainv, gl, write gd
    f_bnd, f_by = bound_ms(ns * (4 + 1 + 3 * 4) + N * 4, 25 * ns)
    b_bnd, b_by = bound_ms(ns * (4 * 4 + 1 + 4) + 2 * N * 4, 30 * ns)
    log(f"[3] march_forward {f_ms:.4f} ms, plain {f_plain:.4f} ms, bound {f_bnd:.5f} ms ({f_by})")
    log(f"[3] march_backward {b_ms:.4f} ms, plain {b_plain:.4f} ms, bound {b_bnd:.5f} ms ({b_by})")
    src = "unboundednerfpytorch_tpu_torch/csrc/march.cu"
    return [
        {"name": "march_forward", "route": "cuda", "source": src,
         "replaces": "unboundednerfpytorch_tpu/ops/pallas/march.py:161", "max_abs_err": err_f,
         "ms": f_ms, "plain_ms": f_plain, "bound_ms": f_bnd, "bound_by": f_by,
         "library_ms": None},
        {"name": "march_backward", "route": "cuda", "source": src,
         "replaces": "unboundednerfpytorch_tpu/ops/pallas/march.py:197", "max_abs_err": err_b,
         "ms": b_ms, "plain_ms": b_plain, "bound_ms": b_bnd, "bound_by": b_by,
         "library_ms": None},
    ]


def profile_summary(prof, n_steps: int, step_ms: float) -> None:
    """Device time over the profiled steps: its share of the unprofiled
    step's wall time (the profiler slows the host, not the device), by phase
    and by kernel. A phase is a ``record_function`` range of the train step
    or loop; the profiler credits a range only with kernels that torch ops
    launch, so the hand-written kernels (launched through ``ctypes``) are
    counted by name, and the backward (on autograd's thread, outside its
    range) is what remains."""
    from torch.autograd import DeviceType

    from unboundednerfpytorch_tpu_torch.ops.cuda import build

    avgs = prof.key_averages()
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    if not kernels:
        log("[4] profile: torch.profiler saw no device kernels")
        return
    per_step = lambda us: us / 1e3 / n_steps
    busy = per_step(sum(e.self_device_time_total for e in kernels))
    log(f"[4] profile over {n_steps} steps: device busy {busy:.2f} ms/step, "
        f"{100 * busy / step_ms:.1f}% of the {step_ms:.1f} ms unprofiled step")
    phases = {e.key: per_step(e.device_time_total) for e in avgs
              if e.device_type == DeviceType.CPU
              and e.key in ("train_loop/batch", "train_step/forward_loss", "train_step/adam")}
    for name in build.KERNELS:
        phases[f"kernel {name}"] = per_step(sum(
            e.self_device_time_total for e in kernels if f"{name}_kernel" in e.key))
    phases["backward and the rest"] = busy - sum(phases.values())
    for name, ms in phases.items():
        log(f"  {name}: {ms:.3f} ms/step ({100 * ms / busy:.1f}% of device time)")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:15]:
        log(f"  {per_step(e.self_device_time_total):9.3f} ms/step "
            f"{e.count / n_steps:6.1f}x  {e.key[:110]}")


def phase_train(cfg, steps: int, views: int, profile: bool) -> dict:
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch.convert import (
        fourier_grid_params_from_numpy, fourier_grid_params_to_numpy,
    )
    from unboundednerfpytorch_tpu_torch.data import synthetic
    from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.train import bbox as bbox_mod
    from unboundednerfpytorch_tpu_torch.train import loop

    fm, ft = cfg.fine_model_and_render, cfg.fine_train
    log(f"[4] config {CONFIG.relative_to(ROOT)}: {fm.num_voxels_density} voxels, "
        f"freq {fm.fourier_freq_num}, rgbnet_dim {fm.rgbnet_dim}, width {fm.rgbnet_width}, "
        f"grid {fm.grid_dtype}, N_rand {ft.N_rand}, sample_budget {fm.sample_budget}, "
        f"probe stride {fm.budget_probe_stride}, weights main {ft.weight_main} entropy "
        f"{ft.weight_entropy_last} nearclip {ft.weight_nearclip} distortion "
        f"{ft.weight_distortion} rgbper {ft.weight_rgbper}, tv {ft.weight_tv_density}/"
        f"{ft.weight_tv_k0}, rand_bkgd {cfg.data.rand_bkgd}")

    t0 = time.time()
    H, W = 411, 618  # bicycle at factor=8
    data = synthetic.orbit_scene(views, H, W, seed=0)
    xyz_min, xyz_max = bbox_mod.compute_bbox_by_cam_frustrm(cfg, data, "FourierGrid",
                                                            device="cuda")
    seed_fn = synthetic.occupancy_seed((xyz_min + xyz_max) / 2, (xyz_max - xyz_min) / 2)
    log(f"[4] scene: {views} views of {H}x{W} in {time.time() - t0:.1f} s")

    # a fixed evaluation batch, composited on grey (the mean of rand_bkgd's
    # uniform draw): the model at init and after the steps
    store = loop.gather_training_rays(cfg, data, "cpu")
    idx = torch.from_numpy(np.random.default_rng(1).integers(0, views * H * W, 4096))
    ev_rays = [store[k][idx] for k in ("rays_o", "rays_d", "viewdirs", "rgb")]
    del store

    def eval_psnr(params, mcfg, device):
        ro, rd, vd, rgb = (t.to(device) for t in ev_rays)
        with torch.no_grad():
            out = fg.forward(params, mcfg, ro, rd, vd, bg=0.5)
        return out, float(-10.0 * torch.log10(torch.mean((out.rgb_marched - rgb) ** 2)))

    psnrs, stamps = [], []
    first_profiled = steps - PROFILED_STEPS + 1 if profile else steps + 1
    # made only when asked for: an unused profiler object crashes the
    # interpreter at exit ("Requested callback is not found", torch 2.11)
    prof = None
    if profile:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA],
                                      acc_events=True)

    def callback(step, metrics):
        loss = float(metrics["loss"])  # synchronises the step
        stamps.append(time.perf_counter())
        psnrs.append(float(metrics["psnr"]))
        if not np.isfinite(loss):
            raise AssertionError(f"step {step}: loss {loss}")
        if prof is not None and step == first_profiled - 1:
            prof.start()
        elif prof is not None and step == steps:
            prof.stop()

    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t_start = time.perf_counter()
    _, mcfg, params, _ = loop.run_train(cfg, data, seed=0, device="cuda", log_fn=log, log_every=5,
                                        callback=callback, coarse_mask_fn=seed_fn)
    counts = dict(build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    dts = np.diff([t_start] + stamps) * 1e3
    unprofiled = dts[:first_profiled - 1]
    step_ms = float(np.median(unprofiled[3:] if len(unprofiled) > 3 else unprofiled))
    log(f"[4] grids density {tuple(params.density.grid.shape)} k0 "
        f"{tuple(params.k0.grid.shape)} {params.k0.grid.dtype}; S={2 * mcfg.n_inner} -> "
        f"budget {mcfg.sample_budget}")
    log(f"[4] {steps} steps: train psnr first {psnrs[0]:.4f} last {psnrs[-1]:.4f}; "
        f"ms/step median after warm-up {step_ms:.1f} (first step {dts[0]:.1f}); "
        f"peak memory {peak_gb:.2f} GB; launches {counts}")
    want = {"tv_add_grad": 2 * steps, "march_forward": steps, "march_backward": steps}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    if profile:
        profile_summary(prof, PROFILED_STEPS, step_ms)

    init = fg.create(mcfg, torch.Generator().manual_seed(0), device="cuda")
    init.mask_cache.mask = params.mask_cache.mask
    _, psnr_init = eval_psnr(init, mcfg, "cuda")
    del init
    _, psnr_trained = eval_psnr(params, mcfg, "cuda")
    log(f"[4] eval psnr (4096 fixed rays, grey background): init {psnr_init:.5f} -> "
        f"after {steps} steps {psnr_trained:.5f}")
    if not psnr_trained > psnr_init:
        raise AssertionError("eval psnr did not rise")

    # the trained model on the card against the plain path on the CPU. Both
    # take an all-true occupancy cache: the nearest-voxel lookup may round a
    # point differently on the two devices, which would select other samples
    cpu_params = fourier_grid_params_from_numpy(fourier_grid_params_to_numpy(params), "cpu")
    for name in ("density", "k0"):
        grid = getattr(cpu_params, name).grid
        grid.data = grid.data.to(getattr(params, name).grid.dtype)
    cpu_params.mask_cache.mask = torch.ones_like(cpu_params.mask_cache.mask)
    params.mask_cache.mask = torch.ones_like(params.mask_cache.mask)
    out_gpu, _ = eval_psnr(params, mcfg, "cuda")
    out_cpu, _ = eval_psnr(cpu_params, mcfg, "cpu")
    for field in ("rgb_marched", "alphainv_last", "weights"):
        got, ref = getattr(out_gpu, field), getattr(out_cpu, field)
        if got.shape != ref.shape:
            raise AssertionError(f"{field}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
        check(f"trained forward {field} (card vs CPU plain path)", got.cpu(), ref, 1e-4, 1e-5)
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--views", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help=f"trace the last {PROFILED_STEPS} train steps with torch.profiler")
    args = ap.parse_args(argv)
    if args.profile and args.steps < PROFILED_STEPS + 4:
        ap.error(f"--profile needs --steps >= {PROFILED_STEPS + 4}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if not (ROOT / "unboundednerfpytorch_tpu_torch").is_dir() or not CONFIG.is_file():
        print(f"chip_smoke: the repository is not beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    # float32 products in full precision, as the CPU reference runs them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = phase_device()
    phase_build()
    cfg = slice_config(args.steps)
    tv_shapes, march_shape, shift, interval = slice_shapes(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [phase_tv(gen, tv_shapes)]
    kernels += phase_march(gen, march_shape, shift, interval)
    counts = phase_train(cfg, args.steps, args.views, args.profile)
    for k in kernels:
        k["launches"] = counts[k["name"]]
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
