#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--steps 10] [--views 20] [--profile]

Phases, each reported on its own line:
  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  2. build every hand-written kernel from ``unboundednerfpytorch_tpu_torch/csrc``
     (one ``nvcc`` per source, all started together);
  3. hold each kernel against its plain PyTorch version on the card at the
     shapes its path gives it, and time kernel, plain version, bound and,
     where one PyTorch call computes the same function, that call: the TV
     injection and the two march kernels at the train step's shapes, the
     march forward also at a render chunk's (its entry sums the two). The
     four gather-probe kernels are driven through their entry point
     (``probes.gather.main``), which holds each against its plain version at
     every one of its shapes (indexed copies bit-equal, ``box_sum`` within
     1e-3 relative) and times it; that one run, counted from 0, also gives
     these kernels' launches;
  4. train the FourierGrid fine stage of
     ``configs/nerf_unbounded/bicycle_single.py`` at full width (``pg_scale=()``,
     so the grids start at their final ~200^3 x 7 banks) on a seeded synthetic
     scene of bicycle's size, with launch counts checked, save ``fine_last``,
     then compare a forward on the card with the plain path on the CPU.
     10 steps by default (20 in the first slice), so that the whole script
     stays well inside its time limit;
  5. render: the checkpoint gets the synthetic scene's geometry imprinted
     (a few steps do not make a scene) and ``fast_color_thres`` takes its
     schedule's final value; then ``render.run_render`` (``load_model``,
     ``build_render_cache``, ``make_forward(cache=...)``,
     ``render_viewpoints``) renders 3 held-out 411x618 views in chunks of
     8192 with ground truth: the first warms up, the other two are timed.
     Checked: finite images; ``march_forward`` launched once per chunk and no
     other kernel at all; the two-stage cached render WITHOUT the density
     bake equals the uncached single-stage render (1e-4 relative) on every
     ray that did not overflow ``color_budget``; the cached render on the card
     equals the same path on the CPU for one chunk (the scene's occupancy:
     99.5% of the rays within 1e-4 relative, the rest being rays where the
     nearest-voxel lookup or a threshold rounds differently; all-true
     occupancy: at most 1e-5 of the samples pass ``fast_color_thres`` on one
     device only, the rays of such samples agree within two thresholds' worth and
     every other ray within 1e-5 + 1e-5 relative); the baked render's PSNR against
     the exact render is printed and held above ``BAKED_MIN_PSNR``.

``--profile`` also traces the last train steps and one rendered view with
``torch.profiler`` and prints the device time by range and by kernel.

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
import tempfile
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "nerf_unbounded" / "bicycle_single.py"

PROFILED_STEPS = 4
H, W = 411, 618  # bicycle at factor=8
RENDER_VIEWS = 3  # held-out views: one warm-up, two timed
RENDER_CHUNK = 8192
# the density bake (one f32 bank at 2x) against the exact density on the
# imprinted scene, whose ball has an edge two voxels wide: the floor under
# which the bake would be broken rather than approximate
BAKED_MIN_PSNR = 30.0
# card against CPU: the share of a chunk's samples that may pass
# ``fast_color_thres`` on one device only (7 of a chunk's 786,432)
MAX_FLIPPED_SHARE = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


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
    from unboundednerfpytorch_tpu_torch.probes.timing import bound_ms, time_ms

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
    from unboundednerfpytorch_tpu_torch.probes.timing import bound_ms, time_ms

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
    log(f"[3] march_forward at the train step's {[N, S]}: {f_ms:.4f} ms, plain "
        f"{f_plain:.4f} ms, bound {f_bnd:.5f} ms ({f_by})")

    # the render path launches the same forward kernel at one chunk of rays
    Nr = RENDER_CHUNK
    dr, mr = march_inputs(gen, (Nr, S))
    got_r = march.march_forward(dr, mr, shift, interval)
    ref_r = march.fused_alpha2weights_plain(dr, mr, shift, interval)
    torch.cuda.synchronize()
    err_f = max(err_f, check(f"march_forward weights {[Nr, S]}", got_r[0], ref_r[0], 1e-5, 1e-6),
                check(f"march_forward alphainv_last {[Nr, S]}", got_r[1], ref_r[1], 1e-5, 1e-6))
    r_ms = time_ms(lambda: march.march_forward(dr, mr, shift, interval), iters=50)
    r_plain = time_ms(lambda: march.fused_alpha2weights_plain(dr, mr, shift, interval), iters=50)
    r_bnd, _ = bound_ms(Nr * S * (4 + 1 + 3 * 4) + Nr * 4, 25 * Nr * S)
    log(f"[3] march_forward at a render chunk's {[Nr, S]}: {r_ms:.4f} ms, plain "
        f"{r_plain:.4f} ms, bound {r_bnd:.5f} ms")
    # the entry sums the two shapes, one launch each
    f_ms, f_plain, f_bnd = f_ms + r_ms, f_plain + r_plain, f_bnd + r_bnd
    b_bnd, b_by = bound_ms(ns * (4 * 4 + 1 + 4) + 2 * N * 4, 30 * ns)
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


# TPU kernel sites that each gather-probe kernel replaces
PROBE_REPLACES = {
    "gather_tile_rows": "tools/probe_dynamic_gather.py:50, tools/probe_kernel_gather.py:54",
    "gather_rows": "tools/probe_pallas_gather.py:53, tools/probe_pallas_gather.py:81",
    "box_gather8": "tools/probe_vreg_gather.py:72",
    "box_sum": "tools/probe_kernel_gather.py:119",
}


def phase_probes():
    """The probe entry point as a user runs it, its launches counted from 0:
    the four gather-probe kernels at every one of its shapes, each against
    its plain version (the probe raises on a disagreement), then the times.
    A kernel's entry sums its shapes. Returns (entries, launch counts)."""
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.probes import gather

    build.reset_launch_counts()
    t0 = time.time()
    records = gather.main()
    counts = dict(build.LAUNCHES)
    log(f"[3] probes.gather.main in {time.time() - t0:.1f} s; launches {counts}")
    if set(counts) != set(PROBE_REPLACES) or min(counts.values()) < 1:
        raise AssertionError(f"probe launch counts {counts}: want each of {set(PROBE_REPLACES)}")
    out = []
    for name, site in PROBE_REPLACES.items():
        recs = [r for r in records if r["kernel"] == name and "bound_ms" in r]
        if not recs:
            raise AssertionError(f"the probe timed no shape of {name}")
        lib = [r["library_ms"] for r in recs]
        entry = {"name": name, "route": "cuda",
                 "source": "unboundednerfpytorch_tpu_torch/csrc/gather_probe.cu",
                 "replaces": site, "max_abs_err": max(r["max_abs_err"] for r in recs),
                 "ms": sum(r["ms"] for r in recs),
                 "plain_ms": sum(r["plain_ms"] for r in recs),
                 "bound_ms": sum(r["bound_ms"] for r in recs), "bound_by": "bytes",
                 "library_ms": None if None in lib else sum(lib)}
        log(f"[3] {name} over {len(recs)} shapes: {entry['ms']:.4f} ms, plain "
            f"{entry['plain_ms']:.4f} ms, library call {entry['library_ms']}, bound "
            f"{entry['bound_ms']:.4f} ms (bytes)")
        out.append(entry)
    return out, counts


def profile_summary(tag: str, prof, n_units: int, unit: str, unit_ms: float, ranges) -> None:
    """Device time over the profiled window, per ``unit`` (a train step or a
    rendered view): its share of the unprofiled unit's wall time (the
    profiler slows the host, not the device), by ``record_function`` range
    and by kernel. The hand-written kernels launch inside ``torch.library``
    ops, so the profiler credits them to the range around them; the train
    step's backward runs on autograd's thread, outside its range, and is what
    remains."""
    from torch.autograd import DeviceType

    from unboundednerfpytorch_tpu_torch.ops.cuda import build

    avgs = prof.key_averages()
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    if not kernels:
        log(f"{tag} profile: torch.profiler saw no device kernels")
        return
    per_unit = lambda us: us / 1e3 / n_units
    busy = per_unit(sum(e.self_device_time_total for e in kernels))
    log(f"{tag} profile over {n_units} {unit}s: device busy {busy:.2f} ms/{unit}, "
        f"{100 * busy / unit_ms:.1f}% of the {unit_ms:.1f} ms unprofiled {unit}")
    phases = {e.key: per_unit(e.device_time_total) for e in avgs
              if e.device_type == DeviceType.CPU and e.key in ranges}
    phases["outside these ranges"] = busy - sum(phases.values())
    for name, ms in phases.items():
        log(f"  range {name}: {ms:.3f} ms/{unit} ({100 * ms / busy:.1f}% of device time)")
    for name in build.KERNELS:
        ms = per_unit(sum(e.self_device_time_total for e in kernels
                          if f"{name}_kernel" in e.key))
        if ms > 0:
            log(f"  kernel {name}: {ms:.3f} ms/{unit} ({100 * ms / busy:.1f}% of device time)")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:15]:
        log(f"  {per_unit(e.self_device_time_total):9.3f} ms/{unit} "
            f"{e.count / n_units:6.1f}x  {e.key[:110]}")


def make_profiler():
    import torch

    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA],
                                  acc_events=True)


def phase_train(cfg, steps: int, views: int, profile: bool, exp_dir: str):
    """Returns (launch counts of the train run, the scene's data_dict)."""
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
    data = synthetic.orbit_scene(views, H, W, seed=0, n_test=RENDER_VIEWS)
    xyz_min, xyz_max = bbox_mod.compute_bbox_by_cam_frustrm(cfg, data, "FourierGrid",
                                                            device="cuda")
    seed_fn = synthetic.occupancy_seed((xyz_min + xyz_max) / 2, (xyz_max - xyz_min) / 2)
    log(f"[4] scene: {views} training and {RENDER_VIEWS} held-out views of {H}x{W} in "
        f"{time.time() - t0:.1f} s")

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
    prof = make_profiler() if profile else None

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
                                        callback=callback, coarse_mask_fn=seed_fn,
                                        exp_dir=exp_dir)
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
        profile_summary("[4]", prof, PROFILED_STEPS, "step", step_ms,
                        ("train_loop/batch", "train_step/forward_loss", "train_step/tv",
                         "train_step/adam"))

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
    return counts, data


def phase_render(cfg, data, exp_dir: str, profile: bool) -> dict:
    """Phase 5; returns the launch counts of the ``run_render`` run."""
    import numpy as np
    import torch

    from unboundednerfpytorch_tpu_torch import render
    from unboundednerfpytorch_tpu_torch.configs.schema import normalize_fast_color_thres
    from unboundednerfpytorch_tpu_torch.convert import (
        fourier_grid_params_from_numpy, fourier_grid_params_to_numpy,
    )
    from unboundednerfpytorch_tpu_torch.data import synthetic
    from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
    from unboundednerfpytorch_tpu_torch.ops import rays as ray_ops
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.render import renderer
    from unboundednerfpytorch_tpu_torch.train import loop
    from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt
    from unboundednerfpytorch_tpu_torch.utils import metrics as M

    path = f"{exp_dir}/fine_last"
    t0 = time.time()
    family, mcfg, params, step, _ = ckpt.load_model(path, device="cuda")
    params.requires_grad_(False)
    synthetic.imprint_scene(params, mcfg.scene_center, mcfg.scene_radius, seed=0)
    final_thres = normalize_fast_color_thres(cfg.fine_model_and_render)[1][-1][1]
    mcfg = dataclasses.replace(mcfg, fast_color_thres=final_thres)
    ckpt.save_model(path, family, mcfg, params, global_step=step)
    log(f"[5] checkpoint of step {step} loaded, scene imprinted, fast_color_thres "
        f"{final_thres:g}, saved again in {time.time() - t0:.1f} s")

    # ---- the run_render path, as a user runs it
    n_chunks = -(-H * W // RENDER_CHUNK)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.time()
    out = render.run_render(types.SimpleNamespace(render_test=True, chunk=RENDER_CHUNK), cfg,
                            data, exp_dir, log_fn=lambda m: log(f"[5] {m}"))["test"]
    total_s = time.time() - t0
    counts = dict(build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"march_forward": RENDER_VIEWS * n_chunks}
    if counts != want:
        raise AssertionError(f"render launch counts {counts} != {want}")
    for name in ("rgbs", "depths", "bgmaps"):
        arr = out[name]
        if arr.shape[:3] != (RENDER_VIEWS, H, W) or not np.isfinite(arr).all():
            raise AssertionError(f"rendered {name}: shape {arr.shape} or non-finite values")
    view_ms = float(np.median(out["seconds"][1:])) * 1e3
    log(f"[5] run_render: {RENDER_VIEWS} views of {H}x{W} in {n_chunks} chunks of "
        f"{RENDER_CHUNK}, {total_s:.1f} s with load and cache build; ms/view "
        f"{[round(t * 1e3, 1) for t in out['seconds']]}, median after the warm-up view "
        f"{view_ms:.1f} ms = {H * W / view_ms * 1e3:.0f} rays/s; peak memory {peak_gb:.2f} GB; "
        f"psnr {np.mean(out['psnrs']):.3f} ssim {np.mean(out['ssims']):.4f} against ground "
        f"truth; launches {counts}")

    # ---- the cached forwards against each other, on view 0
    idx = int(np.asarray(data["i_test"])[0])
    ro, rd, vd = ray_ops.get_rays_of_a_view(
        H, W, torch.as_tensor(data["Ks"][idx], device="cuda"),
        torch.as_tensor(data["poses"][idx][:3, :4], device="cuda"),
        inverse_y=cfg.data.inverse_y, flip_x=cfg.data.flip_x, flip_y=cfg.data.flip_y)
    ro, rd, vd = (x.reshape(-1, 3) for x in (ro, rd, vd))
    render_kwargs = {"bg": 1.0, "stepsize": cfg.fine_model_and_render.stepsize}
    fwd = loop.make_forward(mcfg, render_kwargs)
    baked = fg.build_render_cache(params, mcfg, log_fn=lambda m: log(f"[5] {m}"))
    exact = fg.build_render_cache(params, dataclasses.replace(mcfg, density_bake_scale=0.0),
                                  log_fn=lambda m: log(f"[5] {m}"))
    if baked.density_dims is None or exact.density_dims is not None:
        raise AssertionError(f"cache branches: {baked.branch} / {exact.branch}")
    cb = mcfg.color_budget
    rgb = {"baked": [], "exact": [], "single": []}
    over_ray, over_chunk, hit = [], [], []
    with torch.no_grad():
        for a in range(0, H * W, RENDER_CHUNK):
            sl = slice(a, a + RENDER_CHUNK)
            r_exact = fwd(params, ro[sl], rd[sl], vd[sl], None, cache=exact)
            r_baked = fwd(params, ro[sl], rd[sl], vd[sl], None, cache=baked)
            r_single = fwd(params, ro[sl], rd[sl], vd[sl], None, cache=None)
            if not (r_exact.rgb_compacted and r_baked.rgb_compacted) or r_single.rgb_compacted:
                raise AssertionError("a forward took another branch than asked for")
            rgb["exact"].append(r_exact.rgb_marched)
            rgb["baked"].append(r_baked.rgb_marched)
            rgb["single"].append(r_single.rgb_marched)
            over_ray.append(r_exact.mask.sum(-1) > cb)
            over_chunk.append((float(r_exact.color_overflow_frac),
                               float(r_baked.color_overflow_frac)))
            hit.append(r_exact.alphainv_last < 0.01)
    rgb = {k: torch.cat(v) for k, v in rgb.items()}
    over_ray, hit = torch.cat(over_ray), torch.cat(hit)
    keep = ~over_ray
    log(f"[5] view 0: {int(hit.sum())} of {H * W} rays end on the ball; color_overflow_frac "
        f"(share of rays with more than {cb} survivors) exact "
        f"{np.mean([c[0] for c in over_chunk]):.4f} baked "
        f"{np.mean([c[1] for c in over_chunk]):.4f}; chunks with any overflow "
        f"{sum(c[0] > 0 for c in over_chunk)} of {len(over_chunk)}")
    if float(keep.float().mean()) < 0.1 or int((keep & hit).sum()) < 1000:
        raise AssertionError("too few rays without overflow to compare the two stages")
    check(f"two-stage exact cache vs uncached single stage, {int(keep.sum())} rays without "
          "overflow", rgb["exact"][keep], rgb["single"][keep], 1e-4, 1e-6)
    psnr_baked = M.psnr(rgb["baked"].cpu().numpy(), rgb["exact"].cpu().numpy())
    log(f"[5] baked density ({baked.branch}) against the exact two-stage render, view 0: "
        f"psnr {psnr_baked:.2f} dB (floor {BAKED_MIN_PSNR})")
    if not psnr_baked > BAKED_MIN_PSNR:
        raise AssertionError(f"baked render psnr {psnr_baked} <= {BAKED_MIN_PSNR}")
    del exact, rgb

    # ---- the main path's forward on the card against the same path on the CPU
    t0 = time.time()
    mid = (n_chunks // 2) * RENDER_CHUNK + RENDER_CHUNK // 4  # rows through the ball
    sl = slice(mid, mid + RENDER_CHUNK)
    cpu_params = fourier_grid_params_from_numpy(fourier_grid_params_to_numpy(params), "cpu")
    for name in ("density", "k0"):
        grid = getattr(cpu_params, name).grid
        grid.data = grid.data.to(getattr(params, name).grid.dtype)
    cpu_params.requires_grad_(False)
    cpu_cache = dataclasses.replace(
        baked, density_tables=tuple(t.cpu() for t in baked.density_tables),
        k0_tables=tuple(t.cpu() for t in baked.k0_tables))
    fields = ("rgb_marched", "depth", "alphainv_last")
    with torch.no_grad():
        got = fwd(params, ro[sl], rd[sl], vd[sl], None, cache=baked)
        ref = fwd(cpu_params, ro[sl].cpu(), rd[sl].cpu(), vd[sl].cpu(), None, cache=cpu_cache)
        # the scene's occupancy: a sample on a voxel's half-way point may round
        # to another voxel on the other device, which selects other samples
        same = torch.ones(RENDER_CHUNK, dtype=torch.bool)
        for f in fields:
            g, r = getattr(got, f).cpu(), getattr(ref, f)
            d = (g - r).abs()
            same &= (d.reshape(RENDER_CHUNK, -1).amax(-1) <= 1e-5 + 1e-4 * float(r.abs().max()))
        log(f"[5] card vs CPU, one chunk, the scene's occupancy: {int(same.sum())} of "
            f"{RENDER_CHUNK} rays agree; {int((got.alphainv_last < 0.01).sum())} end on the ball")
        if float(same.float().mean()) < 0.995:
            raise AssertionError("the card's render and the CPU's differ on more than 0.5% "
                                 "of the rays")
        for p_ in (params, cpu_params):
            p_.mask_cache.mask = torch.ones_like(p_.mask_cache.mask)
        got = fwd(params, ro[sl], rd[sl], vd[sl], None, cache=baked)
        ref = fwd(cpu_params, ro[sl].cpu(), rd[sl].cpu(), vd[sl].cpu(), None, cache=cpu_cache)
        # a sample whose alpha or weight lies within rounding of
        # fast_color_thres passes on one device only, and moves its ray by
        # about that threshold. Such samples are counted by comparing the two
        # masks (2 of 786,432 on an H100; the trained grids differ in their
        # last bits from run to run, the backward's adds being atomic, so a
        # few more are allowed for: 1e-5 of the samples), and only their rays
        # get the looser tolerance
        flipped = got.mask.cpu() != ref.mask
        n_flipped = int(flipped.sum())
        log(f"[5] all-true occupancy: {n_flipped} of {flipped.numel()} samples pass "
            f"fast_color_thres {mcfg.fast_color_thres:g} on one device only, on "
            f"{int(flipped.any(-1).sum())} rays")
        if n_flipped > MAX_FLIPPED_SHARE * flipped.numel():
            raise AssertionError(f"{n_flipped} samples differ in the threshold mask")
        same = ~flipped.any(-1)
        for f in fields + ("weights",):
            g, r = getattr(got, f).cpu(), getattr(ref, f)
            check(f"cached render {f}, all-true occupancy, rays of equal masks (card vs CPU)",
                  g[same], r[same], 1e-5, 1e-5)
            if n_flipped:
                check(f"cached render {f}, rays of a flipped sample", g[~same], r[~same],
                      1e-4, 2 * mcfg.fast_color_thres)
    log(f"[5] card-vs-CPU comparison took {time.time() - t0:.1f} s")
    del cpu_params, cpu_cache

    if profile:
        _, _, params, _, _ = ckpt.load_model(path, device="cuda")  # the occupancy again
        params.requires_grad_(False)
        view = lambda: renderer.render_image(
            lambda aux, o, d, v: fwd(aux[0], o, d, v, None, cache=aux[1]), H, W,
            data["Ks"][idx], data["poses"][idx][:3, :4], chunk=RENDER_CHUNK,
            aux=(params, baked), inverse_y=cfg.data.inverse_y, flip_x=cfg.data.flip_x,
            flip_y=cfg.data.flip_y)
        view()
        prof = make_profiler()
        prof.start()
        for _ in range(2):
            view()
        prof.stop()
        profile_summary("[5]", prof, 2, "view", view_ms,
                        ("render/rays", "forward/sample", "forward/density", "forward/march",
                         "forward/compact", "forward/k0", "forward/rgb"))
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--views", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help=f"trace the last {PROFILED_STEPS} train steps and one rendered view "
                         "with torch.profiler")
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
    probe_kernels, probe_counts = phase_probes()
    kernels += probe_kernels
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as exp_dir:
        train_counts, data = phase_train(cfg, args.steps, args.views, args.profile, exp_dir)
        torch.cuda.empty_cache()
        render_counts = phase_render(cfg, data, exp_dir, args.profile)
    # a kernel's launches: those of every path that ran it, each path counted
    # from 0 just before it was driven to just after
    for k in kernels:
        k["launches"] = sum(c.get(k["name"], 0)
                            for c in (train_counts, render_counts, probe_counts))
        if k["launches"] < 1:
            raise AssertionError(f"no path launched {k['name']}")
    log(f"launches by path: train {train_counts}, render {render_counts}, probes "
        f"{probe_counts}")
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
