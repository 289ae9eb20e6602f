"""A full-width unbudgeted train step with the corner gather in slices and
whole, on the card.

    python -m unboundednerfpytorch_tpu_torch.probes.gather_memory

``configs/free_dataset/grass.py`` (seven banks of 319^3 in f32, 4096 rays of
1064 samples, no sample budget) is built at its final world size with
random grids, and train steps run on seeded rays through the scene box with
``ops.interp.SLICE_BYTES`` at its value (slices of 1 GiB) and so large that
every gather runs whole, in turns (sliced, whole, whole, sliced). For each
turn it prints one JSON line: the state's GB, the step's peak GB (or ``"out
of memory"``) and its device ms, the median of ``STEPS`` steps after one
warm-up step. ``chip_smoke.py`` phase 8b measures the same step end to end.
"""

from __future__ import annotations

import json
import pathlib
import time

import numpy as np
import torch

from unboundednerfpytorch_tpu_torch.configs import loader
from unboundednerfpytorch_tpu_torch.device import resolve_device
from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
from unboundednerfpytorch_tpu_torch.ops import interp
from unboundednerfpytorch_tpu_torch.train import loop
from unboundednerfpytorch_tpu_torch.train import step as step_mod

ROOT = pathlib.Path(__file__).resolve().parents[2]
CONFIG = "configs/free_dataset/grass.py"
STEPS = 3


def _batch(n: int, device) -> dict:
    """``n`` seeded rays from a sphere of radius 1.5 about the box's centre,
    aimed near it, with random colours."""
    rng = np.random.default_rng(0)
    o = rng.standard_normal((n, 3)) * 1.5
    d = rng.standard_normal((n, 3)) * 0.3 - o
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    rgb = rng.random((n, 3))
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in (("rays_o", o), ("rays_d", d), ("viewdirs", vd), ("rgb", rgb))}


def measure(slice_bytes: int, state, step_fn, batch, device) -> dict:
    interp.SLICE_BYTES = slice_bytes
    bg = torch.rand((batch["rgb"].shape[0], 3), generator=torch.Generator(device).manual_seed(1),
                    device=device)
    rec = {"gather": "whole" if slice_bytes > 1 << 40 else f"slices of {slice_bytes} bytes",
           "state_gb": torch.cuda.memory_allocated(device) / 1e9}
    try:
        step_fn(state, batch, bg)  # warm-up
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        ms = []
        for _ in range(STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step_fn(state, batch, bg)
            end.record()
            torch.cuda.synchronize(device)
            ms.append(start.elapsed_time(end))
        rec.update(peak_gb=torch.cuda.max_memory_allocated(device) / 1e9,
                   step_ms=float(np.median(ms)), steps_ms=ms)
    except torch.cuda.OutOfMemoryError:
        rec["peak_gb"] = "out of memory"
    for p in state.params.parameters():
        p.grad = None
    torch.cuda.empty_cache()
    return rec


def main(device=None) -> list:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the probe measures the card's memory: it needs a CUDA device")
    cfg = loader.load_config(str(ROOT / CONFIG))
    fm, ft = cfg.fine_model_and_render, cfg.fine_train
    mcfg = fg.config_from(fm, (-1.0,) * 3, (1.0,) * 3, fm.num_voxels_density, fm.num_voxels_rgb)
    params = fg.create(mcfg, torch.Generator().manual_seed(0), device=dev)
    with torch.no_grad():
        for grid in (params.density.grid, params.k0.grid):
            for b in range(grid.shape[0]):
                grid[b].normal_(0.0, 0.5)
    state = step_mod.create_train_state(params, ft)
    render_kwargs = {"near": 0.0, "bg": 1.0, "stepsize": fm.stepsize}
    step_fn = step_mod.make_train_step(
        loop.make_forward(mcfg, render_kwargs), ft, world_size_max=float(max(mcfg.world_size)),
        near_thres=0.0)
    batch = _batch(ft.N_rand, dev)
    sliced, out = interp.SLICE_BYTES, []
    for slice_bytes in (sliced, 1 << 62, 1 << 62, sliced):
        t0 = time.time()
        rec = {"config": CONFIG, "card": torch.cuda.get_device_name(dev),
               "card_gb": torch.cuda.get_device_properties(dev).total_memory / 1e9,
               "world_size": mcfg.world_size_rgb, "samples_a_ray": 2 * mcfg.n_inner,
               "n_rand": ft.N_rand, **measure(slice_bytes, state, step_fn, batch, dev)}
        rec["seconds"] = time.time() - t0
        print(json.dumps(rec), flush=True)
        out.append(rec)
    interp.SLICE_BYTES = sliced
    return out


if __name__ == "__main__":
    main()
