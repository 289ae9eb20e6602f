"""The port on several GPUs of one node, against one GPU.

    torchrun --standalone --nproc_per_node 4 -m unboundednerfpytorch_tpu_torch.probes.multi_gpu

Every rank builds the same seeded synthetic capture in memory (``VIEWS``
views of ``H`` x ``W``, the size of bicycle at factor 8) and the parts run
in turn, each printing one JSON line on rank 0 (also appended to
``chiprun_out/multi_gpu.jsonl``):

* ``dp``: ``nerf_unbounded/bicycle_single.py`` at full width through
  ``run_train`` data-parallel over every rank (``DP_STEPS`` steps, the
  boundaries compressed to ``DP_PG_SCALE`` as ``chip_smoke.py`` does), then
  the same run on rank 0 alone while the others wait: the losses step by
  step (the first within 1e-5 relative: the same parameters, the global
  batch's mean in another order; later steps part by the bf16 roundings of
  the grids' gradients, which are rounded once a rank before the sum), the
  replicas' parameters equal to the bit (checksums gathered from every
  rank), and the median step time after the last boundary on each;
* ``render``: the first held-out view of that model through its render
  cache cooperatively over every rank and on rank 0 alone (equal within
  1e-5), and its time on each;
* ``grid``: ``waymo/waymo_block.py`` with ``--grid_parallel 2`` (data N/2 x
  grid 2): ``GRID_STEPS`` steps over the grids of 188^3 and 238^3 (the
  boundaries compressed to ``GRID_PG_SCALE``; 13a's grids before the last
  boundary; the last, to 299^3, is not reached), which the grid axis cuts
  and the 188^3 -> 238^3 boundary keeps cut, saved at step ``GRID_SAVE``
  and at the end (rank 0 writes what each rank's host sends), then resumed
  for one more step; then on rank 0 alone: the losses, the median step time
  at 238^3, every rank's peak device GB against one rank's, and the saves'
  seconds;
* ``save_transport``: the two ways a save could bring 238^3 slabs (7 banks,
  k0 3 channels bf16) to rank 0's host, timed: each rank's copy to its host
  then a gather over a gloo group, or each slab in turn over NCCL into one
  slab's buffer on rank 0's card, then copied to its pinned host memory
  (``mesh.gather_to_host``, the port's since PR 18 measured both);
* ``blocks``: ``waymo_block.py``'s recipe on two blocks of the views
  through ``train.block_parallel.run_train_blocks_parallel`` (block b on
  rank b, ``BLOCK_STEPS`` steps each at 299^3), its seconds against a block's
  alone.

``--device cpu`` (gloo) and ``--small`` (grids and images cut) rehearse it on
CPU processes: ``torchrun --nproc_per_node 4 -m
unboundednerfpytorch_tpu_torch.probes.multi_gpu --device cpu --small``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from unboundednerfpytorch_tpu_torch.configs import loader
from unboundednerfpytorch_tpu_torch.data import synthetic
from unboundednerfpytorch_tpu_torch.device import resolve_device
from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
from unboundednerfpytorch_tpu_torch.parallel import mesh as mesh_mod
from unboundednerfpytorch_tpu_torch.render.renderer import render_image
from unboundednerfpytorch_tpu_torch.train import block_parallel, loop

ROOT = pathlib.Path(__file__).resolve().parents[2]
BICYCLE = ROOT / "configs" / "nerf_unbounded" / "bicycle_single.py"
WAYMO_BLOCK = ROOT / "configs" / "waymo" / "waymo_block.py"
VIEWS, H, W = 20, 411, 618
DP_STEPS, DP_PG_SCALE, WARMUP = 10, (3, 6), 2
GRID_STEPS, GRID_PG_SCALE, GRID_SAVE = 8, (1, 2, 3, 5, 100), 6
BLOCK_STEPS = 3
# --small: voxels and image size of the CPU rehearsal
SMALL_VOXELS, SMALL_H, SMALL_W = 26**3, 24, 36


def _cfg(path, small: bool, **train):
    cfg = loader.load_config(str(path))
    fm = cfg.fine_model_and_render
    if small:
        fm = dataclasses.replace(fm, num_voxels_density=SMALL_VOXELS, num_voxels_rgb=SMALL_VOXELS,
                                 num_voxels_base_density=SMALL_VOXELS,
                                 num_voxels_base_rgb=SMALL_VOXELS)
        train["N_rand"] = 256
    return dataclasses.replace(cfg, fine_model_and_render=fm,
                               fine_train=dataclasses.replace(cfg.fine_train, **train))


class StepClock:
    """A ``run_train`` callback: each step's loss and its milliseconds (the
    device synchronised at each step's end), and the boundaries' records."""

    def __init__(self, dev):
        self.dev, self.loss, self.ms, self.boundaries = dev, [], [], []
        self.t = time.perf_counter()

    def __call__(self, step, metrics):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.ms.append((now - self.t) * 1e3)
        self.t = now
        self.loss.append(float(metrics["loss"]))
        if "pg_scale" in metrics:
            rec = metrics["pg_scale"]
            self.boundaries.append({"step": step, "world_size": list(rec["world_size_density"]),
                                    "sharded": rec.get("sharded"), "layout": rec.get("layout")})


def _checksums(params) -> torch.Tensor:
    """One int64 a parameter from its bits, position-weighted: replicas with
    equal bits give equal sums."""
    out = []
    for p in params.parameters():
        t = p.detach().contiguous().reshape(-1)
        bits = t.view(torch.int16 if t.element_size() == 2 else torch.int32).to(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device, dtype=torch.int64) % 1021 + 1
        out.append((bits * w).sum())
    return torch.stack(out)


def _alone(fn):
    """``fn()`` on rank 0 while the others wait; its result on rank 0."""
    out = fn() if mesh_mod.is_main() else None
    mesh_mod.barrier()
    return out


def _median_after(ms, first: int) -> float:
    return float(np.median(ms[first:])) if len(ms) > first else float("nan")


def part_dp(dev, data, small: bool):
    cfg = _cfg(BICYCLE, small, N_iters=DP_STEPS, pg_scale=DP_PG_SCALE)
    quiet = lambda *a, **k: None  # noqa: E731
    clock = StepClock(dev)
    _, mcfg, params, _ = loop.run_train(cfg, data, seed=0, device=dev, log_fn=quiet,
                                        callback=clock)
    sums = _checksums(params)
    every = [torch.empty_like(sums) for _ in range(mesh_mod.world_size())]
    dist.all_gather(every, sums)
    replicas_equal = all(bool(torch.equal(s, sums)) for s in every)
    one = StepClock(dev)
    _alone(lambda: loop.run_train(cfg, data, seed=0, device=dev, log_fn=quiet, callback=one,
                                  use_mesh=False))
    first = DP_PG_SCALE[-1] + WARMUP
    rec = {"part": "dp", "config": "nerf_unbounded/bicycle_single.py", "steps": DP_STEPS,
           "n_rand": cfg.fine_train.N_rand, "replicas_equal": replicas_equal,
           "loss_dp": clock.loss, "boundaries": clock.boundaries,
           "step_ms_dp": clock.ms, "median_ms_dp": _median_after(clock.ms, first)}
    if mesh_mod.is_main():
        rel = [abs(a - b) / abs(b) for a, b in zip(clock.loss, one.loss)]
        rec.update(loss_one=one.loss, loss_rel_diff=rel, step_ms_one=one.ms,
                   median_ms_one=_median_after(one.ms, first))
        if not replicas_equal or not rel[0] <= 1e-5 or not np.isfinite(clock.loss).all():
            raise AssertionError(f"[dp] replicas equal {replicas_equal}, first losses "
                                 f"{clock.loss[0]} against {one.loss[0]}")
    return rec, cfg, mcfg, params


def part_render(dev, data, cfg, mcfg, params):
    params.requires_grad_(False)
    cache = fg.build_render_cache(params, mcfg)
    kw = {"near": float(data["near"]), "far": float(data["far"]),
          "bg": 1.0 if cfg.data.white_bkgd else 0.0, "stepsize": cfg.fine_model_and_render.stepsize}
    fwd = loop.make_forward(mcfg, kw)
    view = int(np.asarray(data["i_test"])[0])
    Hv, Wv = (int(v) for v in np.asarray(data["HW"])[view])
    args = (Hv, Wv, np.asarray(data["Ks"])[view], np.asarray(data["poses"])[view][:3, :4])
    mesh = mesh_mod.make_mesh()

    def render(m):
        ms, out = [], None
        for _ in range(3):  # a warm-up view, then two timed
            t0 = time.perf_counter()
            out = render_image(lambda ro, rd, vd: fwd(params, ro, rd, vd, None, cache=cache),
                               *args, device=dev, mesh=m)
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, ms[1:]

    coop, coop_ms = render(mesh)
    alone = _alone(lambda: render(None))
    rec = {"part": "render", "view": [Hv, Wv], "ms_cooperative": coop_ms}
    if mesh_mod.is_main():
        diff = max(float(np.abs(a - b).max()) for a, b in zip(coop, alone[0]))
        rec.update(ms_one=alone[1], max_abs_diff=diff)
        if not diff <= 1e-5:
            raise AssertionError(f"[render] the cooperative view differs by {diff}")
    return rec


def _peak_gb(dev) -> list:
    """Every rank's peak device GB since its last reset (rank order)."""
    if dev.type != "cuda":
        return []
    mine = torch.tensor([torch.cuda.max_memory_allocated() / 1e9], device=dev)
    every = [torch.empty_like(mine) for _ in range(mesh_mod.world_size())]
    dist.all_gather(every, mine)
    return [float(t) for t in every]


def part_grid(dev, data, small: bool, tmp: str):
    from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt

    steps = GRID_STEPS
    cfg = _cfg(WAYMO_BLOCK, small, N_iters=steps, pg_scale=GRID_PG_SCALE)
    quiet = lambda *a, **k: None  # noqa: E731
    clock, logs, saves = StepClock(dev), [], []
    real_save = ckpt.save_model

    def timed_save(*args, **kw):
        t0 = time.perf_counter()
        real_save(*args, **kw)
        saves.append(time.perf_counter() - t0)

    ckpt.save_model = timed_save
    try:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        exp = os.path.join(tmp, "grid")
        loop.run_train(cfg, data, seed=0, device=dev, log_fn=logs.append, callback=clock,
                       grid_parallel=2, exp_dir=exp, save_every=GRID_SAVE)
        peaks = _peak_gb(dev)
        resumed = StepClock(dev)
        more = dataclasses.replace(cfg, fine_train=dataclasses.replace(cfg.fine_train,
                                                                       N_iters=steps + 1))
        loop.run_train(more, data, seed=0, device=dev, log_fn=quiet, callback=resumed,
                       grid_parallel=2, exp_dir=exp)
    finally:
        ckpt.save_model = real_save
    one = StepClock(dev)

    def alone():
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        loop.run_train(cfg, data, seed=0, device=dev, log_fn=quiet, callback=one,
                       use_mesh=False)
        return torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None

    peak_one = _alone(alone)
    first = GRID_PG_SCALE[3] + WARMUP
    rec = {"part": "grid", "config": "waymo/waymo_block.py", "grid_parallel": 2,
           "data_parallel": mesh_mod.world_size() // 2, "n_rand": cfg.fine_train.N_rand,
           "boundaries": clock.boundaries, "loss_grid": clock.loss, "step_ms_grid": clock.ms,
           "median_ms_grid_238": _median_after(clock.ms, first), "peak_gb_ranks": peaks,
           "save_s": saves, "resumed_loss": resumed.loss,
           "layout": [line for line in logs if "mesh" in line or "cut" in line]}
    if mesh_mod.is_main():
        rel = [abs(a - b) / abs(b) for a, b in zip(clock.loss, one.loss)]
        rec.update(loss_one=one.loss, loss_rel_diff=rel, step_ms_one=one.ms,
                   median_ms_one_238=_median_after(one.ms, first), peak_gb_one=peak_one)
        kept = [b for b in clock.boundaries if b["step"] == GRID_PG_SCALE[3]]
        if not rel[0] <= 1e-5 or not np.isfinite(clock.loss).all() or not kept or \
                kept[0]["sharded"] != ["density", "k0"] or len(resumed.loss) != 1:
            raise AssertionError(f"[grid] first losses {clock.loss[0]} against {one.loss[0]}, "
                                 f"boundaries {clock.boundaries}, resumed {resumed.loss}")
    return rec


def part_save_transport(dev, small: bool):
    """A save's slabs to rank 0's host over the first grid group, both ways
    (module docstring), each timed from a barrier to its end on rank 0."""
    from unboundednerfpytorch_tpu_torch.parallel.halo import transportable

    mesh = mesh_mod.make_mesh(grid_parallel=2)
    cfg = _cfg(WAYMO_BLOCK, small)
    fm = cfg.fine_model_and_render
    mcfg = fg.config_from(fm, (-1.0,) * 3, (1.0,) * 3, int(fm.num_voxels_density / 2),
                          int(fm.num_voxels_rgb / 2))
    X, Y, Z = mcfg.world_size_rgb
    shape = (2 * fm.fourier_freq_num + 1, X // 2, Y, Z, 4)  # density and k0 together
    slab = torch.ones(shape, dtype=torch.bfloat16, device=dev)
    shard = mesh.shard(X)
    rec = {"part": "save_transport", "slab": list(shape), "slab_gb": slab.numel() * 2 / 1e9}
    in_group = mesh.data_index == 0

    def timed(fn):
        mesh_mod.barrier()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if in_group:
            fn()
        mesh_mod.barrier()
        return time.perf_counter() - t0

    gloo = [dist.new_group(list(r), backend="gloo")
            for r in (range(d * 2, d * 2 + 2) for d in range(mesh.data))][mesh.data_index]

    def gloo_gather():
        host = slab.cpu()
        if shard.index:
            dist.gather(transportable(host), None, dst=shard.ranks[0], group=gloo)
            return
        parts = [torch.empty_like(host) for _ in range(shard.count)]
        dist.gather(transportable(host), [transportable(p) for p in parts], dst=shard.ranks[0],
                    group=gloo)
        torch.cat(parts, dim=1)

    rec["gloo_host_gather_s"] = [timed(gloo_gather) for _ in range(3)]
    rec["nccl_device_buffer_s"] = [timed(lambda: mesh_mod.gather_to_host(slab, shard))
                                   for _ in range(3)]
    return rec


def part_blocks(dev, data, small: bool, tmp: str):
    cfg = _cfg(WAYMO_BLOCK, small, N_iters=BLOCK_STEPS, pg_scale=())
    quiet = lambda *a, **k: None  # noqa: E731
    sync = (lambda: torch.cuda.synchronize()) if dev.type == "cuda" else (lambda: None)
    mesh_mod.barrier()
    t0 = time.perf_counter()
    paths = block_parallel.run_train_blocks_parallel(cfg, data, 2, os.path.join(tmp, "par"),
                                                     device=dev, log_fn=quiet)
    sync()
    seconds = time.perf_counter() - t0

    def one_block():
        t1 = time.perf_counter()
        ids = np.asarray(data["i_train"])
        loop.run_train(cfg, {**data, "i_train": ids[: -(-len(ids) // 2)]}, seed=0, device=dev,
                       log_fn=quiet, exp_dir=os.path.join(tmp, "one"), use_mesh=False,
                       bbox=block_parallel.shared_bbox(cfg, data, dev))
        sync()
        return time.perf_counter() - t1

    alone = _alone(one_block)
    return {"part": "blocks", "config": "waymo/waymo_block.py", "blocks": len(paths),
            "steps": BLOCK_STEPS, "seconds_parallel": seconds, "seconds_one_block": alone,
            "merged": os.path.exists(os.path.join(tmp, "par", "fine_last_merged", "meta.json"))}


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--small", action="store_true", help="the CPU rehearsal's sizes")
    args = ap.parse_args(argv)
    dev = resolve_device(device or args.device)
    if not mesh_mod.maybe_initialize_distributed(dev):
        raise SystemExit("run it under torchrun --nproc_per_node N (N > 1)")
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    h, w = (SMALL_H, SMALL_W) if args.small else (H, W)
    data = synthetic.orbit_scene(VIEWS, h, w, seed=0, n_test=2)
    out_dir = pathlib.Path("chiprun_out")
    card = "cpu"
    if dev.type == "cuda":  # every card's name and power limit, as nvidia-smi reads them
        card = "; ".join(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines())

    def emit(rec):
        rec = {**rec, "card": card, "world_size": mesh_mod.world_size()}
        if mesh_mod.is_main():
            line = json.dumps(rec)
            print(line, flush=True)
            out_dir.mkdir(exist_ok=True)
            with open(out_dir / "multi_gpu.jsonl", "a") as f:
                f.write(line + "\n")

    rec, cfg, mcfg, params = part_dp(dev, data, args.small)
    emit(rec)
    emit(part_render(dev, data, cfg, mcfg, params))
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="multi_gpu_") as tmp:
        # every rank writes into rank 0's directory (one node, one disk)
        shared = [tmp]
        dist.broadcast_object_list(shared, src=0)
        emit(part_grid(dev, data, args.small, shared[0]))
        emit(part_save_transport(dev, args.small))
        emit(part_blocks(dev, data, args.small, shared[0]))
        mesh_mod.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
