"""The system under test, built through the port's own public functions as
its training loop and its render program build it, at the window's step.

The model is the family's (``train.loop.build_model`` at the configured
final size), its ``fast_color_thres`` the schedule's at the window's step,
as the loop leaves it there; the benchmark's family file puts the
benchmark's inputs into its parameters (for the grid families
``fill_grids``: ``act_shift`` lowered once for each ``pg_scale`` boundary
passed, the grids and the MLP filled); the occupancy cache is refreshed from
that density by the port's ``update_occupancy_cache``, as a boundary
refreshes it.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from benchmark.inputs import capture as capture_mod
from benchmark.inputs import weights
from benchmark.reference.recipe import thres_at


class Phases:
    """Seconds of each part of set-up, each ended by a synchronise, for the
    log on standard error."""

    def __init__(self, device):
        from benchmark.core.runner import process_age

        self.device, self.t = device, time.perf_counter()
        self.parts = [f"process start to set-up {process_age():.2f}"]

    def done(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.parts.append(f"{name} {now - self.t:.2f}")
        self.t = now

    def log(self) -> None:
        print("set-up seconds: " + ", ".join(self.parts), file=sys.stderr)


def start_step(cfg: dict, traffic: dict) -> int:
    """The window's first step: the last ``pg_scale`` boundary, the one
    value of the traffic's ``start_step`` that a mix states now."""
    if traffic["start_step"] != "last_pg_scale":
        raise ValueError(f"no start step {traffic['start_step']!r}")
    return max(int(b) for b in cfg["fine_train"]["pg_scale"])


def capture(cfg: dict, seed: int, device, images: bool):
    c = cfg["capture"]
    return capture_mod.orbit_capture(seed, int(c["n_views"]), int(c["H"]), int(c["W"]),
                                     int(cfg["data"]["llffhold"]), device, images=images)


def build(cfg_dict: dict, seed: int, step: int, cap, device, family,
          phases: Phases | None = None):
    """(ExpConfig, the port's family name, model config, params,
    render_kwargs, data_dict) of the program at ``step``, its weights the
    benchmark's, put in by ``family`` (``benchmark/families/<family>.py``,
    ``program_fill``)."""
    from unboundednerfpytorch_tpu_torch.configs.schema import exp_config_from_dict
    from unboundednerfpytorch_tpu_torch.train import bbox as bbox_mod
    from unboundednerfpytorch_tpu_torch.train import loop

    cfg = exp_config_from_dict(cfg_dict)
    data = cap.data_dict()
    name = loop.model_family_name(cfg)
    xyz_min, xyz_max = bbox_mod.compute_bbox_by_cam_frustrm(cfg, data, name, device=device)
    fm, ft = cfg.fine_model_and_render, cfg.fine_train
    xyz_min, xyz_max = np.asarray(xyz_min, np.float64), np.asarray(xyz_max, np.float64)
    if abs(fm.world_bound_scale - 1) > 1e-9:  # as the loop widens the box
        shift = (xyz_max - xyz_min) * (fm.world_bound_scale - 1) / 2
        xyz_min, xyz_max = xyz_min - shift, xyz_max + shift
    final = dataclasses.replace(ft, pg_scale=())  # the configured size itself
    name, mcfg, params = loop.build_model(cfg, fm, final, xyz_min, xyz_max,
                                          torch.Generator().manual_seed(0), device,
                                          n_train=len(data["i_train"]))
    mcfg = dataclasses.replace(
        mcfg, fast_color_thres=thres_at(cfg_dict["fine_model_and_render"]
                                        ["fast_color_thres_schedule"], step))
    center, radius = capture_mod.scene_box(cap, float(cfg.data.unbounded_inner_r),
                                           fm.world_bound_scale)
    family.program_fill(params, mcfg, ft, step, center, radius, seed)
    if phases is not None:
        phases.done("model and weights")
    loop.FAMILIES[name].update_occupancy_cache(params, mcfg)
    if phases is not None:
        phases.done("occupancy refresh")
    render_kwargs = {"near": float(data["near"]), "far": float(data["far"]),
                     "bg": 1.0 if cfg.data.white_bkgd else 0.0,
                     "rand_bkgd": cfg.data.rand_bkgd, "stepsize": fm.stepsize}
    return cfg, name, mcfg, params, render_kwargs, data


def fill_grids(params, mcfg, ft, step: int, center, radius, seed: int) -> None:
    """A grid family's ``program_fill``: its ``act_shift`` lowered once for
    each ``pg_scale`` boundary passed, the benchmark's scene written into
    its density and k0 grids, its colour MLP seeded."""
    params.act_shift -= ft.decay_after_scale * sum(1 for b in ft.pg_scale if int(b) <= step)
    weights.imprint(params.density.grid.data, params.k0.grid.data, params.act_shift,
                    center.tolist(), radius.tolist(), mcfg.xyz_min, mcfg.xyz_max, seed)
    weights.fill_mlp([(lin.weight.data, lin.bias.data) for lin in params.rgbnet.layers], seed)


def grid_leaves(params) -> dict:
    """A grid family's ``program_leaves``: the trainable tensors under the
    reference's names."""
    out = {"density": params.density.grid, "k0": params.k0.grid}
    for i, lin in enumerate(params.rgbnet.layers):
        out[f"mlp.{i}.weight"], out[f"mlp.{i}.bias"] = lin.weight, lin.bias
    return out
