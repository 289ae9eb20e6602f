"""The ``train_vm`` kind of traffic: the ``train`` kind's step of the fine
stage at full width, closed loop, back to back, for a bounded DVGO recipe
with TensoRF fields (``nerf/ship.tensorf.py``).

What differs from ``train`` is the capture and the box: the capture is
``inputs/bounded.py``'s, and the fine stage's box, occupancy seed and ray
store are the ones the loop's coarse-to-fine hand-over gives
(``train/loop.py::run_train``): the camera-frustum box of the coarse stage,
a coarse voxel density holding the written scene, the fine box from its
geometry (``train/bbox.py::compute_bbox_by_coarse_geo``) widened by
``world_bound_scale``, the occupancy cache seeded from it
(``models/dvgo.py::coarse_mask_fn``) and refreshed from the fine density
(``update_occupancy_cache``), and the store cut to the rays that meet the
cache where the recipe's sampler is ``in_maskcache``
(``train/loop.py::filter_in_maskcache``). The step, the batch draw, the
check's readings and the window are ``train``'s; the reference is
``reference/tensorf.py``'s trainer over the VM leaves and the MLP; the
model FLOPs are ``counts/vm.py``'s. A window ends before ``N_iters``.
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys

import numpy as np
import torch

from benchmark.core import check, program, spec
from benchmark.counts import vm
from benchmark.inputs import bounded
from benchmark.inputs.capture import derive_seed, training_rays

Base = spec.module(pathlib.Path(__file__).resolve().parents[2], "kinds", "train").Unit


def build(cfg_dict: dict, seed: int, step: int, cap, device, family):
    """(ExpConfig, the port's family name, model config, params,
    render_kwargs, data_dict) of the program at ``step``: the coarse
    stage's box, the fine box and occupancy seed from a coarse density
    holding the scene, the fine model at its configured size with the
    benchmark's weights (``family.program_fill``), the cache refreshed."""
    from unboundednerfpytorch_tpu_torch.configs.schema import exp_config_from_dict
    from unboundednerfpytorch_tpu_torch.models import dvgo
    from unboundednerfpytorch_tpu_torch.train import bbox as bbox_mod
    from unboundednerfpytorch_tpu_torch.train import loop

    cfg = exp_config_from_dict(cfg_dict)
    data = cap.data_dict()
    fm, ft = cfg.fine_model_and_render, cfg.fine_train
    name = loop.model_family_name(cfg)
    lo, hi = bbox_mod.compute_bbox_by_cam_frustrm(cfg, data, name, device=device)
    _, mcfg_c, coarse = loop.build_model(cfg, cfg.coarse_model_and_render, cfg.coarse_train,
                                         lo, hi, torch.Generator().manual_seed(0), device)
    coarse.density.grid.data[0, ..., 0] = bounded.written_density(
        mcfg_c.world_size, mcfg_c.xyz_min, mcfg_c.xyz_max, coarse.act_shift, device)
    xyz_min, xyz_max = bbox_mod.compute_bbox_by_coarse_geo(
        coarse, mcfg_c, lambda d: dvgo.activate_density(coarse, mcfg_c, d), fm.bbox_thres)
    seed_fn = dvgo.coarse_mask_fn(coarse.density.requires_grad_(False), coarse.act_shift,
                                  mcfg_c, fm.mask_cache_thres)
    # as the loop widens the fine box
    xyz_min, xyz_max = np.asarray(xyz_min, np.float64), np.asarray(xyz_max, np.float64)
    widen = (xyz_max - xyz_min) * (fm.world_bound_scale - 1) / 2
    xyz_min, xyz_max = xyz_min - widen, xyz_max + widen
    final = dataclasses.replace(ft, pg_scale=())  # the configured size itself
    name, mcfg, params = loop.build_model(cfg, fm, final, xyz_min, xyz_max,
                                          torch.Generator().manual_seed(0), device,
                                          n_train=len(data["i_train"]))
    params.mask_cache.mask = torch.as_tensor(
        seed_fn(params.mask_cache.mask.shape, mcfg.xyz_min, mcfg.xyz_max), dtype=torch.bool,
        device=device)
    del coarse, seed_fn
    family.program_fill(params, mcfg, ft, step, seed)
    loop.FAMILIES[name].update_occupancy_cache(params, mcfg)
    rk = {"near": float(data["near"]), "far": float(data["far"]),
          "bg": 1.0 if cfg.data.white_bkgd else 0.0, "rand_bkgd": cfg.data.rand_bkgd,
          "stepsize": fm.stepsize}
    return cfg, name, mcfg, params, rk, data


class Unit(Base):
    def setup(self) -> None:
        from unboundednerfpytorch_tpu_torch.train import loop
        from unboundednerfpytorch_tpu_torch.train.step import (
            FlattenSampler, create_train_state, make_train_step,
        )

        dev = self.device
        phases = program.Phases(dev)
        cap = bounded.capture(self.cfgd, self.seed, dev, images=True)
        phases.done("capture")
        cfg, name, mcfg, params, rk, data = build(self.cfgd, self.seed, self.start, cap, dev,
                                                  self.cell.family)
        phases.done("box, model, weights and occupancy")
        ft = cfg.fine_train
        self.mcfg, self.family, self.n_rand, self.n_iters = mcfg, name, ft.N_rand, ft.N_iters
        anchor = max([1] + [int(b) for b in ft.pg_scale if int(b) <= self.start])
        state = create_train_state(params, ft, start_step=self.start - 1)
        step_fn = make_train_step(
            loop.make_forward(mcfg, rk), ft, world_size_max=float(max(mcfg.world_size)),
            tv_axis_scale=loop.tv_axis_scale(name, mcfg), lr_anchor=anchor, lr_decay_enabled=True)
        store = loop.gather_training_rays(cfg, data, dev)
        del data, cap
        n = store["rgb"].shape[0]
        # each stored ray's place among the capture's, which the reference reads
        store["ray_id"] = torch.arange(n, dtype=torch.int32, device=dev)
        if ft.ray_sampler == "in_maskcache":
            store, report = loop.filter_in_maskcache(params, mcfg, store, rk, dev)
            print(f"in_maskcache kept {report['kept']} of {report['rays']} rays", file=sys.stderr)
        self.ray_id = store.pop("ray_id")
        phases.done("ray store")
        sampler = FlattenSampler(store["rgb"].shape[0], ft.N_rand,
                                 torch.Generator(device=dev).manual_seed(derive_seed(self.seed, 5)),
                                 dev, rand_bkgd=rk["rand_bkgd"])
        if "state_unchanged" in self.faults:  # the step's update left out
            state.optimizer.step = lambda lr_scale=1.0: None
        if "half_batch" in self.faults:  # half the rays dropped, the mean over the rest
            inner = step_fn

            def step_fn(st, batch, bg):
                h = batch["rgb"].shape[0] // 2
                return inner(st, {k: v[:h] for k, v in batch.items()},
                             None if bg is None else bg[:h])
        self.state, self.step_fn, self.store, self.sampler = state, step_fn, store, sampler
        self.losses = []
        self._drive_check_steps()
        phases.done("first steps")
        phases.log()

    def more(self) -> bool:
        """A window ends before the stage's last step (the recipe trains no
        TV, so ``tv_before`` bounds nothing)."""
        return self.state.step < self.n_iters

    def model_flops(self, totals: dict) -> float:
        return vm.step_flops(totals["n_density"], totals["n_colour"],
                             *self.cell.family.flop_shape(self.cfgd))

    def reference(self, dt=torch.float32) -> dict:
        """The reference's readings over the same first steps."""
        from benchmark.reference.tensorf import Trainer

        cap = bounded.capture(self.cfgd, self.seed, self.device, images=False)
        R, model = self.cell.family.reference_model(self.cfgd, self.start, cap, self.seed,
                                                    self.device)
        params = model["leaves"]
        p0 = {k: p.clone() for k, p in params.items()}
        trainer = Trainer(R, params, model["mask"], dt=dt)
        loss = []
        for i, (idx, _) in enumerate(self.batches):
            ro, rd, vd, rgb = training_rays(cap, self.ray_id[idx].long())
            l, grads = trainer.step((ro, rd, vd), rgb)
            loss.append(float(l))
            if i == 0:
                grad = check.norms(grads)
            del grads
        change = {k: float(torch.linalg.vector_norm(params[k] - p0[k])) for k in params}
        n, live, kept = (sum(c) for c in zip(*trainer.slots))
        print(f"reference ({dt}): of {n} sample slots the occupancy cache keeps "
              f"{100 * live / n:.2f} %, both thresholds {100 * kept / n:.2f} %", file=sys.stderr)
        return {"loss": loss, "grad": grad, "change": change}
