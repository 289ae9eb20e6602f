"""The ``train`` kind of traffic: the step of the recipe's fine stage at
full width, closed loop, back to back, from the window's step on.

Per step: a ``FlattenSampler`` batch of the store that the loop's
``gather_training_rays`` builds (the draw under ``bench/batch``, as the
loop's ``next_batch`` makes it), then the ``train_step`` of
``make_train_step(make_forward(...), ...)``, the calls the loop makes. Set-up
builds that one step and its state, drives it through ``check_steps`` steps
on distinct rays (the reference follows them), and hands it to the window.
The mix file states ``start_step`` and ``check_steps``.
"""

from __future__ import annotations

import gc
import time

import torch
from torch.profiler import record_function

from benchmark.core import check, program
from benchmark.counts import model as model_counts
from benchmark.inputs.capture import derive_seed


class Unit:
    unit = "steps"
    NUMBERS = check.TRAIN_NUMBERS

    def __init__(self, cell, seed: int, device: torch.device, faults=()):
        self.cell, self.seed, self.device, self.faults = cell, seed, device, set(faults)
        self.cfgd = cell.config
        self.start = program.start_step(self.cfgd, cell.traffic)
        self.n_check = int(cell.traffic["check_steps"])

    # -- set-up --------------------------------------------------------------

    def setup(self) -> None:
        from unboundednerfpytorch_tpu_torch.train import loop
        from unboundednerfpytorch_tpu_torch.train.step import (
            FlattenSampler, create_train_state, make_train_step,
        )

        dev = self.device
        phases = program.Phases(dev)
        cap = program.capture(self.cfgd, self.seed, dev, images=True)
        phases.done("capture")
        cfg, family, mcfg, params, rk, data = program.build(self.cfgd, self.seed, self.start,
                                                            cap, dev, self.cell.family, phases)
        self.mcfg, self.family = mcfg, family
        ft = cfg.fine_train
        self.n_rand = ft.N_rand
        self.tv_before = ft.tv_before
        state = create_train_state(params, ft, start_step=self.start - 1)
        near_thres = 0.0
        if ft.weight_nearclip > 0 and data.get("near_clip"):
            near_thres = float(data["near_clip"]) / float(mcfg.scene_radius[0])
        anchor = max([1] + [int(b) for b in ft.pg_scale if int(b) <= self.start])
        step_fn = make_train_step(
            loop.make_forward(mcfg, rk), ft, world_size_max=float(max(mcfg.world_size)),
            near_thres=near_thres, tv_axis_scale=loop.tv_axis_scale(family, mcfg),
            lr_anchor=anchor, lr_decay_enabled=True)
        store = loop.gather_training_rays(cfg, data, dev)
        del data, cap
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

    def run_unit(self):
        with record_function("bench/batch"):
            idx, bg = self.sampler.next_batch()
            batch = {k: v[idx] for k, v in self.store.items()}
        metrics = self.step_fn(self.state, batch, bg)
        self.losses.append(metrics["loss"])
        return idx, bg

    def _drive_check_steps(self) -> None:
        leaves = self.cell.family.program_leaves(self.state.params)
        p0 = {k: p.detach().clone() for k, p in leaves.items()}
        opt = self.state.optimizer
        self.batches, loss = [], []
        for i in range(self.n_check):
            idx, bg = self.run_unit()
            self.batches.append((idx.clone(), None if bg is None else bg.clone()))
            loss.append(float(self.losses[-1]))
            if i == 0:
                grad = {k: float(torch.linalg.vector_norm(opt.exp_avg[p].float()))
                        / (1.0 - opt.beta1) if p in opt.exp_avg else 0.0
                        for k, p in leaves.items()}
        change = {k: float(torch.linalg.vector_norm(leaves[k].detach().float() - p0[k].float()))
                  for k in leaves}
        del p0
        self.readings = {"loss": loss, "grad": grad, "change": change}
        self.losses.clear()

    # -- window --------------------------------------------------------------

    def more(self) -> bool:
        """A window never crosses ``tv_before``, where the step changes."""
        return self.state.step + 1 < self.tv_before

    def window(self, seconds: float) -> dict:
        dev = self.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        n = 0
        while self.more():
            self.run_unit()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        bad = int((~torch.isfinite(torch.stack(self.losses))).sum()) if self.losses else 0
        return {"attempted": n, "failed": bad, "seconds": dt,
                "metrics": {"train_rays_per_s": (n * self.n_rand / dt, "rays/s")}}

    def spy_settings(self) -> dict:
        return {"colour_budget": 0}

    def model_flops(self, totals: dict) -> float:
        from benchmark.reference.recipe import recipe

        shape = self.cell.family.flop_shape(recipe(self.cfgd, self.start, self.cell.family),
                                            False)
        return model_counts.step_flops(totals["n_density"], totals["n_colour"], *shape)

    # -- the check -----------------------------------------------------------

    def free(self) -> None:
        for name in ("state", "step_fn", "store", "sampler"):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, dt=torch.float32) -> dict:
        """The reference's readings over the same first steps."""
        from benchmark.inputs.capture import NEAR_CLIP, training_rays
        from benchmark.reference.recipe import recipe
        from benchmark.reference.train import Trainer

        dev = self.device
        fam = self.cell.family
        R = recipe(self.cfgd, self.start, fam)
        cap = program.capture(self.cfgd, self.seed, dev, images=False)
        g = fam.reference_model(R, self.cfgd, self.seed, cap, dev)
        params = {"density": g["density"], "k0": g["k0"]}
        for i, (w, b) in enumerate(g["mlp"]):
            params[f"mlp.{i}.weight"], params[f"mlp.{i}.bias"] = w, b
        p0 = {k: p.clone() for k, p in params.items()}
        near = NEAR_CLIP / float(g["radius"][0])  # the near clip in contracted units
        trainer = Trainer(R, params, g["mask"], g["center"], g["radius"], near, dt=dt)
        loss = []
        for i, (idx, bg) in enumerate(self.batches):
            ro, rd, vd, rgb = training_rays(cap, idx)
            l, grads = trainer.step((ro, rd, vd), rgb, bg)
            loss.append(float(l))
            if i == 0:
                grad = check.norms(grads)
            del grads
        change = {k: float(torch.linalg.vector_norm(params[k].float() - p0[k].float()))
                  for k in params}
        return {"loss": loss, "grad": grad, "change": change}

    def numbers(self, ref: dict) -> dict:
        return check.train_numbers(self.readings, ref)

    @staticmethod
    def compare(prog: dict, ref: dict) -> dict:
        """The numbers of two readings of the reference's kind (the control's)."""
        return check.train_numbers(prog, ref)
