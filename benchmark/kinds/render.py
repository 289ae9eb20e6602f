"""The ``render`` kind of traffic: one client asking for whole views in
turn (closed loop), at poses on the capture's orbit drawn from the seed.

Each view goes through the family's ``build_render_cache`` (set-up),
``make_forward`` and ``render/renderer.py::render_image(..., aux=(params,
cache))``, as ``render/__init__.py::run_render`` composes them. A view is
timed from its request to its image on the host. The mix file states
``start_step``, ``check_views`` and ``check_pixels``.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.core import check, program
from benchmark.counts import model as model_counts
from benchmark.inputs import capture as capture_mod
from benchmark.inputs.capture import derive_seed

POSES = 4096  # the views a run may ask for
# rays a block of the reference: the render's chunk (render/renderer.py DEFAULT_CHUNK), so that its
# sums run over the same shapes
REFERENCE_BLOCK = 8192


class Unit:
    unit = "views"
    NUMBERS = check.RENDER_NUMBERS

    def __init__(self, cell, seed: int, device: torch.device, faults=()):
        self.cell, self.seed, self.device, self.faults = cell, seed, device, set(faults)
        self.cfgd = cell.config
        self.start = program.start_step(self.cfgd, cell.traffic)
        t = cell.traffic
        self.check_views = int(t["check_views"])
        self.check_pixels = int(t["check_pixels"])

    def setup(self) -> None:
        from unboundednerfpytorch_tpu_torch.train import loop

        dev = self.device
        phases = program.Phases(dev)
        cap = program.capture(self.cfgd, self.seed, dev, images=False)
        self.H, self.W, self.K = cap.H, cap.W, cap.K
        phases.done("capture")
        cfg, family, mcfg, params, rk, _ = program.build(self.cfgd, self.seed, self.start, cap, dev,
                                                         self.cell.family, phases)
        params.requires_grad_(False)
        rk = {k: v for k, v in rk.items() if k != "rand_bkgd"}
        cache = loop.FAMILIES[family].build_render_cache(params, mcfg)
        phases.done("render cache")
        core = loop.make_forward(mcfg, rk)
        fwd = lambda aux, ro, rd, vd: core(aux[0], ro, rd, vd, None, cache=aux[1])  # noqa: E731
        if "answer_altered" in self.faults:  # every colour shifted where it is made
            inner = fwd

            def fwd(aux, ro, rd, vd):
                res = inner(aux, ro, rd, vd)
                return res._replace(rgb_marched=res.rgb_marched + 0.01)
        self.fwd, self.aux = fwd, (params, cache)
        self.colour_budget = getattr(mcfg, "color_budget", 0)
        self.poses = capture_mod.orbit_view_poses(self.seed, POSES + 1, dev).cpu().numpy()
        self.outputs, self.latency = [], []
        self._view(self.poses[POSES])  # warm-up: every shape of a view, once
        phases.done("first view")
        phases.log()

    def _view(self, c2w):
        from unboundednerfpytorch_tpu_torch.render.renderer import DEFAULT_CHUNK, render_image

        return render_image(self.fwd, self.H, self.W, self.K, c2w[:3, :4], chunk=DEFAULT_CHUNK,
                            aux=self.aux, device=self.device)

    def run_unit(self):
        t = time.perf_counter()
        out = self._view(self.poses[len(self.outputs) % POSES])
        self.latency.append(time.perf_counter() - t)
        self.outputs.append(out)

    def window(self, seconds: float) -> dict:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        first = len(self.outputs)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.run_unit()
        dt = time.perf_counter() - t0  # the last view is on the host
        n = len(self.outputs) - first
        bad = sum(not all(np.isfinite(a).all() for a in o) for o in self.outputs[first:])
        lat = np.array(self.latency[first:]) * 1e3
        metrics = {"render_rays_per_s": (n * self.H * self.W / dt, "rays/s"),
                   "render_view_ms_p90": (float(np.percentile(lat, 90)), "ms")}
        return {"attempted": n, "failed": bad, "seconds": dt, "metrics": metrics}

    def spy_settings(self) -> dict:
        return {"colour_budget": self.colour_budget}

    def model_flops(self, totals: dict) -> float:
        from benchmark.reference.recipe import recipe

        shape = self.cell.family.flop_shape(recipe(self.cfgd, self.start, self.cell.family),
                                            True)
        return model_counts.forward_flops(totals["n_density"], totals["n_colour"], *shape)

    def free(self) -> None:
        self.fwd = self.aux = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _sample(self):
        """The views and pixels the check compares, drawn from the seed."""
        gen = torch.Generator().manual_seed(derive_seed(self.seed, 6))
        n = len(self.outputs)
        views = torch.randperm(n, generator=gen)[:min(self.check_views, n)].tolist()
        pix = [torch.randperm(self.H * self.W, generator=gen)[:self.check_pixels] for _ in views]
        return views, pix

    def reference(self, dt=torch.float32) -> dict:
        from benchmark.reference import model
        from benchmark.reference.recipe import recipe

        dev = self.device
        fam = self.cell.family
        R = recipe(self.cfgd, self.start, fam)
        cap = program.capture(self.cfgd, self.seed, dev, images=False)
        g = fam.reference_model(R, self.cfgd, self.seed, cap, dev)
        fam.prepare_render(R, g)
        poses = torch.as_tensor(self.poses, device=dev)
        views, pix = self._sample()
        out = {"rgb": [], "depth": [], "alphainv": []}
        block = REFERENCE_BLOCK
        with torch.no_grad():
            for v, p in zip(views, pix):
                p = p.to(dev)
                ro, rd, vd = (t[p] for t in capture_mod.view_rays(self.H, self.W,
                                                                  poses[v % POSES]))
                for a in range(0, p.shape[0], block):
                    sl = slice(a, a + block)
                    o = model.forward(R, g, ro[sl], rd[sl], vd[sl], R.render_bg(), dt=dt,
                                      render=True)
                    out["rgb"].append(o["rgb"].float())
                    out["depth"].append(o["depth"].float())
                    out["alphainv"].append(o["alphainv_last"].float())
        return {k: torch.cat(v).cpu() for k, v in out.items()}

    def program_outputs(self) -> dict:
        views, pix = self._sample()
        rgb, depth, ai = [], [], []
        for v, p in zip(views, pix):
            o = self.outputs[v]
            p = p.numpy()
            rgb.append(o[0].reshape(-1, 3)[p])
            depth.append(o[1].reshape(-1)[p])
            ai.append(o[2].reshape(-1)[p])
        return {"rgb": torch.from_numpy(np.concatenate(rgb)),
                "depth": torch.from_numpy(np.concatenate(depth)),
                "alphainv": torch.from_numpy(np.concatenate(ai))}

    def numbers(self, ref: dict) -> dict:
        return check.render_numbers(self.program_outputs(), ref)

    @staticmethod
    def compare(prog: dict, ref: dict) -> dict:
        """The numbers of two readings of the reference's kind (the control's)."""
        return check.render_numbers(prog, ref)
