"""Counters around the port's kernel wrappers and its march, for the traced
window only.

Each counter is a file of ``benchmark/spies/``, found by listing the folder:
its ``TARGET`` names the port's function as ``(module, attribute)``, where
the callers look it up, and its ``wrap(orig, spies)`` returns the function
that takes its place. A wrapper calls the original as it is and, beside it,
under the ``bench/count`` range (``Spies.counting``; the trace leaves it out
of every device time), counts on the device what the call needed: the bytes
and flops of the op by its definition (``benchmark.counts.ops``,
``Spies.add``) or the samples whose density the recipe needs and those it
colours (``Spies.add_samples``, for ``benchmark.counts.model``). The counts
stay device scalars until the window has closed, so the counters add no
synchronisation. A counter whose target the port no longer has is left out,
and the metrics that read it find nothing.
"""

from __future__ import annotations

import collections
import contextlib
import importlib
import pathlib
import sys

import torch
from torch.profiler import record_function

from benchmark.core import spec
from benchmark.core.trace import COUNT_RANGE


def alpha_of(density, mask, shift, interval):
    """The march's alpha, by its definition, where ``mask`` holds."""
    sp = torch.clamp_min(density + shift, 0.0) + torch.log1p(torch.exp(-(density + shift).abs()))
    return torch.where(mask, 1.0 - torch.exp(-sp * interval), torch.zeros_like(density))


class Spies:
    def __init__(self, root, settings: dict):
        self.root, self.settings = pathlib.Path(root), settings
        self.work = collections.defaultdict(list)  # op -> [(bytes, flops)]
        self.samples = []  # (n_density, n_colour)

    def counting(self):
        """The context a count runs in: no autograd, the ``bench/count`` range."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.no_grad())
        stack.enter_context(record_function(COUNT_RANGE))
        return stack

    def add(self, op, counted):
        self.work[op].append(counted)

    def add_samples(self, n_density, n_colour):
        self.samples.append((n_density, n_colour))

    def totals(self) -> dict:
        """{op: (bytes, flops)} and the samples' totals, as Python floats."""
        out = {op: (float(sum(float(b) for b, _ in v)), float(sum(float(f) for _, f in v)))
               for op, v in self.work.items()}
        nd = float(sum(float(a) for a, _ in self.samples))
        nc = float(sum(float(b) for _, b in self.samples))
        return {"ops": out, "n_density": nd, "n_colour": nc}

    @contextlib.contextmanager
    def installed(self):
        saved = []
        try:
            for path in sorted((self.root / "benchmark" / "spies").glob("*.py")):
                spy = spec.module(self.root, "spies", path.stem)
                owner, attr = spy.TARGET
                target = importlib.import_module(owner)
                if not hasattr(target, attr):
                    print(f"counter {path.stem}: the port has no {owner}.{attr}; left out",
                          file=sys.stderr)
                    continue
                orig = getattr(target, attr)
                saved.append((target, attr, orig))
                setattr(target, attr, spy.wrap(orig, self))
            yield self
        finally:
            for target, attr, orig in reversed(saved):
                setattr(target, attr, orig)
