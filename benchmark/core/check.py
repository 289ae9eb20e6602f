"""The numbers that decide ``correct`` and their limits.

Train cells compare three readings of the first steps that set-up drives
through the window's own call: each step's loss, the gradient of the first
step as masked Adam gets it (its norm worked out from the first moment after
one update, m / (1 - beta1)), and the change of the parameters over the
steps. Norms are compared leaf by leaf, by the worst leaf: the gap between
the program's norm and the reference's, over the reference's norm of that
leaf or of the median leaf, whichever is larger. A leaf whose reference
gradient is under a thousandth of the median leaf's moves by round-off
alone and is left out of the change.

Render cells compare the colour, depth and background share of the views'
pixels that a seeded sample takes, each by its widest gap
(``render_numbers``).
"""

from __future__ import annotations

import statistics

import torch

TRAIN_NUMBERS = ("loss_gap", "grad_gap", "change_gap")
RENDER_NUMBERS = ("rgb_gap", "depth_gap", "alphainv_gap")
NEGLIGIBLE = 1e-3


def leaf_gap(prog: dict, ref: dict, leaves=None) -> float:
    leaves = sorted(ref) if leaves is None else leaves
    med = statistics.median(ref[k] for k in ref)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` / ``ref``: {"loss": [per step], "grad": {leaf: norm},
    "change": {leaf: norm}}."""
    med = statistics.median(ref["grad"].values())
    moving = [k for k in sorted(ref["grad"]) if ref["grad"][k] >= NEGLIGIBLE * med]
    return {
        "loss_gap": max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["loss"], ref["loss"])),
        "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
        "change_gap": leaf_gap(prog["change"], ref["change"], moving),
    }


def render_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` / ``ref``: {"rgb": [n, 3], "depth": [n], "alphainv": [n]};
    each by its widest gap, so that a fault on a few rays of a view shows."""
    gap = lambda k: float((prog[k].double() - ref[k].double()).abs().max())  # noqa: E731
    return {"rgb_gap": gap("rgb"), "depth_gap": gap("depth"), "alphainv_gap": gap("alphainv")}


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(t.float())) for k, t in tensors.items()}


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit, or not finite, fails."""
    checks = {}
    ok = True
    for k, v in numbers.items():
        lim = limits.get(k)
        checks[k] = {"value": v, "limit": lim}
        if lim is None or not (v == v) or v > lim:
            ok = False
    return ok, checks
