"""The recipe's numbers, worked out from a configuration file of the
benchmark alone: the contracted cube, the lattices, the sample counts, the
thresholds at the window's step, the loss and TV weights and Adam's
settings; the family's own numbers come from its file
(``benchmark/families/<family>.py``, ``recipe_fields``). Plain Python and
numpy; nothing of the program.

Each formula is the published model's (sjtuytc/UnboundedNeRFPytorch,
``FourierGrid_model.py`` and ``dcvgo.py``), as the configuration states it.
"""

from __future__ import annotations

import dataclasses
import math
import types

import numpy as np


def thres_at(schedule, step: int) -> float:
    """The ``fast_color_thres`` schedule's value at ``step``: the entry of
    the largest key not above it."""
    items = sorted((int(k), float(v)) for k, v in schedule)
    return [v for k, v in items if k <= step][-1]


@dataclasses.dataclass(frozen=True)
class Recipe:
    family: types.ModuleType  # benchmark/families/<family>.py
    banks: int
    world_size: tuple
    num_voxels: int
    num_voxels_base: int
    k0_dim: int
    mlp_dims: tuple  # ((in, out), ...)
    viewbase_pe: int
    bg_len: float
    stepsize: float
    t_boundary: float
    act_shift: float
    thres: float
    sample_budget: int
    probe_stride: int
    color_budget: int
    bake_world_size: tuple | None
    white_bkgd: bool
    rand_bkgd: bool
    train: dict  # fine_train as the file states it
    start_step: int

    @property
    def cube(self) -> float:
        return 1.0 + self.bg_len

    @property
    def voxel_size_ratio(self) -> float:
        return _voxel_size(self.bg_len, self.num_voxels) / _voxel_size(self.bg_len,
                                                                        self.num_voxels_base)

    @property
    def interval(self) -> float:
        return self.stepsize * self.voxel_size_ratio

    @property
    def n_inner(self) -> int:
        return int(2 / (2 + 2 * self.bg_len) * self.world_size[0] / self.stepsize) + 1

    @property
    def lr_anchor(self) -> int:
        return max([1] + [int(b) for b in self.train["pg_scale"] if int(b) <= self.start_step])

    def render_bg(self) -> float:
        """The colour a render composites on (the family's rule)."""
        return self.family.render_bg(self)


def _voxel_size(bg_len: float, num_voxels: int) -> float:
    ext = (2.0 * (1.0 + bg_len)) ** 3
    return float((ext / num_voxels) ** (1.0 / 3.0))


def world_size(bg_len: float, num_voxels: int) -> tuple:
    ext = np.array([2.0 * (1.0 + bg_len)] * 3)
    return tuple(int(v) for v in (ext / _voxel_size(bg_len, num_voxels)).astype(np.int64))


def recipe(cfg: dict, start_step: int, family: types.ModuleType) -> Recipe:
    """The recipe at ``start_step``; ``family``'s ``recipe_fields(cfg)``
    gives its numbers: banks, num_voxels, num_voxels_base, t_boundary,
    sample_budget, probe_stride, color_budget, bake_world_size."""
    fm, ft, data = cfg["fine_model_and_render"], cfg["fine_train"], cfg["data"]
    fields = family.recipe_fields(cfg)
    bg_len = float(fm["bg_len"])
    k0_dim = int(fm["rgbnet_dim"])
    pe = 4
    width, depth = int(fm["rgbnet_width"]), int(fm["rgbnet_depth"])
    dims = [3 + 6 * pe + k0_dim] + [width] * (depth - 1) + [3]
    passed = sum(1 for b in ft["pg_scale"] if int(b) <= start_step)
    alpha_init = float(fm["alpha_init"])
    shift = math.log(1.0 / (1.0 - alpha_init) - 1.0) - float(ft["decay_after_scale"]) * passed
    return Recipe(
        family=family, world_size=world_size(bg_len, fields["num_voxels"]), k0_dim=k0_dim,
        mlp_dims=tuple(zip(dims[:-1], dims[1:])), viewbase_pe=pe, bg_len=bg_len,
        stepsize=float(fm["stepsize"]), act_shift=shift,
        thres=thres_at(fm["fast_color_thres_schedule"], start_step),
        white_bkgd=bool(data["white_bkgd"]), rand_bkgd=bool(data["rand_bkgd"]), train=dict(ft),
        start_step=start_step, **fields)
