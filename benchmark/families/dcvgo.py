"""DCVGO (DVGO v2, unbounded inward) as the benchmark needs it: its
numbers in the recipe, its plain forward, the shape of its model FLOPs, and
the hooks into the program's parameters.

The forward contracts and samples each ray, keeps the inner samples and
those where ``cumdist_thres`` marks the running step length (the oversample
skip), and those the occupancy cache holds, interpolates density and k0 on
one lattice, marches, and colours the samples over both thresholds.
FourierGrid's own keys in the configuration (``sample_budget``,
``color_budget``, ``density_bake_scale``, ...) do not apply. Plain PyTorch;
nothing of the program but in the two hooks, which fill and name its
tensors.
"""

from __future__ import annotations

import torch

from benchmark.core import program
from benchmark.reference import model as M
from benchmark.reference import scene

program_fill = program.fill_grids
program_leaves = program.grid_leaves
reference_model = scene.build


def recipe_fields(cfg: dict) -> dict:
    fm = cfg["fine_model_and_render"]
    if not cfg["data"].get("unbounded_inward"):
        raise ValueError("the reference covers unbounded-inward DCVGO")
    return {"banks": 1, "num_voxels": int(fm["num_voxels_rgb"]),
            "num_voxels_base": int(fm["num_voxels_base_rgb"]), "t_boundary": 2.0,
            "sample_budget": 0, "probe_stride": 1, "color_budget": 0, "bake_world_size": None}


def render_bg(R) -> float:
    """The recipe's white or black background."""
    return 1.0 if R.white_bkgd else 0.0


def density_at(R, grid, pts, packed: bool):
    """The density field at points of the cube, f32."""
    return M.trilerp(grid.reshape(-1, 1), tuple(grid.shape[1:4]), M.norm01(pts, R.cube),
                     torch.float32, packed=packed)[..., 0]


def prepare_render(R, g: dict) -> None:
    """A render reads the grids themselves."""


def flop_shape(R, render: bool) -> tuple:
    """(density banks, k0 banks, k0 channels, MLP dims) a sample's model
    FLOPs count (``benchmark.counts.model``)."""
    return 1, 1, R.k0_dim, R.mlp_dims


def forward(R, g: dict, ro, rd, vd, bg, dt, render: bool) -> dict:
    cube = R.cube
    with torch.no_grad():
        pts, inner, t = M.sample(R, g["center"], g["radius"], ro, rd)
    N, S = pts.shape[:2]
    with torch.no_grad():
        tt = t.expand(N, S)
        step = pts[:, 1:] - pts[:, :-1]
        dist = torch.sqrt((step * step).sum(-1))
        live = inner.clone()
        live[:, 1:] |= M.cumdist_thres(dist, 2 * cube / R.world_size[0] * R.stepsize * 0.95)
        live &= M.mask_lookup(g["mask"], pts, cube)
        c01 = M.norm01(pts, cube)
    dims = tuple(g["density"].shape[1:4])
    density = M.trilerp(g["density"].reshape(-1, 1), dims, c01, dt, packed=render)[..., 0]
    k0 = M.trilerp(g["k0"].reshape(-1, g["k0"].shape[-1]), dims, c01, dt, packed=render)
    w, ai, keep = M.march(R, density, live, dt)
    rgb = M.colour(R, g["mlp"], k0, vd, dt)
    rgb_marched = (w[..., None] * rgb).sum(1) + ai[:, None] * bg
    return M.outputs(w, ai, keep, rgb, rgb_marched, density, tt, S)
