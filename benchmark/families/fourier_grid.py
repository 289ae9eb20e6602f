"""FourierGrid (CVPR'24) as the benchmark needs it: its numbers in the
recipe, its plain forward, its density bake for a render, the shape of its
model FLOPs, and the hooks into the program's parameters.

The forward contracts and samples each ray, cuts it to the first
``sample_budget`` samples that a strided probe of the occupancy cache finds
occupied, takes the mean over the Fourier banks of each bank's trilinear
density, marches, and colours the samples over both thresholds; a render
reads the density from the bake (the field resampled onto one lattice at
``density_bake_scale`` times the resolution) and colours each ray's first
``color_budget`` samples over the weights threshold. Plain PyTorch; nothing
of the program but in the two hooks, which fill and name its tensors.
"""

from __future__ import annotations

import torch

from benchmark.core import program
from benchmark.reference import model as M
from benchmark.reference import scene
from benchmark.reference.recipe import world_size

program_fill = program.fill_grids
program_leaves = program.grid_leaves
reference_model = scene.build


def recipe_fields(cfg: dict) -> dict:
    fm = cfg["fine_model_and_render"]
    nv = int(fm["num_voxels_density"])
    if nv != int(fm["num_voxels_rgb"]):
        raise ValueError("the reference takes density and k0 on one lattice")
    bake = None
    if float(fm["density_bake_scale"]) > 0:
        bake = world_size(float(fm["bg_len"]), int(nv * float(fm["density_bake_scale"]) ** 3))
    return {"banks": 2 * int(fm["fourier_freq_num"]) + 1, "num_voxels": nv,
            "num_voxels_base": int(fm["num_voxels_base_density"]),
            "t_boundary": float(fm["t_boundary"]), "sample_budget": int(fm["sample_budget"]),
            "probe_stride": int(fm["budget_probe_stride"]),
            "color_budget": int(fm["color_budget"]), "bake_world_size": bake}


def render_bg(R) -> float:
    """A render takes no background from the data and composites on 0 (the
    JAX package's forward, which the port follows)."""
    return 0.0


def density_at(R, grid, pts, packed: bool):
    """The density field (every bank) at points of the cube, f32."""
    return M.field(grid, M.bank_coords(pts, R.cube, R.banks), torch.float32,
                   packed=packed)[..., 0]


def prepare_render(R, g: dict) -> None:
    """The render's density bake, worked out again from the grids."""
    if R.bake_world_size is not None:
        g["baked"] = M.density_on_lattice(R, g["density"], R.bake_world_size, packed=True,
                                          slab_nodes=1 << 20)


def flop_shape(R, render: bool) -> tuple:
    """(density banks, k0 banks, k0 channels, MLP dims) a sample's model
    FLOPs count (``benchmark.counts.model``): a render with a bake and a
    colour budget reads the density from one lattice."""
    baked = render and R.bake_world_size is not None and R.color_budget > 0
    return (1 if baked else R.banks), R.banks, R.k0_dim, R.mlp_dims


def forward(R, g: dict, ro, rd, vd, bg, dt, render: bool) -> dict:
    cube = R.cube
    with torch.no_grad():
        pts, _, t = M.sample(R, g["center"], g["radius"], ro, rd)
    N, S = pts.shape[:2]
    with torch.no_grad():
        if 0 < R.sample_budget < S:
            st = R.probe_stride
            probe = M.mask_lookup(g["mask"], pts[:, ::st], cube).repeat_interleave(st, 1)
            sel, live = M.compact(probe[:, :S], R.sample_budget)
            pts = M.take(pts, sel)
            tt = t[sel]
        else:  # a budget of every sample: none is dropped, none masked
            live = torch.ones((N, S), dtype=torch.bool, device=pts.device)
            tt = t.expand(N, S)
        c01b = M.bank_coords(pts, cube, R.banks)
    if render and R.bake_world_size is not None:
        baked = g["baked"]
        c01 = (M.norm01(pts, cube) * 2.0 - 1.0 + 1.0) * 0.5
        density = M.trilerp(baked.reshape(-1, 1), tuple(baked.shape), c01, dt,
                            packed=True)[..., 0]
    else:
        density = M.field(g["density"], c01b, dt, packed=render)[..., 0]
    w, ai, keep = M.march(R, density, live, dt)
    if render and R.color_budget > 0:
        sel2, live2 = M.compact(keep, min(R.color_budget, keep.shape[1]))
        wc = M.take(w, sel2) * live2.to(w.dtype)
        k0 = M.field(g["k0"], M.take(c01b.flatten(2), sel2).unflatten(2, (R.banks, 3)), dt,
                     packed=True)
        rgb = M.colour(R, g["mlp"], k0, vd, dt)
        rgb_marched = (wc[..., None] * rgb).sum(1) + ai[:, None] * bg
    else:
        k0 = M.field(g["k0"], c01b, dt, packed=render)
        rgb = M.colour(R, g["mlp"], k0, vd, dt)
        rgb_marched = (w[..., None] * rgb).sum(1) + ai[:, None] * bg
    return M.outputs(w, ai, keep, rgb, rgb_marched, density, tt, S)
