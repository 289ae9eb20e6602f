"""The reference's own model at the window's first step, from the seed: the
scene box worked out from the capture's cameras, the grids and MLP filled by
the benchmark's inputs, and the occupancy cache computed here again. Plain
PyTorch; nothing of the program."""

from __future__ import annotations

import torch

from benchmark.inputs import capture as capture_mod
from benchmark.inputs import weights
from benchmark.reference import model
from benchmark.reference.recipe import Recipe

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build(R: Recipe, cfg: dict, seed: int, cap, device) -> dict:
    """The reference's model: density, k0 ([B, X, Y, Z, C] in the
    configuration's grid dtype), mlp [(weight, bias)] f32, the occupancy
    cache, the scene box."""
    center, radius = capture_mod.scene_box(cap, float(cfg["data"]["unbounded_inner_r"]),
                                           float(cfg["fine_model_and_render"]["world_bound_scale"]))
    dt = DTYPES[cfg["fine_model_and_render"]["grid_dtype"]]
    ws = R.world_size
    density = torch.zeros((R.banks, *ws, 1), dtype=dt, device=device)
    k0 = torch.zeros((R.banks, *ws, R.k0_dim), dtype=dt, device=device)
    cube = R.cube
    weights.imprint(density, k0, R.act_shift, center.tolist(), radius.tolist(), (-cube,) * 3,
                    (cube,) * 3, seed)
    mlp = [(torch.zeros((b, a), device=device), torch.zeros((b,), device=device))
           for a, b in R.mlp_dims]
    weights.fill_mlp(mlp, seed)
    return {"density": density, "k0": k0, "mlp": mlp, "mask": model.occupancy(R, density),
            "center": center, "radius": radius}
