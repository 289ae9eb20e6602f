"""The benchmark's weights: the grids with the capture's scene written into
them and a seeded colour MLP, made on the device from the seed.

The grids stand where a run of the recipe stands after its last ``pg_scale``
boundary: a torch copy of the port's ``data/synthetic.py::imprint_scene``
writes an opaque ball where the capture's ball is (raw density + act_shift =
``SOLID`` inside, a soft edge), a thin haze in a shell of the contracted
background (``HAZE``, where 1 < |p|_inf < 1.03, on the white fields of a
checkerboard of side 1/4), and seeded noise into every k0 bank. A ray then
ends on the ball after a few samples, crosses clear sky, or gathers some
fifty low-weight samples in the haze, so the early exit, both thresholds
and a colour budget all have work. The same function fills the program's
tensors and the reference's, so both start from the same values.
"""

from __future__ import annotations

import math

import torch

from benchmark.inputs.capture import SPHERE_RADIUS, derive_seed

SOLID = 7.0
HAZE = -3.0
K0_NOISE = 0.5


@torch.no_grad()
def imprint(density: torch.Tensor, k0: torch.Tensor, act_shift: float, scene_center,
            scene_radius, xyz_min, xyz_max, seed: int) -> None:
    """Write the scene into ``density`` [B, X, Y, Z, 1] (bank 0, scaled by B
    because a query averages the banks) and noise into ``k0`` [B, X, Y, Z,
    C], in place. The grids lie on the contracted cube [xyz_min, xyz_max];
    ``scene_center`` / ``scene_radius`` map the world into it."""
    dev = density.device
    B, X, Y, Z, _ = density.shape
    axes = [torch.linspace(lo, hi, n, device=dev) for lo, hi, n in zip(xyz_min, xyz_max, (X, Y, Z))]
    p = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)
    radius = float(max(scene_radius))
    center = torch.tensor([-float(c) / radius for c in scene_center], device=dev)
    rs = SPHERE_RADIUS / radius
    raw = (SOLID - act_shift) * torch.sigmoid((rs - torch.linalg.norm(p - center, dim=-1))
                                              / (0.08 * rs))
    far = p.abs().amax(-1)
    white = torch.floor(p * 4.0).sum(-1) % 2 == 0
    raw = raw + (HAZE - act_shift) * ((far > 1.0) & (far < 1.03) & white)
    del p, far, white
    density[0, ..., 0] += (B * raw).to(density.dtype)
    del raw
    gen = torch.Generator(device=dev).manual_seed(derive_seed(seed, 3))
    for b in range(k0.shape[0]):
        k0[b] += (K0_NOISE * torch.randn(k0.shape[1:], generator=gen, device=dev)).to(k0.dtype)


@torch.no_grad()
def fill_mlp(layers, seed: int) -> None:
    """``layers``: [(weight [out, in], bias [out])] of the colour MLP, filled
    in place from U(+-1/sqrt(fan_in)), the last bias zero (``nn.Linear``'s
    rule, which the recipe's MLP follows), drawn on their device."""
    dev = layers[0][0].device
    gen = torch.Generator(device=dev).manual_seed(derive_seed(seed, 4))
    for i, (w, b) in enumerate(layers):
        bound = 1.0 / math.sqrt(w.shape[1])
        w.copy_((torch.rand(w.shape, generator=gen, device=dev) * 2 - 1) * bound)
        if i == len(layers) - 1:
            b.zero_()
        else:
            b.copy_((torch.rand(b.shape, generator=gen, device=dev) * 2 - 1) * bound)
