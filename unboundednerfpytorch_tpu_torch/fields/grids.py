"""Field primitives: the Fourier-embedded multi-bank grid and the occupancy
mask.

Counterpart of ``FourierGrid``, ``MaskGrid`` and ``nerf_pos_embed_coords``
of ``unboundednerfpytorch_tpu/fields/grids.py``. Grids are channel-last
``[B, X, Y, Z, C]`` parameters (B = 2K+1 banks).
"""

from __future__ import annotations

import torch
from torch import nn

from unboundednerfpytorch_tpu_torch.ops import interp, sampling


def _norm01(xyz: torch.Tensor, xyz_min, xyz_max) -> torch.Tensor:
    mn = torch.tensor(xyz_min, dtype=xyz.dtype, device=xyz.device)
    mx = torch.tensor(xyz_max, dtype=xyz.dtype, device=xyz.device)
    return (xyz - mn) / (mx - mn)


def nerf_pos_embed_coords(coords: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """[-1, 1] coords [..., 3] -> the 2K+1 bank coords [..., 2K+1, 3]:
    bank 0 = identity, then (sin 2^k c, cos 2^k c) for k = 0..K-1."""
    banks = [coords[..., None, :]]
    for k in range(num_freqs):
        scaled = coords * (2.0**k)
        banks.append(torch.sin(scaled)[..., None, :])
        banks.append(torch.cos(scaled)[..., None, :])
    return torch.cat(banks, dim=-2)


class FourierGrid(nn.Module):
    """Multi-bank voxel grid; query = mean over banks of a trilinear sample
    at each bank's embedded coordinate (num_freqs == 0: one plain bank)."""

    def __init__(self, channels: int, world_size, xyz_min, xyz_max, num_freqs: int = 0,
                 dtype=torch.float32, device=None, grid: torch.Tensor | None = None):
        super().__init__()
        X, Y, Z = (int(s) for s in world_size)
        banks = 1 + 2 * num_freqs if num_freqs > 0 else 1
        if grid is None:
            grid = torch.zeros((banks, X, Y, Z, channels), dtype=dtype, device=device)
        self.grid = nn.Parameter(grid)
        self.xyz_min = tuple(float(v) for v in xyz_min)
        self.xyz_max = tuple(float(v) for v in xyz_max)
        self.num_freqs = int(num_freqs)

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        coords = _norm01(xyz, self.xyz_min, self.xyz_max) * 2.0 - 1.0
        B = self.grid.shape[0]
        if self.num_freqs > 0:
            c01 = (nerf_pos_embed_coords(coords, self.num_freqs) + 1.0) * 0.5
            return interp.grid_sample_banks(self.grid, c01) / B
        return interp.grid_sample_3d(self.grid[0], (coords + 1.0) * 0.5)


class MaskGrid(nn.Module):
    """Boolean occupancy grid [X, Y, Z] with nearest-voxel lookup."""

    def __init__(self, world_size, xyz_min, xyz_max, mask: torch.Tensor | None = None,
                 device=None):
        super().__init__()
        X, Y, Z = (int(s) for s in world_size)
        if mask is None:
            mask = torch.ones((X, Y, Z), dtype=torch.bool, device=device)
        self.register_buffer("mask", mask.to(torch.bool))
        self.xyz_min = tuple(float(v) for v in xyz_min)
        self.xyz_max = tuple(float(v) for v in xyz_max)

    def scale_shift(self):
        dev = self.mask.device
        mn = torch.tensor(self.xyz_min, dtype=torch.float32, device=dev)
        mx = torch.tensor(self.xyz_max, dtype=torch.float32, device=dev)
        size = torch.tensor(self.mask.shape, dtype=torch.float32, device=dev)
        scale = (size - 1) / (mx - mn)
        return scale, -mn * scale

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        scale, shift = self.scale_shift()
        return sampling.maskcache_lookup(self.mask, xyz, scale, shift)
