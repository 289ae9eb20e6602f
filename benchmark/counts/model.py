"""The model FLOPs of a train step and of a rendered view, by the
configuration's mathematics: the trilinear corner sums of every bank and
channel that a sample needs, and the colour MLP's matrix products on the
samples that the configuration's rules colour; a train step adds the
backward of both at twice the forward.

A corner sum is 8 products and 8 additions: 16 flops a bank and channel.
The density is needed at every sample that the forward kept after the
occupancy cache and the sample budget (``n_density``); k0 and the MLP at the
samples over both ``fast_color_thres`` thresholds (``n_colour``), at most
``color_budget`` a ray where a render colours only so many. Counting the
samples is the caller's: the harness reads them from the masks of the timed
path's forward, the CPU tests from shapes worked by hand.
"""

from __future__ import annotations

CORNER_FLOPS = 16


def mlp_flops(mlp_dims) -> int:
    """Multiply-adds of one sample through the MLP, as 2 flops each."""
    return sum(2 * a * b for a, b in mlp_dims)


def forward_flops(n_density: float, n_colour: float, density_banks: int, k0_banks: int,
                  k0_dim: int, mlp_dims) -> float:
    return (CORNER_FLOPS * n_density * density_banks
            + CORNER_FLOPS * n_colour * k0_banks * k0_dim
            + n_colour * mlp_flops(mlp_dims))


def step_flops(n_density: float, n_colour: float, density_banks: int, k0_banks: int,
               k0_dim: int, mlp_dims) -> float:
    """A train step: the forward, and the backward at twice its flops."""
    return 3 * forward_flops(n_density, n_colour, density_banks, k0_banks, k0_dim, mlp_dims)
