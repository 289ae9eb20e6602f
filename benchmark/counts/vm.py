"""The work of TensoRF's vector-matrix (VM) lookup by its definition, and
the model FLOPs of a DVGO step over two VM fields.

A field of R components a plane (planes xy, xz, yz; vectors z, y, x) and C
channels, looked up at one point: its three planes' 4 bilinear corners and
its three vectors' 2 linear corners are read (each R values), and the three
products, [.., 3R] features, are written; a corner's value is weighed and
summed (2 flops a corner and component), each plane's sample times its
vector's (R flops a pair), and the 3R features projected to C channels by
``f_vec`` (2 flops a feature and channel) or, for one channel, summed (3R
flops). Whatever implements it, this is what a lookup needs: the least
time of the work at the timed inputs is the yardstick of whatever kernel
does it.
"""

from __future__ import annotations

from benchmark.counts.model import mlp_flops

PLANE_CORNERS, LINE_CORNERS = 4, 2
CORNER_FLOPS = 2  # weigh and sum


def lookup_work(n: int, ranks, channels: int, element_size: int) -> tuple:
    """(bytes, flops) of ``n`` lookups of a field whose planes have
    ``ranks`` (R_xy, R_xz, R_yz) components, each vector its plane's."""
    r = int(sum(ranks))
    nbytes = n * element_size * ((PLANE_CORNERS + LINE_CORNERS) * r + r)
    project = 2 * r * channels if channels > 1 else r
    flops = n * (CORNER_FLOPS * (PLANE_CORNERS + LINE_CORNERS) * r + r + project)
    return nbytes, flops


def step_flops(n_density: float, n_colour: float, density_comp: int, k0_comp: int,
               k0_dim: int, mlp_dims) -> float:
    """A train step's model FLOPs: the density looked up at the samples the
    occupancy cache keeps (``n_density``), k0 and the MLP at those over both
    thresholds (``n_colour``), and the backward at twice the forward."""
    density = lookup_work(1, (density_comp,) * 3, 1, 4)[1]
    k0 = lookup_work(1, (k0_comp,) * 3, k0_dim, 4)[1]
    return 3 * (n_density * density + n_colour * (k0 + mlp_flops(mlp_dims)))
