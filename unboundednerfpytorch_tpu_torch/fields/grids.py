"""Field primitives: the Fourier-embedded multi-bank grid, the dense grid,
the vector-matrix (TensoRF) grid and the occupancy mask.

Counterpart of ``FourierGrid`` (with ``scale_volume_grid``), ``DenseGrid``,
``TensoRFGrid``, ``MaskGrid`` and ``nerf_pos_embed_coords`` of
``unboundednerfpytorch_tpu/fields/grids.py``. Voxel grids are channel-last
``[B, X, Y, Z, C]`` parameters (B = 2K+1 banks; one for a dense grid, whose
JAX counterpart is ``[X, Y, Z, C]``), so that the TV kernel, the resize and
the index-add backward serve both. A TensoRF grid keeps the JAX layout:
planes ``[A, B, R]`` and vectors ``[A, R]``, channel-last.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from unboundednerfpytorch_tpu_torch.device import constant
from unboundednerfpytorch_tpu_torch.ops import interp, sampling
from unboundednerfpytorch_tpu_torch.parallel import halo
from unboundednerfpytorch_tpu_torch.parallel import mesh as mesh_mod
from unboundednerfpytorch_tpu_torch.utils.profiling import span


def _norm01(xyz: torch.Tensor, xyz_min, xyz_max) -> torch.Tensor:
    mn = constant(xyz_min, xyz.dtype, xyz.device)
    mx = constant(xyz_max, xyz.dtype, xyz.device)
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
    at each bank's embedded coordinate (num_freqs == 0: one plain bank).

    ``dense`` says that the field's values are its lattice ``grid`` itself,
    which the TV kernel, the packed render cache, the near-camera mask-out
    and the bf16 storage work on; a decomposed field (TensoRF) has none and
    says False. Every field gives ``get_dense_grid``.

    ``shard`` (a :class:`..parallel.halo.GridShard`, set by
    ``parallel.mesh.shard_params``) says that ``grid`` holds one x-slab of
    the lattice, ``[B, X / count, Y, Z, C]``: queries then go through the
    halo-exchange sample and every rank of the grid group must make them
    together; ``world_size`` stays the whole lattice's."""

    dense = True

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
        self.shard = None

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        coords = _norm01(xyz, self.xyz_min, self.xyz_max) * 2.0 - 1.0
        B = self.grid.shape[0]
        if self.num_freqs > 0:
            c01 = (nerf_pos_embed_coords(coords, self.num_freqs) + 1.0) * 0.5
            if self.shard is not None:
                return halo.sharded_grid_sample(self.grid, c01, self.shard) / B
            return interp.grid_sample_banks(self.grid, c01) / B
        if self.shard is not None:
            return halo.sharded_grid_sample(self.grid, ((coords + 1.0) * 0.5)[..., None, :],
                                            self.shard)
        return interp.grid_sample_3d(self.grid[0], (coords + 1.0) * 0.5)

    @torch.no_grad()
    def scale_volume_grid(self, new_world_size) -> None:
        """Resample every bank onto ``new_world_size`` (trilinear,
        align-corners), in place: ``grid`` becomes a new parameter of the
        same dtype, and the old one is dropped. A bank at a time, in f32,
        rounded once to the grid's dtype: at full width the f32 image of
        all banks together would be several GB.

        A cut grid stays cut where its group's size divides the new X: each
        rank resizes its own slab, with the neighbours' planes that the
        resize reads (``halo.resize_source``), to the bit the whole grid's
        planes, and ``shard`` describes the new lattice. Elsewhere the old
        slabs are joined on every rank (``parallel.mesh``'s one join, the JAX
        rule's replicated placement) and the whole grid is resized."""
        size = tuple(int(s) for s in new_world_size)
        src, shard, x_range = self.grid.detach(), self.shard, None
        if shard is not None:
            if size[0] % shard.count == 0:
                src, a = halo.resize_source(src, shard, size[0])
                self.shard = dataclasses.replace(shard, X=size[0])
                first = self.shard.index * self.shard.xs
                x_range = (a, shard.X, first, first + self.shard.xs)
            else:
                src = mesh_mod._gather_x(src, shard)
                self.shard = None
            # the old slab goes before the new grid is made: ``src`` holds
            # what the resize reads
            self.grid.data = src.new_empty(0)
        new = resize_banks(src, size, x_range)
        del src
        self.grid = nn.Parameter(new, requires_grad=self.grid.requires_grad)

    @property
    def world_size(self) -> tuple:
        if self.shard is not None:
            return (self.shard.X, *self.grid.shape[2:4])
        return tuple(self.grid.shape[1:4])

    def get_dense_grid(self) -> torch.Tensor:
        """The lattice, every bank: [B, X, Y, Z, C] (the JAX ``grid``)."""
        if self.shard is not None:
            raise ValueError("get_dense_grid needs the whole grid: unshard it first")
        return self.grid


def resize_banks(grid: torch.Tensor, size, x_slab: tuple | None = None) -> torch.Tensor:
    """Every bank of ``grid`` [B, X, Y, Z, C] resized to ``size`` by
    ``interp.resize_grid_3d`` (with its ``x_slab``: output planes
    [first, stop) alone, from old planes [a, ...)), a bank at a time in f32,
    rounded once to the grid's dtype."""
    X = size[0] if x_slab is None else x_slab[3] - x_slab[2]
    new = torch.empty((grid.shape[0], X, *size[1:], grid.shape[-1]), dtype=grid.dtype,
                      device=grid.device)
    for b in range(grid.shape[0]):
        new[b] = interp.resize_grid_3d(grid[b], size, x_slab=x_slab)
    return new


class DenseGrid(FourierGrid):
    """One plain bank ``[1, X, Y, Z, C]``, queried at the normalized
    coordinate itself (as the JAX ``DenseGrid``, without the round trip
    through [-1, 1] that a one-bank FourierGrid takes)."""

    def __init__(self, channels: int, world_size, xyz_min, xyz_max, dtype=torch.float32,
                 device=None, grid: torch.Tensor | None = None):
        super().__init__(channels, world_size, xyz_min, xyz_max, num_freqs=0, dtype=dtype,
                         device=device, grid=grid)

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        c01 = _norm01(xyz, self.xyz_min, self.xyz_max)
        if self.shard is not None:
            return halo.sharded_grid_sample(self.grid, c01[..., None, :], self.shard)
        return interp.grid_sample_3d(self.grid[0], c01)

    def get_dense_grid(self) -> torch.Tensor:
        """The values at the lattice's nodes, [X, Y, Z, C]."""
        if self.shard is not None:
            raise ValueError("get_dense_grid needs the whole grid: unshard it first")
        return self.grid[0]


# the TensoRF leaves in the JAX pytree's order (f_vec only where channels > 1)
TENSORF_LEAVES = ("xy_plane", "xz_plane", "yz_plane", "x_vec", "y_vec", "z_vec", "f_vec")


def vm_lookup(n01: torch.Tensor, f_vec: torch.Tensor | None, tables: tuple) -> torch.Tensor:
    """A TensoRF field at points ``n01`` [..., 3] in [0, 1]: ``tables`` the
    planes xy, xz, yz and the vectors x, y, z (:class:`TensoRFGrid`'s
    leaves), each plane's bilinear sample times its complementary vector's
    linear one, the three products concatenated and projected by ``f_vec``
    (or, without it, summed to one channel): [..., C]."""
    xy_plane, xz_plane, yz_plane, x_vec, y_vec, z_vec = tables
    x, y, z = n01[..., 0], n01[..., 1], n01[..., 2]

    def line(vec, c):  # [A, R] at c in [0, 1] -> [..., R]
        return interp.grid_sample_2d(vec[:, None, :], torch.stack([c, torch.zeros_like(c)], -1))

    xy = interp.grid_sample_2d(xy_plane, torch.stack([x, y], -1))
    xz = interp.grid_sample_2d(xz_plane, torch.stack([x, z], -1))
    yz = interp.grid_sample_2d(yz_plane, torch.stack([y, z], -1))
    xv, yv, zv = line(x_vec, x), line(y_vec, y), line(z_vec, z)
    if f_vec is not None:
        return torch.cat([xy * zv, xz * yv, yz * xv], dim=-1) @ f_vec
    val = (xy * zv).sum(-1) + (xz * yv).sum(-1) + (yz * xv).sum(-1)
    return val[..., None]


class VMQuery(torch.autograd.Function):
    """:func:`vm_lookup` as one node of autograd, so that its whole backward
    (the lookups' index-add, the products' and the projection's) runs under
    the ``backward/vm`` span. The forward runs :func:`vm_lookup` with
    autograd on, over detached copies of the inputs, and keeps that graph;
    the backward is that graph's: the same operations in the same order as
    without the node, so the values and gradients are equal to the bit."""

    @staticmethod
    def forward(ctx, n01, f_vec, *tables):
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip((n01, f_vec, *tables), ctx.needs_input_grad)]
            out = vm_lookup(leaves[0], leaves[1], tuple(leaves[2:]))
        ctx.leaves, ctx.out = leaves, out
        return out.detach()

    @staticmethod
    def backward(ctx, grad):
        with span("backward/vm"):
            want = [i for i, t in enumerate(ctx.leaves) if t is not None and t.requires_grad]
            got = torch.autograd.grad(ctx.out, [ctx.leaves[i] for i in want], grad)
        grads = [None] * len(ctx.leaves)
        for i, g in zip(want, got):
            grads[i] = g
        del ctx.leaves, ctx.out
        return tuple(grads)


def vm_query(n01: torch.Tensor, f_vec: torch.Tensor | None, tables: tuple) -> torch.Tensor:
    """:func:`vm_lookup`, through :class:`VMQuery` where autograd records it."""
    args = (n01, f_vec, *tables)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
        return VMQuery.apply(*args)
    return vm_lookup(n01, f_vec, tables)


class TensoRFGrid(nn.Module):
    """Vector-matrix decomposed grid (TensoRF; the JAX ``TensoRFGrid``):
    planes xy [X, Y, Rxy], xz [X, Z, R], yz [Y, Z, R] and vectors x [X, R],
    y [Y, R], z [Z, Rxy]. A query multiplies each plane's bilinear sample by
    its complementary vector's linear one; for ``channels`` > 1 the three
    products, concatenated, are projected by ``f_vec`` [R + R + Rxy,
    channels] (a matmul), else summed to one channel.

    ``leaves`` (name -> tensor) builds it from given values, e.g. the JAX
    package's; otherwise planes and vectors are drawn N(0, 0.1^2) and
    ``f_vec`` U(+-sqrt(6 / (6 fan_in))) from ``generator``, on the CPU, then
    moved (the JAX package's distributions; its draws differ).

    A query runs under the ``field/vm`` span (:func:`vm_query`: the six
    lookups, the products and the projection), and its whole backward, while
    autograd runs it, under ``backward/vm``, inside ``train_step/backward``."""

    dense = False

    def __init__(self, channels: int, world_size, xyz_min, xyz_max, n_comp: int,
                 n_comp_xy: int | None = None, generator: torch.Generator | None = None,
                 device=None, leaves: dict | None = None):
        super().__init__()
        X, Y, Z = (int(s) for s in world_size)
        R = int(n_comp)
        Rxy = int(n_comp_xy) if n_comp_xy is not None else R
        self.xyz_min = tuple(float(v) for v in xyz_min)
        self.xyz_max = tuple(float(v) for v in xyz_max)
        self.channels = int(channels)
        shapes = {"xy_plane": (X, Y, Rxy), "xz_plane": (X, Z, R), "yz_plane": (Y, Z, R),
                  "x_vec": (X, R), "y_vec": (Y, R), "z_vec": (Z, Rxy)}
        if self.channels > 1:
            shapes["f_vec"] = (R + R + Rxy, self.channels)
        for name in TENSORF_LEAVES:
            if name not in shapes:
                self.f_vec = None
                continue
            if leaves is not None:
                value = leaves[name]
                value = (value.detach().to(torch.float32) if isinstance(value, torch.Tensor)
                         else torch.tensor(np.asarray(value, np.float32)))
                if tuple(value.shape) != shapes[name]:
                    raise ValueError(f"{name} {tuple(value.shape)}, want {shapes[name]}")
            elif name == "f_vec":
                bound = (6.0 / ((1 + 5.0) * (R + R + Rxy))) ** 0.5
                value = (torch.rand(shapes[name], generator=generator) * 2 - 1) * bound
            else:
                value = torch.randn(shapes[name], generator=generator) * 0.1
            setattr(self, name, nn.Parameter(value.to(device)))

    @property
    def world_size(self) -> tuple:
        return (self.xy_plane.shape[0], self.xy_plane.shape[1], self.xz_plane.shape[1])

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        with span("field/vm"):
            n01 = _norm01(xyz, self.xyz_min, self.xyz_max)
            return vm_query(n01, self.f_vec, tuple(getattr(self, name)
                                                   for name in TENSORF_LEAVES[:6]))

    @torch.no_grad()
    def scale_volume_grid(self, new_world_size) -> None:
        """Planes and vectors resampled to ``new_world_size`` (trilinear,
        align-corners, as the JAX package resizes them), in place: new
        parameters of the same trainability; ``f_vec`` is kept."""
        X, Y, Z = (int(s) for s in new_world_size)

        def plane(p, a, b):
            return interp.resize_grid_3d(p[:, :, None, :], (a, b, 1))[:, :, 0, :]

        def vec(v, a):
            return interp.resize_grid_3d(v[:, None, None, :], (a, 1, 1))[:, 0, 0, :]

        new = {"xy_plane": plane(self.xy_plane, X, Y), "xz_plane": plane(self.xz_plane, X, Z),
               "yz_plane": plane(self.yz_plane, Y, Z), "x_vec": vec(self.x_vec, X),
               "y_vec": vec(self.y_vec, Y), "z_vec": vec(self.z_vec, Z)}
        for name, value in new.items():
            old = getattr(self, name)
            setattr(self, name, nn.Parameter(value.to(old.dtype),
                                             requires_grad=old.requires_grad))

    def get_dense_grid(self) -> torch.Tensor:
        """The field at every node of the lattice, [X, Y, Z, C] (C = 1 for a
        scalar grid), as the JAX einsums give it."""
        if self.channels > 1:
            feat = torch.cat([torch.einsum("xyr,zr->xyzr", self.xy_plane, self.z_vec),
                              torch.einsum("xzr,yr->xyzr", self.xz_plane, self.y_vec),
                              torch.einsum("yzr,xr->xyzr", self.yz_plane, self.x_vec)], dim=-1)
            return torch.einsum("xyzr,rc->xyzc", feat, self.f_vec)
        g = (torch.einsum("xyr,zr->xyz", self.xy_plane, self.z_vec)
             + torch.einsum("xzr,yr->xyz", self.xz_plane, self.y_vec)
             + torch.einsum("yzr,xr->xyz", self.yz_plane, self.x_vec))
        return g[..., None]

    def leaves(self) -> dict:
        """name -> parameter, in the JAX pytree's order."""
        return {name: getattr(self, name) for name in TENSORF_LEAVES
                if getattr(self, name) is not None}


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
        mn = constant(self.xyz_min, torch.float32, dev)
        mx = constant(self.xyz_max, torch.float32, dev)
        size = constant(self.mask.shape, torch.float32, dev)
        scale = (size - 1) / (mx - mn)
        return scale, -mn * scale

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        scale, shift = self.scale_shift()
        return sampling.maskcache_lookup(self.mask, xyz, scale, shift)
