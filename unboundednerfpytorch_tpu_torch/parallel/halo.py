"""The trilinear sample of a grid cut along x over a grid group, with a halo
exchange.

Counterpart of ``unboundednerfpytorch_tpu/parallel/halo.py``
(``sharded_grid_sample``). A shard holds the x-slab ``[B, xs, Y, Z, C]`` of
a ``[B, X, Y, Z, C]`` grid (B banks, each queried at its own coordinate).
A query at base plane ``x`` needs planes ``x`` and ``x + 1``, so:

1. each shard sends its first plane to its left neighbour, which appends it
   to its slab (``[B, xs + 1, Y, Z, C]``); the last shard appends zeros
   (plane X does not exist): one exchange for all banks at once;
2. each (query, bank) is answered by the shard that owns its base plane,
   ``clip(floor(x (X - 1)), 0, X - 1) // xs``, from its extended slab at the
   point less ``index * xs`` planes, which gives the global corners and
   weights to the bit (:func:`..ops.interp.corners_at`);
3. the partial answers, summed over the banks in bank order, are summed over
   the grid group: one all-reduce a field and a forward.

The JAX package does one exchange and one ``psum`` a bank; the sum is
linear, so the values are the same up to the order of a float sum.

Gradients: the extension is a ``torch.autograd.Function`` whose backward
sends the appended plane's gradient back to the neighbour it came from,
which adds it to the gradient of its first plane; the all-reduce's backward
is the identity on the (replicated) cotangent. So a shard's grid gradient
is the sum over the queries it owns, as one device's would be for those
planes.

:func:`partial_sample` is step 2 alone, on an extended slab given by the
caller: a single process can emulate a grid group by handing each shard a
copy of its neighbour's plane.

A ``pg_scale`` boundary keeps a grid cut where the group divides its new X:
:func:`resize_source` hands each shard the neighbours' planes that its share
of the resize reads (:func:`resize_plan`: at most one on each side where the
grid grows), and :func:`max_pool_3x3_slab` the neighbours' edge planes that
the occupancy refresh's pool reads; :func:`all_gather_x` joins slabs (the
refreshed mask, which stays whole on every rank).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from unboundednerfpytorch_tpu_torch.ops import interp


@dataclasses.dataclass(frozen=True)
class GridShard:
    """Which x-slab of a grid this rank holds: shard ``index`` of ``count``
    over ``group`` (whose global ranks, in shard order, are ``ranks``), of a
    grid of ``X`` planes."""

    index: int
    count: int
    X: int
    group: object = None
    ranks: tuple = ()

    @property
    def xs(self) -> int:
        return self.X // self.count


def transportable(t: torch.Tensor) -> torch.Tensor:
    """gloo takes no bfloat16 (nor bool): such a tensor travels as its bytes."""
    return t.view(torch.uint8) if t.dtype in (torch.bfloat16, torch.bool) else t


def _p2p(sends: list, recvs: list, shard: GridShard) -> None:
    """One batch of point-to-point operations over the grid group: each
    (tensor, shard index) of ``sends`` sent, each (buffer, shard index) of
    ``recvs`` filled in place."""
    ops = [dist.P2POp(dist.irecv, transportable(buf), shard.ranks[k], group=shard.group)
           for buf, k in recvs]
    ops += [dist.P2POp(dist.isend, transportable(t.contiguous()), shard.ranks[k],
                       group=shard.group) for t, k in sends]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def _shift(send: torch.Tensor | None, to: int | None, recv_from: int | None,
           like: torch.Tensor, shard: GridShard) -> torch.Tensor | None:
    """Send ``send`` to shard ``to`` and receive a tensor shaped as ``like``
    from shard ``recv_from`` (either may be None), as one batch of
    point-to-point operations over the grid group."""
    out = None if recv_from is None else torch.empty_like(like)
    _p2p([] if to is None else [(send, to)], [] if out is None else [(out, recv_from)], shard)
    return out


class _Extend(torch.autograd.Function):
    """slab [B, xs, Y, Z, C] -> [B, xs + 1, Y, Z, C]: the right neighbour's
    first plane appended (zeros on the last shard)."""

    @staticmethod
    def forward(ctx, slab, shard: GridShard):
        ctx.shard = shard
        k = shard.index
        first = slab[:, 0].contiguous()
        halo = _shift(first, k - 1 if k > 0 else None, k + 1 if k + 1 < shard.count else None,
                      first, shard)
        if halo is None:
            halo = torch.zeros_like(first)
        return torch.cat([slab, halo[:, None]], dim=1)

    @staticmethod
    def backward(ctx, g_ext):
        shard = ctx.shard
        k = shard.index
        xs = g_ext.shape[1] - 1
        g_slab = g_ext[:, :xs].contiguous()
        g_halo = g_ext[:, xs].contiguous()
        # the appended plane's gradient goes back to its owner, the right
        # neighbour; the last shard's plane of zeros has none
        from_left = _shift(g_halo, k + 1 if k + 1 < shard.count else None,
                           k - 1 if k > 0 else None, g_halo, shard)
        if from_left is not None:
            g_slab[:, 0] += from_left
        return g_slab, None


class _GridSum(torch.autograd.Function):
    """All-reduce (sum) over the grid group; the backward is the identity,
    as every rank of the group holds the same cotangent."""

    @staticmethod
    def forward(ctx, partial, shard: GridShard):
        out = partial.clone()
        dist.all_reduce(out, group=shard.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def partial_sample(ext: torch.Tensor, c01: torch.Tensor, index: int, X: int) -> torch.Tensor:
    """Shard ``index``'s share of the bank sum of a trilinear sample: ext
    [B, xs + 1, Y, Z, C] (its slab and the next plane), c01 [..., B, 3] each
    bank's query in [0, 1] of the whole grid (align_corners, zeros padding,
    as :func:`..ops.interp.grid_sample_3d`). Returns [..., C] (f32 for a
    bf16 grid): the sum over banks, in bank order, of the answers to the
    (query, bank) pairs this shard owns, zero for the others."""
    B, xe, Y, Z, C = ext.shape
    xs = xe - 1
    scale = torch.tensor([X - 1, Y - 1, Z - 1], dtype=c01.dtype, device=c01.device)
    c = c01 * scale
    base = torch.floor(c[..., 0]).clamp(0, X - 1)
    mine = torch.div(base, xs, rounding_mode="floor") == index
    shift = torch.tensor([index * xs, 0, 0], dtype=c.dtype, device=c.device)
    idx, w = interp.corners_at(c - shift, (xe, Y, Z))  # [..., B, 8]
    w = w * mine[..., None].to(w.dtype)
    idx = idx + torch.arange(B, device=idx.device, dtype=idx.dtype)[:, None] * (xe * Y * Z)
    batch = idx.shape[:-2]
    vals = interp.GatherTrilerp.apply(ext.reshape(-1, C), idx.reshape(-1, 8),
                                      w.reshape(-1, 8)).reshape(*batch, B, C)
    out = vals[..., 0, :]
    for b in range(1, B):
        out = out + vals[..., b, :]
    return out


def sharded_grid_sample(slab: torch.Tensor, c01: torch.Tensor, shard: GridShard) -> torch.Tensor:
    """The bank sum of the trilinear sample of the whole grid, on every rank
    of the grid group: slab [B, xs, Y, Z, C] this rank's x-slab, c01 [..., B,
    3]. Differentiable with respect to ``slab``; every rank of the group must
    call it with the same queries."""
    ext = _Extend.apply(slab, shard)
    return _GridSum.apply(partial_sample(ext, c01, shard.index, shard.X), shard)


def exchange_boundary_planes(slab: torch.Tensor, shard: GridShard):
    """(plane before the slab, plane after it) [B, Y, Z, C] from the left and
    right neighbours (None at the grid's ends): what a shard's TV needs."""
    k = shard.index
    left = k - 1 if k > 0 else None
    right = k + 1 if k + 1 < shard.count else None
    first, last = slab[:, 0].contiguous(), slab[:, -1].contiguous()
    # a shard's last plane goes right, its first plane goes left
    before = _shift(last, right, left, last, shard)
    after = _shift(first, left, right, first, shard)
    return before, after


def all_gather_x(slab: torch.Tensor, shard: GridShard, axis: int = 1) -> torch.Tensor:
    """The whole tensor, on every rank of the grid group, from each shard's
    slab along ``axis``."""
    parts = [torch.empty_like(slab) for _ in range(shard.count)]
    dist.all_gather([transportable(p) for p in parts], transportable(slab.contiguous()),
                    group=shard.group)
    return torch.cat(parts, dim=axis)


def resize_plan(count: int, x_old: int, x_new: int) -> list:
    """For each of ``count`` shards of an ``x_old``-plane grid resized to
    ``x_new`` planes (``count`` dividing both): (first, stop, a, b), its new
    planes [first, stop) and the old planes [a, b) that they read
    (``interp.resize_source_planes``). A new slab reads its own old slab and,
    where the grid grows, the last plane of its left neighbour's and the
    first of its right neighbour's."""
    xs = x_new // count
    return [(a, a + xs, *interp.resize_source_planes(x_old, x_new, a, a + xs))
            for a in range(0, x_new, xs)]


def resize_source(slab: torch.Tensor, shard: GridShard, x_new: int) -> tuple:
    """(ext, a): this shard's x-slab [B, xs, ...] with the neighbours' planes
    that its share of a resize to ``x_new`` planes reads (:func:`resize_plan`)
    on either side, and the global index of ext's first plane. One batch of
    point-to-point operations over the grid group; every rank of the group
    calls it. A plan that reads past a neighbour's slab is refused."""
    plan = resize_plan(shard.count, shard.X, x_new)
    xs, k = shard.xs, shard.index

    def need(j):  # planes shard j reads of its left and of its right neighbour
        _, _, a, b = plan[j]
        left, right = max(0, j * xs - a), max(0, b - (j + 1) * xs)
        if left > xs or right > xs:
            raise ValueError(f"a resize of {shard.X} to {x_new} planes over {shard.count} "
                             f"shards reads past a neighbour's slab")
        return left, right

    left, right = need(k)
    sends, recvs = [], []
    before = after = None
    if k > 0:
        n = need(k - 1)[1]
        if n:
            sends.append((slab[:, :n], k - 1))
        if left:
            before = torch.empty_like(slab[:, :left])
            recvs.append((before, k - 1))
    if k + 1 < shard.count:
        n = need(k + 1)[0]
        if n:
            sends.append((slab[:, xs - n:], k + 1))
        if right:
            after = torch.empty_like(slab[:, :right])
            recvs.append((after, k + 1))
    _p2p(sends, recvs, shard)
    parts = [t for t in (before, slab, after) if t is not None]
    return (torch.cat(parts, dim=1) if len(parts) > 1 else slab), k * xs - left


def max_pool_3x3_slab(vol: torch.Tensor, shard: GridShard) -> torch.Tensor:
    """``interp.max_pool_3d_same(window=3)`` of a grid [X, Y, Z] cut along x,
    on this shard's slab [xs, Y, Z]: the neighbours' edge planes exchanged
    (one batch each way), the slab pooled with them and cut back. Equal to
    the whole grid's pool's planes, the max being exact."""
    before, after = exchange_boundary_planes(vol[None], shard)  # [1, Y, Z] each, or None
    ext = torch.cat([t for t in (before, vol, after) if t is not None], dim=0)
    first = 0 if before is None else 1
    return interp.max_pool_3d_same(ext, window=3)[first:first + vol.shape[0]]
