"""The process group and the (data, grid) layout of its ranks.

Counterpart of ``unboundednerfpytorch_tpu/parallel/mesh.py``. The JAX
package runs one SPMD program over a mesh of chips; the port runs one
process a GPU, as ``torchrun`` launches them, joined by a
``torch.distributed`` process group (NCCL on the card, gloo on the CPU):

* ``data``: every rank draws the same global ray batch and takes its slice
  (:meth:`Mesh.batch_slice`); each scales its loss terms to its share of the
  global loss and the gradients are summed over the ``data`` group, so a
  step equals the single-device step on the global batch;
* ``grid``: the voxel grids are cut along their first spatial axis over the
  ``grid`` group (:func:`shard_params`, the JAX rule: a grid whose X the
  group's size does not divide stays whole), and their queries go through
  the halo-exchange sample of :mod:`.halo`. Once cut, a grid and its Adam
  moments stand whole on no card: a ``pg_scale`` boundary resizes them slab
  by slab (but where the group does not divide the new X: the one join,
  :func:`_gather_x`, as JAX replicates such an array), a save assembles them
  in host memory of the group's first rank (:func:`gather_to_host`: a slab
  at a time through one slab's buffer on its card), and a resume cuts a
  checkpoint on the host (:func:`shard_params`, :func:`shard_opt_state`).

Ranks are laid out as the JAX mesh's devices: rank ``r`` has data index
``r // grid`` and grid index ``r % grid``; the ranks of one grid group hold
consecutive x-slabs in rank order.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from unboundednerfpytorch_tpu_torch.parallel import halo
from unboundednerfpytorch_tpu_torch.parallel.halo import GridShard

# the fields whose lattice grids are sharded (the MLP, the view grid, the
# embeddings and the occupancy mask stay whole on every rank)
SHARDED_FIELDS = ("density", "k0")


def maybe_initialize_distributed(device=None, log_fn=None) -> bool:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL on
    ``cuda:LOCAL_RANK``, made the current device, or gloo for ``device="cpu"``.
    A single-process run (no ``WORLD_SIZE`` above 1) is left untouched and
    gets False; an initialised group gets True."""
    if dist.is_initialized():
        return True
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu:
        torch.cuda.set_device(local)
    dist.init_process_group("gloo" if on_cpu else "nccl", init_method="env://", rank=rank,
                            world_size=world)
    if log_fn is not None:
        log_fn(f"distributed: rank {rank} of {world} ({dist.get_backend()})")
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """Rank 0, or a run without a process group: the one that writes files."""
    return rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, grid) layout and its two groups."""

    data: int  # ranks along the data axis
    grid: int  # ranks along the grid axis
    rank: int
    data_group: object  # ranks with this rank's grid index (None: this rank alone)
    grid_group: object  # ranks with this rank's data index, in shard order (None: alone)
    grid_ranks: tuple

    @property
    def data_index(self) -> int:
        return self.rank // self.grid

    @property
    def grid_index(self) -> int:
        return self.rank % self.grid

    def batch_slice(self, n_global: int) -> slice:
        """This rank's rows of a global batch of ``n_global``, which the data
        axis must divide."""
        if n_global % self.data:
            raise ValueError(f"a batch of {n_global} does not divide over {self.data} "
                             "data ranks")
        n = n_global // self.data
        return slice(self.data_index * n, (self.data_index + 1) * n)

    def shard(self, x_global: int) -> GridShard:
        return GridShard(index=self.grid_index, count=self.grid, X=int(x_global),
                         group=self.grid_group, ranks=self.grid_ranks)


def make_mesh(grid_parallel: int = 1) -> Mesh:
    """The layout of the initialised group's ranks: (world / grid_parallel,
    grid_parallel). Every rank must call it (the groups are made
    collectively)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group")
    world, me = dist.get_world_size(), dist.get_rank()
    g = int(grid_parallel)
    if g < 1 or world % g:
        raise ValueError(f"--grid_parallel {g} does not divide the {world} ranks")
    n_data = world // g
    data_groups = [list(range(j, world, g)) for j in range(g)]
    grid_groups = [list(range(d * g, (d + 1) * g)) for d in range(n_data)]

    def group(ranks):
        # new_group is collective: every rank makes every group, in one order
        if len(ranks) == world:
            return dist.group.WORLD  # a world of one rank included
        return None if len(ranks) == 1 else dist.new_group(ranks)

    made_data = [group(r) for r in data_groups]
    made_grid = [group(r) for r in grid_groups]
    return Mesh(data=n_data, grid=g, rank=me, data_group=made_data[me % g],
                grid_group=made_grid[me // g], grid_ranks=tuple(grid_groups[me // g]))


def _shardable(field, g: int) -> bool:
    """The JAX ``shard_params`` rule on the port's ``[B, X, Y, Z, C]``
    grids: cut along X where ``g`` divides it, else leave whole."""
    return (g > 1 and getattr(field, "dense", False) and field.shard is None
            and field.grid.shape[1] % g == 0)


def sharded_names(params) -> list:
    """The names of the fields of ``params`` whose grids are cut."""
    return [n for n in SHARDED_FIELDS if getattr(getattr(params, n, None), "shard", None)]


def x_slab(whole, shard: GridShard | None, axis: int = 1):
    """The shard's planes of a whole tensor or array along ``axis`` (the
    whole where ``shard`` is None): what a cut field holds of a lattice-sized
    tensor, e.g. a per-element lr or a mask over the lattice."""
    if shard is None:
        return whole
    index = [slice(None)] * axis + [slice(shard.index * shard.xs, (shard.index + 1) * shard.xs)]
    return whole[tuple(index)]


@torch.no_grad()
def shard_params(mesh: Mesh, params, optimizer=None) -> list:
    """Cut the density and k0 grids of ``params`` to this rank's x-slab, in
    place (the parameter stays the same object: its ``.data`` is the slab),
    where the grid group's size divides their X. With ``optimizer`` (a
    ``MaskedAdam`` built on ``params``) the moments of those grids are cut
    alike. Returns the names of the fields cut."""
    cut = []
    for name in SHARDED_FIELDS:
        field = getattr(params, name, None)
        if field is None or not _shardable(field, mesh.grid):
            continue
        shard = mesh.shard(field.grid.shape[1])
        p = field.grid
        p.data = x_slab(p.data, shard).contiguous()
        if optimizer is not None:
            for moments in (optimizer.exp_avg, optimizer.exp_avg_sq, optimizer.per_lr):
                if p in moments:
                    moments[p] = x_slab(moments[p], shard).contiguous()
        field.shard = shard
        cut.append(name)
    return cut


def shard_opt_state(params, opt_state: dict | None) -> dict | None:
    """A whole optimizer state (``MaskedAdam.state_dict``'s layout, its
    moments numpy arrays, as a checkpoint loads it) cut as the grids of
    ``params`` are: each cut field's moments to its slab, on the host."""
    if opt_state is None:
        return None
    shards = {n: getattr(params, n).shard for n in sharded_names(params)}
    out = dict(opt_state)
    for key in ("exp_avg", "exp_avg_sq"):
        out[key] = {g: [np.ascontiguousarray(x_slab(m, shards[g])) for m in ms] if g in shards
                    else ms for g, ms in opt_state[key].items()}
    return out


def _gather_x(slab: torch.Tensor, shard: GridShard) -> torch.Tensor:
    """The whole grid from every shard's slab along axis 1, on every rank: a
    boundary's join (a new X that the group does not divide, the JAX rule's
    replicated placement) and :func:`unshard_params`."""
    return halo.all_gather_x(slab, shard, axis=1)


def gather_to_host(slab: torch.Tensor, shard: GridShard) -> torch.Tensor | None:
    """The whole [B, X, ...] tensor in host memory (pinned, from a card) of
    the grid group's first rank, from every rank's x-slab; None on the
    others. The first rank copies its own slab to its host, then receives
    the others' a slab at a time into one slab's buffer on its card and
    copies each on: no card holds more than its own slab and one in flight.
    The other way, each rank's copy to its host and a gather over a gloo
    group of host tensors, took 1.12-1.33 s for a 0.38 GB slab on four
    H100s at 700 W, against 0.022-0.024 s this way once its pinned buffer
    was cached (0.49 s the first time; ``probes/multi_gpu.py``'s
    ``save_transport``). Every rank of the group calls it."""
    slab = slab.detach().contiguous()
    if shard.index:
        dist.send(halo.transportable(slab), dst=shard.ranks[0], group=shard.group)
        return None
    B, xs = slab.shape[:2]
    out = torch.empty((B, xs * shard.count, *slab.shape[2:]), dtype=slab.dtype,
                      pin_memory=slab.is_cuda)
    buf = torch.empty_like(slab)
    for k in range(shard.count):
        if k:
            dist.recv(halo.transportable(buf), src=shard.ranks[k], group=shard.group)
        for b in range(B):  # a bank's planes lie contiguous in ``out``
            out[b, k * xs:(k + 1) * xs].copy_((buf if k else slab)[b])
    return out


@torch.no_grad()
def unshard_params(params, optimizer=None) -> list:
    """The inverse of :func:`shard_params`: every rank gets the whole grids
    (and, with ``optimizer``, their whole moments) back, in place. Returns the
    names of the fields joined."""
    joined = []
    for name in SHARDED_FIELDS:
        field = getattr(params, name, None)
        if field is None or getattr(field, "shard", None) is None:
            continue
        shard, p = field.shard, field.grid
        if optimizer is not None:
            for moments in (optimizer.exp_avg, optimizer.exp_avg_sq, optimizer.per_lr):
                if p in moments:
                    moments[p] = _gather_x(moments[p], shard)
        p.data = _gather_x(p.data, shard)
        field.shard = None
        joined.append(name)
    return joined


def all_reduce_grads(params, mesh: Mesh) -> None:
    """Sum every trainable parameter's ``.grad`` over the data group, in
    place. A parameter without a grad takes part with zeros (every rank must
    make the same calls); a bf16 grad is summed in f32 and rounded once."""
    if mesh.data_group is None:
        return
    for p in params.parameters():
        if not p.requires_grad:
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        g = p.grad
        if g.dtype == torch.bfloat16:
            acc = g.float()
            dist.all_reduce(acc, group=mesh.data_group)
            g.copy_(acc)
        else:
            dist.all_reduce(g, group=mesh.data_group)


def all_reduce_sum(values: dict, group) -> dict:
    """{name: scalar tensor} summed over ``group`` in one collective."""
    names = sorted(values)
    if not names or group is None:
        return dict(values)
    vec = torch.stack([values[k].detach().to(torch.float32).reshape(()) for k in names])
    dist.all_reduce(vec, group=group)
    return dict(zip(names, vec.unbind(0)))


def launch_hint(n_visible: int, module: str, argv) -> str | None:
    """The line a plain launch of ``python -m module`` on a node with several
    visible GPUs prints: the ``torchrun`` command that would use them all
    (None for one GPU or inside a process group)."""
    if n_visible <= 1 or dist.is_initialized():
        return None
    return (f"{n_visible} GPUs are visible and this run uses one; to use them all: "
            f"torchrun --standalone --nproc_per_node {n_visible} -m {module} "
            f"{' '.join(argv)}")
