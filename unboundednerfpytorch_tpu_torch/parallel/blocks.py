"""Which rank trains which block.

Counterpart of ``unboundednerfpytorch_tpu/parallel/blocks.py``: blocks never
communicate while they train, so ``--block_parallel`` gives them to the
ranks round robin, block ``b`` to rank ``b % world``, and each rank trains
its own in turn (``train/block_parallel.py``).
"""

from __future__ import annotations


def assign_blocks(n_blocks: int, world: int) -> list:
    """[the blocks of rank r for r in range(world)], round robin."""
    return [list(range(r, n_blocks, world)) for r in range(world)]


def my_blocks(n_blocks: int, rank: int, world: int) -> list:
    """The blocks rank ``rank`` of ``world`` trains."""
    return assign_blocks(n_blocks, world)[rank]


def my_block_for_host(n_blocks: int, rank: int) -> int:
    """One block a process (the JAX ``my_block_for_host``): rank ``rank``
    takes block ``rank mod n_blocks``."""
    return rank % n_blocks
