"""Concurrent block training: ``--block_parallel``.

Counterpart of ``unboundednerfpytorch_tpu/train/block_parallel.py``. Blocks
never communicate while they train, so the ranks of the process group take
them round robin (``parallel/blocks.py``: block ``b`` on rank ``b % world``),
each training its own in turn through the recipe of
:func:`..loop.run_train_blocks` with no collective; rank 0 merges them once
every rank is done. As in the JAX package, every block trains in one shared
world box, computed from all the training views (the precondition of the
elementwise-minimum merge), and each block's ``fine_last_<b>`` is what the
block render and ``merge_blocks`` take. Out of a process group (or with one
rank) the blocks train in turn on this process: the run is the sequential
``run_train_blocks`` with the shared box, which the tests hold it equal to.
"""

from __future__ import annotations

from unboundednerfpytorch_tpu_torch.device import resolve_device
from unboundednerfpytorch_tpu_torch.train import bbox as bbox_mod
from unboundednerfpytorch_tpu_torch.train import loop


def shared_bbox(cfg, data_dict: dict, device=None):
    """(xyz_min, xyz_max) of the camera-frustum box of all training views."""
    return bbox_mod.compute_bbox_by_cam_frustrm(cfg, data_dict, loop.model_family_name(cfg),
                                                device=resolve_device(device))


def run_train_blocks_parallel(cfg, data_dict: dict, block_num: int, exp_dir: str,
                              seed: int = 777, log_fn=print, merge: bool = True,
                              no_reload: bool = False, save_every: int = 0, device=None,
                              log_every: int = 500) -> list:
    """Train the blocks concurrently over the ranks; returns every block's
    ``fine_last_<b>`` path (on every rank)."""
    xyz_min, xyz_max = shared_bbox(cfg, data_dict, device)
    return loop.run_train_blocks(cfg, data_dict, block_num, exp_dir, seed=seed, log_fn=log_fn,
                                 merge=merge, no_reload=no_reload, save_every=save_every,
                                 device=device, log_every=log_every, bbox=(xyz_min, xyz_max),
                                 parallel=True)
