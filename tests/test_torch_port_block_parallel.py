"""``--block_parallel`` and Block-NeRF's data parallelism, on gloo ranks of
the CPU.

One spawn of two gloo ranks (``parallel/spawn.py``) runs:

* ``train.block_parallel.run_train_blocks_parallel`` on a FourierGrid
  recipe (``nerf_unbounded/bicycle_single.py`` cut to 12^3 voxels and two
  steps) over four views cut into two blocks: block b on rank b, the shared
  box of all the views, rank 0 merging;
* two Block-NeRF steps (D 6, W 32, as ``test_torch_port_block_nerf.py``)
  data-parallel over the two ranks, each on its half of the global batch.

Held against, in this process with one thread (as each rank has): the
port's sequential ``train.loop.run_train_blocks`` in the same shared box,
every block's checkpoint and the merge equal to the bit (no collective runs
while the blocks train, so the arithmetic is the same); the single-device
Block-NeRF steps on the global batch (1e-5 relative / 1e-6 absolute: the
gradient sums run in another order), both replicas equal to the bit.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from unboundednerfpytorch_tpu_torch.configs import loader
from unboundednerfpytorch_tpu_torch.data import synthetic
from unboundednerfpytorch_tpu_torch.models.block_nerf import training
from unboundednerfpytorch_tpu_torch.models.block_nerf.model import BlockNeRF
from unboundednerfpytorch_tpu_torch.parallel import blocks, spawn
from unboundednerfpytorch_tpu_torch.parallel import mesh as mesh_mod
from unboundednerfpytorch_tpu_torch.train import block_parallel, loop
from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt

ROOT = pathlib.Path(__file__).resolve().parents[1]
DIMS = dict(D=6, W=32, vis_width=16, appearance_dim=8)
RENDER = dict(n_samples=8, n_importance=16)
BATCH = 16


def _cfg():
    cfg = loader.load_config(str(ROOT / "configs" / "nerf_unbounded" / "bicycle_single.py"))
    vox = 12**3
    fm = dataclasses.replace(cfg.fine_model_and_render, num_voxels_density=vox,
                             num_voxels_rgb=vox, num_voxels_base_density=vox,
                             num_voxels_base_rgb=vox, sample_budget=16)
    ft = dataclasses.replace(cfg.fine_train, pg_scale=(), N_iters=2, N_rand=64)
    return dataclasses.replace(cfg, fine_model_and_render=fm, fine_train=ft)


def _ray_store():
    rng = np.random.default_rng(2)
    n = 64
    d = rng.standard_normal((n, 3))
    rays = np.concatenate([rng.standard_normal((n, 3)) * 0.2,
                           d / np.linalg.norm(d, axis=-1, keepdims=True),
                           np.full((n, 1), 0.01), np.full((n, 1), 0.5),
                           np.full((n, 1), 0.1), np.full((n, 1), 3.0)], axis=1)
    return {"rays": rays.astype(np.float32),
            "rgbs": rng.random((n, 3)).astype(np.float32),
            "ts": rng.integers(0, 4, n).astype(np.int64)}


def _block_nerf(store, mesh=None):
    """Two steps from the seeded model; its parameters after them."""
    model = BlockNeRF(n_appearance=4, generator=torch.Generator().manual_seed(0), **DIMS)
    training.train_block(model, {k: torch.from_numpy(v) for k, v in store.items()}, 2,
                         batch_size=BATCH, generator=torch.Generator().manual_seed(1),
                         log_fn=lambda *_: None, mesh=mesh, **RENDER)
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _ranks(rank, world, cfg, data, work, store):
    paths = block_parallel.run_train_blocks_parallel(cfg, data, 2, f"{work}/parallel",
                                                     device="cpu", log_fn=lambda *_: None)
    return {"paths": paths, "block_nerf": _block_nerf(store, mesh_mod.make_mesh())}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("block_parallel")
    cfg, data, store = _cfg(), synthetic.orbit_scene(4, 16, 24, seed=1), _ray_store()
    res = spawn.run(_ranks, 2, str(work / "store"), cfg, data, str(work), store)
    return dict(work=work, cfg=cfg, data=data, store=store, res=res)


def _load(path):
    _, _, params, step, _ = ckpt.load_model(str(path), device="cpu")
    return {k: v.detach().float().numpy() for k, v in params.state_dict().items()}, step


def test_block_parallel_equals_sequential_blocks(run):
    work, res = run["work"], run["res"]
    assert blocks.assign_blocks(5, 2) == [[0, 2, 4], [1, 3]]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        box = block_parallel.shared_bbox(run["cfg"], run["data"], device="cpu")
        seq = loop.run_train_blocks(run["cfg"], run["data"], 2, str(work / "sequential"),
                                    device="cpu", log_fn=lambda *_: None, bbox=box)
    finally:
        torch.set_num_threads(threads)
    assert res[0]["paths"] == res[1]["paths"] == [str(work / "parallel" / f"fine_last_{b}")
                                                   for b in range(2)]
    assert [pathlib.Path(p).name for p in seq] == ["fine_last_0", "fine_last_1"]
    for name in ("fine_last_0", "fine_last_1", "fine_last_merged"):
        got, got_step = _load(work / "parallel" / name)
        want, want_step = _load(work / "sequential" / name)
        assert got_step == want_step
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {k}")
    # the blocks trained apart: they differ, and each in the shared box
    a, _ = _load(work / "parallel" / "fine_last_0")
    b, _ = _load(work / "parallel" / "fine_last_1")
    assert not np.array_equal(a["k0.grid"], b["k0.grid"])


def test_block_nerf_data_parallel_step_matches_one_device(run):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = _block_nerf(run["store"])
    finally:
        torch.set_num_threads(threads)
    res = run["res"]
    for k, v in want.items():
        np.testing.assert_allclose(res[0]["block_nerf"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(res[1]["block_nerf"][k], res[0]["block_nerf"][k])
    before = BlockNeRF(n_appearance=4, generator=torch.Generator().manual_seed(0), **DIMS)
    moved = max(float(np.abs(want[k] - v.detach().numpy()).max())
                for k, v in before.state_dict().items())
    assert moved > 1e-4  # the steps moved the parameters
