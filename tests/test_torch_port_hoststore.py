"""The host ray store (``load2gpu_on_the_fly``) and the sliced Adam update.

The port's ``HostRayStoreSampler`` keeps the flattened rays in host memory
as numpy and draws its epoch permutations from ``np.random.default_rng``:
its batches are the JAX ``HostRayStoreSampler``'s for the same seed, to the
bit, through an epoch's end, and so is ``fast_forward``. A trainer run on
the store, cut at step 2 and resumed, equals the uninterrupted run to the
bit (CPU, ``rand_bkgd`` on, a ``pg_scale`` boundary in the resumed part).

``MaskedAdam`` updates a parameter in slices of ``CHUNK`` elements; the
arithmetic of an element does not depend on the slice, so any slicing gives
the update of the whole tensor at once (the formula written out below) to
the bit, on f32 and bf16 grids, with and without ``skip_zero_grad``.
"""

import dataclasses
import math
import pathlib

import numpy as np
import pytest
import torch

from unboundednerfpytorch_tpu.train import step as jstep
from unboundednerfpytorch_tpu_torch.configs import loader
from unboundednerfpytorch_tpu_torch.data import synthetic
from unboundednerfpytorch_tpu_torch.optim.masked_adam import MaskedAdam, ParamGroup
from unboundednerfpytorch_tpu_torch.train import loop
from unboundednerfpytorch_tpu_torch.train import step as tstep
from torch_threads import torch_threads  # noqa: F401: the workers' share of the cores

ROOT = pathlib.Path(__file__).resolve().parents[1]
COLUMNS = ("rgb", "rays_o", "rays_d", "viewdirs")


def _store(n=203, seed=0):
    rng = np.random.default_rng(seed)
    out = {k: rng.standard_normal((n, 3)).astype(np.float32) for k in COLUMNS}
    out["img_index"] = np.repeat(np.arange(7, dtype=np.int32), 29)
    return out


@pytest.mark.parametrize("n_rand", [16, 50, 203])
def test_host_sampler_draws_the_jax_samplers_batches(n_rand):
    store = _store()
    want = jstep.HostRayStoreSampler(store, n_rand, seed=5)
    got = tstep.HostRayStoreSampler(store, n_rand, 5, torch.device("cpu"))
    for _ in range(11):  # 203 rays: several epochs' ends
        w = want.next_batch()
        g, bg = got.next_batch()
        assert bg is None
        for k in COLUMNS:
            assert g[k].dtype == torch.float32 and g[k].shape == (n_rand, 3)
            np.testing.assert_array_equal(g[k].numpy(), w[k], err_msg=k)
    # replaying n draws stands where n draws stand, in both packages
    want, got = jstep.HostRayStoreSampler(store, n_rand, seed=5), tstep.HostRayStoreSampler(
        store, n_rand, 5, torch.device("cpu"))
    want.fast_forward(6)
    got.fast_forward(6)
    for _ in range(3):
        np.testing.assert_array_equal(got.next_batch()[0]["rays_d"].numpy(),
                                      want.next_batch()["rays_d"])


def test_host_sampler_backgrounds_replay_with_the_batches():
    """With a generator (``rand_bkgd``) the backgrounds come from it, one
    draw a batch, and ``fast_forward`` replays them with the indices."""
    gen = lambda: torch.Generator().manual_seed(9)
    a = tstep.HostRayStoreSampler(_store(), 32, 1, torch.device("cpu"), bg_generator=gen())
    draws = [a.next_batch() for _ in range(9)]
    b = tstep.HostRayStoreSampler(_store(), 32, 1, torch.device("cpu"), bg_generator=gen())
    b.fast_forward(5)
    for batch, bg in draws[5:]:
        batch2, bg2 = b.next_batch()
        assert torch.equal(bg, bg2) and bg.shape == (32, 3)
        assert all(torch.equal(batch[k], batch2[k]) for k in COLUMNS)


def test_host_store_holds_the_device_stores_rays():
    """``gather_training_rays(host=True)`` is the device store as numpy."""
    cfg = _config(3)
    data = synthetic.orbit_scene(3, 12, 16, seed=2)
    host = loop.gather_training_rays(cfg, data, "cpu", host=True)
    dev = loop.gather_training_rays(cfg, data, "cpu")
    for k in (*COLUMNS, "img_index"):
        assert isinstance(host[k], np.ndarray)
        np.testing.assert_array_equal(host[k], dev[k].numpy(), err_msg=k)


def _config(n_iters):
    """bicycle_single on the host store, cut to 24^3 voxels, a 16-sample
    budget and a boundary at step 3 (``rand_bkgd`` on, as the config has
    it)."""
    cfg = loader.load_config(str(ROOT / "configs" / "nerf_unbounded" / "bicycle_single.py"))
    vox = 24**3
    fm = dataclasses.replace(cfg.fine_model_and_render, num_voxels_density=vox,
                             num_voxels_rgb=vox, num_voxels_base_density=vox,
                             num_voxels_base_rgb=vox, sample_budget=16, color_budget=6)
    ft = dataclasses.replace(cfg.fine_train, pg_scale=(3,), N_iters=n_iters, N_rand=128)
    data = dataclasses.replace(cfg.data, load2gpu_on_the_fly=True)
    assert data.rand_bkgd
    return dataclasses.replace(cfg, data=data, fine_model_and_render=fm, fine_train=ft)


def _train(exp_dir, n_iters):
    seen = []
    out = loop.run_train(_config(n_iters), synthetic.orbit_scene(4, 12, 16, seed=0), seed=0,
                         device="cpu", log_fn=lambda _: None, log_every=1, exp_dir=str(exp_dir),
                         callback=lambda s, m: seen.append((s, float(m["loss"]))))
    return out, seen


def test_host_store_run_resumed_is_bit_equal_to_the_uninterrupted_one(tmp_path):
    whole, whole_seen = _train(tmp_path / "whole", 4)
    _, first = _train(tmp_path / "cut", 2)
    rest, rest_seen = _train(tmp_path / "cut", 4)
    assert [s for s, _ in first + rest_seen] == [1, 2, 3, 4]
    assert first + rest_seen == whole_seen
    (_, cfg_a, pa, _), (_, cfg_b, pb, _) = whole, rest
    assert cfg_a == cfg_b and pa.act_shift == pb.act_shift
    for (na, ta), (nb, tb) in zip(sorted(pa.state_dict().items()), sorted(pb.state_dict().items())):
        assert na == nb and torch.equal(ta, tb), na


def _unsliced(p, m, v, grad, step_size, skip, b1=0.9, b2=0.99, eps=1e-8):
    """The update of a whole tensor at once (new p, m, v)."""
    grad = torch.zeros_like(m) if grad is None else grad.to(m.dtype)
    m1 = m * b1 + grad * (1.0 - b1)
    v1 = v * b2 + grad * (1.0 - b2) * grad
    upd = (p.to(m.dtype) - step_size * m1 / (torch.sqrt(v1) + eps)).to(p.dtype)
    if not skip:
        return upd, m1, v1
    keep = grad != 0
    return torch.where(keep, upd, p), torch.where(keep, m1, m), torch.where(keep, v1, v)


@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [1 << 26, 1000, 7])
def test_sliced_adam_is_bit_equal_to_the_whole_update(monkeypatch, dtype, skip, chunk):
    monkeypatch.setattr(MaskedAdam, "CHUNK", chunk)
    gen = torch.Generator().manual_seed(0)
    grid = torch.nn.Parameter((torch.randn((1, 9, 8, 7, 3), generator=gen)).to(dtype))
    other = torch.nn.Parameter(torch.randn((5, 4), generator=gen))  # no grad: zero
    opt = MaskedAdam([ParamGroup("k0", [grid], 0.1, skip), ParamGroup("mlp", [other], 1e-3, False)])
    p, q = grid.detach().clone(), other.detach().clone()
    m = {k: torch.zeros(x.shape, dtype=torch.float32) for k, x in (("p", p), ("q", q))}
    v = {k: torch.zeros(x.shape, dtype=torch.float32) for k, x in (("p", p), ("q", q))}
    for t in range(1, 4):
        g = torch.randn(grid.shape, generator=gen).to(dtype)
        g[:, ::2] = 0  # untouched voxels
        grid.grad = g.clone()
        opt.step(lr_scale=0.5)
        corr = math.sqrt(1.0 - 0.99**t) / (1.0 - 0.9**t)
        p, m["p"], v["p"] = _unsliced(p, m["p"], v["p"], g, 0.1 * 0.5 * corr, skip)
        q, m["q"], v["q"] = _unsliced(q, m["q"], v["q"], None, 1e-3 * 0.5 * corr, False)
        assert grid.dtype == dtype and torch.equal(grid.detach(), p)
        assert torch.equal(other.detach(), q)
        assert torch.equal(opt.exp_avg[grid], m["p"]) and torch.equal(opt.exp_avg_sq[grid], v["p"])
