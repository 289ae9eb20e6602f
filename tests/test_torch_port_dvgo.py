"""The port's DVGO family, its coarse stage and the per-element-lr Adam
against the JAX package on the CPU.

Small configs: a box of about 24^3 voxels (24 x 25 x 23 nodes, 86 samples a
ray), k0 12 channels and an rgb MLP of width 32 and depth 2 (or k0 alone),
random grids. JAX parameters are drawn, carried into the port by
``convert``, and the same numpy rays go through both packages.

Tolerances: bounded marching's points and ``t`` to 1e-6 and its masks
equal; the forward's ``rgb_marched``, weights and transmittance to 1e-5
absolute (the raw density, a sum of eight products of values up to +-16,
to 1e-4), gradients of every parameter to 1e-4 of the largest, plus, for the
density grid, the 2e-3 relative that ``test_torch_port_kernels.py`` allows
where alpha is near 1 (autograd through the cumulative product against
XLA's); ``hit_coarse_geo`` equal; ``compute_bbox_by_coarse_geo`` to 1e-6;
masks of thresholds equal except nodes whose value lies within 1e-6
relative of the threshold, which are counted and bounded; the voxel counts
of ``voxel_count_views`` equal except voxels where a view's weight sum lies
within 1e-4 of 1 (summed in another order), counted and bounded; the plain
``masked_adam`` with ``per_lr`` against JAX ``update``: f32 exact (p, m and
v bit-equal) given JAX's own f32 step size; through ``MaskedAdam``, whose
step size is a double rounded once where JAX rounds its f32 factors, the
moments bit-equal and p within 1e-5 relative / 1e-6 absolute; one coarse
step with ``per_lr`` and one fine step on the ``in_maskcache`` store as the
families' steps (2e-5 absolute, 1e-4 relative), but for at most 0.1% of a
grid's elements whose gradient is 0 on one side only or under Adam's eps,
each within one step. The kernel with ``per_lr`` against its plain version,
bit for bit, is marked ``cuda`` and skips without a card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unboundednerfpytorch_tpu.configs.schema import ExpConfig as JExpConfig
from unboundednerfpytorch_tpu.configs.schema import ModelRenderConfig as JModelRenderConfig
from unboundednerfpytorch_tpu.configs.schema import TrainStageConfig as JTrainStageConfig
from unboundednerfpytorch_tpu.models import dvgo as jdvgo
from unboundednerfpytorch_tpu.ops import interp as jinterp
from unboundednerfpytorch_tpu.ops import sampling as jsampling
from unboundednerfpytorch_tpu.optim import factory as jfactory
from unboundednerfpytorch_tpu.optim import masked_adam as j_adam
from unboundednerfpytorch_tpu.train import bbox as jbbox
from unboundednerfpytorch_tpu.train import loop as jloop
from unboundednerfpytorch_tpu.train import step as jstep
from unboundednerfpytorch_tpu_torch import convert
from unboundednerfpytorch_tpu_torch.configs.schema import (
    ExpConfig, ModelRenderConfig, TrainStageConfig,
)
from unboundednerfpytorch_tpu_torch.fields.grids import _norm01
from unboundednerfpytorch_tpu_torch.models import dvgo
from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
from unboundednerfpytorch_tpu_torch.ops import interp, sampling
from unboundednerfpytorch_tpu_torch.ops.cuda import adam, build
from unboundednerfpytorch_tpu_torch.optim import factory
from unboundednerfpytorch_tpu_torch.optim.masked_adam import MaskedAdam, ParamGroup, make_per_lr
from unboundednerfpytorch_tpu_torch.train import bbox, loop
from unboundednerfpytorch_tpu_torch.train import step as tstep
from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt

XYZ_MIN, XYZ_MAX = (-1.0, -1.2, -0.8), (1.1, 1.0, 1.2)
NEAR, STEPSIZE = 0.2, 0.5
MODEL_KW = dict(num_voxels_density=24**3, num_voxels_rgb=24**3, num_voxels_base_density=24**3,
                num_voxels_base_rgb=24**3, rgbnet_dim=12, rgbnet_width=32, rgbnet_depth=2,
                alpha_init=1e-2, fast_color_thres=1e-4, maskout_near_cam_vox=False)
TRAIN_KW = dict(N_rand=48, lrate_density=0.1, lrate_k0=0.1, lrate_rgbnet=1e-3, lrate_decay=20,
                weight_main=1.0, weight_entropy_last=0.01, weight_rgbper=0.1, pg_scale=())
# the forward's variants: the MLP on k0 (direct), the MLP on k0 past its
# first three channels (added as the diffuse part), the MLP on the view
# embedding alone, k0's colour without an MLP, and no fast_color_thres
MODES = {"mlp_direct": {}, "mlp_diffuse": dict(rgbnet_direct=False),
         "mlp_full_implicit": dict(rgbnet_full_implicit=True), "k0_only": dict(rgbnet_dim=0),
         "no_thres": dict(fast_color_thres=0.0)}


def make_pair(seed=0, offset=0.0, **overrides):
    """(JAX config, JAX params, port config, port params): the JAX config from
    the JAX ``build_model`` (a DVGO config: no dataset type), the port's from
    its own; density N(offset, 4^2), k0 N(0, 0.5^2)."""
    kw = {**MODEL_KW, **overrides}
    key = jax.random.PRNGKey(seed)
    fam, jcfg, jp = jloop.build_model(JExpConfig(), JModelRenderConfig(**kw),
                                      JTrainStageConfig(pg_scale=()), np.array(XYZ_MIN),
                                      np.array(XYZ_MAX), key)
    assert fam == "dvgo"
    tcfg = dvgo.config_from(ModelRenderConfig(**kw), XYZ_MIN, XYZ_MAX, kw["num_voxels_rgb"])
    rng = np.random.default_rng(seed)
    dgrid = rng.standard_normal(jp.density.grid.shape) * 4.0 + offset
    kgrid = rng.standard_normal(jp.k0.grid.shape) * 0.5
    jp = jp.replace(density=jp.density.replace(grid=jnp.asarray(dgrid, jnp.float32)),
                    k0=jp.k0.replace(grid=jnp.asarray(kgrid, jnp.float32)))
    tp = convert.params_from_numpy("dvgo", convert.tree_from_params_object(jp), "cpu")
    return jcfg, jp, tcfg, tp


def make_rays(n=48, seed=1, spread=2.5):
    """Rays from around and inside the box, looking roughly at its centre,
    their directions of random length (the marching steps along the unit
    direction)."""
    rng = np.random.default_rng(seed)
    center = (np.asarray(XYZ_MIN) + np.asarray(XYZ_MAX)) / 2
    o = center + rng.standard_normal((n, 3)) * spread
    d = (center + rng.standard_normal((n, 3)) * 0.4 - o) * rng.uniform(0.3, 3.0, (n, 1))
    d[::7, 1] = 0.0  # a zero component: the slab test's 1e-6 guard
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return [a.astype(np.float32) for a in (o, d, vd)]


def t_(a):
    return torch.from_numpy(np.asarray(a))


def test_configs_and_params_match_jax():
    jcfg, jp, tcfg, tp = make_pair()
    assert convert.config_to_dict(tcfg) == dataclasses.asdict(jcfg)
    for name in ("world_size", "voxel_size", "voxel_size_ratio", "act_shift", "k0_dim",
                 "rgbnet_in_dim"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert dvgo.n_samples(tcfg, STEPSIZE) == jdvgo.n_samples(jcfg, STEPSIZE) == 86
    assert tp.act_shift == pytest.approx(float(jp.act_shift))
    assert tp.k0.grid.shape == (1, *jp.k0.grid.shape)
    fresh = dvgo.create(tcfg, torch.Generator().manual_seed(0))
    assert [lin.weight.shape[::-1] for lin in fresh.rgbnet.layers] == [
        w.shape for w in jp.rgbnet.weights]
    # TensoRF fields are ported: their own test file holds them against JAX
    tf = dvgo.create(dataclasses.replace(tcfg, density_type="TensoRFGrid",
                                         density_config=(("n_comp", 2),)))
    assert tf.density.world_size == tcfg.world_size and tf.density.f_vec is None


def test_bounded_marching_matches_jax():
    o, d, _ = make_rays(64, seed=2)
    lo, hi = np.asarray(XYZ_MIN, np.float32), np.asarray(XYZ_MAX, np.float32)
    want = jsampling.ray_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo),
                              jnp.asarray(hi), NEAR)
    got = sampling.ray_aabb(t_(o), t_(d), XYZ_MIN, XYZ_MAX, NEAR)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    ws = (21, 21, 20)
    assert sampling.n_samples_cap(ws, STEPSIZE) == jsampling.n_samples_cap(ws, STEPSIZE)
    want = jsampling.sample_pts_on_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo),
                                        jnp.asarray(hi), NEAR, 0.05, 80)
    pts, mask, t = sampling.sample_pts_on_rays(t_(o), t_(d), XYZ_MIN, XYZ_MAX, NEAR, 0.05, 80)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want.mask))
    assert 0 < int(mask.sum()) < mask.numel()
    for g, w in ((pts, want.pts), (t, want.t)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def jforward(jp, jcfg, o, d, vd, bg=1.0):
    return jdvgo.forward(jp, jcfg, jnp.asarray(o), jnp.asarray(d), jnp.asarray(vd), near=NEAR,
                         stepsize=STEPSIZE, bg=bg)


def tforward(tp, tcfg, o, d, vd, bg=1.0, cache=None):
    return dvgo.forward(tp, tcfg, t_(o), t_(d), t_(vd), near=NEAR, stepsize=STEPSIZE, bg=bg,
                        cache=cache)


@pytest.mark.parametrize("mode", list(MODES))
def test_forward_matches_jax(mode):
    jcfg, jp, tcfg, tp = make_pair(seed=3, **MODES[mode])
    o, d, vd = make_rays(seed=4)
    want = jforward(jp, jcfg, o, d, vd)
    got = tforward(tp, tcfg, o, d, vd)
    assert got.n_max == want.n_max == 86
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert 0 < int(got.mask.sum()) < got.mask.numel()
    for field in ("rgb_marched", "alphainv_last", "weights", "raw_alpha", "raw_rgb"):
        np.testing.assert_allclose(getattr(got, field).detach().numpy(),
                                   np.asarray(getattr(want, field)), rtol=0, atol=1e-5,
                                   err_msg=field)
    for field in ("t", "s", "depth"):
        np.testing.assert_allclose(getattr(got, field).detach().numpy(),
                                   np.asarray(getattr(want, field)), rtol=1e-5, atol=2e-5,
                                   err_msg=field)
    # the raw density is a sum of eight products of values up to +-16
    np.testing.assert_allclose(got.raw_density.detach().numpy(), np.asarray(want.raw_density),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["mlp_direct", "k0_only"])
def test_gradients_match_jax(mode):
    """d(loss)/d(every parameter) through the whole forward, with cotangents
    on every output the train step's losses read."""
    jcfg, jp, tcfg, tp = make_pair(seed=5, **MODES[mode])
    o, d, vd = make_rays(seed=6)
    rng = np.random.default_rng(7)
    N, S = o.shape[0], dvgo.n_samples(tcfg, STEPSIZE)
    c_rgb = rng.standard_normal((N, 3)).astype(np.float32)
    c_ai = rng.standard_normal(N).astype(np.float32)
    c_w = rng.standard_normal((N, S)).astype(np.float32)
    c_raw = rng.standard_normal((N, S, 3)).astype(np.float32)

    def loss_of(r, sum_, c):
        return (sum_(r.rgb_marched * c(c_rgb)) + sum_(r.alphainv_last * c(c_ai))
                + sum_(r.weights * c(c_w)) + sum_(r.raw_rgb * c(c_raw)))

    def j_loss(dgrid, kgrid, mlp):
        p = jp.replace(density=jp.density.replace(grid=dgrid), k0=jp.k0.replace(grid=kgrid),
                       rgbnet=mlp)
        return loss_of(jforward(p, jcfg, o, d, vd, bg=0.5), jnp.sum, jnp.asarray)

    gd, gk, gm = jax.grad(j_loss, argnums=(0, 1, 2))(jp.density.grid, jp.k0.grid, jp.rgbnet)
    loss_of(tforward(tp, tcfg, o, d, vd, bg=0.5), torch.sum, t_).backward()
    pairs = [(tp.density.grid.grad[0], gd, 2e-3), (tp.k0.grid.grad[0], gk, 0.0)]
    if tp.rgbnet is not None:
        pairs += [(lin.weight.grad.T, w, 0.0) for lin, w in zip(tp.rgbnet.layers, gm.weights)]
        pairs += [(lin.bias.grad, b, 0.0) for lin, b in zip(tp.rgbnet.layers, gm.biases)]
    for got, w, rel in pairs:
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        err = np.abs(got.numpy() - w)
        assert (err <= 1e-4 * np.abs(w).max() + rel * np.abs(w)).all(), float(err.max())


def test_cached_forward_equals_the_grids():
    _, _, tcfg, tp = make_pair(seed=8)
    o, d, vd = make_rays(seed=9)
    cache = dvgo.build_render_cache(tp, tcfg)
    assert cache is not None
    with torch.no_grad():
        a = tforward(tp, tcfg, o, d, vd, cache=cache)
        b = tforward(tp, tcfg, o, d, vd)
    for field in ("rgb_marched", "weights", "depth"):
        torch.testing.assert_close(getattr(a, field), getattr(b, field), rtol=1e-5, atol=1e-6)
    full = dataclasses.replace(tcfg, rgbnet_full_implicit=True)
    assert dvgo.build_render_cache(tp, full) is None


def random_mask(shape, seed, share=0.15):
    return np.random.default_rng(seed).random(shape) < share


def test_hit_coarse_geo_matches_jax():
    jcfg, jp, tcfg, tp = make_pair(seed=10)
    mask = random_mask(jp.mask_cache.mask.shape, 11)
    jp = jp.replace(mask_cache=jp.mask_cache.replace(mask=jnp.asarray(mask)))
    tp.mask_cache.mask = t_(mask)
    o, d, _ = make_rays(200, seed=12)
    want = jdvgo.hit_coarse_geo(jp, jcfg, jnp.asarray(o), jnp.asarray(d), NEAR, STEPSIZE)
    got = dvgo.hit_coarse_geo(tp, tcfg, t_(o), t_(d), NEAR, STEPSIZE)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < got.numel()


def _count_near_one(tcfg, o, d):
    """Per view, the weight sum of every voxel in float64 (the same points
    and weights, summed exactly enough to tell which sums lie near 1)."""
    ws = tcfg.world_size
    S = dvgo.n_samples(tcfg, STEPSIZE)
    sums = []
    for ro, rd in zip(o, d):
        ro, rd = t_(ro).double(), t_(rd).double()
        t_min, _ = sampling.ray_aabb(ro, rd, XYZ_MIN, XYZ_MAX, NEAR)
        step = torch.arange(S, dtype=torch.float64) * (STEPSIZE * tcfg.voxel_size)
        x = t_min[:, None] + step[None, :] / torch.linalg.norm(rd, dim=-1)[:, None]
        pts = ro[:, None, :] + rd[:, None, :] * x[..., None]
        idx, w = interp.trilerp_corners(_norm01(pts, XYZ_MIN, XYZ_MAX), ws)
        acc = torch.zeros(int(np.prod(ws)), dtype=torch.float64)
        acc.index_add_(0, idx.reshape(-1), w.reshape(-1))
        sums.append(acc.view(ws).numpy())
    return np.stack(sums)


def test_voxel_count_views_matches_jax():
    jcfg, jp, tcfg, tp = make_pair(seed=13)
    rays = [make_rays(300, seed=20 + v, spread=1.5)[:2] for v in range(4)]
    o = np.stack([r[0] for r in rays])
    d = np.stack([r[1] for r in rays])
    want = np.asarray(jdvgo.voxel_count_views(jp, jcfg, jnp.asarray(o), jnp.asarray(d), NEAR,
                                              STEPSIZE))
    got = dvgo.voxel_count_views(tp, tcfg, o, d, NEAR, STEPSIZE).numpy()
    assert got.shape == want.shape == (*tcfg.world_size, 1)
    near_one = (np.abs(_count_near_one(tcfg, o, d) - 1.0) < 1e-4).sum(0)[..., None]
    flips = np.abs(got - want)
    assert (flips <= near_one).all()
    assert flips.sum() <= max(2, 1e-3 * want.size)
    assert want.max() == len(o) and 0 < (want > 2).mean() < 1
    # torch tensors of the store, on the device, give the same counts
    got_t = dvgo.voxel_count_views(tp, tcfg, t_(o), t_(d), NEAR, STEPSIZE).numpy()
    np.testing.assert_array_equal(got_t, got)


def test_voxel_count_views_in_chunks_equals_one_chunk(monkeypatch):
    _, _, tcfg, tp = make_pair(seed=14)
    o, d = make_rays(257, seed=15, spread=1.5)[:2]
    whole = dvgo.voxel_count_views(tp, tcfg, o[None], d[None], NEAR, STEPSIZE)
    monkeypatch.setattr(dvgo, "_chunk_rays", lambda s: 10)
    parts = dvgo.voxel_count_views(tp, tcfg, o[None], d[None], NEAR, STEPSIZE)
    assert whole.sum() > 0
    # each chunk's index_add_ sums in its own order: the counts of sums
    # within rounding of 1 may differ
    assert float((whole != parts).float().sum()) <= 2


def _flips(got, want, value, thres, rtol=1e-6):
    """Where two threshold masks differ, the value must lie within ``rtol``
    of the threshold; returns the count of such nodes."""
    diff = np.asarray(got) != np.asarray(want)
    assert (np.abs(np.asarray(value)[diff] - thres) <= rtol * max(abs(thres), 1e-30)).all()
    return int(diff.sum())


@pytest.mark.parametrize("thres", [1e-3, 2.0])
def test_compute_bbox_by_coarse_geo_matches_jax(thres):
    """A ball of density inside the box, with a threshold that part of the
    lattice passes, and one that none does (the box of every node)."""
    jcfg, jp, tcfg, tp = make_pair(seed=16)
    ws = jcfg.world_size
    ijk = np.stack(np.meshgrid(*[np.arange(n) for n in ws], indexing="ij"), -1)
    r2 = (((ijk - np.array([9.0, 13.0, 8.0])) / np.array(ws)) ** 2).sum(-1)
    dgrid = (20.0 - 200.0 * r2)[..., None].astype(np.float32)
    jp = jp.replace(density=jp.density.replace(grid=jnp.asarray(dgrid)))
    tp = convert.params_from_numpy("dvgo", convert.tree_from_params_object(jp), "cpu")
    jact = lambda dd: jdvgo.activate_density(jp, jcfg, dd)
    want = jbbox.compute_bbox_by_coarse_geo(jp, jcfg, jact, thres)
    got = bbox.compute_bbox_by_coarse_geo(
        tp, tcfg, lambda dd: dvgo.activate_density(tp, tcfg, dd), thres)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    width = np.asarray(want[1], np.float64) - np.asarray(want[0], np.float64)
    inner = width < np.asarray(XYZ_MAX) - np.asarray(XYZ_MIN) - 1e-5
    assert inner.any() == (thres < 1)


def jax_coarse_mask(jp, jcfg, ws, lo, hi, thres):
    """The JAX ``run_train``'s ``coarse_mask_fn``, as it is written there."""
    axes = [jnp.linspace(mn, mx, int(n)) for mn, mx, n in zip(lo, hi, ws)]
    xyz = jnp.stack(jnp.meshgrid(*axes, indexing="ij"), -1)
    alpha = jdvgo.activate_density(jp, jcfg, jp.density(xyz)[..., 0])
    pooled = jinterp.max_pool_3d_same(alpha)
    return np.asarray(pooled >= thres), np.asarray(pooled)


def test_coarse_mask_fn_matches_jax():
    jcfg, jp, tcfg, tp = make_pair(seed=17, offset=-4.0)
    ws, lo, hi = (26, 23, 19), (-0.7, -0.9, -0.5), (0.9, 0.8, 1.0)
    thres = 0.05
    want, pooled = jax_coarse_mask(jp, jcfg, ws, lo, hi, thres)
    got = dvgo.coarse_mask_fn(tp.density, tp.act_shift, tcfg, thres)(ws, lo, hi).numpy()
    assert got.shape == ws and 0 < want.mean() < 1
    assert _flips(got, want, pooled, thres) <= 2


def test_maskout_near_cam_vox_matches_jax():
    jcfg, jp, tcfg, tp = make_pair(seed=18)
    cams = np.random.default_rng(19).uniform(-1.5, 1.5, (5, 3)).astype(np.float32)
    want = jdvgo.maskout_near_cam_vox(jp, jcfg, jnp.asarray(cams), 0.6)
    dvgo.maskout_near_cam_vox(tp, tcfg, cams, 0.6)
    got = tp.density.grid[0].detach().numpy()
    w = np.asarray(want.density.grid)
    out = w == -100.0
    assert 0 < out.mean() < 1
    np.testing.assert_array_equal(got == -100.0, out)
    np.testing.assert_array_equal(got[~out], w[~out])


def test_scale_volume_grid_and_occupancy_refresh_match_jax():
    jcfg, jp, tcfg, tp = make_pair(seed=21, offset=-6.0)
    n = 2 * MODEL_KW["num_voxels_rgb"]
    jp2, jcfg2 = jdvgo.scale_volume_grid(jp, jcfg, n)
    report = {}
    tp2, tcfg2 = dvgo.scale_volume_grid(tp, tcfg, n, report=report)
    assert tcfg2.world_size == jcfg2.world_size != jcfg.world_size
    for name in ("density", "k0"):
        np.testing.assert_allclose(getattr(tp2, name).grid[0].detach().numpy(),
                                   np.asarray(getattr(jp2, name).grid), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tp2.mask_cache.mask.numpy(), np.asarray(jp2.mask_cache.mask))
    assert 0 < float(tp2.mask_cache.mask.float().mean()) < 1 == report["carried"]
    # the refresh of the cache on its own lattice, from a mask partly false
    mask = ~random_mask(jp2.mask_cache.mask.shape, 22, share=0.2)
    jp2 = jp2.replace(mask_cache=jp2.mask_cache.replace(mask=jnp.asarray(mask)))
    tp2.mask_cache.mask = t_(mask)
    jcfg3 = dataclasses.replace(jcfg2, fast_color_thres=0.02)
    tcfg3 = dataclasses.replace(tcfg2, fast_color_thres=0.02)
    want = np.asarray(jdvgo.update_occupancy_cache(jp2, jcfg3).mask_cache.mask)
    got = dvgo.update_occupancy_cache(tp2, tcfg3).mask_cache.mask.numpy()
    assert 0 < want.mean() < mask.mean()
    assert int((got != want).sum()) <= 2


@pytest.mark.parametrize("skip", [False, True])
def test_masked_adam_per_lr_matches_jax(skip):
    """Three updates with a per-element lr (a fifth of it 0), skip or not:
    every element moves as the JAX update moves it, a zero grad included.
    The plain version given the step size JAX computes (its bias correction
    in f32) is bit-equal to JAX's ``update``; ``MaskedAdam``, whose step
    size is a double rounded once, holds p within 1e-5 relative / 1e-6
    absolute, as ``test_torch_port_adam.py`` holds it without ``per_lr``."""
    rng = np.random.default_rng(23)
    shape = (5, 6, 7)
    p0 = rng.standard_normal(shape).astype(np.float32)
    plr = (rng.integers(0, 9, shape) * (rng.random(shape) > 0.2) / 8.0).astype(np.float32)
    grads = [(rng.standard_normal(shape) * (rng.random(shape) > 0.3)).astype(np.float32)
             for _ in range(3)]
    params = {"density": jnp.asarray(p0)}
    hyper = {"density": j_adam.AdamHyper(lr=0.1, skip_zero_grad=skip)}
    state = j_adam.init(params)
    pt = torch.nn.Parameter(torch.tensor(p0))
    opt = MaskedAdam([ParamGroup("density", [pt], 0.1, skip)])
    opt.set_per_lr({"density": [t_(plr)]})
    plain = [torch.tensor(p0), torch.zeros(shape), torch.zeros(shape)]
    for t, g in enumerate(grads):
        lr_scale = 1.0 - 0.1 * t
        params, state = j_adam.update(params, {"density": jnp.asarray(g)}, state, hyper,
                                      lr_scale=lr_scale, per_lr={"density": jnp.asarray(plr)})
        pt.grad = t_(g)
        opt.step(lr_scale=lr_scale)
        tf = jnp.float32(t + 1)  # JAX's step size, as its update computes it
        step = float(0.1 * lr_scale * (jnp.sqrt(1.0 - 0.99**tf) / (1.0 - 0.9**tf)))
        adam.masked_adam_plain(*plain, t_(g), step, 0.9, 0.99, 1e-8, skip, per_lr=t_(plr))
    for got, want in zip(plain, (params["density"], state.exp_avg["density"],
                                 state.exp_avg_sq["density"])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(opt.exp_avg[pt].numpy(), np.asarray(state.exp_avg["density"]))
    np.testing.assert_array_equal(opt.exp_avg_sq[pt].numpy(),
                                  np.asarray(state.exp_avg_sq["density"]))
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(params["density"]), rtol=1e-5,
                               atol=1e-6)
    moved = pt.detach().numpy() != p0
    # a zero grad moves too (the moment of an earlier step), a zero lr not
    touched = np.any([g != 0 for g in grads], axis=0)
    np.testing.assert_array_equal(moved, (plr != 0) & touched)
    assert (moved & (grads[-1] == 0)).any()


def test_make_per_lr_and_state_dict():
    tp = make_pair(seed=24)[3]
    train = TrainStageConfig(**TRAIN_KW)
    trainable = factory.split_trainable(tp, train)
    lr = torch.rand(tp.density.grid.shape)
    tree = make_per_lr(trainable, {"density": [lr]})
    assert tree["k0"] == [None] and len(tree["rgbnet"]) == 4
    opt = factory.make_optimizer(tp, train)
    opt.set_per_lr(tree)
    assert list(opt.per_lr) == [tp.density.grid]
    assert "per_lr" not in opt.state_dict()  # computed anew on resume
    with pytest.raises(ValueError, match="shape"):
        opt.set_per_lr({"density": [lr[..., :1, :]]})
    with pytest.raises(ValueError, match="tensors"):
        make_per_lr(trainable, {"density": [lr, lr]})


def jax_state_with_per_lr(jp, jtrain, plr):
    state = jstep.create_train_state(jp, jtrain)
    trainable, _ = jfactory.split_trainable(jp, jtrain)
    per_lr = j_adam.make_per_lr(trainable, {"density": jp.density.replace(grid=plr)})
    return state.replace(per_lr=per_lr)


def _step_pair(jcfg, jp, tcfg, tp, train_kw, batch, plr=None):
    jtrain, ttrain = JTrainStageConfig(**train_kw), TrainStageConfig(**train_kw)
    jfwd = lambda p, ro, rd, vd, key, img_index=None: jdvgo.forward(
        p, jcfg, ro, rd, vd, near=NEAR, stepsize=STEPSIZE, bg=1.0)
    tfwd = loop.make_forward(tcfg, {"near": NEAR, "bg": 1.0, "stepsize": STEPSIZE})
    ws_max = float(max(jcfg.world_size))
    j_step = jax.jit(jstep.make_train_step(jfwd, jtrain, world_size_max=ws_max, lr_anchor=1))
    if plr is None:
        j_state = jstep.create_train_state(jp, jtrain)
    else:
        j_state = jax_state_with_per_lr(jp, jtrain, jnp.asarray(plr))
    t_state = tstep.create_train_state(tp, ttrain)
    if plr is not None:
        t_state.optimizer.set_per_lr(make_per_lr(factory.split_trainable(tp, ttrain),
                                                 {"density": [t_(plr)[None]]}))
    j_state, j_m = j_step(j_state, {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.PRNGKey(0))
    t_m = tstep.make_train_step(tfwd, ttrain, world_size_max=ws_max, lr_anchor=1)(
        t_state, {k: t_(v) for k, v in batch.items()}, None)
    for name in ("loss", "mse", "psnr"):
        assert float(t_m[name]) == pytest.approx(float(j_m[name]), rel=1e-4, abs=1e-6), name
    pairs = [(t_state.params.density.grid[0], j_state.params.density.grid),
             (t_state.params.k0.grid[0], j_state.params.k0.grid)]
    if t_state.params.rgbnet is not None:
        pairs += [(lin.weight.T, w) for lin, w in zip(t_state.params.rgbnet.layers,
                                                       j_state.params.rgbnet.weights)]
    lr = max(train_kw["lrate_density"], train_kw["lrate_k0"])
    for got, want in pairs:
        got, want = got.detach().numpy(), np.asarray(want)
        off = np.abs(got - want) > 2e-5 + 1e-4 * np.abs(want)
        # an element whose gradient is exactly 0 on one side only (a sample
        # past the early exit, or a threshold, by a rounding: with the skip
        # it keeps its value there) or under Adam's eps (where the step's
        # size follows the gradient's last digits) takes another step:
        # counted, and each within one step
        assert off.mean() <= 1e-3, (int(off.sum()), off.size)
        assert (np.abs(got - want)[off] <= 1.1 * lr).all()
    return t_state, j_state


def test_a_coarse_step_with_per_lr_matches_jax():
    """The coarse stage's step: k0 alone (no MLP), the density's Adam step
    scaled by a per-element lr from ``voxel_count_views``, no skip. The
    density sits 10 above its zero: at the coarse ``alpha_init`` of 1e-6 a
    density near 0 gives gradients near Adam's eps, where the step's size
    follows the gradient's last digits."""
    jcfg, jp, tcfg, tp = make_pair(seed=25, offset=10.0, rgbnet_dim=0, alpha_init=1e-6,
                                   fast_color_thres=1e-7)
    views = [make_rays(200, seed=30 + v, spread=1.5) for v in range(4)]
    o, d = np.stack([v[0] for v in views]), np.stack([v[1] for v in views])
    count = np.asarray(jdvgo.voxel_count_views(jp, jcfg, jnp.asarray(o), jnp.asarray(d), NEAR,
                                               STEPSIZE))
    plr = count / max(count.max(), 1.0)
    assert 0 < (plr == 0).mean() < 1
    ro, rd, vd = make_rays(TRAIN_KW["N_rand"], seed=40, spread=1.5)
    batch = dict(rays_o=ro, rays_d=rd, viewdirs=vd,
                 rgb=np.random.default_rng(41).random((ro.shape[0], 3)).astype(np.float32))
    t_state, j_state = _step_pair(jcfg, jp, tcfg, tp, TRAIN_KW, batch, plr=plr)
    assert build.LAUNCHES.get("masked_adam_per_lr", 0) == 0  # the CPU: no kernel
    # the density of voxels of count 0 did not move, with a grad or without
    still = plr[..., 0] == 0
    np.testing.assert_array_equal(t_state.params.density.grid[0].detach().numpy()[still],
                                  np.asarray(jp.density.grid)[still])


def test_a_fine_step_on_the_in_maskcache_store_matches_jax():
    """The fine stage's step on a batch of the rays that the occupancy cache
    keeps (the JAX filter's and the port's agree), skip_zero_grad on the
    grids."""
    jcfg, jp, tcfg, tp = make_pair(seed=26)
    mask = random_mask(jp.mask_cache.mask.shape, 27, share=0.3)
    jp = jp.replace(mask_cache=jp.mask_cache.replace(mask=jnp.asarray(mask)))
    tp.mask_cache.mask = t_(mask)
    ro, rd, vd = make_rays(300, seed=28)
    rgb = np.random.default_rng(29).random((300, 3)).astype(np.float32)
    store = {"rgb": t_(rgb), "rays_o": t_(ro), "rays_d": t_(rd), "viewdirs": t_(vd)}
    kept, report = loop.filter_in_maskcache(tp, tcfg, store,
                                            {"near": NEAR, "stepsize": STEPSIZE}, "cpu")
    hit = np.asarray(jdvgo.hit_coarse_geo(jp, jcfg, jnp.asarray(ro), jnp.asarray(rd), NEAR,
                                          STEPSIZE))
    assert report["kept"] == hit.sum() and 0 < hit.sum() < 300
    np.testing.assert_array_equal(kept["rays_o"].numpy(), ro[hit])
    # the host store's filter keeps the same rays, as numpy arrays
    host, _ = loop.filter_in_maskcache(tp, tcfg, {k: v.numpy() for k, v in store.items()},
                                       {"near": NEAR, "stepsize": STEPSIZE}, "cpu")
    np.testing.assert_array_equal(host["rgb"], rgb[hit])
    batch = {k: v[:TRAIN_KW["N_rand"]].numpy() for k, v in kept.items()}
    train_kw = {**TRAIN_KW, "skip_zero_grad_fields": ("density", "k0")}
    _step_pair(jcfg, jp, tcfg, tp, train_kw, batch)


def test_checkpoint_and_convert_round_trips_from_jax(tmp_path):
    """JAX params -> port -> the port's checkpoint -> port -> JAX layout:
    equal to the bit; and the JAX optimizer's state the same way."""
    jcfg, jp, tcfg, tp = make_pair(seed=31)
    tree = convert.tree_from_params_object(jp)
    jtrain, ttrain = JTrainStageConfig(**TRAIN_KW), TrainStageConfig(**TRAIN_KW)
    j_state = jstep.create_train_state(jp, jtrain)
    j_opt = convert.opt_state_tree_from_object(j_state.opt_state._replace(
        step=jnp.asarray(3, jnp.int32),
        exp_avg=jax.tree.map(lambda x: x + 0.25, j_state.opt_state.exp_avg)))
    t_state = tstep.create_train_state(tp, ttrain, start_step=3,
                                       opt_state=convert.opt_state_from_numpy(j_opt, "dvgo"))
    path = str(tmp_path / "coarse_last")
    ckpt.save_model(path, "dvgo", tcfg, tp, global_step=3,
                    opt_state=t_state.optimizer.state_dict())
    fam, cfg2, tp2, step, opt = ckpt.load_model(path)
    assert (fam, cfg2, step) == ("dvgo", tcfg, 3) and isinstance(tp2, dvgo.DVGOParams)
    back = convert.params_to_numpy(tp2)
    for name in ("density", "k0"):
        np.testing.assert_array_equal(back[name]["grid"], tree[name]["grid"])
    np.testing.assert_array_equal(back["mask_cache"]["mask"], tree["mask_cache"]["mask"])
    for a, b in zip(back["rgbnet"]["weights"], tree["rgbnet"]["weights"]):
        np.testing.assert_array_equal(a, b)
    assert float(back["act_shift"]) == float(tree["act_shift"])
    opt_back = convert.opt_state_to_numpy(
        {k: v if k == "step" else {n: [t_(a) for a in ms] for n, ms in v.items()}
         for k, v in opt.items()}, "dvgo")
    flat_g, flat_w = ckpt._flatten(opt_back), ckpt._flatten(j_opt)
    assert sorted(flat_g) == sorted(flat_w)
    for k in flat_w:
        np.testing.assert_array_equal(flat_g[k], flat_w[k], err_msg=k)


def test_random_samplers():
    """The device store's ``random`` sampler draws with replacement and
    replays on fast_forward; the host store's draws the JAX sampler's
    indices for the same seed."""
    gen = lambda: torch.Generator().manual_seed(5)
    a = tstep.RandomSampler(50, 64, gen(), "cpu", rand_bkgd=True)
    batches = [a.next_batch() for _ in range(3)]
    idx = batches[0][0]
    assert idx.shape == (64,) and len(set(idx.tolist())) < 50 and batches[0][1].shape == (64, 3)
    b = tstep.RandomSampler(50, 64, gen(), "cpu", rand_bkgd=True)
    b.fast_forward(2)
    idx3, bg3 = b.next_batch()
    assert torch.equal(idx3, batches[2][0]) and torch.equal(bg3, batches[2][1])
    store = {k: np.arange(90 * 3, dtype=np.float32).reshape(90, 3) + i
             for i, k in enumerate(("rgb", "rays_o", "rays_d", "viewdirs"))}
    host = tstep.HostRayStoreSampler(store, 16, 7, "cpu", mode="random")
    ref = jstep.HostRayStoreSampler(store, 16, seed=7, mode="random")
    host.fast_forward(2)
    ref.fast_forward(2)
    for _ in range(3):
        got, _ = host.next_batch()
        want = ref.next_batch()
        np.testing.assert_array_equal(got["rays_d"].numpy(), want["rays_d"])
    with pytest.raises(ValueError, match="mode"):
        tstep.HostRayStoreSampler(store, 16, 7, "cpu", mode="epoch")


def test_what_stays_unported_names_a18c(tmp_path, monkeypatch):
    """What waited for ROADMAP A18c now runs: a coarse stage outside the
    DVGO family (DCVGO here; DMPIGO's has its own test file) and
    ``maskout_near_cam_vox`` in the FourierGrid family, each for two steps
    a stage at a small size."""
    from unboundednerfpytorch_tpu_torch.data import synthetic

    data = synthetic.orbit_scene(4, 12, 12, seed=0, n_test=1)
    base = ExpConfig()
    small = dict(num_voxels_rgb=12**3, num_voxels_density=12**3, num_voxels_base_rgb=12**3,
                 num_voxels_base_density=12**3)
    short = dict(N_iters=2, N_rand=64, pg_scale=())
    fam_cfg = dataclasses.replace(
        base, data=dataclasses.replace(base.data, unbounded_inward=True),
        coarse_train=dataclasses.replace(base.coarse_train, **short),
        fine_train=dataclasses.replace(base.fine_train, **short),
        coarse_model_and_render=dataclasses.replace(base.coarse_model_and_render, **small),
        fine_model_and_render=dataclasses.replace(base.fine_model_and_render, **small))
    fam, mcfg, params, _ = loop.run_train(fam_cfg, data, device="cpu", log_fn=lambda _: None)
    assert fam == "dcvgo" and params.mask_cache.mask.shape == mcfg.world_size
    fm = dataclasses.replace(base.fine_model_and_render, maskout_near_cam_vox=True, **small)
    fg_cfg = dataclasses.replace(base, model="FourierGrid", fine_model_and_render=fm,
                                 coarse_train=dataclasses.replace(base.coarse_train, N_iters=0),
                                 fine_train=dataclasses.replace(base.fine_train, **short))
    masked, maskout = [], fg.maskout_near_cam_vox
    monkeypatch.setattr(fg, "maskout_near_cam_vox",
                        lambda *a: masked.append(a[0]) or maskout(*a))
    fam, _, params, _ = loop.run_train(fg_cfg, data, device="cpu", log_fn=lambda _: None)
    assert fam == "FourierGrid" and len(masked) == 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _bits(x):
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 4097, (1 << 20) + 3])
@pytest.mark.parametrize("grad", [True, False])
@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_adam_per_lr_kernel_bit_equal_to_plain(cuda, dtype, skip, grad, n):
    gen = torch.Generator().manual_seed(n)
    p = torch.randn(n, generator=gen).to(dtype)
    g = (torch.randn(n, generator=gen) * (torch.rand(n, generator=gen) > 0.4)).to(dtype)
    m = torch.randn(n, generator=gen) * 0.1
    v = torch.rand(n, generator=gen) * 0.01
    r = torch.rand(n, generator=gen) * (torch.rand(n, generator=gen) > 0.2)
    p, g, m, v, r = (x.cuda() for x in (p, g, m, v, r))
    want = [x.clone() for x in (p, m, v)]
    adam.masked_adam_plain(*want, g if grad else None, 0.03, 0.9, 0.99, 1e-8, skip, per_lr=r)
    build.reset_launch_counts()
    adam.masked_adam(p, m, v, g if grad else None, 0.03, 0.9, 0.99, 1e-8, skip, per_lr=r)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {"masked_adam_per_lr": 1}
    for got, w in zip((p, m, v), want):
        assert torch.equal(_bits(got), _bits(w))
