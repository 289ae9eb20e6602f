"""The port's two-stage training forward (``train_survivor_budget``) against
its single-stage forward and against the JAX package's
``_forward_train_two_stage``, and its deferral in the training loop.

The model is the JAX package's fixture (``tests/test_two_stage.py``: 24^3,
two Fourier frequencies, a density bump at the centre, so that the
threshold keeps a handful of samples a ray and none overflows the budget of
24), carried into the port. Tolerances: values within 2e-5 relative / 2e-6
absolute and gradients within 2e-4 relative / 1e-6 absolute, the JAX
package's own gate between its two forwards; the same against JAX.
"""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from test_torch_port_sparse_probe import as_torch, to_port
from test_two_stage import _cfg, _rays, _sparse_params
from unboundednerfpytorch_tpu.models import fourier_grid as jfg
from unboundednerfpytorch_tpu_torch.configs.schema import ExpConfig
from unboundednerfpytorch_tpu_torch.data import synthetic
from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
from unboundednerfpytorch_tpu_torch.train import loop
from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt

RTOL_V, ATOL_V, RTOL_G, ATOL_G = 2e-5, 2e-6, 2e-4, 1e-6


def two_stage_pair(thres=1e-3, budget=24):
    jcfg1 = _cfg(scene_radius=(3.0, 3.0, 3.0), num_voxels_density=24**3, num_voxels_rgb=24**3,
                 num_voxels_base_density=24**3, num_voxels_base_rgb=24**3, fourier_freq_num=2,
                 fast_color_thres=thres, stepsize=0.5)
    jp = _sparse_params(jcfg1)
    tcfg1, tp = to_port(jcfg1, jp)
    return jcfg1, dataclasses.replace(jcfg1, train_survivor_budget=budget), jp, tcfg1, \
        dataclasses.replace(tcfg1, train_survivor_budget=budget), tp


def rays():
    ro = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (48, 3)) * 0.3
                    + jnp.array([2.5, 0.0, 0.0]))
    rd = -ro / np.linalg.norm(ro, axis=-1, keepdims=True)
    return ro, rd, rd


def port_value_and_grads(tp, tcfg, ro, rd, vd):
    for p in tp.parameters():
        p.grad = None
    r = fg.forward(tp, tcfg, *as_torch(ro, rd, vd))
    loss = torch.sum(r.rgb_marched ** 2) + torch.sum(r.weights) + torch.sum(r.depth)
    loss.backward()
    grads = [tp.density.grid.grad.clone(), tp.k0.grid.grad.clone()]
    grads += [lin.weight.grad.T.clone() for lin in tp.rgbnet.layers]
    return float(loss), r, grads


def jax_value_and_grads(jp, jcfg, ro, rd, vd):
    def run(sub):
        p = jp.replace(density=jp.density.replace(grid=sub["d"]),
                       k0=jp.k0.replace(grid=sub["k"]),
                       rgbnet=jp.rgbnet.replace(weights=sub["w"]))
        r = jfg.forward(p, jcfg, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(vd))
        return jnp.sum(r.rgb_marched**2) + jnp.sum(r.weights) + jnp.sum(r.depth), r

    sub = {"d": jp.density.grid, "k": jp.k0.grid, "w": jp.rgbnet.weights}
    (loss, r), g = jax.jit(jax.value_and_grad(run, has_aux=True))(sub)
    return float(loss), r, [np.asarray(g["d"]), np.asarray(g["k"])] + [np.asarray(w)
                                                                      for w in g["w"]]


def test_train_two_stage_matches_plain_values_and_grads():
    """With no ray over the budget, the two-stage forward's outputs and every
    gradient are the single-stage forward's, and both the JAX package's."""
    jcfg1, jcfg2, jp, tcfg1, tcfg2, tp = two_stage_pair()
    ro, rd, vd = rays()
    l1, r1, g1 = port_value_and_grads(tp, tcfg1, ro, rd, vd)
    l2, r2, g2 = port_value_and_grads(tp, tcfg2, ro, rd, vd)
    assert r2.weights.shape[1] == 24 < r1.weights.shape[1]
    assert float(r2.color_overflow_frac) == 0.0 and r1.color_overflow_frac is None
    for f in ("rgb_marched", "alphainv_last", "depth"):
        np.testing.assert_allclose(getattr(r2, f).detach().numpy(),
                                   getattr(r1, f).detach().numpy(), rtol=RTOL_V, atol=ATOL_V)
    np.testing.assert_allclose(l2, l1, rtol=RTOL_V)
    for a, b in zip(g2, g1):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=RTOL_G,
                                   atol=ATOL_G)
    # against the JAX package's two-stage forward
    jl, jr, jg = jax_value_and_grads(jp, jcfg2, ro, rd, vd)
    assert jr.weights.shape == tuple(r2.weights.shape)
    np.testing.assert_array_equal(r2.mask.numpy(), np.asarray(jr.mask))
    for f in ("rgb_marched", "alphainv_last", "weights", "t", "s", "depth", "raw_density"):
        np.testing.assert_allclose(getattr(r2, f).detach().numpy(), np.asarray(getattr(jr, f)),
                                   rtol=RTOL_V, atol=ATOL_V, err_msg=f)
    np.testing.assert_allclose(l2, jl, rtol=RTOL_V)
    for a, b in zip(g2, jg):
        np.testing.assert_allclose(a.float().numpy(), b, rtol=RTOL_G, atol=ATOL_G)


def test_train_two_stage_probe_is_the_gather_to_the_bit():
    """Stage A's density from the folded tables equals stage B's gather to the
    last bit, so the two agree on every ``alpha > thres``."""
    _, _, _, tcfg1, _, tp = two_stage_pair()
    ro, rd, _ = rays()
    with torch.no_grad():
        pts = fg.sample_ray(tcfg1, *as_torch(ro, rd))[0]
        probe = fg._probe_density(tp, tcfg1, pts)
        gathered, _ = fg._query(tp, tcfg1, pts)
    assert torch.equal(probe, gathered)


def test_train_two_stage_overflow_truncates_the_far_tail():
    """A budget under the survivors of some rays: ``color_overflow_frac``
    counts them, and each ray keeps the first survivors in near -> far
    order."""
    _, _, _, tcfg1, _, tp = two_stage_pair()
    tcfg2 = dataclasses.replace(tcfg1, train_survivor_budget=4)
    ro, rd, vd = rays()
    with torch.no_grad():
        r1 = fg.forward(tp, tcfg1, *as_torch(ro, rd, vd))
        r2 = fg.forward(tp, tcfg2, *as_torch(ro, rd, vd))
    survivors = r1.raw_alpha > tcfg1.fast_color_thres
    assert 0 < float(r2.color_overflow_frac) == float((survivors.sum(-1) > 4).float().mean())
    for i in range(r1.t.shape[0]):
        first = r1.t[i][survivors[i]][:4].numpy()
        got = r2.t[i][r2.mask[i]].numpy()
        assert np.isin(got, first).all() and (np.diff(got) > 0).all()


def test_train_two_stage_inactive_below_thres_gate():
    """Below ``train_two_stage_thres`` the single-stage forward runs."""
    _, _, _, _, tcfg2, tp = two_stage_pair(thres=5e-6)
    with torch.no_grad():
        r = fg.forward(tp, tcfg2, *as_torch(*(np.asarray(x) for x in _rays(16, 5))))
    assert r.weights.shape[1] > 24 and r.color_overflow_frac is None


def test_the_loop_defers_the_survivor_budget_to_the_last_boundary(tmp_path):
    """The loop trains with the survivor budget at 0 until the last
    ``pg_scale`` boundary and with it from there (the step's
    ``overflow_frac`` appears); the held-out panel renders without it, and
    each save stores the configured budget."""
    data = synthetic.orbit_scene(4, 8, 8, seed=0, n_test=1)
    base = ExpConfig()
    fm = dataclasses.replace(
        base.fine_model_and_render, num_voxels_rgb=12**3, num_voxels_density=12**3,
        num_voxels_base_rgb=12**3, num_voxels_base_density=12**3, rgbnet_width=16,
        fourier_freq_num=1, fast_color_thres=1e-4, train_survivor_budget=8,
        maskout_near_cam_vox=False, alpha_init=1e-2)
    ft = dataclasses.replace(base.fine_train, N_iters=5, N_rand=32, pg_scale=(2, 4),
                             i_panel=5, ray_sampler="flatten")
    cfg = dataclasses.replace(base, model="FourierGrid", fine_model_and_render=fm, fine_train=ft,
                              coarse_train=dataclasses.replace(base.coarse_train, N_iters=0))
    seen, panels = {}, []
    real = loop.make_forward

    def spy(mcfg, kw, cache=None):
        panels.append(mcfg.train_survivor_budget)
        return real(mcfg, kw, cache)

    loop.make_forward = spy
    try:
        _, mcfg, _, _ = loop.run_train(
            cfg, data, device="cpu", log_fn=lambda _: None, exp_dir=str(tmp_path),
            callback=lambda step, m: seen.setdefault(step, "overflow_frac" in m))
    finally:
        loop.make_forward = real
    assert seen == {1: False, 2: False, 3: False, 4: True, 5: True}
    # the step's forward at the start and at each boundary, then the panel's
    assert panels == [0, 0, 8, 0]
    assert mcfg.train_survivor_budget == 8
    assert ckpt.load_model(str(tmp_path / "fine_last"))[1].train_survivor_budget == 8
