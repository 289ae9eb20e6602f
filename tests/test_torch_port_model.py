"""The port's FourierGrid forward and gradients against the JAX model.

A tiny config (16^3 voxels, one Fourier frequency so 3 banks, rgbnet width
16, ``sample_budget`` on with the stride-2 probe, ``fast_color_thres`` on):
JAX parameters are drawn, carried into the port by
``convert.fourier_grid_params_from_numpy``, and the same rays and the same
random background go through ``fg.forward`` of both packages on the CPU.

The mask cache stays all-true (as the round lookup of a sample that sits
on a voxel's half-way point could flip with the last ulp of ``t``).
Tolerance: float32 within 1e-4 relative / 1e-6 absolute for values, and
1e-4 relative / 1e-5 absolute for gradients, whose sums run over thousands
of samples in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unboundednerfpytorch_tpu.configs.schema import ModelRenderConfig as JModelRenderConfig
from unboundednerfpytorch_tpu.models import fourier_grid as jfg
from unboundednerfpytorch_tpu_torch import convert
from unboundednerfpytorch_tpu_torch.configs.schema import ModelRenderConfig
from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg

XYZ_MIN, XYZ_MAX = (-2.0, -1.5, -1.0), (2.0, 2.5, 1.0)
MODEL_KW = dict(
    num_voxels_density=16**3, num_voxels_rgb=16**3, num_voxels_base_density=16**3,
    num_voxels_base_rgb=16**3, rgbnet_dim=4, rgbnet_width=16, alpha_init=1e-2,
    fast_color_thres=1e-4, fourier_freq_num=1, bg_len=0.2, stepsize=0.5,
    sample_budget=12, budget_probe_stride=2, maskout_near_cam_vox=False)


def jax_params_to_numpy(p) -> dict:
    """The JAX FourierGridParams as the converter's nested numpy dict."""
    grid = lambda g: {"grid": np.asarray(g.grid), "xyz_min": g.xyz_min,
                      "xyz_max": g.xyz_max, "num_freqs": g.num_freqs}
    return {
        "density": grid(p.density), "k0": grid(p.k0),
        "rgbnet": {"weights": [np.asarray(w) for w in p.rgbnet.weights],
                   "biases": [np.asarray(b) for b in p.rgbnet.biases]},
        "act_shift": np.asarray(p.act_shift),
        "mask_cache": {"mask": np.asarray(p.mask_cache.mask), "xyz_min": p.mask_cache.xyz_min,
                       "xyz_max": p.mask_cache.xyz_max},
    }


def make_pair(seed=0, **overrides):
    """(JAX config, JAX params, port config, port params) with random grids."""
    kw = {**MODEL_KW, **overrides}
    jcfg = jfg.config_from(JModelRenderConfig(**kw), XYZ_MIN, XYZ_MAX,
                           kw["num_voxels_density"], kw["num_voxels_rgb"])
    tcfg = fg.config_from(ModelRenderConfig(**kw), XYZ_MIN, XYZ_MAX,
                          kw["num_voxels_density"], kw["num_voxels_rgb"])
    rng = np.random.default_rng(seed)
    jp = jfg.create(jcfg, jax.random.PRNGKey(seed))
    dgrid = rng.standard_normal(jp.density.grid.shape) * 4.0 - 4.0
    kgrid = rng.standard_normal(jp.k0.grid.shape) * 0.5
    jp = jp.replace(density=jp.density.replace(grid=jnp.asarray(dgrid, jp.density.grid.dtype)),
                    k0=jp.k0.replace(grid=jnp.asarray(kgrid, jp.k0.grid.dtype)))
    return jcfg, jp, tcfg, convert.fourier_grid_params_from_numpy(jax_params_to_numpy(jp), "cpu")


def make_rays(n=48, seed=1):
    """Rays from cameras around the scene box, looking roughly inwards."""
    rng = np.random.default_rng(seed)
    center = (np.asarray(XYZ_MIN) + np.asarray(XYZ_MAX)) / 2
    o = center + rng.standard_normal((n, 3)) * 1.5
    d = center + rng.standard_normal((n, 3)) * 0.5 - o
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return [a.astype(np.float32) for a in (o, d, vd)]


def test_config_matches_jax():
    jcfg, _, tcfg, _ = make_pair()
    for name in ("world_size_density", "world_size_rgb", "n_inner", "act_shift",
                 "voxel_size_ratio_density", "rgbnet_in_dim", "scene_center", "scene_radius",
                 "fast_color_thres", "sample_budget", "budget_probe_stride"):
        assert getattr(tcfg, name) == pytest.approx(getattr(jcfg, name)), name


def test_converter_round_trip():
    _, jp, _, tp = make_pair(grid_dtype="bfloat16")
    assert tp.density.grid.dtype == torch.bfloat16
    assert tuple(tp.rgbnet.layers[0].weight.shape) == tuple(jp.rgbnet.weights[0].shape[::-1])
    back = convert.params_to_numpy(tp)
    want = jax_params_to_numpy(jp)
    for name in ("density", "k0"):
        np.testing.assert_array_equal(back[name]["grid"], np.asarray(want[name]["grid"], np.float32))
    for a, b in zip(back["rgbnet"]["weights"] + back["rgbnet"]["biases"],
                    want["rgbnet"]["weights"] + want["rgbnet"]["biases"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(back["mask_cache"]["mask"], want["mask_cache"]["mask"])
    assert float(back["act_shift"]) == pytest.approx(float(want["act_shift"]))


@pytest.mark.parametrize("budget", [12, 0])
def test_forward_matches_jax(budget):
    jcfg, jp, tcfg, tp = make_pair(sample_budget=budget)
    o, d, vd = make_rays()
    key = jax.random.PRNGKey(3)
    want = jfg.forward(jp, jcfg, jnp.asarray(o), jnp.asarray(d), jnp.asarray(vd),
                       rand_bkgd_key=key)
    bg = torch.from_numpy(np.array(jax.random.uniform(key, (o.shape[0], 3))))
    got = fg.forward(tp, tcfg, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(vd),
                     bg_color=bg)
    assert got.n_max == want.n_max
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert 0 < int(got.mask.sum()) < got.mask.numel()  # the threshold bites
    for field in ("rgb_marched", "alphainv_last", "weights", "raw_alpha", "raw_rgb",
                  "raw_density", "t", "s", "depth"):
        np.testing.assert_allclose(getattr(got, field).detach().numpy(),
                                   np.asarray(getattr(want, field)), rtol=1e-4, atol=1e-6,
                                   err_msg=field)


def test_gradients_match_jax():
    """d(loss)/d(density grid, k0 grid, MLP) through the whole forward, with
    cotangents on every output the train step's losses read."""
    jcfg, jp, tcfg, tp = make_pair(seed=2)
    o, d, vd = make_rays(seed=4)
    rng = np.random.default_rng(5)
    N = o.shape[0]
    c_rgb = rng.standard_normal((N, 3)).astype(np.float32)
    c_ai = rng.standard_normal(N).astype(np.float32)
    S = jcfg.sample_budget
    c_w = rng.standard_normal((N, S)).astype(np.float32)
    c_d = rng.standard_normal((N, S)).astype(np.float32)
    c_raw = rng.standard_normal((N, S, 3)).astype(np.float32)

    def j_loss(dgrid, kgrid, weights):
        p = jp.replace(density=jp.density.replace(grid=dgrid), k0=jp.k0.replace(grid=kgrid),
                       rgbnet=jp.rgbnet.replace(weights=weights))
        r = jfg.forward(p, jcfg, jnp.asarray(o), jnp.asarray(d), jnp.asarray(vd), bg=0.5)
        return (jnp.sum(r.rgb_marched * c_rgb) + jnp.sum(r.alphainv_last * c_ai)
                + jnp.sum(r.weights * c_w) + jnp.sum(r.raw_density * c_d)
                + jnp.sum(r.raw_rgb * c_raw))

    gd, gk, gw = jax.grad(j_loss, argnums=(0, 1, 2))(jp.density.grid, jp.k0.grid,
                                                    jp.rgbnet.weights)
    r = fg.forward(tp, tcfg, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(vd),
                   bg=0.5)
    (torch.sum(r.rgb_marched * torch.from_numpy(c_rgb))
     + torch.sum(r.alphainv_last * torch.from_numpy(c_ai))
     + torch.sum(r.weights * torch.from_numpy(c_w))
     + torch.sum(r.raw_density * torch.from_numpy(c_d))
     + torch.sum(r.raw_rgb * torch.from_numpy(c_raw))).backward()
    assert float(np.abs(np.asarray(gd)).max()) > 0
    for got, want in [(tp.density.grid.grad, gd), (tp.k0.grid.grad, gk)] + [
            (lin.weight.grad.T, w) for lin, w in zip(tp.rgbnet.layers, gw)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
