"""The port's plain ops against their JAX counterparts.

Interpolation, sampling, rays, losses, the TV gradient and masked Adam: the
same numpy inputs go through ``unboundednerfpytorch_tpu`` and
``unboundednerfpytorch_tpu_torch`` on the CPU.

Tolerances: float32 results within 1e-5 relative / 1e-6 absolute (the two
frameworks sum in other orders); integer and boolean results exactly; ray
directions within 1e-6 (a 3x3 product taken as einsum vs a vmapped matmul).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unboundednerfpytorch_tpu.ops import interp as j_interp
from unboundednerfpytorch_tpu.ops import losses as j_losses
from unboundednerfpytorch_tpu.ops import rays as j_rays
from unboundednerfpytorch_tpu.ops import sampling as j_sampling
from unboundednerfpytorch_tpu.ops import tv as j_tv
from unboundednerfpytorch_tpu.optim import masked_adam as j_adam
from unboundednerfpytorch_tpu_torch.ops import interp, losses, rays, sampling
from unboundednerfpytorch_tpu_torch.ops import tv as tv_ops
from unboundednerfpytorch_tpu_torch.optim.masked_adam import MaskedAdam, ParamGroup

RTOL, ATOL = 1e-5, 1e-6


def _close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


# ---------------------------------------------------------------- interp


def test_trilerp_corners_match_jax():
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-0.1, 1.1, (50, 3)).astype(np.float32)  # some outside
    idx_j, w_j = j_interp.trilerp_corners(jnp.asarray(xyz), (5, 6, 7))
    idx_t, w_t = interp.trilerp_corners(torch.from_numpy(xyz), (5, 6, 7))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    _close(w_t, w_j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grid_sample_3d_value_and_grad_match_jax(dtype):
    rng = np.random.default_rng(1)
    grid = rng.standard_normal((5, 6, 4, 3)).astype(np.float32)
    xyz = rng.uniform(-0.05, 1.05, (64, 3)).astype(np.float32)
    cot = rng.standard_normal((64, 3)).astype(np.float32)
    gj = jnp.asarray(grid, dtype)

    def f(g):
        return jnp.sum(j_interp.grid_sample_3d(g, jnp.asarray(xyz)) * cot)

    val_j = j_interp.grid_sample_3d(gj, jnp.asarray(xyz))
    # the port accumulates a bf16 table's grad in f32 and rounds once; XLA's
    # scatter-add into a bf16 grad rounds at every add (up to 7% apart on
    # these inputs). So the reference grad is the f32 one, rounded to bf16
    grad_j = jax.grad(f)(gj.astype(jnp.float32)).astype(dtype)
    gt = torch.from_numpy(np.array(gj, np.float32)).to(getattr(torch, dtype))
    gt.requires_grad_(True)
    val_t = interp.grid_sample_3d(gt, torch.from_numpy(xyz))
    assert val_t.dtype == torch.float32  # bf16 tables promote, as in JAX
    (val_t * torch.from_numpy(cot)).sum().backward()
    assert gt.grad.dtype == gt.dtype
    _close(val_t, val_j)
    if dtype == "float32":
        _close(gt.grad, grad_j)
    else:  # f32 sums in other orders round to bf16: one bf16 step apart at most
        _close(gt.grad, np.asarray(grad_j, np.float32), rtol=2.0**-7, atol=1e-6)


def test_grid_sample_banks_matches_per_bank_loop():
    """The port's one-gather-over-all-banks query equals the JAX per-bank
    loop of FourierGrid.__call__."""
    from unboundednerfpytorch_tpu.fields.grids import FourierGrid as JFourierGrid
    from unboundednerfpytorch_tpu_torch.fields.grids import FourierGrid

    rng = np.random.default_rng(2)
    grid = rng.standard_normal((5, 6, 5, 4, 2)).astype(np.float32)
    xyz = rng.uniform(-1.3, 1.3, (40, 3)).astype(np.float32)
    lo, hi = (-1.2,) * 3, (1.2,) * 3
    want = JFourierGrid(grid=jnp.asarray(grid), xyz_min=lo, xyz_max=hi, num_freqs=2)(
        jnp.asarray(xyz))
    got = FourierGrid(2, (6, 5, 4), lo, hi, num_freqs=2, grid=torch.from_numpy(grid))(
        torch.from_numpy(xyz))
    _close(got, want)


# ---------------------------------------------------------------- sampling


def test_contracted_t_values_and_contract_match_jax():
    t_j = j_sampling.contracted_t_values(17, 17, t_boundary=1.5)
    t_t = sampling.contracted_t_values(17, 17, t_boundary=1.5)
    _close(t_t, t_j)
    rng = np.random.default_rng(3)
    pts = (rng.standard_normal((30, 9, 3)) * 2.0).astype(np.float32)
    for norm in ("inf", "l2"):
        cj, ij = j_sampling.contract(jnp.asarray(pts), 0.2, norm_type=norm)
        ct, it = sampling.contract(torch.from_numpy(pts), 0.2, norm_type=norm)
        _close(ct, cj)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


@pytest.mark.parametrize("budget", [4, 13])
def test_compact_and_gather_samples_match_jax(budget):
    rng = np.random.default_rng(4)
    mask = rng.random((20, 13)) > 0.6
    mask[0] = False  # a ray with nothing live
    sel_j, m_j = j_sampling.compact_samples(jnp.asarray(mask), budget)
    sel_t, m_t = sampling.compact_samples(torch.from_numpy(mask), budget)
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    x = rng.standard_normal((20, 13, 4)).astype(np.float32)
    g_j = j_sampling.gather_samples(jnp.asarray(x), sel_j)
    g_t = sampling.gather_samples(torch.from_numpy(x), sel_t)
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))


def test_maskcache_lookup_matches_jax():
    rng = np.random.default_rng(5)
    grid = rng.random((6, 7, 5)) > 0.5
    xyz = rng.uniform(-1.4, 1.4, (200, 3)).astype(np.float32)
    scale = np.array([5 / 2.4, 6 / 2.4, 4 / 2.4], np.float32)
    shift = (1.2 * scale).astype(np.float32)
    want = j_sampling.maskcache_lookup(jnp.asarray(grid), jnp.asarray(xyz),
                                       jnp.asarray(scale), jnp.asarray(shift))
    got = sampling.maskcache_lookup(torch.from_numpy(grid), torch.from_numpy(xyz),
                                    torch.from_numpy(scale), torch.from_numpy(shift))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- rays


def _camera(rng):
    K = np.array([[30.0, 0, 11.0], [0, 28.0, 7.5], [0, 0, 1]], np.float32)
    a = rng.standard_normal((3, 3))
    q, _ = np.linalg.qr(a)
    c2w = np.concatenate([q, rng.standard_normal((3, 1))], 1).astype(np.float32)
    return K, c2w


@pytest.mark.parametrize("mode,inverse_y,flip_x,flip_y", [
    ("center", False, False, False), ("lefttop", True, False, False),
    ("center", False, True, True)])
def test_get_rays_of_a_view_matches_jax(mode, inverse_y, flip_x, flip_y):
    K, c2w = _camera(np.random.default_rng(6))
    kw = dict(inverse_y=inverse_y, flip_x=flip_x, flip_y=flip_y, mode=mode)
    want = j_rays.get_rays_of_a_view(15, 22, jnp.asarray(K), jnp.asarray(c2w), **kw)
    got = rays.get_rays_of_a_view(15, 22, torch.from_numpy(K), torch.from_numpy(c2w), **kw)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-6)


def test_get_training_rays_flatten_matches_jax():
    rng = np.random.default_rng(7)
    cams = [_camera(rng) for _ in range(3)]
    Ks = np.stack([c[0] for c in cams])
    poses = np.stack([c[1] for c in cams])
    images = rng.random((3, 9, 12, 3)).astype(np.float32)
    want = j_rays.get_training_rays_flatten(jnp.asarray(images), jnp.asarray(poses), 9, 12,
                                            jnp.asarray(Ks))
    got = rays.get_training_rays_flatten(torch.from_numpy(images), torch.from_numpy(poses),
                                         9, 12, torch.from_numpy(Ks))
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-6)


# ---------------------------------------------------------------- losses


def test_losses_values_and_grads_match_jax():
    rng = np.random.default_rng(8)
    N, S = 12, 10
    w = (rng.random((N, S)) * 0.2).astype(np.float32)
    s = np.sort(rng.random((N, S)), -1).astype(np.float32)
    mask = rng.random((N, S)) > 0.3
    raw_rgb = rng.random((N, S, 3)).astype(np.float32)
    target = rng.random((N, 3)).astype(np.float32)
    ai = rng.random(N).astype(np.float32)
    dens = rng.standard_normal((N, S)).astype(np.float32)
    t = (rng.random((N, S)) * 2).astype(np.float32)
    pred = rng.random((N, 3)).astype(np.float32)

    def j_total(w_, rgb_, ai_, d_, p_):
        m = jnp.asarray(mask)
        return (j_losses.mse(p_, target) + 0.1 * j_losses.entropy_last(ai_)
                + 0.2 * j_losses.rgbper(rgb_, target, w_, N, mask=m)
                + 0.3 * j_losses.distortion(w_, jnp.asarray(s), S, mask=m)
                + 0.4 * j_losses.nearclip(d_, jnp.asarray(t), 0.7, mask=m))

    args = [jnp.asarray(a) for a in (w, raw_rgb, ai, dens, pred)]
    val_j, grads_j = jax.value_and_grad(j_total, argnums=(0, 1, 2, 3, 4))(*args)
    tt = [torch.from_numpy(a).requires_grad_(True) for a in (w, raw_rgb, ai, dens, pred)]
    m = torch.from_numpy(mask)
    val_t = (losses.mse(tt[4], torch.from_numpy(target))
             + 0.1 * losses.entropy_last(tt[2])
             + 0.2 * losses.rgbper(tt[1], torch.from_numpy(target), tt[0], N, mask=m)
             + 0.3 * losses.distortion(tt[0], torch.from_numpy(s), S, mask=m)
             + 0.4 * losses.nearclip(tt[3], torch.from_numpy(t), 0.7, mask=m))
    val_t.backward()
    _close(val_t, val_j)
    for g_t, g_j in zip(tt, grads_j):
        _close(g_t.grad, g_j)
    _close(losses.mse2psnr(torch.tensor(0.01)), j_losses.mse2psnr(jnp.float32(0.01)))


# ---------------------------------------------------------------- TV


@pytest.mark.parametrize("dense", [True, False])
def test_total_variation_grad_matches_jax(dense):
    rng = np.random.default_rng(9)
    p = rng.standard_normal((3, 6, 5, 4, 2)).astype(np.float32)
    g = (rng.standard_normal(p.shape) * (rng.random(p.shape) > 0.5)).astype(np.float32)
    want = j_tv.total_variation_grad(jnp.asarray(p), 0.3, 0.2, 0.1, dense,
                                     existing_grad=jnp.asarray(g))
    got = tv_ops.total_variation_grad(torch.from_numpy(p), 0.3, 0.2, 0.1, dense,
                                      existing_grad=torch.from_numpy(g))
    _close(got, want)


# ---------------------------------------------------------------- masked Adam


def test_masked_adam_matches_jax_bf16_params_f32_moments():
    """Three steps with a decaying lr: a bf16 grid with skip_zero_grad (its
    zero-grad voxels keep value and moments), and an f32 plain group."""
    rng = np.random.default_rng(10)
    grid0 = jnp.asarray(rng.standard_normal((2, 4, 4, 3, 2)), jnp.bfloat16)
    w0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = []
    for _ in range(3):
        g = rng.standard_normal(grid0.shape) * (rng.random(grid0.shape) > 0.5)
        grads.append((np.asarray(jnp.asarray(g, jnp.bfloat16), np.float32),
                      rng.standard_normal(w0.shape).astype(np.float32)))
    lr_scales = [1.0, 0.9, 0.8]

    params = {"grid": grid0, "w": jnp.asarray(w0)}
    hyper = {"grid": j_adam.AdamHyper(lr=0.1, skip_zero_grad=True),
             "w": j_adam.AdamHyper(lr=0.01)}
    state = j_adam.init(params)
    for (gg, gw), sc in zip(grads, lr_scales):
        params, state = j_adam.update(
            params, {"grid": jnp.asarray(gg, jnp.bfloat16), "w": jnp.asarray(gw)}, state,
            hyper, lr_scale=sc)

    grid_t = torch.nn.Parameter(torch.from_numpy(np.asarray(grid0, np.float32)).to(torch.bfloat16))
    w_t = torch.nn.Parameter(torch.from_numpy(w0))
    opt = MaskedAdam([ParamGroup("grid", [grid_t], 0.1, True), ParamGroup("w", [w_t], 0.01, False)])
    assert opt.exp_avg[grid_t].dtype == torch.float32
    for (gg, gw), sc in zip(grads, lr_scales):
        grid_t.grad = torch.from_numpy(gg).to(torch.bfloat16)
        w_t.grad = torch.from_numpy(gw)
        opt.step(lr_scale=sc)
    assert grid_t.dtype == torch.bfloat16
    _close(grid_t, np.asarray(params["grid"], np.float32), rtol=2.0**-7)
    _close(w_t, params["w"])
    _close(opt.exp_avg[grid_t], state.exp_avg["grid"])
    _close(opt.exp_avg_sq[grid_t], state.exp_avg_sq["grid"])
    _close(opt.exp_avg_sq[w_t], state.exp_avg_sq["w"])
    untouched = np.all(np.stack([gg for gg, _ in grads]) == 0, axis=0)
    assert untouched.any()
    np.testing.assert_array_equal(grid_t.detach().float().numpy()[untouched],
                                  np.asarray(grid0, np.float32)[untouched])
