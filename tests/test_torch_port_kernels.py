"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version (the kernels are CUDA
and run only on the card); those plain versions are held here against the
Pallas kernels in interpret mode, on the cases of ``test_tv_pallas.py`` and
``test_pallas_march.py``. Tests marked ``cuda`` launch the kernels and skip
without a GPU; ``chip_smoke.py`` runs the same comparisons at full size.

Tolerances: float32 results within 1e-5 relative (sums are taken in another
order); each bfloat16 output element within half a bfloat16 step of the
float32 result on the same inputs (the one rounding its store may add), plus
the float32 tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unboundednerfpytorch_tpu.ops import alpha as jalpha
from unboundednerfpytorch_tpu.ops.pallas import march as pmarch
from unboundednerfpytorch_tpu.ops.pallas import tv as ptv
from unboundednerfpytorch_tpu_torch.ops.cuda import march, tv

W3 = (0.31, 0.11, 0.07)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _assert_bf16_rounding_of(got, want32):
    """Each element of the bfloat16 ``got`` is the float32 ``want32`` rounded
    once: |got - want32| <= half a bfloat16 step + 1e-5 |want32| + 1e-6."""
    assert got.dtype == torch.bfloat16
    want32 = torch.from_numpy(np.array(want32, np.float32))
    step = torch.ldexp(torch.ones_like(want32), torch.frexp(want32).exponent - 8)
    diff = (got.cpu().float() - want32).abs()
    tol = 0.5 * step + 1e-5 * want32.abs() + 1e-6
    assert bool((diff <= tol).all()), float((diff / tol).max())


def _tv_data(shape, seed=0, sparse_frac=0.4):
    rng = np.random.RandomState(seed)
    p = rng.randn(*shape).astype(np.float32)
    g = (rng.randn(*shape) * (rng.rand(*shape) > sparse_frac)).astype(np.float32)
    return p, g


@pytest.mark.parametrize("shape", [(2, 9, 8, 6, 2), (5, 5, 5, 1), (1, 4, 16, 10, 3),
                                   (3, 1, 6, 5, 2)])
@pytest.mark.parametrize("dense", [True, False])
def test_tv_plain_matches_pallas(shape, dense):
    p, g = _tv_data(shape)
    want = ptv.tv_add_grad(jnp.asarray(p), jnp.asarray(g), *W3, 1.0, dense, interpret=True)
    got = tv.tv_add_grad(torch.from_numpy(p), torch.from_numpy(g), *W3, 1.0, dense)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_tv_gate_off_is_identity():
    p, g = _tv_data((2, 6, 5, 4, 2), seed=3)
    want = ptv.tv_add_grad(jnp.asarray(p), jnp.asarray(g), 0.5, 0.5, 0.5, 0.0, True,
                           interpret=True)
    got = tv.tv_add_grad(torch.from_numpy(p), torch.from_numpy(g), 0.5, 0.5, 0.5, 0.0, True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), g)


@pytest.mark.parametrize("dense", [True, False])
def test_tv_plain_matches_pallas_bf16(dense):
    p, g = _tv_data((2, 7, 6, 5, 3), seed=5)
    # the bf16-representable inputs, and the Pallas kernel's f32 result on them
    p32 = np.asarray(jnp.asarray(p, jnp.bfloat16), np.float32)
    g32 = np.asarray(jnp.asarray(g, jnp.bfloat16), np.float32)
    want32 = ptv.tv_add_grad(jnp.asarray(p32), jnp.asarray(g32), *W3, 1.0, dense,
                             interpret=True)
    got = tv.tv_add_grad(torch.from_numpy(p32).to(torch.bfloat16),
                         torch.from_numpy(g32).to(torch.bfloat16), *W3, 1.0, dense)
    _assert_bf16_rounding_of(got, want32)


def test_tv_in_place_into_out():
    p, g = _tv_data((2, 5, 4, 3, 2), seed=7)
    gt = torch.from_numpy(g.copy())
    out = tv.tv_add_grad(torch.from_numpy(p), gt, *W3, 1.0, True, out=gt)
    assert out is gt
    want = ptv.tv_add_grad(jnp.asarray(p), jnp.asarray(g), *W3, 1.0, True, interpret=True)
    np.testing.assert_allclose(gt.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _march_data(seed=0, n=40, s=33):
    rng = np.random.RandomState(seed)
    density = (rng.randn(n, s) * 3).astype(np.float32)
    density[::3] += 8.0  # opaque rays: the early exit fires
    mask = rng.rand(n, s) > 0.3
    return density, mask


@pytest.mark.parametrize("n,s", [(40, 33), (37, 17)])
def test_march_forward_plain_matches_pallas(n, s):
    density, mask = _march_data(n=n, s=s)
    shift, interval = -1.5, 0.6
    w, ai, alpha = pmarch.fused_alpha2weights(jnp.asarray(density), jnp.asarray(mask),
                                              shift, interval, True)
    gw, gai, galpha = march.fused_alpha2weights(torch.from_numpy(density),
                                                torch.from_numpy(mask), shift, interval)
    assert bool((np.asarray(w) == 0).any())
    np.testing.assert_allclose(galpha.numpy(), np.asarray(alpha), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gw.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gai.numpy(), np.asarray(ai), rtol=1e-5, atol=1e-6)


def _cotangents(n, s, seed=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, s).astype(np.float32), rng.randn(n).astype(np.float32),
            rng.randn(n, s).astype(np.float32))


def _pallas_vjp(density, mask, shift, interval, cw, cl, ca):
    def f(d):
        w, ai, alpha = pmarch.fused_alpha2weights(d, jnp.asarray(mask), shift, interval, True)
        return jnp.sum(w * cw) + jnp.sum(ai * cl) + jnp.sum(alpha * ca)

    return np.asarray(jax.grad(f)(jnp.asarray(density)))


def test_march_backward_formula_matches_pallas():
    """march_backward_plain (the backward kernel's formula, which the kernel
    is held against on the card) against the Pallas backward kernel."""
    n, s = 24, 19
    density, mask = _march_data(2, n=n, s=s)
    shift, interval = -1.0, 0.5
    cw, cl, _ = _cotangents(n, s)
    want = _pallas_vjp(density, mask, shift, interval, cw, cl, np.zeros_like(cw))
    d, m = torch.from_numpy(density), torch.from_numpy(mask)
    alpha = torch.where(m, march.alpha_ops.raw2alpha(d, shift, interval), 0.0)
    t_excl = torch.cat([torch.ones(n, 1), torch.cumprod(1 - alpha, -1)[:, :-1]], -1)
    _, ai, _ = march.fused_alpha2weights_plain(d, m, shift, interval)
    got = march.march_backward_plain(alpha, t_excl, ai, torch.from_numpy(cw),
                                     torch.from_numpy(cl), shift, interval, d, m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_march_plain_autograd_matches_pallas_vjp():
    """Autograd through the plain cumprod scan against the Pallas VJP (which
    divides by 1 - alpha): the two routes agree to 2e-3 relative where alpha
    is near 1, as test_pallas_march.py states for the XLA composition."""
    n, s = 24, 19
    density, mask = _march_data(2, n=n, s=s)
    shift, interval = -1.0, 0.5
    cw, cl, ca = _cotangents(n, s)
    want = _pallas_vjp(density, mask, shift, interval, cw, cl, ca)
    d = torch.from_numpy(density).requires_grad_(True)
    w, ai, alpha = march.fused_alpha2weights(d, torch.from_numpy(mask), shift, interval)
    (torch.sum(w * torch.from_numpy(cw)) + torch.sum(ai * torch.from_numpy(cl))
     + torch.sum(alpha * torch.from_numpy(ca))).backward()
    np.testing.assert_allclose(d.grad.numpy(), want, rtol=2e-3, atol=2e-5)


def test_fused_march_autograd_wiring(monkeypatch):
    """FusedMarch (the autograd.Function around the kernels) with each
    kernel replaced by its plain version, on the CPU: its backward chains
    the weights/alphainv cotangents through the backward kernel and adds
    the direct alpha cotangent, as the Pallas VJP does."""

    def fwd_plain(density, mask, shift, interval):
        alpha = torch.where(mask, march.alpha_ops.raw2alpha(density, shift, interval), 0.0)
        t_excl = torch.cat([torch.ones_like(alpha[:, :1]),
                            torch.cumprod(1 - alpha, -1)[:, :-1]], -1)
        w, ai = march.alpha_ops.alpha2weights(alpha)
        return w, ai, alpha, t_excl

    monkeypatch.setattr(march, "march_forward", fwd_plain)
    monkeypatch.setattr(march, "march_backward", march.march_backward_plain)
    n, s = 24, 19
    density, mask = _march_data(4, n=n, s=s)
    shift, interval = -1.0, 0.5
    cw, cl, ca = _cotangents(n, s, seed=5)
    want = _pallas_vjp(density, mask, shift, interval, cw, cl, ca)
    d = torch.from_numpy(density).requires_grad_(True)
    w, ai, alpha = march.FusedMarch.apply(d, torch.from_numpy(mask), shift, interval)
    (torch.sum(w * torch.from_numpy(cw)) + torch.sum(ai * torch.from_numpy(cl))
     + torch.sum(alpha * torch.from_numpy(ca))).backward()
    np.testing.assert_allclose(d.grad.numpy(), want, rtol=1e-5, atol=1e-6)


def test_plain_alpha_ops_match_jax():
    density, mask = _march_data(6)
    a_j = jalpha.raw2alpha(jnp.asarray(density), -2.0, 0.5)
    a_t = march.alpha_ops.raw2alpha(torch.from_numpy(density), -2.0, 0.5)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-6, atol=1e-7)
    w_j, ai_j = jalpha.alpha2weights(a_j, mask=jnp.asarray(mask))
    w_t, ai_t = march.alpha_ops.alpha2weights(a_t, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ai_t.numpy(), np.asarray(ai_j), rtol=1e-5, atol=1e-7)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """The launch-side checks run before anything is built."""
    d = torch.zeros(4, 8, dtype=torch.float64)
    with pytest.raises(ValueError):
        march._check(d, torch.zeros(4, 8, dtype=torch.bool))
    with pytest.raises(ValueError):
        tv._launch(torch.zeros(2, 3, 3, 3, 1), torch.zeros(2, 3, 3, 3, 1),
                   torch.zeros(2, 3, 3, 3, 1), 0.1, 0.1, 0.1, 1.0, True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dense", [True, False])
def test_tv_kernel_matches_plain(cuda, dtype, dense):
    p, g = _tv_data((3, 9, 8, 7, 5), seed=11)
    pt = torch.from_numpy(p).to("cuda", dtype)
    gt = torch.from_numpy(g).to("cuda", dtype)
    got = tv.tv_add_grad(pt, gt, *W3, 1.0, dense)
    want = tv.tv_add_grad_plain(pt.float(), gt.float(), *W3, 1.0, dense)
    if dtype == torch.bfloat16:
        _assert_bf16_rounding_of(got, want.cpu().numpy())
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_march_kernels_match_plain(cuda):
    density, mask = _march_data(8, n=300, s=70)
    d = torch.from_numpy(density).cuda()
    m = torch.from_numpy(mask).cuda()
    w, ai, alpha, t_excl = march.march_forward(d, m, -1.0, 0.5)
    w_ref, ai_ref, alpha_ref = march.fused_alpha2weights_plain(d, m, -1.0, 0.5)
    for got, want in ((w, w_ref), (ai, ai_ref), (alpha, alpha_ref)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    cw, cl, _ = (torch.from_numpy(c).cuda() for c in _cotangents(300, 70))
    gd = march.march_backward(alpha, t_excl, ai, cw, cl, -1.0, 0.5, d, m)
    want = march.march_backward_plain(alpha, t_excl, ai, cw, cl, -1.0, 0.5, d, m)
    torch.testing.assert_close(gd, want, rtol=1e-5, atol=1e-6)
