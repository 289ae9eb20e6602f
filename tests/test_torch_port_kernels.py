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


# shapes whose rows, planes and banks are no multiple of a 16-byte vector, one
# element, and a tensor smaller than a vector
RAGGED_TV_SHAPES = [(2, 7, 9, 11, 1), (3, 5, 7, 199, 12), (1, 1, 1, 1, 1), (1, 2, 1, 3, 5)]


@pytest.mark.parametrize("shape", [(2, 9, 8, 6, 2), (5, 5, 5, 1), (1, 4, 16, 10, 3),
                                   (3, 1, 6, 5, 2)] + RAGGED_TV_SHAPES)
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


@pytest.mark.parametrize("n,s", [(40, 33), (37, 17), (37, 96), (5, 200), (2048, 96), (1, 17),
                                 (37, 1)])
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


# S of 1, under, over and far over a warp's 32 lanes and the backward kernel's
# group of 96 samples; N no multiple of the eight rays of a block
RAGGED_MARCH_SHAPES = [(37, 1), (13, 31), (37, 33), (37, 96), (11, 130), (3, 200)]


@pytest.mark.parametrize("n,s", RAGGED_MARCH_SHAPES)
def test_march_backward_formula_matches_pallas_at_ragged_shapes(n, s):
    """As above at the shapes the warp-a-ray kernel is held to on the card,
    with rays that end at their first sample and rays whose far half is
    masked off. The Pallas kernel scans sequentially and the plain version by
    ``cumsum``: every element within ``march_backward_tolerance`` (1e-5 of the
    terms of g_alpha before they cancel, 1e-7 absolute)."""
    density, mask = _march_data(2, n=n, s=s)
    density[::7, 0] = 30.0
    mask[::7, 0] = True
    mask[1::7, s // 2 + 1:] = False
    shift, interval = -1.0, 0.5
    cw, cl, _ = _cotangents(n, s)
    want = _pallas_vjp(density, mask, shift, interval, cw, cl, np.zeros_like(cw))
    d, m = torch.from_numpy(density), torch.from_numpy(mask)
    alpha = torch.where(m, march.alpha_ops.raw2alpha(d, shift, interval), 0.0)
    t_excl = torch.cat([torch.ones(n, 1), torch.cumprod(1 - alpha, -1)[:, :-1]], -1)
    _, ai, _ = march.fused_alpha2weights_plain(d, m, shift, interval)
    args = (alpha, t_excl, ai, torch.from_numpy(cw), torch.from_numpy(cl), shift, interval, d, m)
    got = march.march_backward_plain(*args)
    assert got.shape == (n, s) and bool((got[~m] == 0).all())
    if s > 1:  # a ray that ends at its first sample gives the others no gradient
        assert bool((got[::7, 1:] == 0).all()) and bool((t_excl[::7, 1:] < 1e-3).all())
    tol = march.march_backward_tolerance(*args)
    excess = ((got - torch.from_numpy(want.copy())).abs() / tol).max()
    assert float(excess) <= 1.0, float(excess)


def test_march_backward_wrapper_refuses_wrong_inputs(monkeypatch):
    """Shapes, dtypes and devices are checked before the launch."""
    monkeypatch.setattr(march, "_check", lambda density, mask: None)
    d = torch.zeros(4, 8)
    m = torch.ones(4, 8, dtype=torch.bool)
    good = dict(alpha=d, t_excl=d, alphainv=d[:, 0], gw=d, gl=d[:, 0])
    for name, bad in (("gw", d[:, :7]), ("gl", d[:3, 0]), ("alpha", d.double()),
                      ("alphainv", d), ("t_excl", d.to("meta"))):
        kw = {**good, name: bad}
        with pytest.raises(TypeError, match=name):
            march.march_backward(kw["alpha"], kw["t_excl"], kw["alphainv"], kw["gw"], kw["gl"],
                                 0.0, 0.5, d, m)


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


@pytest.mark.parametrize("needs_grad", [True, False])
def test_fused_march_picks_its_route_by_the_gradient(monkeypatch, needs_grad):
    """On a CUDA tensor ``fused_alpha2weights`` runs FusedMarch where density
    needs a gradient, and else the forward alone without residuals. Held here
    with the launch replaced by a recorder (the route is Python's choice)."""
    calls = []

    def fake_forward(density, mask, shift, interval, residuals=True):
        calls.append(residuals)
        w, ai, alpha = march.fused_alpha2weights_plain(density, mask, shift, interval)
        return w, ai, alpha, torch.ones_like(w) if residuals else w.new_empty((0, w.shape[1]))

    class OnTheCard(torch.Tensor):
        device = torch.device("cuda")

    monkeypatch.setattr(march, "march_forward", fake_forward)
    density, mask = _march_data(9, n=6, s=5)
    d = torch.from_numpy(density).requires_grad_(needs_grad).as_subclass(OnTheCard)
    out = march.fused_alpha2weights(d, torch.from_numpy(mask), -1.0, 0.5)
    assert len(out) == 3 and calls == [needs_grad]
    with torch.no_grad():
        march.fused_alpha2weights(d, torch.from_numpy(mask), -1.0, 0.5)
    assert calls == [needs_grad, False]


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
@pytest.mark.parametrize("how", ["out_of_place", "in_place", "views", "one_thread_an_element"])
@pytest.mark.parametrize("gate", [1.0, 0.0])
@pytest.mark.parametrize("shape", [(3, 9, 8, 7, 5)] + RAGGED_TV_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dense", [True, False])
def test_tv_kernel_matches_plain(cuda, dtype, dense, shape, gate, how):
    """``how``: a fresh output; ``out is grad``; param, grad and out as views
    that start 1, 3 and 2 elements past an aligned address; the kernel of one
    thread an element forced."""
    p, g = _tv_data(shape, seed=11)
    pt = torch.from_numpy(p).to("cuda", dtype)
    gt = torch.from_numpy(g).to("cuda", dtype)
    want = tv.tv_add_grad_plain(pt.float(), gt.float(), *W3, gate, dense)
    if how == "out_of_place":
        got = tv.tv_add_grad(pt, gt, *W3, gate, dense)
    elif how == "in_place":
        got = tv.tv_add_grad(pt, gt, *W3, gate, dense, out=gt)
        assert got is gt
    elif how == "views":
        n = pt.numel()
        bufs = [torch.zeros(n + 8, device="cuda", dtype=dtype) for _ in range(3)]
        pv, gv, got = (b[o:o + n].view(shape) for b, o in zip(bufs, (1, 3, 2)))
        pv.copy_(pt)
        gv.copy_(gt)
        tv.tv_add_grad(pv, gv, *W3, gate, dense, out=got)
        assert all(float(b[:o].abs().sum() + b[o + n:].abs().sum()) == 0.0
                   for b, o in zip(bufs, (1, 3, 2))), "wrote outside the views"
    else:
        got = tv._launch(pt, gt, torch.empty_like(gt), *W3, gate, dense, simple=True)
    if dtype == torch.bfloat16:
        _assert_bf16_rounding_of(got, want.cpu().numpy())
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _rays_without_threshold_flip(t_excl, alpha_ref):
    """The forward kernel multiplies the transmittance in another order than
    ``cumprod``: a sample within rounding (1e-5 relative) of the early-exit
    threshold may be processed by one of the two only. At most one such sample
    is let through; its ray is left out of the elementwise comparison."""
    t_ref = torch.cat([torch.ones_like(alpha_ref[:, :1]),
                       torch.cumprod(1 - alpha_ref, -1)[:, :-1]], -1)
    thres = march.alpha_ops.EARLY_EXIT_T
    flipped = (t_excl >= thres) != (t_ref >= thres)
    assert int(flipped.sum()) <= 1
    assert bool(((t_ref[flipped] - thres).abs() <= 1e-5 * thres).all())
    return ~flipped.any(-1), t_ref


@pytest.mark.cuda
@pytest.mark.parametrize("n,s", [(300, 70)] + [(n, s) for s in (1, 17, 31, 33, 96, 130, 200)
                                              for n in (0, 1, 37, 2048)])
def test_march_kernels_match_plain(cuda, n, s):
    density, mask = _march_data(8, n=n, s=s)
    density[::7, 0] = 30.0  # rays that end at their first sample
    mask[::7, 0] = True
    mask[1::7, s // 2 + 1:] = False  # masked tails
    d = torch.from_numpy(density).cuda()
    m = torch.from_numpy(mask).cuda()
    w, ai, alpha, t_excl = march.march_forward(d, m, -1.0, 0.5)
    assert (w.shape, ai.shape, alpha.shape, t_excl.shape) == ((n, s), (n,), (n, s), (n, s))
    # without a gradient: the same values, and no residual kept
    with torch.no_grad():
        lean = march.fused_alpha2weights(d, m, -1.0, 0.5)
    for got, want in zip(lean, (w, ai, alpha)):
        assert got.shape == want.shape and torch.equal(got, want)
    cw, cl, ca = (torch.from_numpy(c).cuda() for c in _cotangents(n, s))
    if n == 0:
        assert march.march_backward(alpha, t_excl, ai, cw, cl, -1.0, 0.5, d, m).shape == (0, s)
        return
    w_ref, ai_ref, alpha_ref = march.fused_alpha2weights_plain(d, m, -1.0, 0.5)
    same, t_ref = _rays_without_threshold_flip(t_excl, alpha_ref)
    for got, want in ((w, w_ref), (ai, ai_ref), (alpha, alpha_ref), (t_excl, t_ref)):
        torch.testing.assert_close(got[same], want[same], rtol=1e-5, atol=1e-6)
    # the backward kernel, fed by the forward's residuals: it sums gw * w in
    # another order than the plain version's cumsum, which the tolerance
    # allows for and nothing else
    args = (alpha, t_excl, ai, cw, cl, -1.0, 0.5, d, m)
    want = march.march_backward_plain(*args)
    tol = march.march_backward_tolerance(*args)
    gd = march.march_backward(*args)
    assert bool(torch.isfinite(gd).all())
    assert float(((gd - want).abs() / tol).max()) <= 1.0
    # the same through autograd, with the direct alpha cotangent added
    dg = d.clone().requires_grad_(True)
    w2, ai2, alpha2 = march.fused_alpha2weights(dg, m, -1.0, 0.5)
    assert torch.equal(w2, w) and torch.equal(ai2, ai) and torch.equal(alpha2, alpha)
    (torch.sum(w2 * cw) + torch.sum(ai2 * cl) + torch.sum(alpha2 * ca)).backward()
    direct = ca * march._dalpha_ddensity(d, -1.0, 0.5) * m
    assert float(((dg.grad - (want + direct)).abs() / (tol + 1e-6 * direct.abs())).max()) <= 1.0


@pytest.mark.cuda
def test_march_backward_takes_an_expanded_cotangent(cuda):
    """``loss = weights.sum()`` hands the backward a cotangent of stride 0."""
    density, mask = _march_data(5, n=37, s=33)
    d = torch.from_numpy(density).cuda().requires_grad_(True)
    m = torch.from_numpy(mask).cuda()
    w, ai, _ = march.fused_alpha2weights(d, m, -1.0, 0.5)
    (w.sum() + ai.sum()).backward()
    alpha, t_excl = (x.detach() for x in march.march_forward(d.detach(), m, -1.0, 0.5)[2:])
    args = (alpha, t_excl, ai.detach(), torch.ones_like(w), torch.ones_like(ai), -1.0, 0.5,
            d.detach(), m)
    want = march.march_backward_plain(*args)
    tol = march.march_backward_tolerance(*args)
    assert float(((d.grad - want).abs() / tol).max()) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("n,s", [(0, 5), (1, 1), (37, 33), (33, 95), (4096, 1063), (70, 200),
                                 (65, 1063), (33, 129), (31, 257)])
def test_cumdist_thres_kernel_matches_plain(cuda, n, s):
    """The DCVGO oversample skip: the kernel walks each ray's distances in the
    plain version's order with the plain version's float operations, so the
    flags are equal, not close. Besides random distances with tails of
    zeros: sums that run across the kernel's pieces of 128 samples before
    they pass the threshold, distances exactly at it and at half of it, and a
    tensor that starts 4 bytes past a 16-byte boundary."""
    from unboundednerfpytorch_tpu_torch.ops import sampling
    from unboundednerfpytorch_tpu_torch.ops.cuda import build
    from unboundednerfpytorch_tpu_torch.ops.cuda.ub360 import cumdist_thres

    thres = 0.0061
    at = np.float32(thres)
    rng = np.random.RandomState(n + s)
    dist = (rng.rand(n, s) * 0.01).astype(np.float32)
    dist[::5, s // 3:] = 0.0  # rays that stop moving
    long_runs = (rng.rand(n, s) * (thres / 60)).astype(np.float32)
    exact = np.full((n, s), at, np.float32)
    exact[1::2] = at / 2
    for i, case in enumerate((dist, long_runs, exact)):
        want = sampling.cumdist_thres_plain(torch.from_numpy(case), thres)
        build.reset_launch_counts()
        got = cumdist_thres(torch.from_numpy(case).cuda(), thres)
        assert got.dtype == torch.bool and got.shape == (n, s) and got.is_cuda
        assert torch.equal(got.cpu(), want), i
        assert build.LAUNCHES["cumdist_thres"] == (1 if n else 0)  # no launch for no ray
    store = torch.zeros(n * s + 1, device="cuda")
    view = store[1:].view(n, s)
    view.copy_(torch.from_numpy(dist))
    assert torch.equal(cumdist_thres(view, thres).cpu(),
                       sampling.cumdist_thres_plain(torch.from_numpy(dist), thres))
