"""Masked Adam in the port: the plain version against the JAX package's
``update``, the CUDA wrapper's refusals and its CPU path, and (marked
``cuda``, skipped without a GPU) the kernel ``csrc/adam.cu`` against the
plain version on the card.

Tolerances: against JAX, float32 within 1e-5 relative / 1e-6 absolute (XLA
may fuse the update's products into other roundings) and a bfloat16
parameter within a bfloat16 step; the kernel against the plain version on
the card bit for bit (it runs each operation of the plain version, rounded
as PyTorch rounds it).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unboundednerfpytorch_tpu.optim import masked_adam as j_adam
from unboundednerfpytorch_tpu_torch.ops.cuda import adam, build
from unboundednerfpytorch_tpu_torch.optim.masked_adam import MaskedAdam, ParamGroup

B1, B2, EPS = 0.9, 0.99, 1e-8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _close(got: torch.Tensor, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


@pytest.mark.parametrize("skip", [True, False])
def test_masked_adam_matches_jax_without_a_grad(skip):
    """A parameter that has a grad at the first step and none at the next two
    (``.grad`` None in the port, zeros in JAX), beside one that always has
    one: with ``skip_zero_grad`` it keeps value and moments after the first
    step; without, its moments decay and it goes on moving."""
    rng = np.random.default_rng(3)
    a0 = rng.standard_normal((4, 5)).astype(np.float32)
    b0 = rng.standard_normal((6,)).astype(np.float32)
    grads = [rng.standard_normal(a0.shape).astype(np.float32) for _ in range(3)]
    gb = rng.standard_normal(b0.shape).astype(np.float32)
    params = {"a": jnp.asarray(a0), "b": jnp.asarray(b0)}
    hyper = {"a": j_adam.AdamHyper(lr=0.05, skip_zero_grad=skip),
             "b": j_adam.AdamHyper(lr=0.1, skip_zero_grad=skip)}
    state = j_adam.init(params)
    a_t, b_t = torch.nn.Parameter(torch.tensor(a0)), torch.nn.Parameter(torch.tensor(b0))
    opt = MaskedAdam([ParamGroup("a", [a_t], 0.05, skip), ParamGroup("b", [b_t], 0.1, skip)])
    after_first = None
    for t, g in enumerate(grads):
        jb = jnp.asarray(gb) if t == 0 else jnp.zeros(b0.shape)
        params, state = j_adam.update(params, {"a": jnp.asarray(g), "b": jb}, state, hyper,
                                      lr_scale=1.0 - 0.1 * t)
        a_t.grad = torch.from_numpy(g)
        b_t.grad = torch.from_numpy(gb) if t == 0 else None
        opt.step(lr_scale=1.0 - 0.1 * t)
        if t == 0:
            after_first = [x.clone() for x in (b_t.detach(), opt.exp_avg[b_t],
                                               opt.exp_avg_sq[b_t])]
    _close(a_t, params["a"])
    _close(b_t, params["b"])
    _close(opt.exp_avg[b_t], state.exp_avg["b"])
    _close(opt.exp_avg_sq[b_t], state.exp_avg_sq["b"])
    now = (b_t.detach(), opt.exp_avg[b_t], opt.exp_avg_sq[b_t])
    assert all(torch.equal(x, y) for x, y in zip(now, after_first)) == skip


def _tensors(n, dtype, device="cpu", seed=0):
    gen = torch.Generator().manual_seed(seed)
    p = torch.randn(n, generator=gen).to(dtype)
    g = (torch.randn(n, generator=gen) * (torch.rand(n, generator=gen) > 0.4)).to(dtype)
    m = torch.randn(n, generator=gen) * 0.1
    v = torch.rand(n, generator=gen) * 0.01
    return [x.to(device) for x in (p, g, m, v)]


@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [None, 1000, 7])
def test_wrapper_on_the_cpu_is_the_plain_version_in_slices(dtype, skip, chunk):
    """On the CPU the wrapper runs the plain version in slices of ``chunk``,
    bit-equal to one plain update of the whole tensor, and launches nothing."""
    p, g, m, v = _tensors(4099, dtype)
    want = [x.clone() for x in (p, m, v)]
    adam.masked_adam_plain(*want, g, 0.03, B1, B2, EPS, skip)
    build.reset_launch_counts()
    adam.masked_adam(p, m, v, g, 0.03, B1, B2, EPS, skip, chunk=chunk)
    assert not build.LAUNCHES
    for got, w in zip((p, m, v), want):
        assert got.dtype == w.dtype and torch.equal(got, w)


def _bad_args():
    """(what, p, m, v, grad, exception) the kernel does not take."""
    f32, bf16 = torch.float32, torch.bfloat16
    z = lambda *s, dt=f32: torch.zeros(s, dtype=dt)
    return [
        ("f16 p", z(8, dt=torch.float16), z(8), z(8), None, TypeError),
        ("f64 p", z(8, dt=torch.float64), z(8), z(8), None, TypeError),
        ("bf16 moments", z(8, dt=bf16), z(8, dt=bf16), z(8, dt=bf16), None, TypeError),
        ("a grad of another dtype", z(8, dt=bf16), z(8), z(8), z(8), TypeError),
        ("shapes that differ", z(8), z(8), z(9), None, ValueError),
        ("a grad of another shape", z(8), z(8), z(8), z(4, 2), ValueError),
        ("a non-contiguous p", z(4, 4).t(), z(4, 4), z(4, 4), None, ValueError),
        ("a non-contiguous grad", z(4, 4), z(4, 4), z(4, 4), z(4, 4).t(), ValueError),
        ("tensors on the CPU", z(8, dt=bf16), z(8), z(8), z(8, dt=bf16), ValueError),
    ]


@pytest.mark.parametrize("case", _bad_args(), ids=lambda c: c[0])
def test_the_op_refuses_what_the_kernel_does_not_take(case):
    """The custom op checks before it builds or launches anything: the dtypes
    (p bf16 or f32, grad p's, moments f32), one shape, contiguity, and that
    the tensors lie on one GPU."""
    _, p, m, v, grad, exc = case
    build.reset_launch_counts()
    with pytest.raises(exc, match="masked_adam"):
        torch.ops.unerf_kernels.masked_adam(p, m, v, grad, 0.1, B1, B2, EPS, True)
    assert not build.LAUNCHES


def test_wrapper_raises_for_a_tensor_off_the_cpu_and_the_gpu():
    """Only a CPU tensor takes the plain version; any other device goes to
    the op, which refuses what is not on the GPU."""
    z = lambda: torch.zeros(8, device="meta")
    build.reset_launch_counts()
    with pytest.raises(ValueError, match="GPU"):
        adam.masked_adam(z(), z(), z(), z(), 0.1, B1, B2, EPS, False)
    assert not build.LAUNCHES
    assert "masked_adam" in build.KERNELS and build.SOURCES["adam"].is_file()


# ---------------------------------------------------------------- on the card


def _bits(x):
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 8, 9, 4095, 4097, (1 << 20) + 3])
@pytest.mark.parametrize("grad", [True, False])
@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_adam_kernel_bit_equal_to_plain(cuda, dtype, skip, grad, n):
    p, g, m, v = _tensors(n, dtype, "cuda", seed=n)
    want = [x.clone() for x in (p, m, v)]
    adam.masked_adam_plain(*want, g if grad else None, 0.03, B1, B2, EPS, skip)
    build.reset_launch_counts()
    adam.masked_adam(p, m, v, g if grad else None, 0.03, B1, B2, EPS, skip)
    torch.cuda.synchronize()
    assert build.LAUNCHES["masked_adam"] == (0 if skip and not grad else 1)
    for got, w in zip((p, m, v), want):
        assert torch.equal(_bits(got), _bits(w))


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(1, 1, 1, 1), (3, 3, 3, 3), (1, 0, 0, 0), (0, 0, 2, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_adam_kernel_on_unaligned_views(cuda, dtype, offsets):
    """Views that start inside a 16-byte vector: a scalar head when p, g, m
    and v line up at the same element, one element a thread when not."""
    n = 8 * 1000 + 5
    src = _tensors(n, dtype, "cuda", seed=1)
    views = []
    for x, o in zip(src, offsets):
        buf = torch.empty(n + o, dtype=x.dtype, device="cuda")
        views.append(buf[o:])
        views[-1].copy_(x)
    p, g, m, v = views
    want = [x.clone() for x in (p, m, v)]
    adam.masked_adam_plain(*want, g, 0.03, B1, B2, EPS, True)
    adam.masked_adam(p, m, v, g, 0.03, B1, B2, EPS, True)
    torch.cuda.synchronize()
    for got, w in zip((p, m, v), want):
        assert torch.equal(_bits(got), _bits(w))


@pytest.mark.cuda
def test_masked_adam_step_on_the_card_launches_once_a_parameter(cuda):
    """``MaskedAdam.step`` on the card: one launch for every parameter but a
    skip group's without a grad, bit-equal to the plain version on the CPU's
    copy of the same state (the CPU and the card round each operation
    alike)."""
    gen = torch.Generator().manual_seed(0)
    shapes = {"grid": (2, 9, 8, 7, 3), "w": (5, 4), "idle": (3, 3)}
    cpu = {k: torch.nn.Parameter(torch.randn(s, generator=gen).to(torch.bfloat16))
           for k, s in shapes.items()}
    dev = {k: torch.nn.Parameter(x.detach().cuda()) for k, x in cpu.items()}
    opts = [MaskedAdam([ParamGroup("grid", [ps["grid"]], 0.1, True),
                        ParamGroup("w", [ps["w"]], 1e-3, False),
                        ParamGroup("idle", [ps["idle"]], 0.1, True)]) for ps in (cpu, dev)]
    for t in range(3):
        g = torch.randn(shapes["grid"], generator=gen).to(torch.bfloat16)
        gw = torch.randn(shapes["w"], generator=gen).to(torch.bfloat16)
        for ps, opt in zip((cpu, dev), opts):
            ps["grid"].grad = g.to(ps["grid"].device)
            ps["w"].grad = gw.to(ps["w"].device)
            build.reset_launch_counts()
            opt.step(lr_scale=math.pow(0.9, t))
        assert build.LAUNCHES["masked_adam"] == 2
    torch.cuda.synchronize()
    for k in shapes:
        assert torch.equal(_bits(dev[k].detach().cpu()), _bits(cpu[k].detach()))
        assert torch.equal(opts[1].exp_avg_sq[dev[k]].cpu(), opts[0].exp_avg_sq[cpu[k]])
