"""Fused raw2alpha + transmittance scan: CUDA kernels, autograd wrapper and
plain version.

Counterpart of ``unboundednerfpytorch_tpu/ops/pallas/march.py::
fused_alpha2weights`` (two TPU kernels under a ``jax.custom_vjp``):

  forward : alpha = 1 - exp(-softplus(d + shift) * interval) (masked),
            w = T * alpha with the early exit at T < 1e-3, alphainv_last;
  backward: the reverse-scan density gradient, chained through the
            raw2alpha derivative, plus the direct alpha-output cotangent.

:func:`fused_alpha2weights` runs :func:`fused_alpha2weights_plain` (the
``ops/alpha.py`` cumprod scan under autograd) for CPU tensors only; for CUDA
tensors it runs the kernels of ``csrc/march.cu`` under :class:`FusedMarch`
or raises. ``shift`` and ``interval`` get no gradient, nor does ``mask``.

The two launches are registered as ``torch.library`` custom ops
(``unerf_kernels::march_forward`` / ``march_backward``): the libraries stay
plain C loaded with ``ctypes``, but each launch now runs inside a dispatcher
op, which is what ``torch.profiler`` needs to credit the kernel's device
time to the op and to the ``record_function`` ranges around it.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from unboundednerfpytorch_tpu_torch.ops import alpha as alpha_ops
from unboundednerfpytorch_tpu_torch.ops.cuda import build


def fused_alpha2weights_plain(density, mask, shift, interval):
    """Plain PyTorch version: (weights [N,S], alphainv_last [N], alpha [N,S])
    with alpha masked, differentiable through autograd."""
    alpha = alpha_ops.raw2alpha(density, shift, interval)
    alpha = torch.where(mask, alpha, torch.zeros_like(alpha))
    w, ai = alpha_ops.alpha2weights(alpha)
    return w, ai, alpha


def _dalpha_ddensity(density, shift, interval):
    e = torch.exp(torch.clamp(density + shift, -50.0, 50.0))
    return interval * torch.pow(1.0 + e, -interval - 1.0) * torch.clamp_max(e, 1e10)


def march_backward_plain(alpha, t_excl, alphainv, gw, gl, shift, interval, density, mask):
    """Plain PyTorch version of the backward kernel's formula (the reverse
    scan as a suffix sum), which the kernel is held against. Autograd of
    :func:`fused_alpha2weights_plain` computes the same gradient by another
    route; the two differ where alpha is near 1 (division by 1 - alpha)."""
    processed = t_excl >= alpha_ops.EARLY_EXIT_T
    gww = torch.where(processed, gw * (t_excl * alpha), torch.zeros_like(gw))
    suffix = torch.flip(torch.cumsum(torch.flip(gww, [-1]), -1), [-1]) - gww
    back = suffix + (gl * alphainv)[:, None]
    g_alpha = torch.where(processed, gw * t_excl - back / (1.0 - alpha + 1e-10),
                          torch.zeros_like(gw))
    return g_alpha * _dalpha_ddensity(density, shift, interval) * mask.to(gw.dtype)


def _check(density, mask):
    if not (density.is_cuda and mask.is_cuda):
        raise ValueError("fused_alpha2weights: tensors must be on the GPU")
    if density.dtype != torch.float32 or density.ndim != 2:
        raise TypeError(f"fused_alpha2weights: need f32 [N, S] density, got "
                        f"{density.dtype} {tuple(density.shape)}")
    if mask.dtype != torch.bool or mask.shape != density.shape:
        raise TypeError("fused_alpha2weights: mask must be bool and match density")


@torch.library.custom_op("unerf_kernels::march_forward", mutates_args=())
def _march_forward_op(density: Tensor, mask: Tensor, shift: float,
                      interval: float) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    N, S = density.shape
    w = torch.empty_like(density)
    alpha = torch.empty_like(density)
    t_excl = torch.empty_like(density)
    ai = torch.empty((N,), dtype=density.dtype, device=density.device)
    lib = build.load("march")
    fn = lib.march_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
                   ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
    stream = torch.cuda.current_stream(density.device).cuda_stream
    err = fn(density.data_ptr(), mask.data_ptr(), float(shift), float(interval), N, S,
             w.data_ptr(), ai.data_ptr(), alpha.data_ptr(), t_excl.data_ptr(), stream)
    build.check(lib, err, "march_forward")
    build.LAUNCHES["march_forward"] += 1
    return w, ai, alpha, t_excl


def march_forward(density, mask, shift: float, interval: float):
    """Launch the forward kernel: (weights, alphainv, alpha, t_excl)."""
    _check(density, mask)
    return _march_forward_op(density.contiguous(), mask.contiguous(), float(shift),
                             float(interval))


@torch.library.custom_op("unerf_kernels::march_backward", mutates_args=())
def _march_backward_op(alpha: Tensor, t_excl: Tensor, alphainv: Tensor, gw: Tensor,
                       gl: Tensor, shift: float, interval: float, density: Tensor,
                       mask: Tensor) -> Tensor:
    N, S = density.shape
    gd = torch.empty_like(density)
    lib = build.load("march")
    fn = lib.march_backward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_float] + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]
    stream = torch.cuda.current_stream(density.device).cuda_stream
    err = fn(alpha.data_ptr(), t_excl.data_ptr(), alphainv.data_ptr(), gw.data_ptr(),
             gl.data_ptr(), float(shift), float(interval), density.data_ptr(),
             mask.data_ptr(), N, S, gd.data_ptr(), stream)
    build.check(lib, err, "march_backward")
    build.LAUNCHES["march_backward"] += 1
    return gd


def march_backward(alpha, t_excl, alphainv, gw, gl, shift: float, interval: float,
                   density, mask):
    """Launch the backward kernel: d(loss)/d(density) through weights and
    alphainv_last (without the direct alpha cotangent)."""
    _check(density, mask)
    N, S = density.shape
    tensors = [t.contiguous() for t in (alpha, t_excl, alphainv, gw, gl, density, mask)]
    alpha, t_excl, alphainv, gw, gl, density, mask = tensors
    for t in (alpha, t_excl, gw):
        if t.shape != (N, S) or t.dtype != torch.float32:
            raise TypeError("march_backward: [N, S] f32 inputs expected")
    for t in (alphainv, gl):
        if t.shape != (N,) or t.dtype != torch.float32:
            raise TypeError("march_backward: [N] f32 inputs expected")
    return _march_backward_op(alpha, t_excl, alphainv, gw, gl, float(shift), float(interval),
                              density, mask)


class FusedMarch(torch.autograd.Function):
    """The CUDA kernels under autograd; differentiable w.r.t. density only."""

    @staticmethod
    def forward(ctx, density, mask, shift, interval):
        w, ai, alpha, t_excl = march_forward(density, mask, shift, interval)
        ctx.save_for_backward(alpha, t_excl, ai, density, mask)
        ctx.shift = float(shift)
        ctx.interval = float(interval)
        # unused outputs arrive as None, so an unused alpha costs nothing
        ctx.set_materialize_grads(False)
        return w, ai, alpha

    @staticmethod
    def backward(ctx, gw, gl, galpha):
        alpha, t_excl, ai, density, mask = ctx.saved_tensors
        if gw is None:
            gw = torch.zeros_like(alpha)
        if gl is None:
            gl = torch.zeros_like(ai)
        gd = march_backward(alpha, t_excl, ai, gw, gl, ctx.shift, ctx.interval,
                            density, mask)
        if galpha is not None:
            gd = gd + galpha * _dalpha_ddensity(density, ctx.shift, ctx.interval) * mask
        return gd, None, None, None


def fused_alpha2weights(density: torch.Tensor, mask: torch.Tensor, shift, interval):
    """Fused raw2alpha + transmittance scan.

    density [N, S] f32 raw grid values; mask [N, S] bool live samples;
    ``shift``/``interval`` host scalars. Returns (weights [N, S],
    alphainv_last [N], alpha [N, S] masked).
    """
    if density.device.type == "cpu":
        return fused_alpha2weights_plain(density, mask, shift, interval)
    return FusedMarch.apply(density, mask, float(shift), float(interval))
