"""Masked Adam's update: the CUDA kernel's wrapper and its plain version.

Counterpart of ``unboundednerfpytorch_tpu/optim/masked_adam.py::update`` and
of the reference's CUDA kernels ``adam_upd_cuda`` and its per-voxel-lr
variant. Per element, in place: the moments move towards the gradient, the
parameter takes a step of ``step_size * m1 / (sqrt(v1) + eps)`` in f32 (times
the element's learning rate ``per_lr`` where one is given) and is rounded
back to its own dtype; for a ``skip_zero_grad`` group without ``per_lr`` an
element whose gradient is exactly 0 keeps its value and moments.

:func:`masked_adam` runs :func:`masked_adam_plain` for a tensor on the CPU
(in slices of ``chunk`` elements); for a tensor on any other device it
launches ``csrc/adam.cu`` over the whole tensor, which makes no temporaries,
or raises. The launch is the ``torch.library`` custom op
``unerf_kernels::masked_adam``, which takes p bf16 or f32, a grad of p's
dtype (or none), f32 moments and an f32 ``per_lr`` (or none), contiguous, of
one shape, on one CUDA device. A launch with ``per_lr`` counts under
``masked_adam_per_lr``, one without under ``masked_adam``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch import Tensor

from unboundednerfpytorch_tpu_torch.ops.cuda import build

P_DTYPES = (torch.bfloat16, torch.float32)


def masked_adam_plain(p: Tensor, m: Tensor, v: Tensor, grad: Optional[Tensor], step_size: float,
                      b1: float, b2: float, eps: float, skip_zero_grad: bool,
                      chunk: int | None = None, per_lr: Optional[Tensor] = None) -> None:
    """The update in PyTorch operations, in place, ``grad`` None counting as
    zero; with ``per_lr`` each element's step is scaled by it and every
    element is updated, whatever ``skip_zero_grad`` says. It makes f32
    temporaries of its input's size, so it runs over slices of ``chunk``
    elements (None: the whole tensor at once); the arithmetic of an element
    does not depend on the slice."""
    n = p.numel()
    chunk = chunk or max(n, 1)
    flat = [x.view(-1) for x in (p, m, v)]
    g = None if grad is None else grad.reshape(-1)
    r = None if per_lr is None else per_lr.reshape(-1)
    for a in range(0, n, chunk):
        part = slice(a, a + chunk)
        _plain_slice(*(x[part] for x in flat), None if g is None else g[part],
                     step_size, b1, b2, eps, skip_zero_grad, None if r is None else r[part])


def _plain_slice(p, m, v, grad, step_size, b1, b2, eps, skip_zero_grad, per_lr=None) -> None:
    grad = torch.zeros_like(m) if grad is None else grad.to(m.dtype)
    m1 = m * b1 + grad * (1.0 - b1)
    v1 = v * b2 + grad * (1.0 - b2) * grad
    step = step_size * m1 / (torch.sqrt(v1) + eps)
    if per_lr is not None:
        step = step * per_lr
    upd = (p.to(m.dtype) - step).to(p.dtype)
    del step
    if skip_zero_grad and per_lr is None:
        keep = grad != 0
        del grad
        m.copy_(torch.where(keep, m1, m))
        v.copy_(torch.where(keep, v1, v))
        p.copy_(torch.where(keep, upd, p))
    else:
        m.copy_(m1)
        v.copy_(v1)
        p.copy_(upd)


def _check_args(p: Tensor, m: Tensor, v: Tensor, grad: Optional[Tensor],
                per_lr: Optional[Tensor] = None) -> None:
    """Raise unless the kernel takes these tensors."""
    if p.dtype not in P_DTYPES or m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"masked_adam: need p bf16 or f32 and f32 moments, got p {p.dtype}, "
                        f"m {m.dtype}, v {v.dtype}")
    if grad is not None and grad.dtype != p.dtype:
        raise TypeError(f"masked_adam: grad {grad.dtype} for a {p.dtype} parameter")
    if per_lr is not None and per_lr.dtype != torch.float32:
        raise TypeError(f"masked_adam: per_lr {per_lr.dtype}, need f32")
    tensors = [t for t in (p, m, v, grad, per_lr) if t is not None]
    if any(t.shape != p.shape for t in tensors):
        raise ValueError(f"masked_adam: shapes {[tuple(t.shape) for t in tensors]} differ")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("masked_adam: every tensor must be contiguous")
    if not p.is_cuda or any(t.device != p.device for t in tensors):
        raise ValueError(f"masked_adam: the tensors must be on one GPU, got "
                         f"{[str(t.device) for t in tensors]}")


@functools.cache
def _function():
    """(library, masked_adam) with its C signature set, built and loaded at
    the first launch."""
    lib = build.load("adam")
    fn = lib.masked_adam
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int] + [
        ctypes.c_double] * 4 + [ctypes.c_int, ctypes.c_void_p]
    return lib, fn


@torch.library.custom_op("unerf_kernels::masked_adam", mutates_args=("p", "m", "v"))
def _masked_adam_op(p: Tensor, m: Tensor, v: Tensor, grad: Optional[Tensor], step_size: float,
                    b1: float, b2: float, eps: float, skip_zero_grad: bool,
                    per_lr: Optional[Tensor] = None) -> None:
    _check_args(p, m, v, grad, per_lr)
    lib, fn = _function()
    stream = torch.cuda.current_stream(p.device).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()
    err = fn(p.data_ptr(), m.data_ptr(), v.data_ptr(), ptr(grad), ptr(per_lr), p.numel(),
             int(p.dtype == torch.bfloat16), step_size, b1, b2, eps, int(skip_zero_grad), stream)
    build.check(lib, err, "masked_adam")
    build.LAUNCHES["masked_adam" if per_lr is None else "masked_adam_per_lr"] += 1


def masked_adam(p: Tensor, m: Tensor, v: Tensor, grad: Optional[Tensor], step_size: float,
                b1: float, b2: float, eps: float, skip_zero_grad: bool,
                chunk: int | None = None, per_lr: Optional[Tensor] = None) -> None:
    """One update of ``p`` and its moments ``m``, ``v`` in place from
    ``grad`` (None: no grad, which counts as zero), each element's step
    scaled by ``per_lr`` where it is given. ``chunk``: the plain version's
    slice on the CPU; the kernel needs none. A skip group's parameter
    without a grad and without ``per_lr``, or an empty one, does not change,
    and nothing is launched for it."""
    if p.device.type == "cpu":
        masked_adam_plain(p, m, v, grad, step_size, b1, b2, eps, skip_zero_grad, chunk, per_lr)
        return
    # a meta tensor would pass the op by its trivial fake kernel
    _check_args(p, m, v, grad, per_lr)
    if p.numel() and not (grad is None and skip_zero_grad and per_lr is None):
        _masked_adam_op(p.detach(), m, v, None if grad is None else grad.detach(),
                        float(step_size), float(b1), float(b2), float(eps), bool(skip_zero_grad),
                        per_lr)
