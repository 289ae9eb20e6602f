"""Masked Adam's update: the CUDA kernel's wrapper and its plain version.

Counterpart of ``unboundednerfpytorch_tpu/optim/masked_adam.py::update``
(without ``per_lr``) and of the reference's CUDA kernel ``adam_upd_cuda``.
Per element, in place: the moments move towards the gradient, the parameter
takes a step of ``step_size * m1 / (sqrt(v1) + eps)`` in f32 and is rounded
back to its own dtype; for a ``skip_zero_grad`` group an element whose
gradient is exactly 0 keeps its value and moments.

:func:`masked_adam` runs :func:`masked_adam_plain` for a tensor on the CPU
(in slices of ``chunk`` elements); for a tensor on any other device it
launches ``csrc/adam.cu`` over the whole tensor, which makes no temporaries,
or raises. The launch is the ``torch.library`` custom op
``unerf_kernels::masked_adam``, which takes p bf16 or f32, a grad of p's
dtype (or none) and f32 moments, contiguous, of one shape, on one CUDA
device.
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
                      chunk: int | None = None) -> None:
    """The update in PyTorch operations, in place, ``grad`` None counting as
    zero. It makes f32 temporaries of its input's size, so it runs over
    slices of ``chunk`` elements (None: the whole tensor at once); the
    arithmetic of an element does not depend on the slice."""
    n = p.numel()
    chunk = chunk or max(n, 1)
    flat = [x.view(-1) for x in (p, m, v)]
    g = None if grad is None else grad.reshape(-1)
    for a in range(0, n, chunk):
        _plain_slice(*(x[a:a + chunk] for x in flat), None if g is None else g[a:a + chunk],
                     step_size, b1, b2, eps, skip_zero_grad)


def _plain_slice(p, m, v, grad, step_size, b1, b2, eps, skip_zero_grad) -> None:
    grad = torch.zeros_like(m) if grad is None else grad.to(m.dtype)
    m1 = m * b1 + grad * (1.0 - b1)
    v1 = v * b2 + grad * (1.0 - b2) * grad
    upd = (p.to(m.dtype) - step_size * m1 / (torch.sqrt(v1) + eps)).to(p.dtype)
    if skip_zero_grad:
        keep = grad != 0
        del grad
        m.copy_(torch.where(keep, m1, m))
        v.copy_(torch.where(keep, v1, v))
        p.copy_(torch.where(keep, upd, p))
    else:
        m.copy_(m1)
        v.copy_(v1)
        p.copy_(upd)


def _check_args(p: Tensor, m: Tensor, v: Tensor, grad: Optional[Tensor]) -> None:
    """Raise unless the kernel takes these tensors."""
    if p.dtype not in P_DTYPES or m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"masked_adam: need p bf16 or f32 and f32 moments, got p {p.dtype}, "
                        f"m {m.dtype}, v {v.dtype}")
    if grad is not None and grad.dtype != p.dtype:
        raise TypeError(f"masked_adam: grad {grad.dtype} for a {p.dtype} parameter")
    tensors = (p, m, v) if grad is None else (p, m, v, grad)
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
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int] + [
        ctypes.c_double] * 4 + [ctypes.c_int, ctypes.c_void_p]
    return lib, fn


@torch.library.custom_op("unerf_kernels::masked_adam", mutates_args=("p", "m", "v"))
def _masked_adam_op(p: Tensor, m: Tensor, v: Tensor, grad: Optional[Tensor], step_size: float,
                    b1: float, b2: float, eps: float, skip_zero_grad: bool) -> None:
    _check_args(p, m, v, grad)
    lib, fn = _function()
    stream = torch.cuda.current_stream(p.device).cuda_stream
    err = fn(p.data_ptr(), m.data_ptr(), v.data_ptr(), None if grad is None else grad.data_ptr(),
             p.numel(), int(p.dtype == torch.bfloat16), step_size, b1, b2, eps,
             int(skip_zero_grad), stream)
    build.check(lib, err, "masked_adam")
    build.LAUNCHES["masked_adam"] += 1


def masked_adam(p: Tensor, m: Tensor, v: Tensor, grad: Optional[Tensor], step_size: float,
                b1: float, b2: float, eps: float, skip_zero_grad: bool,
                chunk: int | None = None) -> None:
    """One update of ``p`` and its moments ``m``, ``v`` in place from
    ``grad`` (None: no grad, which counts as zero). ``chunk``: the plain
    version's slice on the CPU; the kernel needs none. A skip group's
    parameter without a grad, or an empty one, does not change, and nothing
    is launched for it."""
    if p.device.type == "cpu":
        masked_adam_plain(p, m, v, grad, step_size, b1, b2, eps, skip_zero_grad, chunk)
        return
    _check_args(p, m, v, grad)  # a meta tensor would pass the op by its trivial fake kernel
    if p.numel() and not (grad is None and skip_zero_grad):
        _masked_adam_op(p.detach(), m, v, None if grad is None else grad.detach(),
                        float(step_size), float(b1), float(b2), float(eps), bool(skip_zero_grad))
