"""Fused TV-gradient injection: the CUDA kernel's wrapper and its plain version.

Counterpart of ``unboundednerfpytorch_tpu/ops/pallas/tv.py::tv_add_grad``
(the TPU kernel). Computes

    out = grad + gate * where(dense | grad != 0, tv_grad(param), 0)

over channel-last ``[..., X, Y, Z, C]`` grids in f32 math for f32 and bf16
grids. The kernel is ``csrc/tv.cu``; ``tv_add_grad_plain`` is the same
function written with :func:`..tv.total_variation_grad`.

:func:`tv_add_grad` takes the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises. The launch is the
``torch.library`` custom op ``unerf_kernels::tv_add_grad`` (it mutates
``out``), so that ``torch.profiler`` credits the kernel to the op and to the
``record_function`` range around it.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from unboundednerfpytorch_tpu_torch.ops import tv as tv_ops
from unboundednerfpytorch_tpu_torch.ops.cuda import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def tv_add_grad_plain(param, grad, wx, wy, wz, gate, dense, out=None):
    """Plain PyTorch version (f32 math, cast back to the grad dtype)."""
    pf = param.float()
    gf = grad.float()
    tvg = tv_ops.total_variation_grad(pf, wx, wy, wz, dense_mode=True)
    keep = (gf != 0) | bool(dense)
    res = (gf + tvg * keep.to(torch.float32) * float(gate)).to(grad.dtype)
    if out is None:
        return res
    out.copy_(res)
    return out


@torch.library.custom_op("unerf_kernels::tv_add_grad", mutates_args=("out",))
def _tv_add_grad_op(param: Tensor, grad: Tensor, out: Tensor, B: int, X: int, Y: int, Z: int,
                    C: int, wx: float, wy: float, wz: float, gate: float,
                    dense: bool) -> None:
    lib = build.load("tv")
    fn = lib.tv_add_grad
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float] * 4 + [
        ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream(param.device).cuda_stream
    err = fn(param.data_ptr(), grad.data_ptr(), out.data_ptr(), _DTYPE_CODE[param.dtype],
             B, X, Y, Z, C, wx / 6.0, wy / 6.0, wz / 6.0, float(gate), int(bool(dense)),
             stream)
    build.check(lib, err, "tv_add_grad")
    build.LAUNCHES["tv_add_grad"] += 1


def _launch(param, grad, out, wx, wy, wz, gate, dense):
    if not (param.is_cuda and grad.is_cuda and out.is_cuda):
        raise ValueError("tv_add_grad: all tensors must be on the GPU")
    if param.dtype not in _DTYPE_CODE:
        raise TypeError(f"tv_add_grad: unsupported dtype {param.dtype}")
    if not (param.dtype == grad.dtype == out.dtype):
        raise TypeError("tv_add_grad: param, grad and out must share a dtype")
    if not (param.shape == grad.shape == out.shape):
        raise ValueError(f"tv_add_grad: shape mismatch {param.shape} {grad.shape} {out.shape}")
    if param.ndim < 4:
        raise ValueError(f"tv_add_grad: need [..., X, Y, Z, C], got {tuple(param.shape)}")
    if not (param.is_contiguous() and grad.is_contiguous() and out.is_contiguous()):
        raise ValueError("tv_add_grad: tensors must be contiguous")
    X, Y, Z, C = (int(v) for v in param.shape[-4:])
    B = 1
    for d in param.shape[:-4]:
        B *= int(d)
    if X * Y * Z * C >= 2**31:
        raise ValueError("tv_add_grad: one bank must hold fewer than 2^31 elements")
    _tv_add_grad_op(param, grad, out, B, X, Y, Z, C, wx, wy, wz, float(gate), bool(dense))
    return out


def tv_add_grad(param: torch.Tensor, grad: torch.Tensor, wx: float, wy: float, wz: float,
                gate, dense, out: torch.Tensor | None = None) -> torch.Tensor:
    """``grad + gate * where(dense | grad != 0, tv_grad(param), 0)``.

    ``gate`` and ``dense`` are host scalars. ``out`` may be ``grad`` itself
    (in-place injection, which the train step uses to avoid a grid-sized
    copy). The /6 weight fold happens here, as in the TPU wrapper.
    """
    if param.device.type == "cpu":
        return tv_add_grad_plain(param, grad, wx, wy, wz, gate, dense, out=out)
    if out is None:
        out = torch.empty_like(grad)
    return _launch(param, grad, out, float(wx), float(wy), float(wz), gate, dense)
