"""The DCVGO oversample skip (``cumdist_thres``): the CUDA kernel's wrapper.

Counterpart of ``unboundednerfpytorch_tpu/ops/sampling.py::cumdist_thres``
(a ``lax.scan``) and of the reference's CUDA kernel
``ub360_utils_kernel.cu:12-32``. Per ray, a running sum of the step distances
that emits True and restarts from 0 wherever it exceeds ``thres``. A loop
over bicycle's 1063 step distances would be thousands of launches a step, so the
card runs ``csrc/ub360.cu``: one thread a ray walks the samples in order,
from pieces that bulk copies bring into shared memory.

:func:`cumdist_thres` takes the plain version
(:func:`..sampling.cumdist_thres_plain`) only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises. The result carries no
gradient: the points it is computed from depend on no parameter. The launch
is the ``torch.library`` custom op ``unerf_kernels::cumdist_thres``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor

from unboundednerfpytorch_tpu_torch.ops import sampling
from unboundednerfpytorch_tpu_torch.ops.cuda import build


@functools.cache
def _function():
    """(library, cumdist_thres) with its C signature set, built and loaded at
    the first launch."""
    lib = build.load("ub360")
    fn = lib.cumdist_thres
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    return lib, fn


@torch.library.custom_op("unerf_kernels::cumdist_thres", mutates_args=())
def _cumdist_thres_op(dist: Tensor, thres: float) -> Tensor:
    N, S = dist.shape
    out = torch.empty((N, S), dtype=torch.bool, device=dist.device)
    lib, fn = _function()
    stream = torch.cuda.current_stream(dist.device).cuda_stream
    err = fn(dist.data_ptr(), float(thres), N, S, out.data_ptr(), stream)
    build.check(lib, err, "cumdist_thres")
    build.LAUNCHES["cumdist_thres"] += 1
    return out


def cumdist_thres(dist: torch.Tensor, thres: float) -> torch.Tensor:
    """dist [N, S] f32 step distances -> bool [N, S]."""
    if dist.device.type == "cpu":
        return sampling.cumdist_thres_plain(dist, thres)
    if not dist.is_cuda:
        raise ValueError("cumdist_thres: the tensor must be on the GPU")
    if dist.dtype != torch.float32 or dist.ndim != 2:
        raise TypeError(f"cumdist_thres: need f32 [N, S], got {dist.dtype} "
                        f"{tuple(dist.shape)}")
    if dist.numel() == 0:  # nothing to launch for
        return torch.zeros(dist.shape, dtype=torch.bool, device=dist.device)
    return _cumdist_thres_op(dist.detach().contiguous(), float(thres))
