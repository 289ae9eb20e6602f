"""Evaluation metrics: PSNR, SSIM, LPIPS (numpy and scipy only).

The port's own copy of ``unboundednerfpytorch_tpu/utils/metrics.py``:
mse2psnr, the mip-NeRF SSIM (separable Gaussian blur + clipped covariances),
and a lazily cached LPIPS (the ``lpips`` package is optional; a clear
ImportError is raised when it is absent).
"""

from __future__ import annotations

import numpy as np
import scipy.signal


def mse2psnr(mse: float) -> float:
    return float(-10.0 * np.log10(mse))


def psnr(img0: np.ndarray, img1: np.ndarray, max_val: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(img0) - np.asarray(img1)) ** 2))
    return float(-10.0 * np.log10(mse / (max_val**2)))


def rgb_ssim(
    img0,
    img1,
    max_val: float = 1.0,
    filter_size: int = 11,
    filter_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
    return_map: bool = False,
):
    """SSIM as mip-NeRF computes it (google-research mipnerf
    ``internal/math.py``, Apache-2.0): the canonical constants and the
    separable Gaussian window."""
    img0 = np.asarray(img0)
    img1 = np.asarray(img1)
    assert img0.ndim == 3 and img0.shape[-1] == 3 and img0.shape == img1.shape

    hw = filter_size // 2
    shift = (2 * hw - filter_size + 1) / 2
    f_i = ((np.arange(filter_size) - hw + shift) / filter_sigma) ** 2
    filt = np.exp(-0.5 * f_i)
    filt /= np.sum(filt)

    def convolve2d(z, f):
        return scipy.signal.convolve2d(z, f, mode="valid")

    def filt_fn(z):
        return np.stack(
            [
                convolve2d(convolve2d(z[..., i], filt[:, None]), filt[None, :])
                for i in range(z.shape[-1])
            ],
            -1,
        )

    mu0 = filt_fn(img0)
    mu1 = filt_fn(img1)
    mu00 = mu0 * mu0
    mu11 = mu1 * mu1
    mu01 = mu0 * mu1
    sigma00 = filt_fn(img0**2) - mu00
    sigma11 = filt_fn(img1**2) - mu11
    sigma01 = filt_fn(img0 * img1) - mu01

    sigma00 = np.maximum(0.0, sigma00)
    sigma11 = np.maximum(0.0, sigma11)
    sigma01 = np.sign(sigma01) * np.minimum(
        np.sqrt(sigma00 * sigma11), np.abs(sigma01)
    )
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    ssim_map = numer / denom
    return ssim_map if return_map else float(np.mean(ssim_map))


_LPIPS_CACHE: dict = {}


def rgb_lpips(np_gt: np.ndarray, np_im: np.ndarray, net_name: str = "alex") -> float:
    """Perceptual metric via the ``lpips`` package (CPU), its networks cached
    after first use. Raises ImportError when the package is not installed."""
    try:
        import lpips  # type: ignore
        import torch
    except ImportError as e:  # pragma: no cover - environment-dependent
        raise ImportError(
            "LPIPS requires the optional `lpips` package (not bundled)"
        ) from e
    if net_name not in _LPIPS_CACHE:
        _LPIPS_CACHE[net_name] = lpips.LPIPS(net=net_name, version="0.1").eval()
    gt = torch.from_numpy(np.ascontiguousarray(np_gt)).permute(2, 0, 1)
    im = torch.from_numpy(np.ascontiguousarray(np_im)).permute(2, 0, 1)
    with torch.no_grad():
        return float(_LPIPS_CACHE[net_name](gt, im, normalize=True).item())


def to8b(x: np.ndarray) -> np.ndarray:
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)
