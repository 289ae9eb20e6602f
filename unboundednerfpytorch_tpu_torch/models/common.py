"""Shared model pieces: the render result, view-direction embedding,
compositing and the act_shift initialiser.

Counterpart of ``unboundednerfpytorch_tpu/models/common.py``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class RenderResult(NamedTuple):
    """Fixed-shape volume-rendering output ([N, S] tensors + live mask)."""

    rgb_marched: torch.Tensor  # [N, 3]
    alphainv_last: torch.Tensor  # [N]
    weights: torch.Tensor  # [N, S] (masked)
    raw_alpha: torch.Tensor  # [N, S]
    raw_rgb: torch.Tensor  # [N, S, 3]
    raw_density: torch.Tensor  # [N, S]
    mask: torch.Tensor  # [N, S] live-sample mask after all thresholds
    t: torch.Tensor  # [N, S] ray parameter
    s: torch.Tensor  # [N, S] normalized distance 1 - 1/(1+t)
    depth: torch.Tensor  # [N]
    n_max: int  # static sample count (distortion interval)
    # two-stage render only: fraction of rays in this call whose survivors
    # overflowed color_budget (their tail weights were dropped), a device
    # scalar, so the truncation can be observed. None elsewhere.
    color_overflow_frac: torch.Tensor | None = None
    # two-stage render only: raw_rgb above is COMPACTED [N, color_budget, 3]
    # and pairs with the compacted weights, not with the full [N, S]
    # ``weights``; training losses (rgbper) must not consume it.
    rgb_compacted: bool = False


def act_shift_from_alpha_init(alpha_init: float) -> float:
    """softplus bias b with 1 - exp(-softplus(b)) == alpha_init."""
    return float(math.log(1.0 / (1.0 - alpha_init) - 1.0))


def viewdir_embedding(viewdirs: torch.Tensor, viewbase_pe: int) -> torch.Tensor:
    """(v, sin 2^k v, cos 2^k v): [N, 3] -> [N, 3 + 6 * viewbase_pe]."""
    freqs = 2.0 ** torch.arange(viewbase_pe, dtype=viewdirs.dtype, device=viewdirs.device)
    emb = (viewdirs[..., None] * freqs).reshape(*viewdirs.shape[:-1], -1)
    return torch.cat([viewdirs, torch.sin(emb), torch.cos(emb)], dim=-1)


def composite(weights: torch.Tensor, rgb: torch.Tensor, alphainv_last: torch.Tensor,
              bg) -> torch.Tensor:
    """rgb_marched = sum_s w * rgb + T_last * bg (bg a scalar or [N, 3])."""
    acc = torch.einsum("ns,nsc->nc", weights, rgb)
    return acc + alphainv_last[:, None] * bg
