"""Shared model pieces: the render result, view-direction embedding,
compositing, the act_shift initialiser, the march and color head that
the FourierGrid, DCVGO and DMPIGO forwards share, and the colouring of the
DVGO family's samples (every slot, or those over both thresholds alone).

Counterpart of ``unboundednerfpytorch_tpu/models/common.py``.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch

from unboundednerfpytorch_tpu_torch.device import to_host
from unboundednerfpytorch_tpu_torch.ops import alpha as alpha_ops
from unboundednerfpytorch_tpu_torch.ops.cuda.march import fused_alpha2weights


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
    # DCVGO only: per ray, the weight of the samples inside the unit
    # (uncontracted) region. None elsewhere.
    wsum_mid: torch.Tensor | None = None
    # the DVGO family's compacted forward only (``colour(..., compact=True)``):
    # raw_rgb above is [K, 3], the colours of the samples at these flat
    # indices [K] of [N, S], those over both thresholds (``mask``), in order;
    # ``losses.rgbper`` takes it. None where raw_rgb is [N, S, 3].
    rgb_rows: torch.Tensor | None = None


def sample_grad(rays_o: torch.Tensor, rays_d: torch.Tensor):
    """The context of a forward's sampling: ``torch.no_grad()`` unless the
    rays require a gradient. Training rays never do; the pose tuner's carry
    the gradient of the camera poses, which then reaches the sample points,
    their interpolation weights and the view directions, as in the JAX
    forwards (which stop no gradient there)."""
    if rays_o.requires_grad or rays_d.requires_grad:
        return contextlib.nullcontext()
    return torch.no_grad()


def act_shift_from_alpha_init(alpha_init: float) -> float:
    """softplus bias b with 1 - exp(-softplus(b)) == alpha_init."""
    return float(math.log(1.0 / (1.0 - alpha_init) - 1.0))


def viewdir_embedding(viewdirs: torch.Tensor, viewbase_pe: int) -> torch.Tensor:
    """(v, sin 2^k v, cos 2^k v): [N, 3] -> [N, 3 + 6 * viewbase_pe]."""
    freqs = 2.0 ** torch.arange(viewbase_pe, dtype=viewdirs.dtype, device=viewdirs.device)
    emb = (viewdirs[..., None] * freqs).flatten(-2)
    return torch.cat([viewdirs, torch.sin(emb), torch.cos(emb)], dim=-1)


def composite(weights: torch.Tensor, rgb: torch.Tensor, alphainv_last: torch.Tensor,
              bg) -> torch.Tensor:
    """rgb_marched = sum_s w * rgb + T_last * bg (bg a scalar or [N, 3])."""
    acc = torch.einsum("ns,nsc->nc", weights, rgb)
    return acc + alphainv_last[:, None] * bg


def march(density: torch.Tensor, mask: torch.Tensor, shift: float, interval: float,
          thres: float):
    """alpha -> threshold mask -> fused scan -> weights threshold: (raw alpha,
    weights, alphainv_last, mask). The ``alpha > thres`` mask that the JAX
    forwards build before the scan is computed here without grad and handed
    to the fused CUDA march (:mod:`..ops.cuda.march`)."""
    with torch.no_grad():
        alpha = alpha_ops.raw2alpha(density, shift, interval)
        if thres > 0:
            mask = mask & (alpha > thres)
    weights, alphainv_last, _ = fused_alpha2weights(density, mask, shift, interval)
    if thres > 0:
        mask = mask & (weights > thres)
        weights = weights * mask.to(weights.dtype)
    return alpha, weights, alphainv_last, mask


def rgb_head(rgbnet, k0: torch.Tensor, viewdirs: torch.Tensor, viewbase_pe: int,
             vcol: torch.Tensor | None = None, emb: torch.Tensor | None = None):
    """Sample colours [N, S, 3], in the JAX ``_rgb_head``'s order: without an
    MLP, the sigmoid of k0's first three channels; with a view-direction
    colour ``vcol`` [N, 3], the sigmoid of those channels plus it; else the
    rgb MLP on k0, the view-direction embedding and, given, the ray's
    appearance embedding ``emb`` [N, E]."""
    if rgbnet is None:
        return torch.sigmoid(k0[..., :3])
    if vcol is not None:
        return torch.sigmoid(k0[..., :3] + vcol[:, None, :])
    N, S = k0.shape[:2]
    vemb = viewdir_embedding(viewdirs, viewbase_pe)
    feats = [k0, vemb[:, None, :].expand(N, S, vemb.shape[-1])]
    if emb is not None:
        feats.append(emb[:, None, :].expand(N, S, emb.shape[-1]))
    return torch.sigmoid(rgbnet(torch.cat(feats, dim=-1)))


def rows_of(x: torch.Tensor, rows: torch.Tensor | None) -> torch.Tensor:
    """``x`` [N, S, C] at the flat sample indices ``rows`` [K] of [N, S]
    ([K, C]), or whole where ``rows`` is None."""
    return x if rows is None else x.reshape(-1, x.shape[-1])[rows]


def colour(mask: torch.Tensor, weights: torch.Tensor, alphainv_last: torch.Tensor, bg,
           viewdirs: torch.Tensor, k0_at, head, compact: bool):
    """The samples' colours and the composite on ``bg`` (a scalar or [N,
    3]): (rgb_marched [N, 3], raw_rgb, rows). ``k0_at(rows)`` looks k0 up at
    the flat sample indices ``rows`` of [N, S] (:func:`rows_of`), or at every
    sample for None; ``head(k0, viewdirs)`` colours k0 [M, S', C] seen along
    ``viewdirs`` [M, 3].

    Dense: the head at every sample, raw_rgb [N, S, 3], rows None. Compact:
    the samples of ``mask`` alone, the march's kept mask, outside which the
    weights are 0 and no colour reaches the image, the losses or a gradient.
    Their flat indices ``rows`` [K] (one wait on the card, for K), k0 looked
    up there, the head on [K, 1, C] and their rays' view directions, and the
    weighted colours added up a ray: raw_rgb [K, 3]. Both give the same
    composite and gradients, but for the order of the sums; K may be 0."""
    if not compact:
        rgb = head(k0_at(None), viewdirs)
        return composite(weights, rgb, alphainv_last, bg), rgb, None
    N, S = mask.shape
    flat = mask.reshape(-1)
    rows = torch.nonzero_static(flat, size=int(to_host(flat.sum())))[:, 0]
    ray = torch.div(rows, S, rounding_mode="floor")
    rgb = head(k0_at(rows)[:, None, :], viewdirs[ray])[:, 0]
    w = weights.reshape(-1)[rows]
    acc = rgb.new_zeros((N, 3)).index_add(0, ray, w[:, None] * rgb)
    return acc + alphainv_last[:, None] * bg, rgb, rows
