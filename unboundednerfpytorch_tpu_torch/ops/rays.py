"""Camera-ray generation.

Counterpart of ``unboundednerfpytorch_tpu/ops/rays.py`` (``get_rays``,
``ndc_rays``, ``get_rays_of_a_view``, ``get_training_rays_flatten``) for the
'lefttop' / 'center' pixel conventions, the ``inverse_y`` / ``flip_x`` /
``flip_y`` intrinsic modes and the NDC projection of forward-facing scenes.
"""

from __future__ import annotations

import numpy as np
import torch


def get_rays(H: int, W: int, K: torch.Tensor, c2w: torch.Tensor, inverse_y: bool = False,
             flip_x: bool = False, flip_y: bool = False, mode: str = "center"):
    """Rays of one view: (rays_o, rays_d), each [H, W, 3] in world space."""
    dev = c2w.device
    i = torch.arange(W, dtype=torch.float32, device=dev)[None, :].repeat(H, 1)
    j = torch.arange(H, dtype=torch.float32, device=dev)[:, None].repeat(1, W)
    if mode == "center":
        i = i + 0.5
        j = j + 0.5
    elif mode != "lefttop":
        raise NotImplementedError(f"unknown ray mode {mode!r}")
    if flip_x:
        i = i.flip(1)
    if flip_y:
        j = j.flip(0)
    K = K.to(torch.float32)
    c2w = c2w.to(torch.float32)
    if inverse_y:
        dirs = torch.stack([(i - K[0][2]) / K[0][0], (j - K[1][2]) / K[1][1],
                            torch.ones_like(i)], -1)
    else:
        dirs = torch.stack([(i - K[0][2]) / K[0][0], -(j - K[1][2]) / K[1][1],
                            -torch.ones_like(i)], -1)
    rays_d = torch.einsum("hwc,rc->hwr", dirs, c2w[:3, :3])
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def ndc_rays(H: int, W: int, focal, near: float, rays_o: torch.Tensor,
             rays_d: torch.Tensor):
    """Rays moved to the near plane and projected into normalized device
    coordinates (forward-facing LLFF scenes): (rays_o, rays_d). The scales
    -1 / (W / 2f) are computed in float32 from ``focal`` (a number or a 0-d
    tensor) with numpy, as XLA computes them (torch divides a number by a
    tensor through its reciprocal, an ulp away)."""
    focal = np.float32(float(focal))
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    sx = float(np.float32(-1.0) / (np.float32(W) / (np.float32(2.0) * focal)))
    sy = float(np.float32(-1.0) / (np.float32(H) / (np.float32(2.0) * focal)))
    o0 = sx * rays_o[..., 0] / rays_o[..., 2]
    o1 = sy * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = sx * (rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = sy * (rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def get_rays_of_a_view(H: int, W: int, K: torch.Tensor, c2w: torch.Tensor, ndc: bool = False,
                       inverse_y: bool = False, flip_x: bool = False, flip_y: bool = False,
                       mode: str = "center"):
    """Rays plus unit view directions for one view; with ``ndc`` the rays are
    projected into NDC (the view directions stay the world's)."""
    rays_o, rays_d = get_rays(H, W, K, c2w, inverse_y=inverse_y, flip_x=flip_x,
                              flip_y=flip_y, mode=mode)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    if ndc:
        rays_o, rays_d = ndc_rays(H, W, K[0][0], 1.0, rays_o, rays_d)
    return rays_o, rays_d, viewdirs


def get_training_rays_flatten(images: torch.Tensor, poses: torch.Tensor, H: int, W: int,
                              K: torch.Tensor, ndc: bool = False, inverse_y: bool = False,
                              flip_x: bool = False, flip_y: bool = False):
    """Flattened ray store for same-shape images. K is one [3, 3] or per-view
    [N, 3, 3]. Returns rgb, rays_o, rays_d, viewdirs ([N*H*W, 3] each) and
    img_index [N*H*W]."""
    n_img = poses.shape[0]
    Kb = K.expand(n_img, 3, 3) if K.ndim == 2 else K
    ro, rd, vd = [], [], []
    for c2w, Ki in zip(poses[:, :3, :4], Kb):
        o, d, v = get_rays_of_a_view(H, W, Ki, c2w, ndc=ndc, inverse_y=inverse_y,
                                     flip_x=flip_x, flip_y=flip_y)
        ro.append(o.reshape(-1, 3))
        rd.append(d.reshape(-1, 3))
        vd.append(v.reshape(-1, 3))
    rgb = images.reshape(-1, 3)
    img_index = torch.arange(n_img, dtype=torch.int32, device=poses.device).repeat_interleave(H * W)
    return rgb, torch.cat(ro), torch.cat(rd), torch.cat(vd), img_index
