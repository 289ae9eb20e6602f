"""Camera-ray generation.

Counterpart of ``unboundednerfpytorch_tpu/ops/rays.py`` (``get_rays``,
``get_rays_of_a_view``, ``get_training_rays_flatten``) for the
'lefttop' / 'center' pixel conventions and the ``inverse_y`` / ``flip_x`` /
``flip_y`` intrinsic modes. NDC projection (forward-facing scenes) is not
part of the FourierGrid slice and raises.
"""

from __future__ import annotations

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


def get_rays_of_a_view(H: int, W: int, K: torch.Tensor, c2w: torch.Tensor, ndc: bool = False,
                       inverse_y: bool = False, flip_x: bool = False, flip_y: bool = False,
                       mode: str = "center"):
    """Rays plus unit view directions for one view."""
    if ndc:
        raise NotImplementedError("NDC rays are not ported yet")
    rays_o, rays_d = get_rays(H, W, K, c2w, inverse_y=inverse_y, flip_x=flip_x,
                              flip_y=flip_y, mode=mode)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
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
