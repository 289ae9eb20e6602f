"""Scene bounds from the camera frusta, the camera positions or the coarse
geometry.

Counterpart of ``bbox_unbounded``, ``bbox_bounded``, ``bbox_waymo``,
``bbox_mega``, ``compute_bbox_by_cam_frustrm`` and
``compute_bbox_by_coarse_geo`` of ``unboundednerfpytorch_tpu/train/bbox.py``:
a cube around the near-clip points of every training ray, scaled by
``unbounded_inner_r`` (unbounded inward scenes: the FourierGrid and DCVGO
families), the box swept by every ray between ``near`` and ``far`` (bounded
and forward-facing NDC scenes: DVGO and DMPIGO), or, for waymo and mega
captures, a cube around the training cameras' positions with a margin
(numpy, in the JAX package's dtypes); and the fine stage's box, around the
coarse model's lattice nodes whose alpha passes ``bbox_thres``.
"""

from __future__ import annotations

import numpy as np
import torch

from unboundednerfpytorch_tpu_torch.models.dvgo import density_on_lattice
from unboundednerfpytorch_tpu_torch.models.fourier_grid import _linspace
from unboundednerfpytorch_tpu_torch.ops import rays as ray_ops


def _view_rays(HW, Ks, poses, ndc, inverse_y, flip_x, flip_y, device):
    """(rays_o, rays_d, viewdirs) of each view in turn, [H, W, 3] each."""
    H, W = int(HW[0][0]), int(HW[0][1])
    for K, c2w in zip(Ks, poses):
        yield ray_ops.get_rays_of_a_view(
            H, W, torch.as_tensor(np.asarray(K), dtype=torch.float32, device=device),
            torch.as_tensor(np.asarray(c2w)[:3, :4], dtype=torch.float32, device=device),
            ndc=ndc, inverse_y=inverse_y, flip_x=flip_x, flip_y=flip_y)


def _extent(points):
    """Elementwise min and max over an iterable of [..., 3] point sets."""
    lo = hi = None
    for pts in points:
        pts = pts.reshape(-1, 3)
        vmin, vmax = pts.amin(0), pts.amax(0)
        lo = vmin if lo is None else torch.minimum(lo, vmin)
        hi = vmax if hi is None else torch.maximum(hi, vmax)
    return lo, hi


def bbox_unbounded(HW, Ks, poses, near_clip: float, unbounded_inner_r: float, *, ndc=False,
                   inverse_y=False, flip_x=False, flip_y=False, device=None):
    """(xyz_min, xyz_max) numpy [3] of the cube around the near-clip points."""
    lo, hi = _extent(ro + rd * near_clip for ro, rd, _ in
                     _view_rays(HW, Ks, poses, ndc, inverse_y, flip_x, flip_y, device))
    center = (lo + hi) * 0.5
    radius = (center - lo).max() * unbounded_inner_r
    return (center - radius).cpu().numpy(), (center + radius).cpu().numpy()


def bbox_bounded(HW, Ks, poses, near: float, far: float, *, ndc=False, inverse_y=False,
                 flip_x=False, flip_y=False, device=None):
    """(xyz_min, xyz_max) numpy [3] of the points at ``near`` and ``far`` on
    every ray (along the NDC direction with ``ndc``, the unit view direction
    otherwise)."""

    def ends():
        for ro, rd, vd in _view_rays(HW, Ks, poses, ndc, inverse_y, flip_x, flip_y, device):
            d = rd if ndc else vd
            yield ro + d * near
            yield ro + d * far

    lo, hi = _extent(ends())
    return lo.cpu().numpy(), hi.cpu().numpy()


def _camera_cube(xyz_min, xyz_max, unbounded_inner_r: float):
    center = (xyz_min + xyz_max) * 0.5
    radius = (center - xyz_min).max() * unbounded_inner_r
    return center - radius, center + radius


def bbox_waymo(poses, unbounded_inner_r: float, x_extend: float = 0.05, y_extend: float = 0.01,
               z_extend: float = 0.01):
    """The cube around the camera positions, widened by fixed margins."""
    cams = np.asarray(poses)[:, :3, 3]
    margin = np.array([x_extend, y_extend, z_extend])
    return _camera_cube(cams.min(0) - margin, cams.max(0) + margin, unbounded_inner_r)


def bbox_mega(poses, unbounded_inner_r: float, boundary_ratio: float):
    """The cube around the camera positions, widened by ``boundary_ratio``
    of their extent on each axis."""
    cams = np.asarray(poses)[:, :3, 3]
    margin = boundary_ratio * np.abs(cams.max(0) - cams.min(0))
    return _camera_cube(cams.min(0) - margin, cams.max(0) + margin, unbounded_inner_r)


def compute_bbox_by_cam_frustrm(cfg, data_dict: dict, model_name: str | None = None,
                                device=None):
    """The JAX package's dispatch: waymo and mega captures get their camera
    cubes, unbounded inward scenes (and every FourierGrid or NeRF++ one) the
    near-clip cube, the others the near/far sweep."""
    d = cfg.data
    i_train = np.asarray(data_dict["i_train"])
    HW = np.asarray(data_dict["HW"])[i_train]
    Ks = np.asarray(data_dict["Ks"])[i_train]
    poses = np.asarray(data_dict["poses"])[i_train]
    if d.dataset_type == "waymo":
        return bbox_waymo(poses, d.unbounded_inner_r)
    if d.dataset_type == "mega":
        return bbox_mega(poses, d.unbounded_inner_r, d.boundary_ratio)
    kw = dict(ndc=d.ndc, inverse_y=d.inverse_y, flip_x=d.flip_x, flip_y=d.flip_y, device=device)
    if d.dataset_type == "nerfpp" or model_name == "FourierGrid" or d.unbounded_inward:
        return bbox_unbounded(HW, Ks, poses, data_dict.get("near_clip") or data_dict["near"],
                              d.unbounded_inner_r, **kw)
    return bbox_bounded(HW, Ks, poses, data_dict["near"], data_dict["far"], **kw)


def compute_bbox_by_coarse_geo(params, cfg, activate_fn, thres: float):
    """(xyz_min, xyz_max) numpy f32 [3] of the coarse lattice's nodes (the
    density grid's, ``mn * (1 - u) + mx * u`` for u = linspace(0, 1, n) an
    axis) whose ``activate_fn(density)`` exceeds ``thres``; every node where
    none does. The density is queried through the grid at the nodes."""
    ws = cfg.world_size
    dev = params.mask_cache.mask.device
    mn = torch.tensor(cfg.xyz_min, dtype=torch.float32, device=dev)
    mx = torch.tensor(cfg.xyz_max, dtype=torch.float32, device=dev)
    axes = [mn[i] * (1 - u) + mx[i] * u
            for i, u in enumerate(_linspace(0.0, 1.0, int(n), dev) for n in ws)]
    with torch.no_grad():
        alpha = activate_fn(density_on_lattice(params.density, axes))
        mask = alpha > thres
        if not bool(mask.any()):
            mask = alpha > -1.0
        # a node's coordinate on an axis depends on its index there alone
        hit = [axes[i][mask.any(dim=tuple(j for j in range(3) if j != i))] for i in range(3)]
        lo, hi = [h.min() for h in hit], [h.max() for h in hit]
    return torch.stack(lo).cpu().numpy(), torch.stack(hi).cpu().numpy()
