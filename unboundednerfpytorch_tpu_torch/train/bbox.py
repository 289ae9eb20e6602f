"""Scene bounds from the camera frusta.

Counterpart of ``compute_bbox_by_cam_frustrm`` of
``unboundednerfpytorch_tpu/train/bbox.py`` for the FourierGrid family: a
cube around the near-clip points of every training ray, scaled by
``unbounded_inner_r``.
"""

from __future__ import annotations

import numpy as np
import torch

from unboundednerfpytorch_tpu_torch.ops import rays as ray_ops


def bbox_unbounded(HW, Ks, poses, near_clip: float, unbounded_inner_r: float, *,
                   inverse_y=False, flip_x=False, flip_y=False, device=None):
    """(xyz_min, xyz_max) numpy [3] of the cube around the near-clip points."""
    H, W = int(HW[0][0]), int(HW[0][1])
    lo = hi = None
    for K, c2w in zip(Ks, poses):
        ro, rd, _ = ray_ops.get_rays_of_a_view(
            H, W, torch.as_tensor(np.asarray(K), dtype=torch.float32, device=device),
            torch.as_tensor(np.asarray(c2w)[:3, :4], dtype=torch.float32, device=device),
            inverse_y=inverse_y, flip_x=flip_x, flip_y=flip_y)
        pts = (ro + rd * near_clip).reshape(-1, 3)
        vmin, vmax = pts.amin(0), pts.amax(0)
        lo = vmin if lo is None else torch.minimum(lo, vmin)
        hi = vmax if hi is None else torch.maximum(hi, vmax)
    center = (lo + hi) * 0.5
    radius = (center - lo).max() * unbounded_inner_r
    return (center - radius).cpu().numpy(), (center + radius).cpu().numpy()


def compute_bbox_by_cam_frustrm(cfg, data_dict: dict, model_name: str | None = None,
                                device=None):
    """Bounds for the FourierGrid / unbounded-inward families; the other
    dataset types (waymo, mega, bounded scenes) are not ported yet."""
    d = cfg.data
    if d.dataset_type in ("waymo", "mega") or not (
            d.dataset_type == "nerfpp" or model_name == "FourierGrid" or d.unbounded_inward):
        raise NotImplementedError(
            f"bbox for dataset_type={d.dataset_type!r} / model {model_name!r} is not ported yet")
    if d.ndc:
        raise NotImplementedError("NDC scenes are not ported yet")
    i_train = np.asarray(data_dict["i_train"])
    return bbox_unbounded(
        np.asarray(data_dict["HW"])[i_train], np.asarray(data_dict["Ks"])[i_train],
        np.asarray(data_dict["poses"])[i_train],
        data_dict.get("near_clip") or data_dict["near"], d.unbounded_inner_r,
        inverse_y=d.inverse_y, flip_x=d.flip_x, flip_y=d.flip_y, device=device)
