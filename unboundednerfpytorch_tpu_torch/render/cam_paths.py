"""Camera-path generation for demo videos (the ``gen_trace`` program).

The port's copy of ``unboundednerfpytorch_tpu/render/cam_paths.py``, which
re-implements the reference's ``run_gen_cam_paths``: pick the most
common ("core") physical camera, sort its views by position, take a straight
window from the middle of the drive, find the k nearest views around the
window start, order them by their central-ray direction, and export per-
camera ``cam_{i}.npz`` paths (bbox + camera frusta, the ``run_export_bbox_
cams`` format, :63-84) plus a combined ``rot_cam.npz`` and an optional GT
mp4 (:33-41).

Pure numpy, apart from the scene box, which the port's ``train.bbox``
computes with torch on the CPU."""

from __future__ import annotations

import os

import numpy as np


def central_ray_dir(K, c2w, H: int = 0, W: int = 0,
                    inverse_y: bool = False) -> np.ndarray:
    """World-space direction of the central pixel's ray (numpy mirror of
    ops/rays.get_rays 'center' mode at pixel (H//2, W//2), matching
    get_rotation_kp_2d's cam_d, run_gen_cam_paths.py:44-60). With H=W=0 the
    principal point is used (the optical axis)."""
    K = np.asarray(K, np.float64)
    c2w = np.asarray(c2w, np.float64)
    i = (W // 2 + 0.5) if W else K[0, 2]
    j = (H // 2 + 0.5) if H else K[1, 2]
    if inverse_y:
        d_cam = np.array([(i - K[0, 2]) / K[0, 0], (j - K[1, 2]) / K[1, 1], 1.0])
    else:
        d_cam = np.array([(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1], -1.0])
    return c2w[:3, :3] @ d_cam


def select_k_nearest_points(idx: int, positions: np.ndarray, k: int) -> list[int]:
    """Indices of the k nearest views to view ``idx`` (self included first,
    run_gen_cam_paths.py:15-20)."""
    positions = np.asarray(positions)
    d = np.linalg.norm(positions - positions[idx], axis=-1)
    return list(np.argsort(d)[: k + 1])


def export_bbox_cams(
    data_dict: dict, sample_idxs, save_path: str,
    xyz_min, xyz_max, near: float, far: float, inverse_y: bool = False,
) -> None:
    """npz of scene bbox + camera frusta for the sampled views
    (run_export_bbox_cams, run_gen_cam_paths.py:63-84): per view, the origin
    plus the four image-corner ray endpoints at max(near, far*0.05)."""
    poses = np.asarray(data_dict["poses"])[sample_idxs]
    Ks = np.asarray(data_dict["Ks"])[sample_idxs]
    HW = np.asarray(data_dict["HW"])[sample_idxs]
    if data_dict.get("near_clip") is not None:
        near = float(data_dict["near_clip"])
    cam_lst = []
    for c2w, K, (H, W) in zip(poses, Ks, HW):
        K = np.asarray(K, np.float64)
        corners_px = np.array(
            [[0.5, 0.5], [W - 0.5, 0.5], [0.5, H - 0.5], [W - 0.5, H - 0.5]]
        )
        i, j = corners_px[:, 0], corners_px[:, 1]
        if inverse_y:
            dirs = np.stack(
                [(i - K[0, 2]) / K[0, 0], (j - K[1, 2]) / K[1, 1], np.ones_like(i)], -1
            )
        else:
            dirs = np.stack(
                [(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1], -np.ones_like(i)], -1
            )
        cam_d = dirs @ np.asarray(c2w, np.float64)[:3, :3].T
        cam_o = np.asarray(c2w, np.float64)[:3, 3]
        cam_lst.append(np.array([cam_o, *(cam_o + cam_d * max(near, far * 0.05))]))
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    np.savez_compressed(
        save_path,
        xyz_min=np.asarray(xyz_min),
        xyz_max=np.asarray(xyz_max),
        cam_lst=np.asarray(cam_lst),
    )


def gen_cam_paths(
    cfg,
    data_dict: dict,
    out_dir: str,
    core_cam: int | None = None,
    straight_length: int = 100,
    k_nearest: int = 15,
    write_video: bool = False,
    log_fn=print,
) -> dict:
    """Synthesize straight + rotation camera paths (run_gen_cam_paths:87-141).

    Returns {"straight": [...idxs], "rotation": [...idxs], "combined": [...]}
    and writes cam_{i}.npz / rot_cam.npz under out_dir."""
    from unboundednerfpytorch_tpu_torch.train import bbox as bbox_mod
    from unboundednerfpytorch_tpu_torch.train.loop import model_family_name

    poses = np.asarray(data_dict["poses"])
    positions = poses[:, :3, 3]
    cam_idxs = data_dict.get("cam_idxs")
    if cam_idxs is None:
        cam_idxs = [0] * len(poses)
    cam_idxs = list(np.asarray(cam_idxs).tolist())

    # core camera = the most common physical camera (:97-99)
    if core_cam is None:
        core_cam = max(set(cam_idxs), key=cam_idxs.count)
    core_idxs = [i for i, c in enumerate(cam_idxs) if c == core_cam]

    # straight window: core views sorted by (y, x) position, middle slice
    # (:100-104)
    order = sorted(core_idxs, key=lambda i: (positions[i][1], positions[i][0]))
    start = max(0, len(order) // 2 - straight_length // 2)
    straight_idxs = order[start : start + straight_length]
    if not straight_idxs:
        straight_idxs = order

    os.makedirs(out_dir, exist_ok=True)
    xyz_min, xyz_max = bbox_mod.compute_bbox_by_cam_frustrm(
        cfg, data_dict, model_family_name(cfg), device="cpu"
    )
    near, far = float(data_dict["near"]), float(data_dict["far"])
    inverse_y = bool(getattr(cfg.data, "inverse_y", False))

    # rotation set: nearest views around the window start, ordered by their
    # central-ray direction (:110-124)
    anchor = straight_idxs[0] if straight_idxs else 0
    close_idxs = select_k_nearest_points(anchor, positions, k=k_nearest)
    HW = np.asarray(data_dict["HW"])
    rot = [
        central_ray_dir(
            np.asarray(data_dict["Ks"])[i], poses[i],
            int(HW[i][0]), int(HW[i][1]), inverse_y,
        )
        for i in close_idxs
    ]
    rot_order = sorted(zip(close_idxs, rot), key=lambda r: (r[1][1], r[1][0]))
    rot_idxs = [i for i, _ in rot_order]

    # one path export per distinct physical camera in the rotation set
    seen = set()
    for i in rot_idxs:
        c = cam_idxs[i]
        if c in seen:
            continue
        seen.add(c)
        export_bbox_cams(
            data_dict, [i] + straight_idxs,
            os.path.join(out_dir, f"cam_{c}.npz"),
            xyz_min, xyz_max, near, far, inverse_y,
        )
        log_fn(f"cam_id:{c}, original idx: {i}")

    combined = rot_idxs + straight_idxs
    export_bbox_cams(
        data_dict, combined, os.path.join(out_dir, "rot_cam.npz"),
        xyz_min, xyz_max, near, far, inverse_y,
    )

    if write_video:
        images = np.asarray(data_dict["images"])
        frames = (np.clip(images[combined], 0, 1) * 255).astype(np.uint8)
        try:
            import imageio

            imageio.mimwrite(
                os.path.join(out_dir, "rot.mp4"), frames, fps=15, quality=8
            )
        except Exception as e:  # noqa: BLE001 — codecs are optional
            log_fn(f"video write skipped: {e!r}")

    return {
        "straight": straight_idxs,
        "rotation": rot_idxs,
        "combined": combined,
    }
