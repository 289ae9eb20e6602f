"""Block-NeRF's Waymo data: each block's ray store, its val views and the
generated test and compose trajectories.

Counterpart of ``unboundednerfpytorch_tpu/models/block_nerf/dataset.py``,
host numpy as there. A capture is ``<split>/split_block_<split>.json`` (the
blocks of ``data/preprocess.py::split_blocks``), ``<split>/<split>_all_meta.json``
({image name: {c2w, intrinsics, W, H, equivalent_exposure, image_name,
cam_idx, origin_pos}}) and ``<split>/rgbs/<image_name>.png``. A ray is the
10 numbers origin, direction, the mip-NeRF pixel radius (2/sqrt(12) of the
distance to the next row's direction), exposure, near and far; its
appearance id goes beside it. Images are read through ``data/png.py`` and
resized, where they must be, with OpenCV's Lanczos filter, as the JAX
package does.
"""

from __future__ import annotations

import json
import os

import numpy as np

from unboundednerfpytorch_tpu_torch.data.png import imread


def get_ray_directions(H: int, W: int, K: np.ndarray) -> np.ndarray:
    """Pixel-centre directions in the camera frame, x right, y up, -z
    forward."""
    j, i = np.mgrid[0:H, 0:W].astype(np.float32)
    return np.stack([(i - K[0, 2] + 0.5) / K[0, 0], -(j - K[1, 2] + 0.5) / K[1, 1],
                     -np.ones_like(i)], axis=-1)


def get_rays(directions: np.ndarray, c2w: np.ndarray):
    """(origins, unit directions), [H*W, 3] each."""
    rays_d = directions @ c2w[:3, :3].T
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    return rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)


def pixel_radii(rays_d: np.ndarray, H: int, W: int) -> np.ndarray:
    """The mip-NeRF base radius [H*W, 1]: the distance to the next row's
    direction (the last row repeats the one before) times 2/sqrt(12)."""
    d = rays_d.reshape(H, W, 3)
    dx = np.sqrt(np.sum((d[:-1] - d[1:]) ** 2, -1))
    dx = np.concatenate([dx, dx[-2:-1]], 0)
    return (dx * 2 / np.sqrt(12)).reshape(-1, 1)


def build_image_rays(img_info: dict, rgb, appearance_id: int, img_downscale: int = 4,
                     near: float = 0.01, far: float = 15.0):
    """One image -> (rays [HW, 10] f32, rgbs [HW, 3] f32 or None, ts [HW]
    int32, (H, W)) at ``img_downscale``; the focal is floor-divided by it
    and the principal point is the centre, as in the JAX package."""
    W = int(img_info["W"]) // img_downscale
    H = int(img_info["H"]) // img_downscale
    K = np.zeros((3, 3), np.float32)
    K[0, 0] = img_info["intrinsics"][0] // img_downscale
    K[1, 1] = img_info["intrinsics"][1] // img_downscale
    K[0, 2], K[1, 2], K[2, 2] = W * 0.5, H * 0.5, 1.0
    rays_o, rays_d = get_rays(get_ray_directions(H, W, K),
                              np.asarray(img_info["c2w"], np.float32))
    radii = pixel_radii(rays_d, H, W)
    ones = np.ones((rays_o.shape[0], 1), np.float32)
    rays = np.concatenate([rays_o, rays_d, radii,
                           float(img_info["equivalent_exposure"]) * ones, near * ones,
                           far * ones], axis=-1).astype(np.float32)
    ts = np.full((rays_o.shape[0],), appearance_id, np.int32)
    if rgb is not None:
        if rgb.shape[0] != H or rgb.shape[1] != W:
            import cv2

            rgb = cv2.resize(rgb, (W, H), interpolation=cv2.INTER_LANCZOS4)
        rgb = rgb.reshape(-1, 3).astype(np.float32)
    return rays, rgb, ts, (H, W)


def _read_rgb(path: str) -> np.ndarray:
    return np.asarray(imread(path))[..., :3] / 255.0


def _load_split(root_dir: str, split: str):
    with open(os.path.join(root_dir, split, f"split_block_{split}.json")) as fp:
        block_split = json.load(fp)
    with open(os.path.join(root_dir, split, f"{split}_all_meta.json")) as fp:
        meta = json.load(fp)
    return block_split, meta


def load_block_ray_store(root_dir: str, block: str = "block_0", split: str = "train",
                         img_downscale: int = 4, near: float = 0.01, far: float = 15.0):
    """Every ray of one block's split: ({"rays", "rgbs", "ts"}, images)."""
    block_split, meta = _load_split(root_dir, split)
    rays_l, rgbs_l, ts_l = [], [], []
    elements = block_split[block]["elements"]
    for img_name, appearance_id in elements:
        info = meta[img_name]
        rgb = _read_rgb(os.path.join(root_dir, split, "rgbs", info["image_name"] + ".png"))
        rays, rgbs, ts, _ = build_image_rays(info, rgb, appearance_id, img_downscale, near, far)
        rays_l.append(rays)
        rgbs_l.append(rgbs)
        ts_l.append(ts)
    return ({"rays": np.concatenate(rays_l), "rgbs": np.concatenate(rgbs_l),
             "ts": np.concatenate(ts_l)}, len(elements))


def find_nearest_appearance_idx(img_source: dict, block_elements, meta: dict):
    """For a view outside the block's training set: the appearance id of the
    block's element of the same camera whose origin is nearest (None where
    the block has none of that camera)."""
    cam_idx = img_source.get("cam_idx")
    best_d, best_idx = float("inf"), None
    for name, app_id in block_elements:
        info = meta[name]
        if info.get("cam_idx") != cam_idx:
            continue
        d = float(np.linalg.norm(np.asarray(img_source["origin_pos"], np.float64)
                                 - np.asarray(info["origin_pos"], np.float64)))
        if d < best_d:
            best_d, best_idx = d, app_id
    return best_idx


def load_val_rays(root_dir: str, block: str = "block_0", img_downscale: int = 4,
                  near: float = 0.01, far: float = 15.0, max_views: int = 5) -> list:
    """The block's first ``max_views`` val views: [(rays, rgbs, ts, (H, W),
    image name)]."""
    block_split, meta = _load_split(root_dir, "val")
    out = []
    for img_name, app_id in block_split[block]["elements"][:max_views]:
        info = meta[img_name]
        rgb = _read_rgb(os.path.join(root_dir, "val", "rgbs", info["image_name"] + ".png"))
        rays, rgbs, ts, hw = build_image_rays(info, rgb, app_id, img_downscale, near, far)
        out.append((rays, rgbs, ts, hw, img_name))
    return out


def gen_test_rays(img_info: dict, appearance_id: int, n_frames: int = 10, dy_max: float = 0.2,
                  img_downscale: int = 4, near: float = 0.01, far: float = 15.0) -> list:
    """A short trajectory from a source view, its camera slid in y by
    ``linspace(0, dy_max, n_frames)``: [(rays, ts, (H, W))]."""
    out = []
    for dy in np.linspace(0.0, dy_max, n_frames):
        c2w = np.asarray(img_info["c2w"], np.float32).copy()
        c2w[1, 3] += dy
        rays, _, ts, hw = build_image_rays({**img_info, "c2w": c2w}, None, appearance_id,
                                           img_downscale, near, far)
        out.append((rays, ts, hw))
    return out


def gen_compose_rays(meta: dict, cam_begin: str, cam_end: str, appearance_id: int,
                     frame_step: float = 0.01, img_downscale: int = 4, near: float = 0.01,
                     far: float = 15.0, max_frames: int = 1000) -> list:
    """Frames between two cameras, one per ``frame_step`` of their
    y-distance (at most ``max_frames``), the camera moved along the segment
    with the first view's rotation: [(rays, ts, (H, W))]."""
    a, b = meta[cam_begin], meta[cam_end]
    delta = np.asarray(a["origin_pos"], np.float64) - np.asarray(b["origin_pos"], np.float64)
    n_frames = 1 if abs(delta[1]) < frame_step else int(abs(delta[1]) // frame_step)
    n_frames = min(n_frames, max_frames)
    c2w_a = np.asarray(a["c2w"], np.float64)
    c2w_b = np.asarray(b["c2w"], np.float64)
    out = []
    for k in range(n_frames):
        s = k / max(n_frames - 1, 1)
        c2w = c2w_a.copy()
        c2w[:3, 3] = (1 - s) * c2w_a[:3, 3] + s * c2w_b[:3, 3]
        rays, _, ts, hw = build_image_rays({**a, "c2w": c2w.astype(np.float32)}, None,
                                           appearance_id, img_downscale, near, far)
        out.append((rays, ts, hw))
    return out
