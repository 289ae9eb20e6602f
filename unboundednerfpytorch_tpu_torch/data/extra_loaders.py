"""The free-trajectory and nerfstudio loaders.

The port's copy of the free and nerfstudio parts of
``unboundednerfpytorch_tpu/data/extra_loaders.py``:

- free scenes (F2-NeRF): ``cams_meta.npy`` of [N, 27] rows (a 3x4 pose, a
  3x3 K, 4 distortion terms and the near and far bounds) and ``images/``;
  a fly-through path interpolated through every fifth pose, both pose sets
  recentred on the average pose;
- nerfstudio captures: ``transforms.json`` with each frame's ``file_path``
  and ``transform_matrix``, one focal length for all views.

Images are read through :func:`..data.png.imread` and area-resized with
``cv2`` where ``factor`` > 1, as the JAX package does. The CO3D loader of
that module is not ported (ROADMAP A18c).
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from unboundednerfpytorch_tpu_torch.data.llff import _cv2, poses_avg
from unboundednerfpytorch_tpu_torch.data.png import imread as _imread


def _read_resized(path: str, factor: int) -> np.ndarray:
    """An image's RGB as float32 in [0, 1], area-resized by ``factor``."""
    im = _imread(path)[..., :3]
    if factor > 1:
        cv2 = _cv2()
        im = cv2.resize(im, (im.shape[1] // factor, im.shape[0] // factor),
                        interpolation=cv2.INTER_AREA)
    return (im / 255.0).astype(np.float32)


def _inter_poses(key_poses: np.ndarray, n_out: int) -> np.ndarray:
    """``n_out`` poses through the key poses: rotations by slerp, positions
    linearly."""
    from scipy.spatial.transform import Rotation, Slerp

    n_key = len(key_poses)
    times = np.linspace(0, n_key - 1, n_out)
    slerp = Slerp(np.arange(n_key), Rotation.from_matrix(key_poses[:, :3, :3]))
    out = np.zeros((n_out, 3, 4), np.float32)
    out[:, :3, :3] = slerp(times).as_matrix()
    lo = np.clip(times.astype(int), 0, n_key - 2)
    frac = (times - lo)[:, None]
    out[:, :3, 3] = key_poses[lo, :3, 3] * (1 - frac) + key_poses[lo + 1, :3, 3] * frac
    return out


def _recenter_with_render(poses, render_poses):
    """Both pose sets in the frame of the average training pose."""
    bottom = np.array([[0, 0, 0, 1.0]])
    c2w = np.concatenate([poses_avg(poses)[:3, :4], bottom], 0)
    inv = np.linalg.inv(c2w)

    def apply(ps):
        hom = np.concatenate([ps[:, :3, :4], np.tile(bottom[None], (len(ps), 1, 1))], 1)
        res = ps.copy()
        res[:, :3, :4] = (inv @ hom)[:, :3, :4]
        return res

    return apply(poses), apply(render_poses)


def load_free_data(basedir: str, factor: int = 8, llffhold: int = 8, training_ids=None,
                   n_out_poses: int = 200, sc: float = 1.0):
    """(images, depths=None, Ks, poses [N, 3, 5], bounds, render_poses, i_test)
    of a free-trajectory scene; ``training_ids`` keeps those views only."""
    cam_data = np.load(os.path.join(basedir, "cams_meta.npy")).reshape(-1, 27)
    n_images = cam_data.shape[0]
    poses = cam_data[:, 0:12].reshape(-1, 3, 4).astype(np.float32)
    intri = cam_data[:, 12:21].reshape(-1, 3, 3).astype(np.float32)
    bounds = cam_data[:, 25:27].reshape(-1, 2)

    imgfiles = sorted(f for f in glob.glob(os.path.join(basedir, "images", "*"))
                      if f.lower().endswith(("jpg", "jpeg", "png")))
    imgs = np.stack([_read_resized(f, factor) for f in imgfiles[:n_images]])
    intri[..., :2, :3] /= factor

    if training_ids is not None:
        ids = list(training_ids)
        poses, intri, imgs, bounds = poses[ids], intri[ids], imgs[ids], bounds[ids]

    render_poses = _inter_poses(poses[np.arange(0, poses.shape[0], 5)], n_out_poses)
    bounds = np.clip(bounds, 1e-2, 1e9)
    poses = poses.copy()
    poses[:, :3, 3] *= sc
    render_poses[:, :3, 3] *= sc

    hwf = np.array([imgs.shape[1], imgs.shape[2], intri[0, 0, 0]], np.float32).reshape(1, 3, 1)
    poses5 = np.concatenate([poses, np.tile(hwf, (len(poses), 1, 1))], 2)
    render5 = np.concatenate([render_poses, np.tile(hwf, (len(render_poses), 1, 1))], 2)
    poses5, render5 = _recenter_with_render(poses5, render5)

    i_test = np.arange(imgs.shape[0])[::llffhold] if llffhold > 0 else [0, 1, 2]
    return imgs, None, intri, poses5, bounds, render5, i_test


def load_nerfstudio_data(basedir: str, factor: int = 1, dvgohold: int = 8):
    """(images, depths=None, poses [N, 3, 5], bounds, render_poses, i_test)
    of a nerfstudio capture; every ``dvgohold``-th view is held out and
    rendered."""
    with open(os.path.join(basedir, "transforms.json")) as f:
        meta = json.load(f)
    imgs = np.stack([_read_resized(os.path.join(basedir, fr["file_path"]), factor)
                     for fr in meta["frames"]])
    poses = np.stack([np.asarray(fr["transform_matrix"], np.float32) for fr in meta["frames"]])
    H, W = imgs.shape[1:3]
    fl_x = meta.get("fl_x", meta.get("fl", W)) / factor
    hwf = np.array([H, W, fl_x], np.float32).reshape(1, 3, 1)
    poses5 = np.concatenate([poses[:, :3, :4], np.tile(hwf, (len(poses), 1, 1))], 2)
    i_test = np.arange(len(imgs))[::dvgohold] if dvgohold > 0 else [0]
    bds = np.array([[0.1, 10.0]] * len(imgs))
    return imgs, None, poses5, bds, poses5[list(i_test)], list(i_test)
