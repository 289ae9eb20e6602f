"""The LINEMOD object-sequence loader (the ``configs/linemod/*`` pose
experiments).

The port's copy of ``unboundednerfpytorch_tpu/data/linemod.py``, on the
pvnet layout of a LINEMOD sequence:

    datadir/<seq_name>/
        JPEGImages/*.jpg        640x480 frames (or *.png)
        mask/*.png              object masks (optional)
        pose/pose*.npy          [3, 4] object poses (world -> camera)
        train.txt / test.txt    image stems of each split (optional)

Every frame has the shared LINEMOD intrinsics (``utils.pose_eval.LINEMOD_K``);
the camera-to-world pose of a frame is the inverse of its object pose (the
object's frame is the world's). ``width_max`` / ``height_max`` (the crop of
each object's config) cut a window around the projected object origin and
shift the principal point by its corner. Where a mask exists the frame is
composited on the background outside it. Images are read through
:func:`..data.png.imread` (PIL first), the decoder ``imageio.v2`` uses.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from unboundednerfpytorch_tpu_torch.data.png import imread
from unboundednerfpytorch_tpu_torch.utils.pose_eval import LINEMOD_K


def _invert_rt(rt: np.ndarray) -> np.ndarray:
    """[3, 4] world -> camera to the [4, 4] camera -> world."""
    out = np.eye(4, dtype=np.float64)
    R = rt[:, :3]
    t = rt[:, 3]
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out


def _crop_to_object(img, K, rt, width_max: int, height_max: int, mask=None):
    """The ``width_max`` x ``height_max`` window around the projected object
    origin, kept inside the frame, with the principal point shifted by its
    corner: (image, K, mask or None)."""
    H, W = img.shape[:2]
    center = K @ (rt[:, :3] @ np.zeros(3) + rt[:, 3])
    cx, cy = center[:2] / max(center[2], 1e-9)
    x0 = int(np.clip(round(cx - width_max / 2), 0, max(W - width_max, 0)))
    y0 = int(np.clip(round(cy - height_max / 2), 0, max(H - height_max, 0)))
    img_c = img[y0:y0 + height_max, x0:x0 + width_max]
    K_c = K.copy()
    K_c[0, 2] -= x0
    K_c[1, 2] -= y0
    mask_c = None
    if mask is not None:
        mask_c = mask[y0:y0 + height_max, x0:x0 + width_max]
    return img_c, K_c, mask_c


def _read_split(path: str) -> list[str] | None:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return [os.path.splitext(os.path.basename(line.strip()))[0] for line in f
                if line.strip()]


def load_linemod_data(datadir: str, seq_name: str, width_max: int = -1, height_max: int = -1,
                      white_bkgd: bool = True, testskip: int = 1):
    """(images [N, h, w, 3] f32, poses [N, 4, 4] c2w, Ks [N, 3, 3],
    object_poses [N, 3, 4], i_train, i_test). A frame without a pose file
    is skipped. Without ``train.txt`` every ``8 * testskip``-th frame is a
    test frame; without ``test.txt`` the frames not in ``train.txt`` are."""
    seq_dir = os.path.join(datadir, seq_name)
    img_files = sorted(glob.glob(os.path.join(seq_dir, "JPEGImages", "*.jpg"))
                       + glob.glob(os.path.join(seq_dir, "JPEGImages", "*.png")))
    if not img_files:
        raise FileNotFoundError(f"no LINEMOD frames under {seq_dir}/JPEGImages")

    def stem(p):
        return os.path.splitext(os.path.basename(p))[0]

    pose_files = {stem(p).replace("pose", ""): p
                  for p in glob.glob(os.path.join(seq_dir, "pose", "*.npy"))}
    mask_dir = os.path.join(seq_dir, "mask")

    images, poses, Ks, obj_poses, stems = [], [], [], [], []
    for f in img_files:
        s = stem(f)
        key = s.lstrip("0") or "0"
        pf = pose_files.get(s) or pose_files.get(key) or pose_files.get(
            str(int(s)) if s.isdigit() else s)
        if pf is None:
            continue
        rt = np.load(pf).astype(np.float64)[:3, :4]
        img = np.asarray(imread(f), dtype=np.float32) / 255.0
        mask = None
        mf = os.path.join(mask_dir, s + ".png")
        if os.path.exists(mf):
            mask = np.asarray(imread(mf)) > 0
            if mask.ndim == 3:
                mask = mask[..., 0]
        K = LINEMOD_K.copy()
        if width_max > 0 and height_max > 0:
            img, K, mask = _crop_to_object(img, K, rt, width_max, height_max, mask)
        if mask is not None:
            img = np.where(mask[..., None], img[..., :3], 1.0 if white_bkgd else 0.0)
        images.append(img[..., :3])
        poses.append(_invert_rt(rt))
        Ks.append(K)
        obj_poses.append(rt)
        stems.append(s)

    images = np.stack(images).astype(np.float32)
    poses = np.stack(poses).astype(np.float32)
    Ks = np.stack(Ks).astype(np.float32)
    obj_poses = np.stack(obj_poses).astype(np.float32)

    train_list = _read_split(os.path.join(seq_dir, "train.txt"))
    test_list = _read_split(os.path.join(seq_dir, "test.txt"))
    idx_of = {s: i for i, s in enumerate(stems)}
    if train_list:
        i_train = np.array([idx_of[s] for s in train_list if s in idx_of])
        if test_list:
            i_test = np.array([idx_of[s] for s in test_list if s in idx_of])
        else:
            i_test = np.array([i for i in range(len(stems)) if i not in set(i_train)])
    else:
        i_test = np.arange(len(stems))[::max(8 * testskip, 1)]
        i_train = np.array([i for i in range(len(stems)) if i not in set(i_test)])
    return images, poses, Ks, obj_poses, i_train, i_test
