"""The free-trajectory, nerfstudio and CO3D loaders.

The port's copy of
``unboundednerfpytorch_tpu/data/extra_loaders.py``:

- free scenes (F2-NeRF): ``cams_meta.npy`` of [N, 27] rows (a 3x4 pose, a
  3x3 K, 4 distortion terms and the near and far bounds) and ``images/``;
  a fly-through path interpolated through every fifth pose, both pose sets
  recentred on the average pose;
- nerfstudio captures: ``transforms.json`` with each frame's ``file_path``
  and ``transform_matrix``, one focal length for all views.

Images are read through :func:`..data.png.imread` and area-resized with
``cv2`` where ``factor`` > 1, as the JAX package does;
- CO3D sequences: the gzipped ``frame_annotations.jgz`` (each frame's image
  and mask paths, the mask's mass and the viewpoint: R, T and the principal
  point and focal length in NDC units) and ``set_lists.json`` (the
  ``*known*`` lists train, the others test), a frame with an empty mask
  dropped.
"""

from __future__ import annotations

import glob
import gzip
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


def load_co3d_data(datadir: str, annot_path: str, split_path: str, sequence_name: str):
    """(images, masks, poses [N, 4, 4], render_poses, [H, W, focal], Ks [N, 3,
    3], [i_train, i_test, i_test]) of one CO3D sequence. Images and masks are
    f64 in [0, 1]; frames whose mask's mass is 0 or whose mask stays under
    0.5 are dropped. The camera-to-world pose is the inverse of [R | T]; the
    NDC principal point and focal length become pixels, ``-(pp - 1) * (W,
    H) / 2`` and ``fl * (W, H) / 2``. Frames of several sizes come as object
    arrays, as in the JAX package (whose common loader then cannot cast
    them; neither trains on such a sequence)."""
    with gzip.open(annot_path, "rt", encoding="utf8") as zf:
        annot = [v for v in json.load(zf) if v["sequence_name"] == sequence_name]
    with open(split_path) as f:
        split = json.load(f)
    train_im, test_im = set(), set()
    for k, lst in split.items():
        for v in lst:
            if v[0] == sequence_name:
                (train_im if "known" in k else test_im).add(v[-1])

    imgs, masks, poses, Ks = [], [], [], []
    i_split = [[], []]
    for meta in annot:
        fname = meta["image"]["path"]
        sid = 0 if fname in train_im else 1
        if meta["mask"]["mass"] == 0:
            continue
        mask = _imread(os.path.join(datadir, meta["mask"]["path"])) / 255.0
        if mask.max() < 0.5:
            continue
        Rt = np.concatenate(
            [meta["viewpoint"]["R"], np.array(meta["viewpoint"]["T"])[:, None]], 1)
        poses.append(np.linalg.inv(np.concatenate([Rt, [[0, 0, 0, 1]]])))
        imgs.append(_imread(os.path.join(datadir, fname)) / 255.0)
        masks.append(mask)
        half_wh = np.float32(meta["image"]["size"][::-1]) * 0.5
        pp = np.float32(meta["viewpoint"]["principal_point"])
        fl = np.float32(meta["viewpoint"]["focal_length"])
        pp_px = -1.0 * (pp - 1.0) * half_wh
        fl_px = fl * half_wh
        Ks.append(np.array([[fl_px[0], 0, pp_px[0]], [0, fl_px[1], pp_px[1]], [0, 0, 1]]))
        i_split[sid].append(len(imgs) - 1)

    ragged = lambda xs: len({x.shape for x in xs}) > 1
    imgs_arr = np.array(imgs, dtype=object) if ragged(imgs) else np.stack(imgs)
    masks_arr = np.array(masks, dtype=object) if ragged(masks) else np.stack(masks)
    poses = np.stack(poses)
    Ks = np.stack(Ks)
    render_poses = poses[i_split[-1]]
    i_split.append(i_split[-1])
    H, W = np.array([im.shape[:2] for im in imgs]).mean(0).astype(int)
    focal = Ks[:, [0, 1], [0, 1]].mean()
    return imgs_arr, masks_arr, poses, render_poses, [H, W, focal], Ks, i_split
