"""The NeRF++ and Tanks & Temples loaders.

The port's copy of two parts of ``unboundednerfpytorch_tpu/data/loaders.py``:

- NeRF++ (Tanks & Temples unbounded, light fields): ``train/`` and ``test/``
  directories, each with ``intrinsics/*.txt`` and ``pose/*.txt`` (4x4
  matrices, one a view) and ``rgb/*.png``; an optional ``camera_path/`` for
  the video poses;
- Tanks & Temples (the DVGO release, ``configs/tankstemple``): ``pose/*.txt``
  and ``rgb/*.png`` side by side, the first character of an image's name
  its split (0 train, 1 test), one ``intrinsics.txt``, and a circular
  fly-through around the cameras' centroid.

The other formats of that module (blender, nsvf, blendedmvs, deepvoxels)
are refused by ``data.common.load_common_data``.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from unboundednerfpytorch_tpu_torch.data.png import imread as _imread


def _find_files(d, exts):
    if os.path.isdir(d):
        out = []
        for e in exts:
            out.extend(glob.glob(os.path.join(d, e)))
        return sorted(out)
    return []


def _load_nerfpp_split(split_dir, training_ids=None):
    intr = _find_files(f"{split_dir}/intrinsics", ["*.txt"])
    pose = _find_files(f"{split_dir}/pose", ["*.txt"])
    imgs = _find_files(f"{split_dir}/rgb", ["*.png", "*.jpg"])
    if training_ids:
        keep = []
        for idx, ele in enumerate(intr):
            if int(os.path.basename(ele).replace(".txt", "")) in training_ids:
                keep.append(idx - 1)  # image ids start at 1
        intr = [intr[i] for i in keep]
        pose = [pose[i] for i in keep]
        imgs = [imgs[i] for i in keep]
    return intr, pose, imgs


def rerotate_poses(poses, render_poses):
    """Align the cameras-up PCA axis with -y."""
    import scipy.spatial.transform

    poses = np.copy(poses)
    centroid = poses[:, :3, 3].mean(0)
    poses[:, :3, 3] -= centroid
    x = poses[:, :3, 3]
    cov = np.cov((x - x.mean(0)).T)
    ev, eig = np.linalg.eig(cov)
    cams_up = eig[:, np.argmin(ev)].real
    if cams_up[1] < 0:
        cams_up = -cams_up
    R = scipy.spatial.transform.Rotation.align_vectors([[0, -1, 0]], cams_up[None])[0].as_matrix()
    poses[:, :3, :3] = R @ poses[:, :3, :3]
    poses[:, :3, [3]] = R @ poses[:, :3, [3]]
    poses[:, :3, 3] += centroid
    render_poses = np.copy(render_poses)
    render_poses[:, :3, 3] -= centroid
    render_poses[:, :3, :3] = R @ render_poses[:, :3, :3]
    render_poses[:, :3, [3]] = R @ render_poses[:, :3, [3]]
    render_poses[:, :3, 3] += centroid
    return poses, render_poses


def load_nerfpp_data(basedir: str, rerotate: bool = True, training_ids=None):
    tr_K, tr_pose, tr_img = _load_nerfpp_split(os.path.join(basedir, "train"), training_ids)
    te_K, te_pose, te_img = _load_nerfpp_split(os.path.join(basedir, "test"))
    if not tr_img:
        raise ValueError(f"images not found in {basedir}")

    i_split = [list(range(len(tr_pose))), list(range(len(tr_pose), len(tr_pose) + len(te_pose)))]
    K = np.loadtxt(tr_K[0]).reshape(4, 4)[:3, :3]
    poses = np.stack(
        [np.loadtxt(p).reshape(4, 4) for p in tr_pose + te_pose]
    ).astype(np.float32)
    imgs = np.stack(
        [(_imread(p) / 255.0).astype(np.float32) for p in tr_img + te_img]
    )
    i_split.append(i_split[1])
    H, W = imgs.shape[1:3]
    focal = K[[0, 1], [0, 1]].mean()

    rp_paths = sorted(glob.glob(os.path.join(basedir, "camera_path", "pose", "*txt")))
    if rp_paths:
        render_poses = np.stack([np.loadtxt(p).reshape(4, 4) for p in rp_paths])
        rk = glob.glob(os.path.join(basedir, "camera_path", "intrinsics", "*txt"))
        render_K = np.loadtxt(rk[0]).reshape(4, 4)[:3, :3]
        render_poses[:, :, 0] *= K[0, 0] / render_K[0, 0]
        render_poses[:, :, 1] *= K[1, 1] / render_K[1, 1]
    else:
        render_poses = poses[i_split[1]]
    if rerotate:
        poses, render_poses = rerotate_poses(poses, render_poses)
    return imgs, poses, render_poses, [H, W, focal], K, i_split


def _normalize(x):
    return x / np.linalg.norm(x)


def _load_pose_rgb_pairs(basedir: str, n_splits: int):
    """(images, poses, i_split) of ``pose/*.txt`` and ``rgb/*png`` in sorted
    order, each view in the split its image name's first character gives."""
    pose_paths = sorted(glob.glob(os.path.join(basedir, "pose", "*txt")))
    rgb_paths = sorted(glob.glob(os.path.join(basedir, "rgb", "*png")))
    all_poses, all_imgs = [], []
    i_split = [[] for _ in range(n_splits)]
    for i, (pp, rp) in enumerate(zip(pose_paths, rgb_paths)):
        all_poses.append(np.loadtxt(pp).astype(np.float32))
        all_imgs.append((_imread(rp) / 255.0).astype(np.float32))
        i_split[int(os.path.split(rp)[-1][0])].append(i)
    return np.stack(all_imgs), np.stack(all_poses), i_split


def load_tankstemple_data(basedir: str, movie_render_kwargs: dict | None = None):
    """(images, poses, render_poses, [H, W, focal], K, [i_train, i_val,
    i_test]); the test views are the validation views, the render path 200
    poses on a circle around the cameras' centroid, shaped by
    ``movie_render_kwargs`` (scale_r, shift_x/y/z, pitch_deg, flip_up_vec)."""
    mrk = dict(movie_render_kwargs or {})
    imgs, poses, i_split = _load_pose_rgb_pairs(basedir, 2)
    i_split.append(i_split[-1])
    H, W = imgs[0].shape[:2]
    K = np.loadtxt(os.path.join(basedir, "intrinsics.txt"))
    focal = float(K[0, 0])

    centroid = poses[:, :3, 3].mean(0)
    radcircle = mrk.get("scale_r", 1.0) * np.linalg.norm(poses[:, :3, 3] - centroid, axis=-1).mean()
    centroid[0] += mrk.get("shift_x", 0)
    centroid[1] += mrk.get("shift_y", 0)
    centroid[2] += mrk.get("shift_z", 0)
    target_y = radcircle * np.tan(mrk.get("pitch_deg", 0) * np.pi / 180)
    up = np.array([0, -1.0, 0]) if mrk.get("flip_up_vec") else np.array([0, 1.0, 0])

    render_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 200):
        camorigin = np.array([radcircle * np.cos(th), 0, radcircle * np.sin(th)])
        vec2 = _normalize(camorigin)
        vec0 = _normalize(np.cross(vec2, up))
        lookat = -vec2
        lookat[1] = target_y
        vec2 = _normalize(lookat)
        vec1 = _normalize(np.cross(vec2, vec0))
        render_poses.append(np.stack([vec0, vec1, vec2, camorigin + centroid], 1))
    render_poses = np.stack(render_poses, 0)
    render_poses = np.concatenate(
        [render_poses, np.broadcast_to(poses[0, :3, -1:], render_poses[:, :3, -1:].shape)], -1)
    return imgs, poses, render_poses, [H, W, focal], K, i_split
