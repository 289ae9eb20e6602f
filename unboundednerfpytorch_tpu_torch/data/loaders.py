"""The NeRF++ loader (Tanks & Temples unbounded, light fields).

The port's copy of the NeRF++ part of
``unboundednerfpytorch_tpu/data/loaders.py``: ``train/`` and ``test/``
directories, each with ``intrinsics/*.txt`` and ``pose/*.txt`` (4x4
matrices, one a view) and ``rgb/*.png``; an optional ``camera_path/`` for the
video poses. The other formats of that module (blender, tankstemple, nsvf,
blendedmvs, deepvoxels) are refused by ``data.common.load_common_data``.
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
