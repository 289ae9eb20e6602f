"""The NeRF++, Tanks & Temples, NeRF-synthetic (blender), NSVF, BlendedMVS
and DeepVoxels loaders.

The port's copy of ``unboundednerfpytorch_tpu/data/loaders.py``:

- NeRF++ (Tanks & Temples unbounded, light fields): ``train/`` and ``test/``
  directories, each with ``intrinsics/*.txt`` and ``pose/*.txt`` (4x4
  matrices, one a view) and ``rgb/*.png``; an optional ``camera_path/`` for
  the video poses;
- Tanks & Temples (the DVGO release, ``configs/tankstemple``): ``pose/*.txt``
  and ``rgb/*.png`` side by side, the first character of an image's name
  its split (0 train, 1 test), one ``intrinsics.txt``, and a circular
  fly-through around the cameras' centroid;
- NeRF-synthetic (``configs/nerf``): ``transforms_{train,val,test}.json``
  (``camera_angle_x`` and each frame's ``file_path`` and 4x4
  ``transform_matrix``) beside RGBA PNGs, with ``half_res`` (an area
  resize to half size) and ``testskip``, and 160 views on a sphere
  (:func:`pose_spherical`) as the render path;
- NSVF and BlendedMVS (``configs/nsvf``, ``configs/blendedmvs``): the Tanks
  & Temples layout with three splits (0 train, 1 val, 2 test) and the focal
  length first in ``intrinsics.txt`` (NSVF), or two splits, a 3x3
  ``intrinsics.txt`` and the render path in ``test_traj.txt`` (BlendedMVS);
- DeepVoxels (``configs/deepvoxels``): ``train|validation|test/<scene>/``
  each with ``pose/*.txt`` and ``rgb/*.png``, the intrinsics in
  ``train/<scene>/intrinsics.txt``.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from unboundednerfpytorch_tpu_torch.data.png import imread as _imread


def _trans_t(t):
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def _rot_phi(phi):
    m = np.eye(4, dtype=np.float32)
    m[1, 1] = np.cos(phi)
    m[1, 2] = -np.sin(phi)
    m[2, 1] = np.sin(phi)
    m[2, 2] = np.cos(phi)
    return m


def _rot_theta(th):
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = np.cos(th)
    m[0, 2] = -np.sin(th)
    m[2, 0] = np.sin(th)
    m[2, 2] = np.cos(th)
    return m


def pose_spherical(theta: float, phi: float, radius: float, nsvf_axes: bool = False):
    """The f32 c2w of a camera at ``radius`` from the origin looking at it,
    ``theta`` degrees around the up axis and ``phi`` degrees of elevation;
    ``nsvf_axes`` flips its y and z axes (the NSVF convention)."""
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta / 180.0 * np.pi) @ c2w
    c2w = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                   dtype=np.float32) @ c2w
    if nsvf_axes:
        c2w[:, [1, 2]] *= -1
    return c2w


def load_blender_data(basedir: str, half_res: bool = False, testskip: int = 1):
    """(images [V, H, W, 4] f32 RGBA, poses [V, 4, 4] f32, render_poses
    [160, 4, 4], [H, W, focal], [i_train, i_val, i_test]); the val and test
    splits keep every ``testskip``-th frame (all where it is 0)."""
    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)
    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        meta = metas[s]
        skip = 1 if s == "train" or testskip == 0 else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            imgs.append(_imread(os.path.join(basedir, frame["file_path"] + ".png")))
            poses.append(np.array(frame["transform_matrix"]))
        imgs = (np.array(imgs) / 255.0).astype(np.float32)
        poses = np.array(poses).astype(np.float32)
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(poses)
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)
    H, W = imgs[0].shape[:2]
    focal = 0.5 * W / np.tan(0.5 * float(metas["train"]["camera_angle_x"]))
    render_poses = np.stack(
        [pose_spherical(a, -30.0, 4.0) for a in np.linspace(-180, 180, 161)[:-1]])
    if half_res:
        import cv2

        H, W, focal = H // 2, W // 2, focal / 2.0
        imgs = np.stack([cv2.resize(im, (W, H), interpolation=cv2.INTER_AREA)
                         for im in imgs]).astype(np.float32)
    return imgs, poses, render_poses, [H, W, focal], i_split


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


def load_nsvf_data(basedir: str):
    """(images, poses, render_poses, [H, W, focal], [i_train, i_val,
    i_test]): three splits by name, the focal length the first number of
    ``intrinsics.txt``, 200 render poses on a sphere of the cameras' mean
    radius, 30 degrees down, in NSVF's axes."""
    imgs, poses, i_split = _load_pose_rgb_pairs(basedir, 3)
    H, W = imgs[0].shape[:2]
    with open(os.path.join(basedir, "intrinsics.txt")) as f:
        focal = float(f.readline().split()[0])
    R = np.sqrt((poses[..., :3, 3] ** 2).sum(-1)).mean()
    render_poses = np.stack([pose_spherical(a, -30.0, R, nsvf_axes=True)
                             for a in np.linspace(-180, 180, 201)[:-1]])
    return imgs, poses, render_poses, [H, W, focal], i_split


def load_blendedmvs_data(basedir: str):
    """(images, poses, render_poses, [H, W, focal], K, [i_train, i_val,
    i_test]): two splits by name (the test views are the val views), a 3x3
    ``intrinsics.txt``, the render path the 4x4 poses of ``test_traj.txt``."""
    imgs, poses, i_split = _load_pose_rgb_pairs(basedir, 2)
    i_split.append(i_split[-1])
    H, W = imgs[0].shape[:2]
    K = np.loadtxt(os.path.join(basedir, "intrinsics.txt"))
    focal = float(K[0, 0])
    render_poses = np.loadtxt(os.path.join(basedir, "test_traj.txt")).reshape(-1, 4, 4).astype(
        np.float32)
    return imgs, poses, render_poses, [H, W, focal], K, i_split


def load_dv_data(scene: str, basedir: str, testskip: int = 8):
    """(images, poses, render_poses, [H, W, focal], [i_train, i_val,
    i_test]) of a DeepVoxels scene: ``train``, ``validation`` and ``test``
    directories of ``<scene>``, the last two thinned by ``testskip``; each
    pose is right-multiplied by diag(1, -1, -1, 1) (the camera's y and z axes
    flipped), the focal length and centre of ``train/<scene>/intrinsics.txt``
    scaled to the images' height, and the test poses the render path."""

    def parse_intrinsics(filepath, target_side_len):
        with open(filepath) as f:
            f_, cx, cy, _ = map(float, f.readline().split())
            f.readline()
            f.readline()
            height, width = map(float, f.readline().split())
        cx = cx / width * target_side_len
        cy = cy / height * target_side_len
        f_ = target_side_len / height * f_
        return np.array([[f_, 0, cx], [0, f_, cy], [0, 0, 1]])

    def dir_data(split_dir):
        pose_paths = sorted(glob.glob(os.path.join(split_dir, "pose", "*txt")))
        img_paths = sorted(glob.glob(os.path.join(split_dir, "rgb", "*png")))
        poses = [np.loadtxt(p).reshape(4, 4) for p in pose_paths]
        imgs = [(_imread(p) / 255.0).astype(np.float32) for p in img_paths]
        return np.stack(imgs), np.stack(poses).astype(np.float32)

    splits = {"train": os.path.join(basedir, "train", scene),
              "val": os.path.join(basedir, "validation", scene),
              "test": os.path.join(basedir, "test", scene)}
    all_imgs, all_poses, counts = [], [], [0]
    for s in ("train", "val", "test"):
        imgs, poses = dir_data(splits[s])
        if s != "train" and testskip > 1:
            imgs, poses = imgs[::testskip], poses[::testskip]
        poses = poses @ np.diag([1, -1, -1, 1]).astype(np.float32)
        all_imgs.append(imgs)
        all_poses.append(poses)
        counts.append(counts[-1] + len(imgs))
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs)
    poses = np.concatenate(all_poses)
    H, W = imgs[0].shape[:2]
    K = parse_intrinsics(os.path.join(basedir, "train", scene, "intrinsics.txt"), H)
    render_poses = poses[i_split[2]]
    return imgs, poses, render_poses, [H, W, float(K[0, 0])], i_split
