"""LLFF-format loader (forward-facing and unbounded inward scenes).

The port's copy of ``unboundednerfpytorch_tpu/data/llff.py``, numpy only:
``poses_bounds.npy``, factor-based minification, pose recentering,
``bd_factor`` rescaling, spherification for inward captures, and the spiral
and circular render paths. It backs the Mip-NeRF-360 scenes
(``configs/nerf_unbounded``), whose captures ship ``images_{factor}/``.
Images are read by :func:`..data.png.imread`; making a missing
``images_{factor}/`` or ``images_{W}x{H}/`` needs ``cv2``.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from unboundednerfpytorch_tpu_torch.data.png import imread as _imread
from unboundednerfpytorch_tpu_torch.data.png import write_png

_IMAGE_EXTS = ("jpg", "jpeg", "png")


def _image_files(d: str) -> list:
    return sorted(f for f in glob.glob(os.path.join(d, "*")) if f.lower().endswith(_IMAGE_EXTS))


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("resizing a capture's images needs the cv2 package (an LLFF "
                           "capture may ship its images_<factor>/ directory instead)") from e
    return cv2


def _resized_dir(basedir: str, outdir: str, size_of) -> str:
    """``outdir`` holding area-resized PNG copies of ``images/``, made where
    it is missing or holds another count of images (a capture that ships
    ``outdir`` without ``images/`` is taken as it is). ``size_of(h, w)``
    gives the (width, height) of the copy."""
    srcs = _image_files(os.path.join(basedir, "images"))
    outs = _image_files(outdir)
    if outs and (not srcs or len(outs) == len(srcs)):
        return outdir
    cv2 = _cv2()
    os.makedirs(outdir, exist_ok=True)
    for f in srcs:
        im = _imread(f)
        im2 = cv2.resize(im, size_of(*im.shape[:2]), interpolation=cv2.INTER_AREA)
        write_png(os.path.join(outdir, os.path.splitext(os.path.basename(f))[0] + ".png"), im2)
    return outdir


def _ensure_minified(basedir: str, factor: int) -> str:
    """``images_{factor}/`` with area-resized copies, made where missing."""
    return _resized_dir(basedir, os.path.join(basedir, f"images_{factor}"),
                        lambda h, w: (w // factor, h // factor))


def _ensure_resized(basedir: str, width: int, height: int) -> str:
    """``images_{W}x{H}/`` with exact-resolution copies, made where missing."""
    return _resized_dir(basedir, os.path.join(basedir, f"images_{width}x{height}"),
                        lambda h, w: (width, height))


def _load_data(basedir: str, factor: int | None = None,
               width: int | None = None, height: int | None = None):
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])

    imgdir = os.path.join(basedir, "images")
    # width/height override factor; the missing one follows the native aspect
    if width is not None or height is not None:
        native = _imread(_image_files(imgdir)[0]).shape  # (H, W, C)
        if height is None:
            height = int(native[0] / (native[1] / float(width)))
        if width is None:
            width = int(native[1] / (native[0] / float(height)))
        imgdir = _ensure_resized(basedir, int(width), int(height))
        scale = native[0] / float(height)
    elif factor is not None and factor > 1:
        imgdir = _ensure_minified(basedir, factor)
        scale = float(factor)
    else:
        scale = 1.0
    imgfiles = _image_files(imgdir)
    if poses.shape[-1] != len(imgfiles):
        raise ValueError(f"{len(imgfiles)} images vs {poses.shape[-1]} poses in {basedir}")
    sh = _imread(imgfiles[0]).shape
    poses[:2, 4, :] = np.array(sh[:2]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] * 1.0 / scale

    imgs = np.stack(
        [(_imread(f)[..., :3] / 255.0).astype(np.float32) for f in imgfiles], -1
    )
    return poses, bds, imgs


def normalize(x):
    return x / np.linalg.norm(x)


def viewmatrix(z, up, pos):
    vec2 = normalize(z)
    vec1_avg = up
    vec0 = normalize(np.cross(vec1_avg, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def poses_avg(poses):
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([viewmatrix(vec2, up, center), hwf], 1)


def recenter_poses(poses):
    poses_ = poses + 0
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = poses_avg(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], -2)
    bottom = np.tile(np.reshape(bottom, [1, 1, 4]), [poses.shape[0], 1, 1])
    poses_h = np.concatenate([poses[:, :3, :4], bottom], -2)
    poses_h = np.linalg.inv(c2w) @ poses_h
    poses_[:, :3, :4] = poses_h[:, :3, :4]
    return poses_


def render_path_spiral(c2w, up, rads, focal, zdelta, zrate, rots, N):
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]:
        c = np.dot(
            c2w[:3, :4],
            np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]) * rads,
        )
        z = normalize(c - np.dot(c2w[:3, :4], np.array([0, 0, -focal, 1.0])))
        render_poses.append(np.concatenate([viewmatrix(z, up, c), hwf], 1))
    return render_poses


def _circle_poses(radcircle, zh, center=0.0):
    """120 poses on a circle of radius ``radcircle`` at height ``zh``, each
    looking at the axis, camera up along -z."""
    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array([radcircle * np.cos(th), radcircle * np.sin(th), zh])
        up = np.array([0, 0, -1.0])
        vec2 = normalize(camorigin)
        vec0 = normalize(np.cross(vec2, up))
        vec1 = normalize(np.cross(vec2, vec0))
        new_poses.append(np.stack([vec0, vec1, vec2, camorigin + center], 1))
    return np.stack(new_poses, 0)


def spherify_poses(poses, bds):
    """Inward-capture spherification."""
    p34_to_44 = lambda p: np.concatenate(
        [p, np.tile(np.reshape(np.eye(4)[-1, :], [1, 1, 4]), [p.shape[0], 1, 1])], 1
    )
    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    def min_line_dist(rays_o, rays_d):
        A_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
        b_i = -A_i @ rays_o
        return np.squeeze(
            -np.linalg.inv((np.transpose(A_i, [0, 2, 1]) @ A_i).mean(0)) @ b_i.mean(0)
        )

    pt_mindist = min_line_dist(rays_o, rays_d)
    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = normalize(up)
    vec1 = normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = normalize(np.cross(vec0, vec1))
    pos = center
    c2w = np.stack([vec1, vec2, vec0, pos], 1)

    poses_reset = np.linalg.inv(p34_to_44(c2w[None])) @ p34_to_44(poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(rad**2 - zh**2)
    new_poses = _circle_poses(radcircle, zh)
    new_poses = np.concatenate(
        [new_poses, np.broadcast_to(poses[0, :3, -1:], new_poses[:, :3, -1:].shape)], -1
    )
    poses_reset = np.concatenate(
        [poses_reset[:, :3, :4], np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape)],
        -1,
    )
    return poses_reset, new_poses, bds


def load_llff_data(
    basedir: str,
    factor: int = 8,
    width=None,
    height=None,
    recenter: bool = True,
    bd_factor: float | None = 0.75,
    spherify: bool = False,
    path_zflat: bool = False,
    load_depths: bool = False,
    movie_render_kwargs: dict | None = None,
):
    movie_render_kwargs = dict(movie_render_kwargs or {})
    del load_depths  # depth maps: not supported (unused by the pipeline)
    poses, bds, imgs = _load_data(
        basedir, factor=factor, width=width, height=height
    )

    # stored columns [-up, right, back] -> [right, up, back]; views to axis 0
    poses = np.concatenate([poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    imgs = np.moveaxis(imgs, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds *= sc

    if recenter:
        poses = recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = spherify_poses(poses, bds)
        if movie_render_kwargs:
            centroid = poses[:, :3, 3].mean(0)
            radcircle = movie_render_kwargs.get("scale_r", 1.0) * np.linalg.norm(
                poses[:, :3, 3] - centroid, axis=-1
            ).mean()
            zh = centroid[2] + movie_render_kwargs.get("shift_z", 0)
            new_poses = _circle_poses(radcircle, zh, centroid)
            render_poses = np.concatenate(
                [new_poses, np.broadcast_to(poses[0, :3, -1:], new_poses[:, :3, -1:].shape)],
                -1,
            )
    else:
        c2w = poses_avg(poses)
        up = normalize(poses[:, :3, 1].sum(0))
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        mean_dz = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
        focal = mean_dz * movie_render_kwargs.get("scale_f", 1.0)
        zdelta = movie_render_kwargs.get("zdelta", 0.5) * close_depth
        zrate = movie_render_kwargs.get("zrate", 1.0)
        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, 0) * movie_render_kwargs.get("scale_r", 1.0)
        if path_zflat:
            zloc = -close_depth * 0.1
            c2w = c2w.copy()
            c2w[:3, 3] = c2w[:3, 3] + zloc * c2w[:3, 2]
            rads[2] = 0.0
            zrate = 0.5
        render_poses = np.stack(
            render_path_spiral(
                c2w, up, rads, focal, zdelta, zrate=zrate,
                rots=movie_render_kwargs.get("N_rots", 1),
                N=movie_render_kwargs.get("N_views", 120),
            )
        )

    c2w = poses_avg(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))

    return imgs, None, poses, bds, np.asarray(render_poses, np.float32), i_test
