"""A seeded synthetic unbounded scene, made with numpy.

Counterpart in spirit of ``unboundednerfpytorch_tpu/data/synthetic.py``: a
scene with known geometry so the trainer runs end to end with no dataset on
disk. Cameras orbit the origin at alternating elevations (the 360-capture
pattern of the Mip-NeRF-360 scenes). The scene is a textured sphere at the
origin inside a far sky: each pixel's colour is found in closed form
(ray-sphere intersection), so full-resolution views cost seconds.
:func:`forward_facing_scene` is the forward-facing counterpart (the LLFF
captures of ``configs/llff``): cameras on a small plane, all looking down
-z at a ball before a textured wall. :func:`write_llff_scene` and
:func:`write_nerfpp_scene` put such scenes on disk in the layouts the
loaders read; :func:`write_tankstemple_scene`, :func:`write_free_scene`,
:func:`write_nerfstudio_scene`, :func:`write_waymo_scene`,
:func:`write_mega_scene`, :func:`write_blender_scene`,
:func:`write_nsvf_scene`, :func:`write_blendedmvs_scene` and
:func:`write_deepvoxels_scene` in the other nine;
:func:`write_linemod_scene` and :func:`write_co3d_scene` write an object
sequence in the LINEMOD (pvnet) and CO3D layouts. With ``alpha``,
:func:`orbit_scene` makes RGBA views whose alpha is the sphere's coverage
(the NeRF-synthetic and NSVF captures, composited on white by the loader).
:func:`cluster_scene` lays out the four textured spheres of the JAX
package's unbounded test scene on white, for the pose tuner's recovery.
:func:`write_colmap_scene` writes a capture with the COLMAP sparse model of
its known cameras and of surface points (:func:`forward_facing_points`), for
``--program sfm`` and the COLMAP tooling. :func:`street_scene` (the JAX
``make_street_scene``, in torch on any device) drives cameras down a street
of textured buildings, each view with its own exposure, for Block-NeRF;
:func:`write_waymo_tfrecords` writes views as the Waymo Block-NeRF
release's TFRecords (per-pixel ray origins and directions, intrinsics,
camera, exposure, PNG bytes), which ``data/preprocess.py`` decodes, and
:func:`write_block_nerf_scene` lays a decoded capture out as Block-NeRF
reads it (``<split>/rgbs``, ``<split>_all_meta.json`` and the blocks of
``preprocess.split_blocks``).
"""

from __future__ import annotations

import gzip
import json
import os
import zlib

import numpy as np


def look_at_pose(cam_pos: np.ndarray, target: np.ndarray, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """OpenGL-style c2w (the camera looks down -z), as NeRF poses expect."""
    forward = target - cam_pos
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, np.asarray(up, dtype=np.float64))
    right = right / np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = np.cross(right, forward)
    c2w[:3, 2] = -forward
    c2w[:3, 3] = cam_pos
    return c2w


def _sphere_color(p: np.ndarray, phase: np.ndarray) -> np.ndarray:
    tex = np.sin(6.0 * p[:, :1] + phase[0]) * np.sin(5.0 * p[:, 1:2] + phase[1]) \
        * np.sin(4.0 * p[:, 2:3] + phase[2])
    base = np.array([0.85, 0.45, 0.3]) + 0.1 * np.sin(phase)
    return base * (0.55 + 0.45 * tex)


def _sky_color(d: np.ndarray, phase: np.ndarray) -> np.ndarray:
    return np.stack([
        0.55 + 0.3 * np.sin(2.0 * d[:, 0] + 3.0 * d[:, 2] + phase[0]),
        0.55 + 0.3 * np.sin(2.5 * d[:, 1] - 1.3 + phase[1]),
        0.6 + 0.3 * np.cos(3.0 * d[:, 0] * d[:, 1] + 0.4 + phase[2]),
    ], -1)


def orbit_scene(n_views: int = 20, H: int = 411, W: int = 618, *, seed: int = 0,
                sphere_radius: float = 0.8, cam_radius: float = 3.0,
                near_clip: float = 0.5, n_test: int = 0, focal_scale: float = 0.8,
                alpha: bool = False) -> dict:
    """A reference-shaped data_dict (numpy) of ``n_views`` training views and
    ``n_test`` held-out views (``i_test``), which sit half-way between
    training cameras on the same orbit; the training views do not depend on
    ``n_test``.

    The seed sets the texture phases and the orbit's starting angle.
    ``sphere_radius`` is the world radius of the object at the origin; the
    focal length is ``focal_scale * W``. With ``alpha`` each view is RGBA,
    its alpha 1 where the ray meets the sphere and 0 on the sky.
    """
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0.0, 2.0 * np.pi, 3)
    theta0 = rng.uniform(0.0, 2.0 * np.pi)
    focal = focal_scale * W
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], dtype=np.float32)
    i, j = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5, indexing="xy")
    dirs_cam = np.stack([(i - W / 2) / focal, -(j - H / 2) / focal, -np.ones_like(i)], -1)
    dirs_cam = dirs_cam.reshape(-1, 3)

    poses, images = [], []
    held_out = [(n_views // max(n_test, 1)) * k + 0.5 for k in range(n_test)]
    for k in list(range(n_views)) + held_out:
        theta = theta0 + 2 * np.pi * k / n_views
        elev = 0.5 if k in held_out else (0.35 if k % 2 == 0 else 0.65)
        pos = cam_radius * np.array([np.cos(theta) * np.cos(elev),
                                     np.sin(theta) * np.cos(elev), np.sin(elev)])
        c2w = look_at_pose(pos, np.zeros(3))
        d = dirs_cam @ c2w[:3, :3].T
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        # |pos + t d|^2 = r^2, nearest root
        b = d @ pos
        disc = b * b - (pos @ pos - sphere_radius**2)
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        rgb = _sky_color(d, phase)
        p_hit = pos + t[hit, None] * d[hit]
        rgb[hit] = _sphere_color(p_hit, phase)
        poses.append(c2w.astype(np.float32))
        if alpha:
            rgb = np.concatenate([rgb, hit[:, None].astype(np.float64)], -1)
        images.append(np.clip(rgb, 0.0, 1.0).reshape(H, W, -1).astype(np.float32))

    n = n_views + n_test
    return {
        "HW": np.array([[H, W]] * n),
        "Ks": np.stack([K] * n),
        "near": near_clip,
        "far": 100.0,
        "near_clip": near_clip,
        "i_train": np.arange(n_views),
        "i_val": np.arange(0),
        "i_test": np.arange(n_views, n),
        "poses": np.stack(poses),
        "images": np.stack(images),
        "irregular_shape": False,
    }


# the four spheres (centre, radius) of the JAX package's unbounded test scene
# (its data/synthetic.py::_scene_density_color)
CLUSTER_SPHERES = (((0.45, 0.0, -0.1), 0.38), ((-0.4, 0.35, 0.05), 0.30),
                   ((-0.15, -0.5, -0.2), 0.26), ((0.05, 0.15, 0.42), 0.22))


def cluster_scene(n_views: int = 20, H: int = 96, W: int = 96, *, seed: int = 0,
                  cam_radius: float = 3.0, focal_scale: float = 1.2) -> dict:
    """A data_dict (numpy) of ``n_views`` training views of four textured
    spheres (:data:`CLUSTER_SPHERES`) on white, from cameras on an orbit of
    ``cam_radius`` at alternating elevations, looking at the origin, focal
    ``focal_scale * W``; near 1, far 6. The spheres lie at different depths
    from every camera, so a camera's sideways shift moves them against each
    other: each pose is well-posed against its view, where a lone sphere
    leaves a sideways shift with its compensating rotation nearly free. The
    seed sets the texture phases."""
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0.0, 2.0 * np.pi, 3)
    focal = focal_scale * W
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], dtype=np.float32)
    i, j = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5, indexing="xy")
    dirs_cam = np.stack([(i - W / 2) / focal, -(j - H / 2) / focal, -np.ones_like(i)], -1)
    dirs_cam = dirs_cam.reshape(-1, 3)
    poses, images = [], []
    for k in range(n_views):
        theta = 2 * np.pi * k / n_views
        elev = 0.35 if k % 2 == 0 else 0.65
        pos = cam_radius * np.array([np.cos(theta) * np.cos(elev),
                                     np.sin(theta) * np.cos(elev), np.sin(elev)])
        c2w = look_at_pose(pos, np.zeros(3))
        d = dirs_cam @ c2w[:3, :3].T
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        nearest = np.full(len(d), np.inf)
        rgb = np.ones_like(d)
        for n, (centre, radius) in enumerate(CLUSTER_SPHERES):
            oc = pos - np.asarray(centre)
            b = d @ oc
            disc = b * b - (oc @ oc - radius**2)
            t = -b - np.sqrt(np.maximum(disc, 0.0))
            hit = (disc > 0) & (t < nearest)
            nearest[hit] = t[hit]
            local = (pos + t[hit, None] * d[hit] - np.asarray(centre)) * (0.8 / radius)
            rgb[hit] = _sphere_color(local, phase + n)
        poses.append(c2w.astype(np.float32))
        images.append(np.clip(rgb, 0.0, 1.0).reshape(H, W, 3).astype(np.float32))
    return {
        "HW": np.array([[H, W]] * n_views),
        "Ks": np.stack([K] * n_views),
        "near": 1.0,
        "far": 6.0,
        "near_clip": None,
        "i_train": np.arange(n_views),
        "i_val": np.arange(0),
        "i_test": np.arange(0),
        "poses": np.stack(poses),
        "images": np.stack(images),
        "irregular_shape": False,
    }


def forward_facing_scene(n_views: int = 20, H: int = 756, W: int = 1008, *, seed: int = 0,
                         ball_depth: float = 4.0, ball_radius: float = 1.0,
                         wall_depth: float = 8.0) -> dict:
    """A reference-shaped data_dict (numpy) of a forward-facing capture:
    ``n_views`` cameras at seeded points of a 1.0 x 0.6 patch of the plane
    z = 0, every one looking down -z (no rotation), at a textured ball of
    ``ball_radius`` centred ``ball_depth`` in front of the patch and a
    textured wall at ``wall_depth``. Every view is a training view
    (``i_train``); the loader holds views out by ``llffhold``."""
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0.0, 2.0 * np.pi, 3)
    focal = 0.8 * W
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], dtype=np.float32)
    i, j = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5, indexing="xy")
    d = np.stack([(i - W / 2) / focal, -(j - H / 2) / focal, -np.ones_like(i)], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).reshape(-1, 3)
    center = np.array([0.0, 0.0, -ball_depth])
    poses, images = [], []
    for xy in rng.uniform(-1.0, 1.0, (n_views, 2)) * np.array([0.5, 0.3]):
        pos = np.array([xy[0], xy[1], 0.0])
        t_wall = (wall_depth + pos[2]) / -d[:, 2]
        rgb = _sky_color(0.15 * (pos + t_wall[:, None] * d), phase)
        oc = pos - center
        b = d @ oc
        disc = b * b - (oc @ oc - ball_radius**2)
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        rgb[hit] = _sphere_color(pos + t[hit, None] * d[hit] - center, phase)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = pos
        poses.append(c2w)
        images.append(np.clip(rgb, 0.0, 1.0).reshape(H, W, 3).astype(np.float32))
    return {
        "HW": np.array([[H, W]] * n_views),
        "Ks": np.stack([K] * n_views),
        "near": 0.0,
        "far": 1.0,
        "i_train": np.arange(n_views),
        "i_val": np.arange(0),
        "i_test": np.arange(0),
        "poses": np.stack(poses),
        "images": np.stack(images),
        "irregular_shape": False,
    }


def occupancy_seed(scene_center, scene_radius, sphere_radius: float = 0.8,
                   margin: float = 1.5):
    """``coarse_mask_fn(world_size, xyz_min, xyz_max)`` for the trainer: the
    occupancy a coarse stage would find in :func:`orbit_scene`, in the
    model's contracted coordinates: a ball around the sphere (its radius
    times ``margin``) and the whole contracted background (``|p|_inf > 1``),
    where the sky lies."""
    center = np.asarray(scene_center, np.float64)
    radius = float(np.max(scene_radius))

    def fn(world_size, xyz_min, xyz_max):
        axes = [np.linspace(lo, hi, int(n)) for lo, hi, n in zip(xyz_min, xyz_max, world_size)]
        p = np.stack(np.meshgrid(*axes, indexing="ij"), -1)
        ball = np.linalg.norm(p + center / radius, axis=-1) < margin * sphere_radius / radius
        return ball | (np.abs(p).max(-1) > 1.0)

    return fn


def imprint_scene(params, scene_center, scene_radius, *, seed: int = 0,
                  sphere_radius: float = 0.8, haze: float = -3.0, solid: float = 7.0) -> None:
    """Write the geometry of :func:`orbit_scene` into a model's grids, in
    place: a few train steps do not make a scene, and a render of a near-empty
    model exercises neither the early exit nor the thresholds nor the color
    budget. Bank 0 of the density grid gains an opaque ball where the sphere
    is (raw density + act_shift = ``solid`` inside, with a soft edge) and a
    thin haze in a shell of the contracted background (``haze``, where
    1 < |p|_inf < 1.03, on the white fields of a checkerboard of side 1/4), so
    that a ray ends on the ball after a few samples, crosses clear sky, or
    gathers some fifty low-weight samples in the haze (more than a usual
    ``color_budget``); every k0 bank gains seeded noise, so that the color query returns
    content. ``params`` is the port's FourierGridParams on any device."""
    import torch

    dgrid, kgrid = params.density.grid.data, params.k0.grid.data
    dev = dgrid.device
    B, X, Y, Z, _ = dgrid.shape
    mn, mx = params.density.xyz_min, params.density.xyz_max
    axes = [torch.linspace(lo, hi, n, device=dev) for lo, hi, n in zip(mn, mx, (X, Y, Z))]
    p = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)
    radius = float(np.max(scene_radius))
    center = torch.tensor(-np.asarray(scene_center, np.float64) / radius, dtype=p.dtype,
                          device=dev)
    rs = sphere_radius / radius
    dist = torch.linalg.norm(p - center, dim=-1)
    shift = params.act_shift
    raw = (solid - shift) * torch.sigmoid((rs - dist) / (0.08 * rs))
    far = p.abs().amax(-1)
    white = torch.floor(p * 4.0).sum(-1) % 2 == 0
    raw = raw + (haze - shift) * ((far > 1.0) & (far < 1.03) & white)
    dgrid[0, ..., 0] += (B * raw).to(dgrid.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for b in range(kgrid.shape[0]):
        kgrid[b] += (0.5 * torch.randn(kgrid.shape[1:], generator=gen, device=dev)).to(
            kgrid.dtype)


def write_llff_scene(basedir: str, data: dict, factor: int = 8, bounds=(0.5, 100.0)) -> str:
    """Write a data_dict of :func:`orbit_scene` or :func:`forward_facing_scene`
    (every view, in order) in the on-disk layout of a Mip-NeRF-360 or LLFF
    capture: ``poses_bounds.npy`` in the LLFF storage convention and the views
    as ``images_{factor}/*.png``. ``bounds`` are every view's near and far
    depths (an NDC scene takes its near plane and scale from them).

    A row of ``poses_bounds.npy`` is a [3, 5] matrix, flattened, and the
    view's near and far bounds: its columns are [-up, right, back] of the
    camera, its position, and (H, W, focal) at the full resolution, ``factor``
    times the stored images'. ``data.llff`` turns the columns back to
    [right, up, back] and then changes the gauge (``bd_factor`` scale,
    recentering, spherification), which keeps each pose and its image
    consistent. The full-resolution ``images/`` is not written: the loader
    reads ``images_{factor}/`` as it is."""
    from unboundednerfpytorch_tpu_torch.data.png import write_png

    outdir = os.path.join(basedir, f"images_{factor}")
    os.makedirs(outdir, exist_ok=True)
    rows = []
    for i, (img, c2w, K, hw) in enumerate(zip(data["images"], data["poses"], data["Ks"],
                                              data["HW"])):
        write_png(os.path.join(outdir, f"img_{i:03d}.png"),
                  (np.clip(img, 0.0, 1.0) * 255 + 0.5).astype(np.uint8))
        c2w = np.asarray(c2w, np.float64)[:3]
        hwf = np.array([[hw[0] * factor], [hw[1] * factor], [K[0][0] * factor]], np.float64)
        stored = np.concatenate([-c2w[:, 1:2], c2w[:, 0:1], c2w[:, 2:4], hwf], axis=1)
        rows.append(np.concatenate([stored.reshape(-1), bounds]))
    np.save(os.path.join(basedir, "poses_bounds.npy"), np.stack(rows))
    return basedir


def write_nerfpp_scene(basedir: str, data: dict) -> str:
    """Write a data_dict of :func:`orbit_scene` in the NeRF++ layout of the
    Tanks & Temples scenes: ``train/`` (the ``i_train`` views) and ``test/``
    (``i_test``), each with ``intrinsics/``, ``pose/`` (4x4 matrices as text,
    one a view) and ``rgb/`` (PNG). The poses are written in the OpenCV
    convention of those scenes (camera x right, y down, looking along +z;
    the configs set ``inverse_y``)."""
    from unboundednerfpytorch_tpu_torch.data.png import write_png

    to_cv = np.diag([1.0, -1.0, -1.0, 1.0])
    for split, ids in (("train", data["i_train"]), ("test", data["i_test"])):
        for sub in ("intrinsics", "pose", "rgb"):
            os.makedirs(os.path.join(basedir, split, sub), exist_ok=True)
        for n, i in enumerate(np.asarray(ids)):
            K4 = np.eye(4)
            K4[:3, :3] = data["Ks"][i]
            np.savetxt(os.path.join(basedir, split, "intrinsics", f"{n:06d}.txt"),
                       K4.reshape(1, -1))
            c2w = np.eye(4)
            c2w[:3] = np.asarray(data["poses"][i], np.float64)[:3]
            np.savetxt(os.path.join(basedir, split, "pose", f"{n:06d}.txt"),
                       (c2w @ to_cv).reshape(1, -1))
            write_png(os.path.join(basedir, split, "rgb", f"{n:06d}.png"),
                      (np.clip(data["images"][i], 0.0, 1.0) * 255 + 0.5).astype(np.uint8))
    return basedir


# camera axes of the OpenCV convention (x right, y down, looking along +z)
# from those of the OpenGL one the scenes are made in
TO_OPENCV = np.diag([1.0, -1.0, -1.0, 1.0])


def _to8(img) -> np.ndarray:
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255 + 0.5).astype(np.uint8)


def _upsampled(img, factor: int) -> np.ndarray:
    """The 8-bit image at ``factor`` times its size (each pixel repeated),
    which an area resize by ``factor`` turns back into it exactly."""
    return np.repeat(np.repeat(_to8(img), factor, 0), factor, 1)


def _c2w(pose, opencv: bool) -> np.ndarray:
    c2w = np.eye(4)
    c2w[:3] = np.asarray(pose, np.float64)[:3]
    return c2w @ TO_OPENCV if opencv else c2w


def write_tankstemple_scene(basedir: str, data: dict) -> str:
    """The DVGO release's Tanks & Temples layout: ``pose/`` (4x4 OpenCV
    poses as text) and ``rgb/`` (PNG), the first character of a name the
    view's split (0: ``i_train``, 1: ``i_test``), and ``intrinsics.txt``
    (the first view's 3x3 K, which every view shares)."""
    from unboundednerfpytorch_tpu_torch.data.png import write_png

    for sub in ("pose", "rgb"):
        os.makedirs(os.path.join(basedir, sub), exist_ok=True)
    for split, ids in ((0, data["i_train"]), (1, data["i_test"])):
        for n, i in enumerate(np.asarray(ids)):
            name = f"{split}_{n:04d}"
            np.savetxt(os.path.join(basedir, "pose", name + ".txt"),
                       _c2w(data["poses"][i], True))
            write_png(os.path.join(basedir, "rgb", name + ".png"), _to8(data["images"][i]))
    np.savetxt(os.path.join(basedir, "intrinsics.txt"), np.asarray(data["Ks"][0], np.float64))
    return basedir


def write_free_scene(basedir: str, data: dict, factor: int = 2,
                     bounds=(0.5, 100.0)) -> str:
    """The free-trajectory (F2-NeRF) layout: ``cams_meta.npy``, a row a
    view of its 3x4 OpenGL pose, its 3x3 K at full resolution, 4 distortion
    terms (0) and its near and far ``bounds``, and ``images/`` at full
    resolution (``factor`` times the data's, each pixel repeated, so the
    loader's area resize gives the data's 8-bit images back)."""
    from unboundednerfpytorch_tpu_torch.data.png import write_png

    os.makedirs(os.path.join(basedir, "images"), exist_ok=True)
    rows = []
    for i, (img, pose, K) in enumerate(zip(data["images"], data["poses"], data["Ks"])):
        write_png(os.path.join(basedir, "images", f"{i:05d}.png"), _upsampled(img, factor))
        K_full = np.asarray(K, np.float64).copy()
        K_full[:2, :3] *= factor
        rows.append(np.concatenate([np.asarray(pose, np.float64)[:3, :4].reshape(-1),
                                    K_full.reshape(-1), np.zeros(4), bounds]))
    np.save(os.path.join(basedir, "cams_meta.npy"), np.stack(rows))
    return basedir


def write_nerfstudio_scene(basedir: str, data: dict, factor: int = 4) -> str:
    """The nerfstudio layout: ``transforms.json`` (``fl_x`` at full
    resolution, each frame's ``file_path`` and 4x4 OpenGL
    ``transform_matrix``) and ``images/`` at full resolution (``factor``
    times the data's, each pixel repeated). Every view shares the first
    view's focal length, with the principal point at the centre."""
    from unboundednerfpytorch_tpu_torch.data.png import write_png

    os.makedirs(os.path.join(basedir, "images"), exist_ok=True)
    frames = []
    for i, (img, pose) in enumerate(zip(data["images"], data["poses"])):
        name = f"images/frame_{i:05d}.png"
        write_png(os.path.join(basedir, name), _upsampled(img, factor))
        frames.append({"file_path": name, "transform_matrix": _c2w(pose, False).tolist()})
    with open(os.path.join(basedir, "transforms.json"), "w") as f:
        json.dump({"fl_x": float(data["Ks"][0][0][0]) * factor, "frames": frames}, f)
    return basedir


def _metadata_split(views) -> dict:
    """A split of ``metadata.json`` from (file_path, c2w, K, H, W, cam_idx)
    tuples."""
    keys = ("file_path", "cam2world", "K", "width", "height", "position", "cam_idx",
            "equivalent_exposure")
    split = {k: [] for k in keys}
    for path, c2w, K, h, w, cam in views:
        for k, v in zip(keys, (path, c2w.tolist(), np.asarray(K, np.float64).tolist(), int(w),
                               int(h), c2w[:3, 3].tolist(), int(cam), 1.0)):
            split[k].append(v)
    return split


def _write_metadata_scene(basedir: str, data: dict, cam_idxs, n_val: int, names) -> dict:
    """``metadata.json`` and the images of a Waymo-layout capture: the last
    ``n_val`` views of ``data`` are the val split, the others the train
    split, named by ``names(split, k, cam_idx)``; poses in the OpenCV
    convention. Returns the metadata."""
    from unboundednerfpytorch_tpu_torch.data.png import write_png

    n = len(data["images"])
    meta = {}
    for split, ids in (("train", range(n - n_val)), ("val", range(n - n_val, n))):
        os.makedirs(os.path.join(basedir, f"images_{split}"), exist_ok=True)
        views = []
        for k, i in enumerate(ids):
            path = f"images_{split}/{names(split, k, cam_idxs[i])}.png"
            img = _to8(data["images"][i])
            write_png(os.path.join(basedir, path), img)
            views.append((path, _c2w(data["poses"][i], True), data["Ks"][i], *img.shape[:2],
                          cam_idxs[i]))
        meta[split] = _metadata_split(views)
    with open(os.path.join(basedir, "metadata.json"), "w") as f:
        json.dump(meta, f)
    return meta


def write_waymo_scene(basedir: str, data: dict, cam_idxs, n_val: int = 2,
                      diffusion: dict | None = None) -> str:
    """The Waymo (Block-NeRF) layout: ``metadata.json`` with a train and a
    val split (the last ``n_val`` views of ``data``), the views as
    ``images_train/<cam>_<k>.png`` (the k-th training view of camera
    ``<cam>``, the names ``training_ids`` select) and
    ``images_val/<k>.png``. ``cam_idxs`` gives each view's camera; the
    poses are stored in the OpenCV convention (the configs set
    ``inverse_y``). ``diffusion`` ({name: image}) writes
    ``diffusion/<name>.png``, the replacements ``--diffuse`` reads."""
    from unboundednerfpytorch_tpu_torch.data.png import write_png

    counts = {}

    def names(split, k, cam):
        if split == "val":
            return f"{k}"
        counts[cam] = counts.get(cam, -1) + 1
        return f"{cam}_{counts[cam]}"

    _write_metadata_scene(basedir, data, list(cam_idxs), n_val, names)
    if diffusion:
        os.makedirs(os.path.join(basedir, "diffusion"), exist_ok=True)
        for name, img in diffusion.items():
            write_png(os.path.join(basedir, "diffusion", f"{name}.png"), _to8(img))
    return basedir


def write_mega_scene(basedir: str, data: dict, n_val: int = 2, odd: dict | None = None) -> str:
    """The Mega-NeRF layout (that of :func:`write_waymo_scene`, one camera);
    ``odd``, a data_dict of one view of another image size, is added to the
    train split: the loader keeps the most common size only, so it must
    drop it."""
    n_train = len(data["images"]) - n_val
    if odd is not None:
        data = {k: list(data[k][:n_train]) + list(odd[k][:1]) + list(data[k][n_train:])
                for k in ("images", "poses", "Ks")}
    _write_metadata_scene(basedir, data, [0] * len(data["images"]), n_val,
                          lambda split, k, cam: f"{k:06d}")
    return basedir


def _held_out(data: dict):
    """(val views, test views) of a data_dict: its ``i_val``, or its
    ``i_test`` where it has no val views."""
    i_val = np.asarray(data.get("i_val", ()), np.int64)
    i_test = np.asarray(data["i_test"], np.int64)
    return (i_val if i_val.size else i_test), i_test


def write_blender_scene(basedir: str, data: dict) -> str:
    """The NeRF-synthetic layout: ``transforms_{train,val,test}.json``
    (``camera_angle_x`` from the first view's focal length and width, and a
    frame a view: ``file_path`` ``./<split>/r_<n>`` and its OpenGL c2w as
    ``transform_matrix``) beside ``<split>/r_<n>.png`` (RGBA for an RGBA
    data_dict). The val views are ``i_val``, or ``i_test`` without them."""
    from unboundednerfpytorch_tpu_torch.data.png import write_png

    K = np.asarray(data["Ks"][0], np.float64)
    W = np.asarray(data["images"][0]).shape[1]
    angle = 2.0 * np.arctan(0.5 * W / K[0, 0])
    i_val, i_test = _held_out(data)
    for split, ids in (("train", data["i_train"]), ("val", i_val), ("test", i_test)):
        os.makedirs(os.path.join(basedir, split), exist_ok=True)
        frames = []
        for n, i in enumerate(np.asarray(ids)):
            write_png(os.path.join(basedir, split, f"r_{n}.png"), _to8(data["images"][i]))
            frames.append({"file_path": f"./{split}/r_{n}",
                           "transform_matrix": _c2w(data["poses"][i], False).tolist()})
        with open(os.path.join(basedir, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": float(angle), "frames": frames}, f)
    return basedir


def _write_pose_rgb(basedir: str, splits) -> None:
    """``pose/<split>_<n>.txt`` (4x4 OpenCV c2w) and ``rgb/<split>_<n>.png``
    of each (split number, [(image, pose)])."""
    from unboundednerfpytorch_tpu_torch.data.png import write_png

    for sub in ("pose", "rgb"):
        os.makedirs(os.path.join(basedir, sub), exist_ok=True)
    for split, views in splits:
        for n, (img, pose) in enumerate(views):
            name = f"{split}_{n:04d}"
            np.savetxt(os.path.join(basedir, "pose", name + ".txt"), _c2w(pose, True))
            write_png(os.path.join(basedir, "rgb", name + ".png"), _to8(img))


def _views(data: dict, ids):
    return [(data["images"][i], data["poses"][i]) for i in np.asarray(ids)]


def write_nsvf_scene(basedir: str, data: dict) -> str:
    """The NSVF layout: ``pose/`` (4x4 OpenCV poses) and ``rgb/`` (PNG, RGBA
    for an RGBA data_dict), the first character of a name the split (0
    train, 1 val: ``i_val`` or ``i_test`` without it, 2 test), and
    ``intrinsics.txt`` whose first line is ``focal cx cy 0``."""
    i_val, i_test = _held_out(data)
    _write_pose_rgb(basedir, [(0, _views(data, data["i_train"])), (1, _views(data, i_val)),
                              (2, _views(data, i_test))])
    f_, cx, cy = (float(v) for v in np.asarray(data["Ks"][0], np.float64)[[0, 0, 1], [0, 2, 2]])
    with open(os.path.join(basedir, "intrinsics.txt"), "w") as f:
        f.write(f"{f_!r} {cx!r} {cy!r} 0.\n0. 0. 0.\n1.\n")
    return basedir


def write_blendedmvs_scene(basedir: str, data: dict) -> str:
    """The BlendedMVS layout of the DVGO release: ``pose/`` and ``rgb/``
    (RGB PNG) as :func:`write_tankstemple_scene` writes them (0 train, 1
    test), the 3x3 ``intrinsics.txt`` and ``test_traj.txt``, the test views'
    4x4 poses a row each of four."""
    views = [(np.asarray(img)[..., :3], pose) for img, pose in
             zip(data["images"], data["poses"])]
    _write_pose_rgb(basedir, [(0, [views[i] for i in np.asarray(data["i_train"])]),
                              (1, [views[i] for i in np.asarray(data["i_test"])])])
    np.savetxt(os.path.join(basedir, "intrinsics.txt"), np.asarray(data["Ks"][0], np.float64))
    traj = np.concatenate([_c2w(data["poses"][i], True) for i in np.asarray(data["i_test"])])
    np.savetxt(os.path.join(basedir, "test_traj.txt"), traj)
    return basedir


def write_deepvoxels_scene(basedir: str, data: dict, scene: str = "greek") -> str:
    """The DeepVoxels layout: ``train/<scene>/``, ``validation/<scene>/``
    (``i_val``, or ``i_test`` without it) and ``test/<scene>/``, each with
    ``pose/<n>.txt`` (4x4 OpenCV c2w, which the loader turns back with
    diag(1, -1, -1, 1)) and ``rgb/<n>.png`` (RGB on white), and
    ``train/<scene>/intrinsics.txt``: ``focal cx cy 0``, two lines, then
    ``height width``."""
    from unboundednerfpytorch_tpu_torch.data.png import write_png

    i_val, i_test = _held_out(data)
    for split, ids in (("train", data["i_train"]), ("validation", i_val), ("test", i_test)):
        root = os.path.join(basedir, split, scene)
        for sub in ("pose", "rgb"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
        for n, i in enumerate(np.asarray(ids)):
            img = np.asarray(data["images"][i])
            if img.shape[-1] == 4:
                img = img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])
            np.savetxt(os.path.join(root, "pose", f"{n:06d}.txt"), _c2w(data["poses"][i], True))
            write_png(os.path.join(root, "rgb", f"{n:06d}.png"), _to8(img))
    f_, cx, cy = (float(v) for v in np.asarray(data["Ks"][0], np.float64)[[0, 0, 1], [0, 2, 2]])
    H, W = np.asarray(data["images"][0]).shape[:2]
    with open(os.path.join(basedir, "train", scene, "intrinsics.txt"), "w") as f:
        f.write(f"{f_!r} {cx!r} {cy!r} 0.\n0. 0. 0.\n1.\n{H} {W}\n")
    return basedir


def _sphere_hits(origin: np.ndarray, dirs: np.ndarray, radius: float):
    """(hit [P], hit points [hits, 3]) of rays from ``origin`` along unit
    ``dirs`` [P, 3] against the sphere of ``radius`` at the world origin."""
    b = dirs @ origin
    disc = b * b - (origin @ origin - radius**2)
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    return hit, origin + t[hit, None] * dirs[hit]


def _shade(origin: np.ndarray, dirs: np.ndarray, radius: float, phase: np.ndarray):
    """(rgb [P, 3] of the textured sphere at the origin before the sky, hit
    [P]); the texture is that of a sphere of radius 0.8 scaled to
    ``radius``."""
    d = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    hit, p = _sphere_hits(origin, d, radius)
    rgb = _sky_color(d, phase)
    rgb[hit] = _sphere_color(p * (0.8 / radius), phase)
    return np.clip(rgb, 0.0, 1.0), hit


def _write_jpeg(path: str, img8: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img8).save(path, quality=95)


# the LINEMOD writer's object (a sphere of 5 cm, the size of the ape), the
# range of its cameras' distances (m), its frames' size and model points
LINEMOD_RADIUS, LINEMOD_DISTANCE, LINEMOD_HW, LINEMOD_POINTS = 0.05, (0.6, 0.9), (480, 640), 500


def write_linemod_scene(basedir: str, seq: str = "ape", n_frames: int = 24, n_test: int = 4,
                        *, seed: int = 0) -> str:
    """A seeded LINEMOD sequence in the pvnet layout under ``basedir/seq``:
    ``JPEGImages/<6 digits>.jpg`` (640x480 frames through the shared
    LINEMOD intrinsics), ``mask/<stem>.png`` (the object's coverage),
    ``pose/pose<i>.npy`` ([3, 4] object poses, world -> camera in the OpenCV
    convention of the real sequences: x right, y down, the object ahead at
    +z), ``train.txt`` and ``test.txt`` (the last ``n_test`` frames) and
    ``<seq>.ply``, 500 points of the object's surface in binary
    little-endian float32. The object is the textured sphere of
    :func:`orbit_scene` with a radius of 5 cm at the world origin, seen
    from seeded directions of the upper hemisphere at seeded distances of
    0.6 to 0.9 m, each camera aimed a little off the object. Returns the
    sequence's directory."""
    radius, (H, W), n_points = LINEMOD_RADIUS, LINEMOD_HW, LINEMOD_POINTS
    from unboundednerfpytorch_tpu_torch.data.png import write_png
    from unboundednerfpytorch_tpu_torch.utils.pose_eval import LINEMOD_K

    rng = np.random.default_rng(seed)
    phase = rng.uniform(0.0, 2.0 * np.pi, 3)
    seq_dir = os.path.join(basedir, seq)
    for sub in ("JPEGImages", "mask", "pose"):
        os.makedirs(os.path.join(seq_dir, sub), exist_ok=True)
    K = np.asarray(LINEMOD_K, np.float64)
    u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5, indexing="xy")
    dirs_cam = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], np.ones_like(u)],
                        -1).reshape(-1, 3)
    stems = []
    for i in range(n_frames):
        az = rng.uniform(0.0, 2.0 * np.pi)
        el = rng.uniform(0.2, 1.2)
        dist = rng.uniform(*LINEMOD_DISTANCE)
        cam = dist * np.array([np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), np.sin(el)])
        gl = look_at_pose(cam, rng.normal(0.0, 0.2 * radius, 3))
        c2w = gl @ TO_OPENCV
        R = c2w[:3, :3].T
        rt = np.concatenate([R, (-R @ cam)[:, None]], 1)
        rgb, hit = _shade(cam, dirs_cam @ c2w[:3, :3].T, radius, phase)
        stem = f"{i:06d}"
        stems.append(stem)
        _write_jpeg(os.path.join(seq_dir, "JPEGImages", stem + ".jpg"),
                    _to8(rgb.reshape(H, W, 3)))
        write_png(os.path.join(seq_dir, "mask", stem + ".png"),
                  (hit.reshape(H, W) * 255).astype(np.uint8))
        np.save(os.path.join(seq_dir, "pose", f"pose{i}.npy"), rt)
    for name, part in (("train.txt", stems[:n_frames - n_test]),
                       ("test.txt", stems[n_frames - n_test:])):
        with open(os.path.join(seq_dir, name), "w") as f:
            f.write("".join(f"JPEGImages/{s}.jpg\n" for s in part))
    pts = rng.normal(size=(n_points, 3))
    pts = (radius * pts / np.linalg.norm(pts, axis=-1, keepdims=True)).astype("<f4")
    with open(os.path.join(seq_dir, f"{seq}.ply"), "wb") as f:
        f.write((f"ply\nformat binary_little_endian 1.0\nelement vertex {n_points}\n"
                 "property float x\nproperty float y\nproperty float z\nend_header\n")
                .encode("ascii"))
        f.write(pts.tobytes())
    return seq_dir


def write_co3d_scene(basedir: str, sequence_name: str = "34_1479_4753", n_frames: int = 20,
                     n_test: int = 4, *, seed: int = 0, H: int = 800, W: int = 600,
                     sizes=None, empty_frames: int = 1) -> dict:
    """A seeded CO3D sequence: ``<basedir>/<sequence_name>/images/frame<n>.jpg``
    and ``masks/frame<n>.png``, and beside the sequence's directory the
    gzipped ``frame_annotations.jgz`` (a frame of another sequence among
    them) and ``set_lists.json`` (``train_known``: the first frames,
    ``test_unseen``: the last ``n_test``). The scene is :func:`orbit_scene`'s
    sphere and sky, the cameras on its orbit. Each viewpoint holds R and T
    with [R | T] world -> camera in the axes the co3d configs' rays take
    (``inverse_y``, ``flip_x``, ``flip_y``: x left, y up, looking along +z),
    and the principal point and focal length in NDC units (0 and ``2 f /
    (W, H)``, f = 0.8 W). ``sizes`` gives each frame its own (H, W); ``empty_frames``
    more frames have an empty mask (mass 0), which the loader drops.
    Returns {"datadir", "annot_path", "split_path", "sequence_name"}."""
    from unboundednerfpytorch_tpu_torch.data.png import write_png

    rng = np.random.default_rng(seed)
    phase = rng.uniform(0.0, 2.0 * np.pi, 3)
    theta0 = rng.uniform(0.0, 2.0 * np.pi)
    seq_dir = os.path.join(basedir, sequence_name)
    for sub in ("images", "masks"):
        os.makedirs(os.path.join(seq_dir, sub), exist_ok=True)
    sizes = list(sizes) if sizes is not None else [(H, W)] * n_frames
    to_p3d = np.diag([-1.0, 1.0, -1.0, 1.0])  # OpenGL camera axes -> x left, y up, +z ahead
    annot, known, unseen = [], [], []
    for i in range(n_frames + empty_frames):
        h, w = sizes[i % len(sizes)]
        theta = theta0 + 2 * np.pi * i / n_frames
        elev = 0.35 if i % 2 == 0 else 0.65
        cam = 3.0 * np.array([np.cos(theta) * np.cos(elev),
                                     np.sin(theta) * np.cos(elev), np.sin(elev)])
        c2w = look_at_pose(cam, np.zeros(3)) @ to_p3d
        R = c2w[:3, :3].T
        T = -R @ cam
        half_wh = np.float32([w, h]) * 0.5
        fl = np.float32(0.8 * w) / half_wh
        f_px = fl * half_wh
        # the pixel rays of the configs' flags, as the loader's K gives them
        px, py = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
        dirs = np.stack([((w - 1 - px) + 0.5 - half_wh[0]) / f_px[0],
                         ((h - 1 - py) + 0.5 - half_wh[1]) / f_px[1], np.ones(px.shape)],
                        -1).reshape(-1, 3)
        rgb, hit = _shade(cam, dirs @ c2w[:3, :3].T, 0.8, phase)
        if i >= n_frames:
            hit[:] = False
        name = f"frame{i:06d}"
        img_path, mask_path = f"images/{name}.jpg", f"masks/{name}.png"
        _write_jpeg(os.path.join(seq_dir, img_path), _to8(rgb.reshape(h, w, 3)))
        write_png(os.path.join(seq_dir, mask_path), (hit.reshape(h, w) * 255).astype(np.uint8))
        annot.append({"sequence_name": sequence_name, "frame_number": i,
                      "image": {"path": img_path, "size": [h, w]},
                      "mask": {"path": mask_path, "mass": int(hit.sum())},
                      "viewpoint": {"R": R.tolist(), "T": T.tolist(),
                                    "principal_point": [0.0, 0.0],
                                    "focal_length": [float(v) for v in fl]}})
        (unseen if n_frames - n_test <= i < n_frames else known).append(
            [sequence_name, i, img_path])
    other = dict(annot[0], sequence_name="0_0_0")
    annot_path = os.path.join(basedir, "frame_annotations.jgz")
    with gzip.open(annot_path, "wt", encoding="utf8") as f:
        json.dump(annot + [other], f)
    split_path = os.path.join(basedir, "set_lists.json")
    with open(split_path, "w") as f:
        json.dump({"train_known": known, "test_unseen": unseen}, f)
    return {"datadir": seq_dir, "annot_path": annot_path, "split_path": split_path,
            "sequence_name": sequence_name}


def forward_facing_points(n_points: int = 4000, *, seed: int = 0, ball_depth: float = 4.0,
                          ball_radius: float = 1.0, wall_depth: float = 8.0,
                          wall_half: tuple = (7.0, 4.5)) -> tuple:
    """Surface points of :func:`forward_facing_scene`'s geometry, as a
    sparse reconstruction would hold them: (xyz [P, 3] float64, rgb [P, 3]
    uint8). Half lie on the ball's half facing the cameras, half on the wall
    over ``wall_half`` about the z axis (what the views see of it)."""
    rng = np.random.default_rng(seed)
    n_ball = n_points // 2
    d = rng.standard_normal((n_ball, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:, 2] = np.abs(d[:, 2])  # the half towards the cameras at z = 0
    ball = np.array([0.0, 0.0, -ball_depth]) + ball_radius * d
    wall = np.stack([rng.uniform(-wall_half[0], wall_half[0], n_points - n_ball),
                     rng.uniform(-wall_half[1], wall_half[1], n_points - n_ball),
                     np.full(n_points - n_ball, -wall_depth)], -1)
    xyz = np.concatenate([ball, wall])
    return xyz, rng.integers(0, 256, (n_points, 3), dtype=np.uint8)


def _rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """COLMAP's unit quaternion (w, x, y, z) of a rotation matrix
    (``colmap_read_model.py::rotmat2qvec``)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([[Rxx - Ryy - Rzz, 0, 0, 0],
                  [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                  [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                  [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def write_colmap_scene(basedir: str, data: dict, points, factor: int = 1,
                       text: bool = False) -> str:
    """Write a data_dict's views (every view, in order, named
    ``img_000.png`` ...) with a whole COLMAP sparse model ``sparse/0`` of
    their known cameras, as COLMAP's mapper would leave it: ``cameras.bin``
    (one PINHOLE camera shared by every view), ``images.bin`` (each view's
    world-to-camera rotation as a quaternion and its translation, in COLMAP's
    camera frame: x right, y down, looking along +z) and ``points3D.bin``
    (``points`` = (xyz [P, 3], rgb [P, 3] uint8), each observed by every view
    it projects into, in front of the camera). ``text`` writes the text
    model (``cameras.txt``, ``images.txt``, ``points3D.txt``) instead.

    The camera record describes the full resolution, ``factor`` times the
    views'. The views go to ``images/`` where ``factor`` is 1, else to
    ``images_{factor}/``, the LLFF layout's downsampled copy that the
    ``llff`` loader reads as it is (the full-resolution ``images/`` is then
    not written, as :func:`write_llff_scene` does). ``gen_poses`` finds the
    model whole and runs no COLMAP."""
    import struct

    from unboundednerfpytorch_tpu_torch.data.png import write_png

    xyz, rgb = (np.asarray(a) for a in points)
    outdir = os.path.join(basedir, "images" if factor == 1 else f"images_{factor}")
    sparse = os.path.join(basedir, "sparse", "0")
    os.makedirs(outdir, exist_ok=True)
    os.makedirs(sparse, exist_ok=True)
    H, W = (int(v) * factor for v in np.asarray(data["HW"])[0])
    K = np.asarray(data["Ks"][0], np.float64)
    params = [float(K[0, 0] * factor), float(K[1, 1] * factor), float(K[0, 2] * factor),
              float(K[1, 2] * factor)]
    views, tracks = [], [[] for _ in range(len(xyz))]
    for i, (img, pose) in enumerate(zip(data["images"], data["poses"])):
        name = f"img_{i:03d}.png"
        write_png(os.path.join(outdir, name), _to8(img))
        w2c = np.linalg.inv(_c2w(pose, opencv=True))
        cam = xyz @ w2c[:3, :3].T + w2c[:3, 3]
        z = np.where(cam[:, 2] > 0, cam[:, 2], 1.0)
        uv = np.stack([params[0] * cam[:, 0] / z + params[2],
                       params[1] * cam[:, 1] / z + params[3]], -1)
        seen = np.flatnonzero((cam[:, 2] > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < W)
                              & (uv[:, 1] >= 0) & (uv[:, 1] < H))
        for k, p in enumerate(seen):
            tracks[p].append((i + 1, k))
        views.append((i + 1, _rotmat2qvec(w2c[:3, :3]), w2c[:3, 3], name, uv[seen], seen + 1))
    if text:
        with open(os.path.join(sparse, "cameras.txt"), "w") as f:
            f.write("# CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n")
            f.write(f"1 PINHOLE {W} {H} " + " ".join(repr(v) for v in params) + "\n")
        with open(os.path.join(sparse, "images.txt"), "w") as f:
            f.write("# IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME\n# POINTS2D[] as (X, Y, "
                    "POINT3D_ID)\n")
            for image_id, q, t, name, uv, ids in views:
                f.write(f"{image_id} " + " ".join(repr(float(v)) for v in (*q, *t))
                        + f" 1 {name}\n")
                f.write(" ".join(f"{u!r} {v!r} {p}" for (u, v), p in zip(uv.tolist(), ids))
                        + "\n")
        with open(os.path.join(sparse, "points3D.txt"), "w") as f:
            f.write("# POINT3D_ID X Y Z R G B ERROR TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
            for p, (pt, c, track) in enumerate(zip(xyz.tolist(), rgb.tolist(), tracks)):
                f.write(f"{p + 1} " + " ".join(repr(v) for v in pt) + " "
                        + " ".join(str(v) for v in c) + " 0.5 "
                        + " ".join(f"{a} {b}" for a, b in track) + "\n")
        return basedir
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<QiiQQ4d", 1, 1, 1, W, H, *params))  # model 1: PINHOLE
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(views)))
        for image_id, q, t, name, uv, ids in views:
            f.write(struct.pack("<i7di", image_id, *q, *t, 1) + name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(ids)))
            for (u, v), p in zip(uv.tolist(), ids.tolist()):
                f.write(struct.pack("<ddq", u, v, p))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for p, (pt, c, track) in enumerate(zip(xyz.tolist(), rgb.tolist(), tracks)):
            f.write(struct.pack("<Q3d3Bd", p + 1, *pt, *c, 0.5))
            f.write(struct.pack("<Q", len(track)))
            for a, b in track:
                f.write(struct.pack("<ii", a, b))
    return basedir


# ---------------------------------------------------------------------------
# the street scene of Block-NeRF and the Waymo release's records

# the building boxes of the street: x centres, and each one's colour
STREET_CENTERS = (-3.6, -1.2, 1.2, 3.6)
STREET_PALETTES = ((0.85, 0.4, 0.3), (0.35, 0.6, 0.85), (0.5, 0.8, 0.4), (0.85, 0.75, 0.35))
STREET_SKY = (0.65, 0.75, 0.9)


def _street_density_color(pts):
    """The JAX ``_street_density_color`` in torch: textured boxes on both
    sides of the x axis and a ground slab (density 50 inside), their colours
    averaged where they overlap."""
    import torch

    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    density = torch.zeros(pts.shape[:-1], dtype=pts.dtype, device=pts.device)
    color = torch.zeros_like(pts)
    wsum = torch.zeros_like(density)
    for side in (-1.0, 1.0):
        for cx, base in zip(STREET_CENTERS, STREET_PALETTES):
            inside = ((torch.abs(x - cx) < 0.7) & (torch.abs(y - side * 1.8) < 0.5)
                      & (z > -0.5) & (z < 1.0 + 0.3 * float(np.sin(3.0 * cx))))
            f = inside.to(pts.dtype)
            density = density + f * 50.0
            tex = 0.5 + 0.5 * torch.sin(9.0 * x + 2.0 * side) * torch.sin(7.0 * z + 1.0)
            col = torch.tensor(base, dtype=pts.dtype, device=pts.device) * (
                0.4 + 0.6 * tex[..., None])
            color = color + f[..., None] * col
            wsum = wsum + f
    gf = ((z > -0.62) & (z < -0.5)).to(pts.dtype)
    density = density + gf * 50.0
    check = 0.5 + 0.5 * torch.sin(6.0 * x) * torch.sin(6.0 * y)
    color = color + gf[..., None] * torch.stack(
        [0.3 + 0.3 * check, 0.3 + 0.3 * check, 0.32 + 0.2 * check], -1)
    wsum = wsum + gf
    return density, torch.clamp(color / torch.clamp(wsum[..., None], min=1.0), 0.0, 1.0)


def street_scene(n_views: int = 16, H: int = 40, W: int = 56, near: float = 0.05,
                 far: float = 14.0, n_steps: int = 448, device="cpu", chunk: int = 1 << 14):
    """The JAX ``make_street_scene``: ``n_views`` cameras at x from -3.2 to
    3.2 down the street, turned alternately to either side, each view's
    exposure scaling its image. Returns (views, images): ``views[i]`` the
    Block-NeRF metadata of a view (c2w [3][4], intrinsics [f, f], W, H,
    equivalent_exposure, image_name ``street_<i>``), ``images[i]`` its
    [H, W, 3] float32 image, rendered along the rays of
    ``models/block_nerf/dataset.py`` by ``n_steps`` samples from ``near`` to
    ``far``, ``chunk`` rays at a time on ``device``."""
    import torch

    from unboundednerfpytorch_tpu_torch.models.block_nerf import dataset as D

    focal = 0.8 * W
    sky = torch.tensor(STREET_SKY, device=device)
    t = torch.linspace(near, far, n_steps, device=device)
    dt = t[1] - t[0]
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    views, images = [], []
    for i in range(n_views):
        xcam = -3.2 + 6.4 * i / max(n_views - 1, 1)
        cam = np.array([xcam, 0.0, 0.55])
        yaw = 0.55 if i % 2 == 0 else -0.55
        c2w = look_at_pose(cam, np.array([xcam + 2.2, yaw * 2.0, 0.25]))
        exposure = 0.85 + 0.3 * (i % 4) / 3.0
        views.append({"c2w": c2w[:3].tolist(), "intrinsics": [focal, focal], "W": W, "H": H,
                      "equivalent_exposure": exposure, "image_name": f"street_{i:03d}"})
        ro, rd = D.get_rays(D.get_ray_directions(H, W, K), np.asarray(c2w[:3], np.float32))
        ro = torch.as_tensor(np.ascontiguousarray(ro), device=device)
        rd = torch.as_tensor(rd, device=device)
        rgb = []
        with torch.no_grad():
            for k in range(0, ro.shape[0], chunk):
                o, d = ro[k:k + chunk], rd[k:k + chunk]
                density, color = _street_density_color(o[:, None] + d[:, None] * t[None, :, None])
                alpha = 1.0 - torch.exp(-density * dt)
                keep = 1 - alpha + 1e-10
                w = torch.cumprod(keep, -1) / keep * alpha
                rgb.append(torch.einsum("ns,nsc->nc", w, color)
                           + (1 - w.sum(-1))[:, None] * sky)
        img = torch.clamp(torch.cat(rgb).reshape(H, W, 3) * exposure, 0.0, 1.0)
        images.append(img.float().cpu().numpy())
    return views, images


def split_street_blocks(views, overlap: float = 1.2) -> dict:
    """The JAX ``split_street_blocks``: two overlapping blocks by camera x
    about the median (the overlap at least 2.1 camera spacings), each
    {"centroid", "elements": [(image name, view index)]}, the appearance ids
    global."""
    xs = np.array([np.asarray(v["c2w"])[0, 3] for v in views])
    mid = float(np.median(xs))
    if len(xs) > 1:
        overlap = max(overlap, 2.1 * float(np.max(np.diff(np.sort(xs)))))
    split = {}
    for name, keep in (("block_0", xs <= mid + overlap / 2), ("block_1", xs >= mid - overlap / 2)):
        ids = np.nonzero(keep)[0]
        split[name] = {
            "centroid": np.mean([np.asarray(views[i]["c2w"])[:3, 3] for i in ids],
                                axis=0).tolist(),
            "elements": [(views[i]["image_name"], int(i)) for i in ids],
        }
    return split


def waymo_frame(info: dict, image, cam_idx: int) -> dict:
    """The tf.Example features of one view as the Waymo Block-NeRF release
    holds them: the image as PNG bytes, its size, intrinsics [fx, fy],
    camera, exposure, and every pixel's ray origin and unit direction (the
    pixel-centre rays of ``models/block_nerf/dataset.py`` through ``c2w``)."""
    from unboundednerfpytorch_tpu_torch.data.png import encode_png
    from unboundednerfpytorch_tpu_torch.models.block_nerf import dataset as D

    H, W = int(info["H"]), int(info["W"])
    fx, fy = (float(f) for f in info["intrinsics"][:2])
    K = np.array([[fx, 0, W / 2], [0, fy, H / 2], [0, 0, 1]], np.float32)
    ro, rd = D.get_rays(D.get_ray_directions(H, W, K), np.asarray(info["c2w"], np.float32))
    return {
        "image_hash": [zlib.crc32(str(info.get("image_name", "")).encode())],
        "cam_idx": [int(cam_idx)],
        "equivalent_exposure": np.array([info["equivalent_exposure"]], np.float32),
        "height": [H],
        "width": [W],
        "image": encode_png(_to8(image)),
        "ray_origins": np.asarray(ro, np.float32).reshape(-1),
        "ray_dirs": np.asarray(rd, np.float32).reshape(-1),
        "intrinsics": np.array([fx, fy], np.float32),
    }


def write_waymo_tfrecords(path: str, views, images, cam_idxs, compress: bool = True) -> str:
    """Views as one TFRecord file of :func:`waymo_frame` records (gzipped by
    default, as the release is). A file whose name holds ``validation`` is
    the val split to ``preprocess.decode_waymo_tfrecords``."""
    from unboundednerfpytorch_tpu_torch.data import tfrecord

    tfrecord.write_records(path, [tfrecord.encode_example(waymo_frame(v, im, c))
                                  for v, im, c in zip(views, images, cam_idxs)],
                           compress=compress)
    return path


def write_block_nerf_scene(decoded_dir: str, out_dir: str, radius: float = 2.0,
                           overlap: float = 0.5) -> dict:
    """A capture decoded by ``preprocess.decode_waymo_tfrecords`` laid out
    as Block-NeRF reads it: ``<split>/rgbs/<name>.png`` (each view's image,
    named by its file), ``<split>/<split>_all_meta.json`` ({name: c2w [3][4],
    intrinsics [fx, fy], W, H, equivalent_exposure, image_name, cam_idx,
    origin_pos}) and ``<split>/split_block_<split>.json``: the training
    views' blocks by ``preprocess.split_blocks(radius, overlap)``, and for
    the val split the val views within ``radius`` of each such block's
    centroid. Returns the blocks of the train split."""
    import shutil

    from unboundednerfpytorch_tpu_torch.data import preprocess

    with open(os.path.join(decoded_dir, "metadata.json")) as f:
        decoded = json.load(f)
    metas = {}
    for split, m in decoded.items():
        os.makedirs(os.path.join(out_dir, split, "rgbs"), exist_ok=True)
        meta = {}
        for k, path in enumerate(m["file_path"]):
            name = os.path.splitext(os.path.basename(path))[0]
            shutil.copyfile(os.path.join(decoded_dir, path),
                            os.path.join(out_dir, split, "rgbs", name + ".png"))
            K = np.asarray(m["K"][k])
            meta[name] = {"c2w": np.asarray(m["cam2world"][k])[:3].tolist(),
                          "intrinsics": [float(K[0, 0]), float(K[1, 1])],
                          "W": int(m["width"][k]), "H": int(m["height"][k]),
                          "equivalent_exposure": float(m["equivalent_exposure"][k]),
                          "image_name": name, "cam_idx": int(m["cam_idx"][k]),
                          "origin_pos": list(m["position"][k])}
        metas[split] = meta
        with open(os.path.join(out_dir, split, f"{split}_all_meta.json"), "w") as f:
            json.dump(meta, f)
    blocks = preprocess.split_blocks({n: v["origin_pos"] for n, v in metas["train"].items()},
                                     radius=radius, overlap=overlap)
    preprocess.write_block_split(blocks, os.path.join(out_dir, "train", "split_block_train.json"))
    if "val" in metas:
        val = {}
        for block, info in blocks.items():
            c = np.asarray(info["centroid"])
            names = [n for n, v in metas["val"].items()
                     if np.linalg.norm(c - np.asarray(v["origin_pos"])) <= radius]
            val[block] = {"centroid": info["centroid"],
                          "elements": [[n, k] for k, n in enumerate(names)]}
        preprocess.write_block_split(val, os.path.join(out_dir, "val", "split_block_val.json"))
    return blocks
