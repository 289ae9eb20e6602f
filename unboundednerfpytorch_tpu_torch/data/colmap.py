"""COLMAP / SfM ingestion for custom scenes.

The port's copy of ``unboundednerfpytorch_tpu/data/colmap.py``, numpy and
``subprocess`` as that module is: the COLMAP subprocess driver
(:func:`run_colmap`), the binary and text sparse-model readers (cameras,
images, points3D), :class:`SceneManager`, ``poses_bounds.npy`` for the LLFF
pipeline (:func:`gen_poses`, the ``--program sfm`` of the command line), the
conversion to the NeRF++ 'standard' layout (:func:`colmap_to_standard`) and
the ``cams_meta`` / ``poses_bounds[_raw]`` exports (:func:`export_cams_meta`,
``tools/colmap2standard.py``). They follow the reference's
``tools/colmap_utils/`` (its vendored pycolmap) and
``run_colmap2standard.py``. One departure: :func:`_first_image_hw` reads the
first image through the port's ``data.png.imread`` (PIL) and lets a file it
cannot read raise, where the JAX package tries cv2, then imageio, and falls
back to the camera record on any failure.
"""

from __future__ import annotations

import os
import struct
import subprocess

import numpy as np


# ---------------------------------------------------------------------------
# COLMAP subprocess driver (tools/colmap_utils/colmap_wrapper.py:25-88)
# ---------------------------------------------------------------------------

def run_colmap(basedir: str, match_type: str = "exhaustive_matcher",
               colmap_bin: str = "colmap") -> None:
    """feature_extractor → matcher → mapper into basedir/sparse/0."""
    logfile = os.path.join(basedir, "colmap_output.txt")
    with open(logfile, "w") as log:
        subprocess.check_call(
            [colmap_bin, "feature_extractor",
             "--database_path", os.path.join(basedir, "database.db"),
             "--image_path", os.path.join(basedir, "images"),
             "--ImageReader.single_camera", "1"],
            stdout=log, stderr=subprocess.STDOUT,
        )
        subprocess.check_call(
            [colmap_bin, match_type,
             "--database_path", os.path.join(basedir, "database.db")],
            stdout=log, stderr=subprocess.STDOUT,
        )
        os.makedirs(os.path.join(basedir, "sparse"), exist_ok=True)
        subprocess.check_call(
            [colmap_bin, "mapper",
             "--database_path", os.path.join(basedir, "database.db"),
             "--image_path", os.path.join(basedir, "images"),
             "--output_path", os.path.join(basedir, "sparse"),
             "--Mapper.num_threads", "16",
             "--Mapper.init_min_tri_angle", "4",
             "--Mapper.multiple_models", "0",
             "--Mapper.extract_colors", "0"],
            stdout=log, stderr=subprocess.STDOUT,
        )


# ---------------------------------------------------------------------------
# Binary sparse-model readers (colmap_read_model.py / pycolmap scene_manager)
# ---------------------------------------------------------------------------

def _read_next_bytes(f, num_bytes, fmt, endian="<"):
    return struct.unpack(endian + fmt, f.read(num_bytes))


_CAM_MODEL_PARAMS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


def read_cameras_binary(path: str) -> dict:
    cameras = {}
    with open(path, "rb") as f:
        (n,) = _read_next_bytes(f, 8, "Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read_next_bytes(f, 24, "iiQQ")
            name, n_params = _CAM_MODEL_PARAMS[model_id]
            params = np.array(_read_next_bytes(f, 8 * n_params, "d" * n_params))
            cameras[cam_id] = {
                "model": name, "width": w, "height": h, "params": params,
            }
    return cameras


def read_images_binary(path: str) -> dict:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read_next_bytes(f, 8, "Q")
        for _ in range(n):
            vals = _read_next_bytes(f, 64, "idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (n_pts,) = _read_next_bytes(f, 8, "Q")
            elems = _read_next_bytes(f, 24 * n_pts, "ddq" * n_pts)
            xys = np.array(elems).reshape(-1, 3)[:, :2] if n_pts else np.zeros((0, 2))
            pt_ids = (
                np.array(elems).reshape(-1, 3)[:, 2].astype(np.int64)
                if n_pts else np.zeros((0,), np.int64)
            )
            images[image_id] = {
                "qvec": qvec, "tvec": tvec, "camera_id": camera_id,
                "name": name.decode(), "xys": xys, "point3D_ids": pt_ids,
            }
    return images


def read_points3d_binary(path: str) -> dict:
    points = {}
    with open(path, "rb") as f:
        (n,) = _read_next_bytes(f, 8, "Q")
        for _ in range(n):
            vals = _read_next_bytes(f, 43, "QdddBBBd")
            pid = vals[0]
            xyz = np.array(vals[1:4])
            rgb = np.array(vals[4:7])
            error = vals[7]
            (track_len,) = _read_next_bytes(f, 8, "Q")
            track = _read_next_bytes(f, 8 * track_len, "ii" * track_len)
            points[pid] = {
                "xyz": xyz, "rgb": rgb, "error": error,
                "image_ids": np.array(track[0::2]),
            }
    return points


# COLMAP models with a single shared focal: params lead with [f, cx, cy, ...]
# (src/base/camera_models.h); every other model leads with [fx, fy, cx, cy, ...]
_SINGLE_FOCAL_MODELS = frozenset(
    {"SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
     "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"}
)


def intrinsics_from_params(model: str, params) -> tuple:
    """(fx, fy, cx, cy) from a COLMAP camera record, honoring the per-model
    parameter layout (RADIAL-family models carry one focal length)."""
    p = np.asarray(params, dtype=np.float64)
    if model in _SINGLE_FOCAL_MODELS:
        return float(p[0]), float(p[0]), float(p[1]), float(p[2])
    return float(p[0]), float(p[1]), float(p[2]), float(p[3])


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


# ---------------------------------------------------------------------------
# SceneManager facade (vendored pycolmap scene_manager.py equivalent surface)
# ---------------------------------------------------------------------------

def read_cameras_text(path: str) -> dict:
    cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cameras[int(parts[0])] = {
                "model": parts[1],
                "width": int(parts[2]),
                "height": int(parts[3]),
                "params": np.array([float(p) for p in parts[4:]]),
            }
    return cameras


def read_images_text(path: str) -> dict:
    images = {}
    with open(path) as f:
        # keep blank lines: an image with zero observations is written as a
        # meta line followed by an EMPTY points line — dropping blanks would
        # silently skip it and misalign every following (meta, pts) pair
        lines = [l.strip() for l in f if not l.startswith("#")]
    # leading/trailing whitespace-only lines are not records; a blank line in
    # the pts position mid-file is (zero observations)
    while lines and not lines[0]:
        lines.pop(0)
    while lines and not lines[-1] and len(lines) % 2:
        lines.pop()
    for meta_line, pts_line in zip(lines[0::2], lines[1::2]):
        if not meta_line:
            continue
        p = meta_line.split()
        pts = pts_line.split()
        xys = np.array([float(v) for v in pts]).reshape(-1, 3) if pts else np.zeros((0, 3))
        images[int(p[0])] = {
            "qvec": np.array([float(v) for v in p[1:5]]),
            "tvec": np.array([float(v) for v in p[5:8]]),
            "camera_id": int(p[8]),
            "name": p[9],
            "xys": xys[:, :2],
            "point3D_ids": xys[:, 2].astype(np.int64) if len(xys) else np.zeros((0,), np.int64),
        }
    return images


def read_points3d_text(path: str) -> dict:
    points = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            track = np.array([int(v) for v in p[8::2]], np.int64)
            points[int(p[0])] = {
                "xyz": np.array([float(v) for v in p[1:4]]),
                "rgb": np.array([int(v) for v in p[4:7]]),
                "error": float(p[7]),
                "image_ids": track,
            }
    return points


class SceneManager:
    """Compact equivalent of the reference's vendored pycolmap SceneManager
    (``pycolmap/scene_manager.py``):
    loads a COLMAP sparse model (binary or text), exposes cameras / images /
    points3D with name<->id maps, intrinsic matrices, and w2c/c2w pose math
    — the surface run_colmap2standard.py builds on."""

    INVALID_POINT3D = np.iinfo(np.uint64).max  # pycolmap uses uint64(-1)

    def __init__(self, folder: str, image_path: str | None = None):
        self.folder = folder
        self.image_path = image_path
        self.cameras: dict = {}
        self.images: dict = {}
        self.name_to_image_id: dict = {}
        self.points3D = np.zeros((0, 3))
        self.point3D_ids = np.empty(0, np.int64)
        self.point3D_colors = np.zeros((0, 3), np.uint8)
        self.point3D_errors = np.zeros((0,))
        self.point3D_id_to_images: dict = {}

    # --- loading ----------------------------------------------------------
    def _path(self, stem: str) -> str:
        for ext in (".bin", ".txt"):
            p = os.path.join(self.folder, stem + ext)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"{stem}.bin/.txt not found in {self.folder}")

    def load(self) -> "SceneManager":
        self.load_cameras()
        self.load_images()
        self.load_points3D()
        return self

    def load_cameras(self):
        p = self._path("cameras")
        self.cameras = (
            read_cameras_binary(p) if p.endswith(".bin") else read_cameras_text(p)
        )

    def load_images(self):
        p = self._path("images")
        self.images = (
            read_images_binary(p) if p.endswith(".bin") else read_images_text(p)
        )
        self.name_to_image_id = {
            im["name"]: iid for iid, im in self.images.items()
        }

    def load_points3D(self):
        p = self._path("points3D")
        pts = (
            read_points3d_binary(p) if p.endswith(".bin")
            else read_points3d_text(p)
        )
        self.point3D_ids = np.array(sorted(pts.keys()), np.int64)
        self.points3D = np.array(
            [pts[i]["xyz"] for i in self.point3D_ids]
        ) if len(self.point3D_ids) else np.zeros((0, 3))
        self.point3D_colors = np.array(
            [pts[i]["rgb"] for i in self.point3D_ids], np.uint8
        ) if len(self.point3D_ids) else np.zeros((0, 3), np.uint8)
        self.point3D_errors = np.array(
            [pts[i]["error"] for i in self.point3D_ids]
        )
        self.point3D_id_to_images = {
            int(i): pts[i]["image_ids"] for i in self.point3D_ids
        }

    # --- camera math (scene_manager.py get_camera_matrix equivalents) -----
    def camera_matrix(self, camera_id: int) -> np.ndarray:
        cam = self.cameras[camera_id]
        fx, fy, cx, cy = intrinsics_from_params(cam["model"], cam["params"])
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)

    def world_to_camera(self, image_id: int) -> np.ndarray:
        im = self.images[image_id]
        R = qvec2rotmat(im["qvec"])
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3] = im["tvec"]
        return w2c

    def camera_to_world(self, image_id: int) -> np.ndarray:
        return np.linalg.inv(self.world_to_camera(image_id))

    def image_points3D(self, image_id: int) -> np.ndarray:
        """xyz of the valid 3D points observed by an image.

        Referenced ids absent from point3D_ids (e.g. dropped by
        filter_points3D, or an inconsistent model) are skipped — a bare
        searchsorted would silently map them to a neighboring point
        (pycolmap scene_manager id->index semantics)."""
        ids = self.images[image_id]["point3D_ids"]
        ids = ids[ids >= 0]
        idx = np.searchsorted(self.point3D_ids, ids)
        inb = idx < len(self.point3D_ids)
        idx, ids = idx[inb], ids[inb]
        hit = self.point3D_ids[idx] == ids
        return self.points3D[idx[hit]]

    def filter_points3D(self, max_error: float = np.inf, min_track_len: int = 0):
        """Keep points below a reprojection error / above a track length."""
        track = np.array([
            len(self.point3D_id_to_images[int(i)]) for i in self.point3D_ids
        ]) if len(self.point3D_ids) else np.zeros((0,))
        keep = (self.point3D_errors <= max_error) & (track >= min_track_len)
        self.points3D = self.points3D[keep]
        self.point3D_colors = self.point3D_colors[keep]
        self.point3D_errors = self.point3D_errors[keep]
        self.point3D_ids = self.point3D_ids[keep]
        return int(keep.sum())


# ---------------------------------------------------------------------------
# poses_bounds.npy generation (tools/colmap_utils/pose_utils.py gen_poses)
# ---------------------------------------------------------------------------

def load_colmap_data(basedir: str):
    sparse = os.path.join(basedir, "sparse", "0")
    cameras = read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    images = read_images_binary(os.path.join(sparse, "images.bin"))
    points = read_points3d_binary(os.path.join(sparse, "points3D.bin"))

    cam = cameras[list(cameras.keys())[0]]
    h, w = cam["height"], cam["width"]
    f = cam["params"][0]
    hwf = np.array([h, w, f]).reshape(3, 1)

    names = [images[k]["name"] for k in images]
    perm = np.argsort(names)
    keys = list(images.keys())

    w2c_mats = []
    bottom = np.array([0, 0, 0, 1.0]).reshape(1, 4)
    for k in keys:
        R = qvec2rotmat(images[k]["qvec"])
        t = images[k]["tvec"].reshape(3, 1)
        w2c_mats.append(np.concatenate([np.concatenate([R, t], 1), bottom], 0))
    w2c_mats = np.stack(w2c_mats)
    c2w_mats = np.linalg.inv(w2c_mats)
    poses = c2w_mats[:, :3, :4].transpose([1, 2, 0])
    poses = np.concatenate(
        [poses, np.tile(hwf[..., np.newaxis], [1, 1, poses.shape[-1]])], 1
    )
    # [r, -u, t] -> [-u, r, -t] LLFF convention
    poses = np.concatenate(
        [poses[:, 1:2, :], poses[:, 0:1, :], -poses[:, 2:3, :], poses[:, 3:4, :], poses[:, 4:5, :]],
        1,
    )
    return poses, perm, keys, images, points, w2c_mats


def save_poses_bounds(basedir: str) -> np.ndarray:
    """Compute per-image depth bounds from visible 3D points and write
    poses_bounds.npy (pose_utils.py save_poses)."""
    poses, perm, keys, images, points, w2c = load_colmap_data(basedir)
    pts_arr = np.stack([points[p]["xyz"] for p in points]) if points else np.zeros((0, 3))
    pid_index = {p: i for i, p in enumerate(points)}

    save_arr = []
    for i in perm:
        k = keys[i]
        vis_ids = [pid_index[p] for p in images[k]["point3D_ids"] if p in pid_index]
        if vis_ids:
            pts = pts_arr[vis_ids]
            zvals = (pts @ w2c[i][2, :3]) + w2c[i][2, 3]
            close_d, inf_d = np.percentile(zvals, 0.1), np.percentile(zvals, 99.9)
        else:
            close_d, inf_d = 0.1, 10.0
        save_arr.append(
            np.concatenate([poses[..., i].ravel(), np.array([close_d, inf_d])], 0)
        )
    save_arr = np.array(save_arr)
    np.save(os.path.join(basedir, "poses_bounds.npy"), save_arr)
    return save_arr


def gen_poses(basedir: str, match_type: str = "exhaustive_matcher") -> None:
    """imgs2poses entry (tools/imgs2poses.py): run COLMAP when needed, then
    write poses_bounds.npy."""
    sparse = os.path.join(basedir, "sparse", "0")
    needed = {"cameras.bin", "images.bin", "points3D.bin"}
    have = set(os.listdir(sparse)) if os.path.exists(sparse) else set()
    if not needed.issubset(have):
        run_colmap(basedir, match_type)
    save_poses_bounds(basedir)


def colmap_to_standard(basedir: str, out_dir: str, holdout: int = 8) -> None:
    """Convert a COLMAP reconstruction to the nerfpp 'standard' layout
    (run_colmap2standard.py): train/test dirs with rgb/, pose/*.txt (c2w 4x4)
    and intrinsics/*.txt (flattened 4x4 K)."""
    import shutil

    sparse = os.path.join(basedir, "sparse", "0")
    cameras = read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    images = read_images_binary(os.path.join(sparse, "images.bin"))
    cam = cameras[list(cameras.keys())[0]]
    fx, fy, cx, cy = intrinsics_from_params(cam["model"], cam["params"])
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy

    keys = sorted(images.keys(), key=lambda k: images[k]["name"])
    for split in ("train", "test"):
        for sub in ("rgb", "pose", "intrinsics"):
            os.makedirs(os.path.join(out_dir, split, sub), exist_ok=True)
    for i, k in enumerate(keys):
        split = "test" if holdout > 0 and i % holdout == 0 else "train"
        img = images[k]
        R = qvec2rotmat(img["qvec"])
        t = img["tvec"].reshape(3, 1)
        w2c = np.concatenate(
            [np.concatenate([R, t], 1), np.array([[0, 0, 0, 1.0]])], 0
        )
        c2w = np.linalg.inv(w2c)
        stem = f"{i:05d}"
        np.savetxt(os.path.join(out_dir, split, "pose", stem + ".txt"),
                   c2w.reshape(1, -1))
        np.savetxt(os.path.join(out_dir, split, "intrinsics", stem + ".txt"),
                   K.reshape(1, -1))
        src = os.path.join(basedir, "images", img["name"])
        dst = os.path.join(out_dir, split, "rgb", stem + os.path.splitext(img["name"])[1])
        if os.path.exists(src):
            shutil.copy(src, dst)


# ---------------------------------------------------------------------------
# NeRF-style scene processing + cams_meta / poses_bounds export
# (run_colmap2standard.py:14-212, the mipnerf360 NeRFSceneManager path)
# ---------------------------------------------------------------------------

def scene_process(data_dir: str):
    """Load sparse/0 and return NeRF-frame pose data with lens parameters
    (NeRFSceneManager.process, run_colmap2standard.py:24-112).

    Returns (scene_manager, names, poses, pixtocam, distortion_params,
    camtype): poses are [N, 3, 4] camera-to-world in the NeRF frame
    (right, up, back); pixtocam is the shared inverse intrinsic matrix;
    distortion_params is a kwargs dict for the port's ``cameras.undistort``
    and ``cameras.pixels_to_rays`` (``data/cameras.py``; None for
    distortion-free models); camtype is ``cameras.ProjectionType``.
    """
    from unboundednerfpytorch_tpu_torch.data import cameras as cameras_mod

    sm = SceneManager(os.path.join(data_dir, "sparse", "0")).load()
    cam_id = sorted(sm.cameras.keys())[0]  # shared intrinsics assumed
    cam = sm.cameras[cam_id]
    pixtocam = np.linalg.inv(sm.camera_matrix(cam_id)).astype(np.float64)

    image_ids = list(sm.images.keys())
    names = [sm.images[i]["name"] for i in image_ids]
    c2w = np.stack([sm.camera_to_world(i) for i in image_ids])[:, :3, :4]
    # COLMAP frame (right, down, fwd) -> NeRF frame (right, up, back)
    poses = c2w @ np.diag([1.0, -1.0, -1.0, 1.0])

    dist, camtype = cameras_mod.colmap_distortion_params(
        cam["model"], cam["params"]
    )
    return sm, names, poses, pixtocam, dist, camtype


def compute_depth_bounds(sm: SceneManager, names, poses) -> np.ndarray:
    """Per-image [near, far] from the depths of that image's visible 3D
    points: 1/99 percentiles widened x0.5 / x5 (run_colmap2standard.py:
    140-163). `poses` are NeRF-frame c2w rows aligned with `names`; depth
    along the view axis is -z in that frame. Images observing no valid
    points fall back to [0.1, 10] (the reference would crash there)."""
    bounds = np.zeros((len(names), 2), np.float64)
    bottom = np.array([[0, 0, 0, 1.0]])
    for i, name in enumerate(names):
        image_id = sm.name_to_image_id[name]
        pts = sm.image_points3D(image_id)
        if len(pts) == 0:
            bounds[i] = (0.1, 10.0)
            continue
        c2w = np.concatenate([poses[i], bottom], 0)
        w2c = np.linalg.inv(c2w)
        z = pts @ w2c[2, :3] + w2c[2, 3]
        depth = -z
        near, far = np.percentile(depth, 1.0), np.percentile(depth, 99.0)
        bounds[i] = (near * 0.5, far * 5.0)
    return bounds


def export_cams_meta(data_dir: str, out_mode: str = "cams_meta") -> np.ndarray:
    """Export a COLMAP reconstruction as cams_meta.npy / poses_bounds[_raw]
    .npy (run_colmap2standard.py:115-212, Dataset.__init__ + export).

    cams_meta rows ([N, 27], name-sorted): 12 c2w pose + 9 cam2pix + 4
    distortion (k1, k2, p1, p2) + 2 depth bounds — the layout the
    free-trajectory loader consumes (extra_loaders.load_free_data).
    poses_bounds[_raw] rows ([N, 17]): 3x5 [pose | hwf] + 2 bounds, with the
    `raw` variant permuting pose columns to (-y, x, z) (LLFF convention).
    """
    from unboundednerfpytorch_tpu_torch.data import cameras as cameras_mod

    sm, names, poses, pixtocam, dist, camtype = scene_process(data_dir)
    if camtype == cameras_mod.ProjectionType.FISHEYE:
        # the 4-slot (k1, k2, p1, p2) layout cannot carry the fisheye
        # k3/k4 model and has no projection-type flag; exporting would
        # silently train with the wrong camera model (the reference
        # crashes here too — run_colmap2standard.py:173 KeyError 'p1')
        raise ValueError(
            "OPENCV_FISHEYE reconstructions cannot be exported to "
            f"{out_mode}: the format only encodes perspective cameras. "
            "Undistort the images (colmap image_undistorter) first."
        )

    order = np.argsort(names)
    poses = poses[order]
    names = [names[i] for i in order]
    bounds = compute_depth_bounds(sm, names, poses)
    n = len(names)

    cam2pix = sm.camera_matrix(sorted(sm.cameras.keys())[0])
    if out_mode == "cams_meta":
        d = dist or {}
        dist4 = np.array(
            [d.get("k1", 0.0), d.get("k2", 0.0), d.get("p1", 0.0), d.get("p2", 0.0)]
        )
        data = np.concatenate(
            [
                poses.reshape(n, 12),
                np.tile(cam2pix.reshape(1, 9), (n, 1)),
                np.tile(dist4.reshape(1, 4), (n, 1)),
                bounds.reshape(n, 2),
            ],
            axis=-1,
        )
        data = np.ascontiguousarray(data.astype(np.float64))
        np.save(os.path.join(data_dir, "cams_meta.npy"), data)
        return data

    if out_mode in ("poses_bounds", "poses_bounds_raw"):
        h, w = _first_image_hw(data_dir, sm)
        focal = (cam2pix[0, 0] + cam2pix[1, 1]) * 0.5
        p = poses
        if out_mode == "poses_bounds_raw":
            p = np.concatenate([-p[:, :, 1:2], p[:, :, 0:1], p[:, :, 2:]], 2)
        hwf = np.tile(np.array([h, w, focal]).reshape(1, 3, 1), (n, 1, 1))
        data = np.concatenate(
            [np.concatenate([p, hwf], -1).reshape(n, 15), bounds.reshape(n, 2)],
            axis=-1,
        )
        data = np.ascontiguousarray(data.astype(np.float64))
        np.save(os.path.join(data_dir, f"{out_mode}.npy"), data)
        return data

    raise ValueError(f"unknown out_mode {out_mode!r}")


def _first_image_hw(data_dir: str, sm: SceneManager):
    """(height, width) from the first file under images/, else from the
    COLMAP camera record (the reference reads the first image and crashes
    without one; the camera record is authoritative anyway)."""
    import glob as _glob

    from unboundednerfpytorch_tpu_torch.data.png import imread

    for pattern in ("*.png", "*.PNG", "*.jpg", "*.JPG", "*.jpeg"):
        hits = sorted(_glob.glob(os.path.join(data_dir, "images", pattern)))
        if hits:
            im = imread(hits[0])
            return im.shape[0], im.shape[1]
    cam = sm.cameras[sorted(sm.cameras.keys())[0]]
    return cam["height"], cam["width"]
