"""Waymo Block-NeRF preprocessing: the TFRecord decode and the block split.

The port's copy of ``unboundednerfpytorch_tpu/data/preprocess.py``, host
numpy as there:

* :func:`decode_waymo_tfrecords`: the release's records (image, per-pixel
  ray origins and directions, intrinsics, camera, exposure) into
  ``images_<split>/`` and the ``metadata.json`` that ``data/waymo.py``
  loads, each camera's rotation recovered from its ray directions by least
  squares (:func:`recover_rotation_from_rays`);
* :func:`solve_block_diameter` and :func:`split_blocks`: overlapping blocks
  along the trajectory (``split_block_<split>.json``);
* :func:`extract_block_meta`: one block's ``metadata.json`` and images.

Images are decoded and written through ``data/png.py``.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

from unboundednerfpytorch_tpu_torch.data import png
from unboundednerfpytorch_tpu_torch.data import tfrecord as tfr


def solve_block_diameter(r: float = 2.0, overlap: float = 0.5) -> float:
    """Twice the distance x between the centres of two circles of radius r
    whose lens-shaped intersection is ``overlap`` of a circle's area: Newton
    on 2 acos(x/r) r^2 - 2x sqrt(r^2 - x^2) = overlap pi r^2."""
    x = r * 0.9
    x0 = x + 1.0
    while abs(x - x0) >= 1e-6:
        x0 = x
        f = (2 * np.arccos(x0 / r) * r**2 - 2 * x0 * np.sqrt(r**2 - x0**2)
             - overlap * np.pi * r**2)
        fd = (2 * x0**2 - 2 * r**2) / np.sqrt(r**2 - x0**2) - 2 * np.sqrt(r**2 - x0**2)
        x = x0 - f / fd
    return 2 * x


def sort_origins_by_pos(img_origins: dict) -> dict:
    """{image name: origin} sorted by the origin's y, then x."""
    return dict(sorted(img_origins.items(), key=lambda kv: (kv[1][1], kv[1][0])))


def block_elements_within(img_origins: dict, centroid_name: str, radius: float) -> list:
    """[[image name, running index]] of the origins within ``radius`` of the
    centroid image's."""
    out = []
    c = np.asarray(img_origins[centroid_name])
    for name, origin in img_origins.items():
        if np.linalg.norm(c - np.asarray(origin)) <= radius:
            out.append([name, len(out)])
    return out


def split_blocks(img_origins: dict, radius: float = 2.0, overlap: float = 0.5) -> dict:
    """Overlapping blocks along the sorted trajectory: {``block_<i>``:
    {"centroid": [x, y, z], "elements": [[name, index], ...]}}, the
    ``split_block_train.json`` that Block-NeRF trains and composes from.
    The next block's centroid is the first origin at least the spacing of
    :func:`solve_block_diameter` from this one's (and never this one's
    next neighbour)."""
    origins = sort_origins_by_pos(img_origins)
    names = list(origins)
    spacing = solve_block_diameter(radius, overlap)
    blocks = {}
    i = 0
    while i < len(names):
        centroid_name = names[i]
        blocks[f"block_{len(blocks)}"] = {
            "centroid": list(np.asarray(origins[centroid_name], dtype=float)),
            "elements": block_elements_within(origins, centroid_name, radius),
        }
        j = i + 1
        c = np.asarray(origins[centroid_name])
        while j < len(names) and np.linalg.norm(c - np.asarray(origins[names[j]])) < spacing:
            j += 1
        if j == i + 1 and j < len(names):
            j += 1
        if j >= len(names):
            break
        i = j
    return blocks


def write_block_split(blocks: dict, out_path: str) -> None:
    with open(out_path, "w") as f:
        json.dump(blocks, f, indent=2)


def get_pix2cam(focals, width, height) -> list:
    """The inverse intrinsics of each view, [N][3][3]."""
    f = np.asarray(focals, np.float64)
    cx = np.asarray(width, np.float64) * 0.5
    cy = np.asarray(height, np.float64) * 0.5
    zero, one = np.zeros_like(cx), np.ones_like(cx)
    k_inv = np.array([[one / f, zero, -cx / f], [zero, -one / f, cy / f], [zero, zero, -one]])
    return np.moveaxis(k_inv, -1, 0).tolist()


def extract_block_meta(root_dir: str, block_index: int, out_dir: str, near: float = 0.01,
                       far: float = 15.0, copy_images: bool = True) -> dict:
    """One block of a preprocessed Block-NeRF capture as a capture of its
    own: reads ``<split>/split_block_<split>.json`` and
    ``<split>/<split>_all_meta.json`` (train and val), copies the block's
    images to ``out_dir/images_{train,val,test}/<cam_idx>_<k>.png`` (test
    is val: the release has no test split) and writes ``metadata.json``
    with each split's file_path, cam2world, width, height, focal, pix2cam,
    lossmult, near and far. Returns the metadata."""
    def load(split, name):
        with open(os.path.join(root_dir, split, name)) as f:
            return json.load(f)

    train_split = load("train", "split_block_train.json")
    train_meta = load("train", "train_all_meta.json")
    val_split = load("val", "split_block_val.json")
    val_meta = load("val", "val_all_meta.json")
    key = f"block_{block_index}"
    train_imgs = train_split[key]["elements"]
    val_entry = val_split[key]
    val_imgs = val_entry["elements"] if isinstance(val_entry, dict) else val_entry

    def form_unified(images, all_meta, save_prefix, split_prefix):
        out = {k: [] for k in ("file_path", "cam2world", "width", "height", "focal")}
        os.makedirs(os.path.join(out_dir, save_prefix), exist_ok=True)
        for idx, one_img in enumerate(images):
            name = one_img[0] if isinstance(one_img, (list, tuple)) else one_img
            m = all_meta[name]
            final_path = os.path.join(save_prefix, f"{m['cam_idx']}_{idx}.png")
            src = os.path.join(root_dir, split_prefix, "rgbs", name + ".png")
            if copy_images and os.path.exists(src):
                shutil.copyfile(src, os.path.join(out_dir, final_path))
            c2w = [list(r) for r in m["c2w"]]
            if len(c2w) == 3:
                c2w.append([0.0, 0.0, 0.0, 1.0])
            out["file_path"].append(final_path)
            out["cam2world"].append(c2w)
            out["width"].append(m["W"])
            out["height"].append(m["H"])
            out["focal"].append(m["intrinsics"][0])
        n = len(out["height"])
        out["pix2cam"] = get_pix2cam(out["focal"], out["width"], out["height"])
        out["lossmult"] = [1.0] * n
        out["near"] = [near] * n
        out["far"] = [far] * n
        return out

    os.makedirs(out_dir, exist_ok=True)
    unified = {"train": form_unified(train_imgs, train_meta, "images_train", "train"),
               "val": form_unified(val_imgs, val_meta, "images_val", "val"),
               "test": form_unified(val_imgs, val_meta, "images_test", "val")}
    with open(os.path.join(out_dir, "metadata.json"), "w") as f:
        json.dump(unified, f)
    return unified


def recover_rotation_from_rays(cam_dirs: np.ndarray, world_dirs: np.ndarray) -> np.ndarray:
    """The rotation R, least squares, with world ~ cam @ R^T: from the SVD
    of the correlation, its determinant made +1."""
    A = cam_dirs.reshape(-1, 3)
    B = world_dirs.reshape(-1, 3)
    U, _, Vt = np.linalg.svd(A.T @ B)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    return Vt.T @ np.diag([1.0, 1.0, d]) @ U.T


def decode_waymo_tfrecords(tfrecord_paths, out_dir: str, splits=("train", "val")) -> dict:
    """The Waymo Block-NeRF TFRecords into ``images_<split>/<index>.png``
    and ``metadata.json`` (file_path, cam2world, K, width, height, position,
    cam_idx, equivalent_exposure by split; a file whose name holds
    ``validation`` is the val split). A camera's rotation comes from its
    pixels' ray directions against the intrinsics' (:func:`recover_rotation_from_rays`),
    its position is the mean ray origin. Returns the metadata.

    Both sums over the pixels run in float64. The JAX package takes them in
    float32, where the mean of the origins is a row-by-row sum: at 640x960
    a camera at x = -3.2 comes out at -3.2185 (ROADMAP C)."""
    metadata = {s: {k: [] for k in ("file_path", "cam2world", "K", "width", "height",
                                     "position", "cam_idx", "equivalent_exposure")}
                for s in splits}
    for split in splits:
        os.makedirs(os.path.join(out_dir, f"images_{split}"), exist_ok=True)
    idx = 0
    for path in tfrecord_paths:
        split = "val" if "validation" in os.path.basename(path) else "train"
        for rec in tfr.read_records(path):
            b = tfr.parse_example(rec)
            h, w = int(b["height"][0]), int(b["width"][0])
            K = np.asarray(b["intrinsics"], np.float32).tolist()
            origins = np.asarray(b["ray_origins"], np.float32).reshape(h, w, 3)
            dirs = np.asarray(b["ray_dirs"], np.float32).reshape(h, w, 3)
            img = png.imdecode(b["image"][0])
            fx, fy = K[0], K[1]
            j, i = np.mgrid[0:h, 0:w].astype(np.float32)
            cam_dirs = np.stack(
                [(i - w / 2 + 0.5) / fx, -(j - h / 2 + 0.5) / fy, -np.ones_like(i)], -1)
            cam_dirs = cam_dirs / np.linalg.norm(cam_dirs, axis=-1, keepdims=True)
            world_dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
            # sums over every pixel in float64 (see the docstring)
            origin = origins.reshape(-1, 3).mean(0, dtype=np.float64)
            c2w = np.eye(4)
            c2w[:3, :3] = recover_rotation_from_rays(cam_dirs.astype(np.float64),
                                                     world_dirs.astype(np.float64))
            c2w[:3, 3] = origin
            name = f"{idx:06d}"
            png.write_png(os.path.join(out_dir, f"images_{split}", name + ".png"), img)
            m = metadata[split]
            m["file_path"].append(f"images_{split}/{name}.png")
            m["cam2world"].append(c2w.tolist())
            m["K"].append(np.array(K[:9]).reshape(3, 3).tolist() if len(K) >= 9
                          else [[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]])
            m["width"].append(w)
            m["height"].append(h)
            m["position"].append(origin.tolist())
            m["cam_idx"].append(int(b["cam_idx"][0]))
            m["equivalent_exposure"].append(float(b["equivalent_exposure"][0]))
            idx += 1
    with open(os.path.join(out_dir, "metadata.json"), "w") as f:
        json.dump(metadata, f)
    return metadata
