"""The Waymo (Block-NeRF) metadata loader and its test trajectories.

The port's copy of ``unboundednerfpytorch_tpu/data/waymo.py``. A capture is
``metadata.json`` with a ``train`` and a ``val`` split, each a dict of
per-view lists (``file_path``, ``cam2world``, ``K``, ``width``, ``height``,
``position``, ``cam_idx``, ...), and the images it names. Each split is
sorted by camera position (y, then x) and subset by camera
(``sample_cam``), by index (``sample_num`` views every ``sample_interval``)
and by name (``training_ids``); ``--diffuse`` swaps named training images
for diffusion-made ones. The test split is a generated rotational
trajectory of 200 poses, which has no images: ``images`` holds the train
and val views only, so ``i_test`` lies past its end.

As in the JAX package, :func:`load_waymo_data` does not resize (the
config's ``factor`` is not read; :func:`resize_imgs_to_common` is there
and unused), and ``test_rotate_angle`` is accepted and unused.
"""

from __future__ import annotations

import json
import os

import numpy as np

from unboundednerfpytorch_tpu_torch.data.png import imread as _imread


def _sample_list(lst, idxs):
    return [lst[i] for i in idxs if i < len(lst)]


def _subset(split: dict, idxs) -> None:
    for k in split:
        split[k] = _sample_list(split[k], idxs)


def sort_metadata_by_pos(metadata: dict) -> dict:
    """Each split sorted by its ``position`` entries, y then x."""
    for split in metadata.values():
        order = [i for i, _ in sorted(enumerate(split["position"]),
                                      key=lambda row: (row[1][1], row[1][0]))]
        _subset(split, order)
    return metadata


def sample_metadata_by_cam(metadata: dict, cam_idx: int) -> dict:
    for split in metadata.values():
        _subset(split, [i for i, c in enumerate(split["cam_idx"]) if c == cam_idx])
    return metadata


def sample_metadata_by_idxs(metadata: dict, sample_idxs, val_num: int = 5) -> dict:
    """The train split at ``sample_idxs``; every other split at their first
    ``val_num`` (or its first ``val_num`` views)."""
    for name, split in metadata.items():
        if name == "train":
            idxs = sample_idxs
        else:
            idxs = (sample_idxs or list(range(val_num)))[:val_num]
        if idxs is not None:
            _subset(split, idxs)
    return metadata


def sample_metadata_by_training_ids(metadata: dict, training_ids, assign_pos: dict | None = None,
                                    assign_rot: dict | None = None) -> dict:
    """The train split cut to the images ``images_train/<id>.png``; where
    ``assign_pos`` names an image, its position (and, with ``assign_rot``,
    its yzx Euler rotation in degrees) is set by hand."""
    if not training_ids:
        return metadata
    train = metadata["train"]
    files = train["file_path"]
    keep = [files.index(f"images_train/{ele}.png") for ele in training_ids
            if f"images_train/{ele}.png" in files]
    assert keep, "No image selected by training ids"
    _subset(train, keep)
    if assign_pos:
        from scipy.spatial.transform import Rotation as R

        files = train["file_path"]
        for ele, pos in assign_pos.items():
            fp = f"images_train/{ele}.png"
            if fp not in files:
                continue
            i = files.index(fp)
            train["position"][i] = list(pos)
            c2w = np.array(train["cam2world"][i])
            c2w[:3, 3] = np.asarray(pos)
            if assign_rot and ele in assign_rot:
                c2w[:3, :3] = R.from_euler("yzx", assign_rot[ele], degrees=True).as_matrix()
            train["cam2world"][i] = c2w.tolist()
    return metadata


def gen_rotational_trajs(tr_c2w, train_HW, tr_K, tr_cam_idx, train_pos, test_num: int = 200,
                         rotate_interval: float = -0.3, forward_dis_max: float = 0.03):
    """``test_num`` poses from the first training camera: the yaw (the y of
    a yzx Euler triple) turning by ``rotate_interval`` degrees a pose while
    the camera moves up to ``forward_dis_max`` along -x. Returns (c2ws, HW,
    Ks, cam_idxs, positions), the last four the first training view's."""
    from scipy.spatial.transform import Rotation as R

    start_c2w = np.array(tr_c2w[0])
    base_pos = train_pos[0]
    all_rot_yzx = [R.from_matrix(start_c2w[:3, :3]).as_euler("yzx", degrees=True)]
    for _ in range(test_num - 1):
        prev = all_rot_yzx[-1]
        all_rot_yzx.append([prev[0] + rotate_interval, prev[1], prev[2]])
    all_c2ws, test_pos = [], []
    for i, rot in enumerate(all_rot_yzx):
        c2w = start_c2w.copy()
        c2w[:3, :3] = R.from_euler("yzx", rot, degrees=True).as_matrix()
        fwd = (1 - np.cos(i / test_num * np.pi / 2)) * forward_dis_max
        pos = [base_pos[0] - fwd, base_pos[1], base_pos[2]]
        c2w[:3, 3] = pos
        all_c2ws.append(c2w)
        test_pos.append(pos)
    n = test_num
    return all_c2ws, [train_HW[0]] * n, [tr_K[0]] * n, [tr_cam_idx[0]] * n, test_pos


def gen_straight_trajs(tr_c2w, train_HW, tr_K, tr_cam_idx, test_num: int = 100,
                       rotate_angle: float = 2.0, rot_freq: int = 20):
    """The first ``test_num`` training poses, each yawed by ``rotate_angle``
    degrees times a sine of period ``rot_freq`` poses."""
    from scipy.spatial.transform import Rotation as R

    all_c2ws = [np.array(c) for c in tr_c2w[:test_num]]
    for i, c2w in enumerate(all_c2ws):
        ang = rotate_angle * np.sin(i / rot_freq * 2 * np.pi)
        c2w[:3, :3] = c2w[:3, :3] @ R.from_euler("y", ang, degrees=True).as_matrix()
    n = len(all_c2ws)
    return all_c2ws, [train_HW[0]] * n, [tr_K[0]] * n, [tr_cam_idx[0]] * n


def resize_imgs_to_common(train_HW, val_HW, imgs, tr_K, val_K, factor: int = 1):
    """Images, sizes and intrinsics downscaled by an integer ``factor``."""
    if factor == 1:
        return train_HW, val_HW, imgs, tr_K, val_K
    from unboundednerfpytorch_tpu_torch.data.llff import _cv2

    cv2 = _cv2()
    out_imgs = [cv2.resize(im, (im.shape[1] // factor, im.shape[0] // factor),
                           interpolation=cv2.INTER_AREA) for im in imgs]
    scale = 1.0 / factor

    def scale_K(K):
        return (np.asarray(K, np.float64) * np.array([[scale], [scale], [1.0]])).tolist()

    train_HW = [[h // factor, w // factor] for h, w in train_HW]
    val_HW = [[h // factor, w // factor] for h, w in val_HW]
    return train_HW, val_HW, out_imgs, [scale_K(K) for K in tr_K], [scale_K(K) for K in val_K]


def inward_nearfar_heuristic(cam_o: np.ndarray, ratio: float = 0.05):
    dist = np.linalg.norm(cam_o[:, None] - cam_o, axis=-1)
    far = dist.max()
    return far * ratio, far


def read_metadata(datadir: str, sample_cam, sample_idxs, sample_num: int,
                  sample_interval: int) -> tuple:
    """(metadata, sample_idxs): ``metadata.json`` cut to ``sample_cam``, and
    the index subset that ``sample_num`` and ``sample_interval`` make."""
    with open(os.path.join(datadir, "metadata.json")) as fp:
        metadata = json.load(fp)
    if sample_cam is not None:
        metadata = sample_metadata_by_cam(metadata, sample_cam)
    if sample_num > 0:
        sample_idxs = list(range(0, sample_num * sample_interval, sample_interval))
    return metadata, sample_idxs


def read_images(datadir: str, paths) -> list:
    return [_imread(os.path.join(datadir, p)) / 255.0 for p in paths]


def load_waymo_data(datadir: str, sample_cam: int | None = None, sample_idxs=None,
                    sample_num: int = -1, sample_interval: int = 1, training_ids=None,
                    test_rotate_angle: float = 9.0, load_img: bool = True,
                    near: float | None = None, far: float | None = None,
                    near_clip: float | None = None, diffuse_map: dict | None = None,
                    diff_root: str = "diffusion") -> dict:
    """The data_dict of a Waymo capture, with ``cam_idxs`` (each view's
    camera). ``near``, ``far`` and ``near_clip`` override the heuristic's;
    ``diffuse_map`` ({image stem: replacement stem}) reads those training
    images from ``<datadir>/<diff_root>/<replacement>.png``."""
    del test_rotate_angle  # accepted and unused, as in the JAX package
    metadata, sample_idxs = read_metadata(datadir, sample_cam, sample_idxs, sample_num,
                                          sample_interval)
    metadata = sort_metadata_by_pos(metadata)
    metadata = sample_metadata_by_idxs(metadata, sample_idxs)
    metadata = sample_metadata_by_training_ids(metadata, training_ids)
    if diffuse_map:
        fps = metadata["train"]["file_path"]
        for idx, fp in enumerate(fps):
            stem = os.path.basename(fp).replace(".png", "")
            if stem in diffuse_map:
                fps[idx] = os.path.join(diff_root, diffuse_map[stem] + ".png")

    tr, val = metadata["train"], metadata["val"]
    tr_c2w, val_c2w = tr["cam2world"], val["cam2world"]
    n_tr, n_val = len(tr_c2w), len(val_c2w)
    poses = [np.array(c).reshape(4, 4) for c in tr_c2w + val_c2w]
    imgs = read_images(datadir, tr["file_path"] + val["file_path"]) if load_img else []

    train_HW = [[tr["height"][i], tr["width"][i]] for i in range(len(tr["height"]))]
    val_HW = [[val["height"][i], val["width"][i]] for i in range(len(val["height"]))]
    te_c2w, test_HW, test_K, test_cam_idxs, _ = gen_rotational_trajs(
        tr_c2w, train_HW, tr["K"], tr["cam_idx"], tr["position"])
    poses += [np.array(c).reshape(4, 4) for c in te_c2w]
    poses = np.stack(poses).astype(np.float32)

    i_train = np.arange(n_tr)
    nc, f = inward_nearfar_heuristic(poses[i_train, :3, 3], ratio=0.02)
    return dict(
        HW=np.array(train_HW + val_HW + test_HW),
        Ks=np.array(tr["K"] + val["K"] + test_K),
        near=0.0 if near is None else near,
        far=f if far is None else far,
        near_clip=nc if near_clip is None else near_clip,
        i_train=i_train,
        i_val=np.arange(n_tr, n_tr + n_val),
        i_test=np.arange(n_tr + n_val, n_tr + n_val + len(te_c2w)),
        poses=poses,
        render_poses=np.stack([np.array(c) for c in te_c2w]).astype(np.float32),
        images=np.stack(imgs).astype(np.float32) if imgs else None,
        depths=None,
        cam_idxs=tr["cam_idx"] + val["cam_idx"] + test_cam_idxs,
        irregular_shape=False,
    )
