"""The Mega-NeRF (building, rubble, quad) metadata loader.

The port's copy of ``unboundednerfpytorch_tpu/data/mega.py``: the
``metadata.json`` layout of :mod:`.waymo`, with the train split sorted by
camera position (y, then x), every split cut to the image size most common
in the train split, and its own rotational test trajectory of 100 poses,
which has no images (``i_test`` lies past the end of ``images``).
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from unboundednerfpytorch_tpu_torch.data.waymo import (
    _subset, inward_nearfar_heuristic, read_images, read_metadata,
)


def sort_metadata_by_pos(metadata: dict) -> dict:
    """The train split sorted by its cameras' positions, y then x."""
    train = metadata["train"]
    positions = [np.array(c)[:3, 3] for c in train["cam2world"]]
    order = [i for i, _ in sorted(enumerate(positions), key=lambda row: (row[1][1], row[1][0]))]
    _subset(train, order)
    return metadata


def sample_metadata_by_shape(metadata: dict) -> dict:
    """Every split cut to the (width, height) most common in the train split."""
    train = metadata["train"]
    most = Counter(zip(train["width"], train["height"])).most_common(1)[0][0]
    for split in metadata.values():
        _subset(split, [i for i, s in enumerate(zip(split["width"], split["height"])) if s == most])
    return metadata


def gen_rotational_trajs(tr_c2w, train_HW, tr_K, test_num: int = 100,
                         rotate_interval: float = -0.3):
    """``test_num`` poses at the first training camera, its yaw (the y of a
    yzx Euler triple) turning by ``rotate_interval`` degrees a pose. Returns
    (c2ws, HW, Ks), the last two the first training view's."""
    from scipy.spatial.transform import Rotation as R

    start_c2w = np.array(tr_c2w[0])
    rots = [R.from_matrix(start_c2w[:3, :3]).as_euler("yzx", degrees=True)]
    for _ in range(test_num - 1):
        prev = rots[-1]
        rots.append([prev[0] + rotate_interval, prev[1], prev[2]])
    all_c2ws = []
    for r in rots:
        c2w = start_c2w.copy()
        c2w[:3, :3] = R.from_euler("yzx", r, degrees=True).as_matrix()
        all_c2ws.append(c2w)
    n = len(all_c2ws)
    return all_c2ws, [train_HW[0]] * n, [tr_K[0]] * n


def load_mega_data(datadir: str, sample_cam: int | None = None, sample_idxs=None,
                   sample_num: int = -1, sample_interval: int = 1, load_img: bool = True,
                   near: float | None = None, far: float | None = None,
                   near_clip: float | None = None) -> dict:
    """The data_dict of a Mega-NeRF capture; ``sample_idxs`` (or
    ``sample_num`` and ``sample_interval``) cut every split."""
    metadata, sample_idxs = read_metadata(datadir, sample_cam, sample_idxs, sample_num,
                                          sample_interval)
    metadata = sample_metadata_by_shape(sort_metadata_by_pos(metadata))
    if sample_idxs is not None:
        for split in metadata.values():
            _subset(split, sample_idxs)

    tr, val = metadata["train"], metadata["val"]
    tr_c2w, val_c2w = tr["cam2world"], val["cam2world"]
    n_tr, n_val = len(tr_c2w), len(val_c2w)
    poses = [np.array(c).reshape(4, 4) for c in tr_c2w + val_c2w]
    imgs = read_images(datadir, tr["file_path"] + val["file_path"]) if load_img else []

    train_HW = [[tr["height"][i], tr["width"][i]] for i in range(len(tr["height"]))]
    val_HW = [[val["height"][i], val["width"][i]] for i in range(len(val["height"]))]
    te_c2w, test_HW, test_K = gen_rotational_trajs(tr_c2w, train_HW, tr["K"])
    poses += [np.array(c).reshape(4, 4) for c in te_c2w]
    poses = np.stack(poses).astype(np.float32)

    i_train = np.arange(n_tr)
    nc, f = inward_nearfar_heuristic(poses[i_train, :3, 3], ratio=0.02)
    return dict(
        HW=np.array([[int(h), int(w)] for h, w in train_HW + val_HW + test_HW]),
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
        irregular_shape=False,
    )
