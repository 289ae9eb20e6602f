"""Camera and scene visualization, headless (matplotlib's Agg).

The port's copy of ``unboundednerfpytorch_tpu/utils/visualize.py``, which
stands in for the reference's open3d viewers (``data_preprocess/
visualize_cameras.py``, ``tools/vis_train.py``, ``tools/vis_volume.py``,
``block_nerf/block_visualize.py``): camera frusta and the scene box, the
active voxels of an exported coarse volume, and the top-down map of a block
split, each to a PNG. numpy only; matplotlib is imported inside the
functions that draw, so that a machine without it imports this module.

    python -m unboundednerfpytorch_tpu_torch.utils.visualize --data_path <block dir>
"""

from __future__ import annotations

import numpy as np


def _frustum_points(c2w: np.ndarray, scale: float = 0.1, aspect: float = 0.75):
    """5 points of a camera frustum (apex + 4 image-plane corners) in world."""
    w = scale
    h = scale * aspect
    d = scale * 1.5
    corners = np.array(
        [[0, 0, 0], [-w, -h, -d], [w, -h, -d], [w, h, -d], [-w, h, -d]]
    )
    return corners @ c2w[:3, :3].T + c2w[:3, 3]


def plot_cameras(
    poses: np.ndarray,
    out_path: str,
    xyz_min=None,
    xyz_max=None,
    color: str = "tab:blue",
    title: str = "cameras",
) -> None:
    """3D plot of camera frusta (+ optional scene bbox) to a PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    scale = 0.05 * float(
        np.linalg.norm(np.asarray(poses)[:, :3, 3].max(0) - np.asarray(poses)[:, :3, 3].min(0))
        + 1e-6
    )
    for c2w in np.asarray(poses):
        pts = _frustum_points(c2w[:3, :4], scale=max(scale, 1e-3))
        for i in range(1, 5):
            ax.plot(*zip(pts[0], pts[i]), color=color, lw=0.5)
        loop = [1, 2, 3, 4, 1]
        ax.plot(pts[loop, 0], pts[loop, 1], pts[loop, 2], color=color, lw=0.5)
    if xyz_min is not None and xyz_max is not None:
        mn, mx = np.asarray(xyz_min), np.asarray(xyz_max)
        for s, e in [
            ([mn[0], mn[1], mn[2]], [mx[0], mn[1], mn[2]]),
            ([mn[0], mn[1], mn[2]], [mn[0], mx[1], mn[2]]),
            ([mn[0], mn[1], mn[2]], [mn[0], mn[1], mx[2]]),
            ([mx[0], mx[1], mx[2]], [mn[0], mx[1], mx[2]]),
            ([mx[0], mx[1], mx[2]], [mx[0], mn[1], mx[2]]),
            ([mx[0], mx[1], mx[2]], [mx[0], mx[1], mn[2]]),
        ]:
            ax.plot(*zip(s, e), color="tab:red", lw=1.0)
    ax.set_title(title)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_volume(
    points: np.ndarray,
    colors: np.ndarray,
    xyz_min,
    xyz_max,
    out_path: str,
    poses: np.ndarray | None = None,
    title: str = "coarse volume",
) -> None:
    """Active-voxel point cloud + scene bbox (+ optional camera frusta) to a
    PNG — the headless equivalent of the reference's open3d volume viewer
    (the reference's ``tools/vis_volume.py``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(9, 9))
    ax = fig.add_subplot(111, projection="3d")
    s = float(np.clip(2e5 / max(len(points), 1), 0.3, 8.0))
    ax.scatter(points[:, 0], points[:, 1], points[:, 2],
               c=colors, s=s, linewidths=0, depthshade=False)
    mn, mx = np.asarray(xyz_min, np.float64), np.asarray(xyz_max, np.float64)
    corners = mn + np.array(
        [[0, 0, 0], [0, 0, 1], [0, 1, 1], [0, 1, 0],
         [1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0]], np.float64
    ) * (mx - mn)
    for a, b in [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7),
                 (7, 4), (0, 4), (1, 5), (2, 6), (3, 7)]:
        ax.plot(*zip(corners[a], corners[b]), color="tab:red", lw=0.8)
    if poses is not None:
        scale = 0.03 * float(np.linalg.norm(mx - mn))
        for c2w in np.asarray(poses):
            pts = _frustum_points(np.asarray(c2w)[:3, :4], scale=scale)
            for i in range(1, 5):
                ax.plot(*zip(pts[0], pts[i]), color="0.5", lw=0.4)
    ax.set_title(title)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_block_split(blocks: dict, out_path: str) -> None:
    """Top-down (x, y) map of block centroids + member camera origins
    (the block_visualize.py equivalent)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    cmap = plt.get_cmap("tab20")
    for i, (name, info) in enumerate(blocks.items()):
        c = cmap(i % 20)
        centroid = np.asarray(info["centroid"])
        ax.scatter(*centroid[:2], color=c, marker="*", s=200, zorder=3)
        ax.annotate(name, centroid[:2])
    ax.set_aspect("equal")
    ax.set_title("block split (top-down)")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def _main(argv=None) -> int:
    """CLI counterpart of the reference's ``data_preprocess/visualize_cameras
    .py --data_path <block_dir>`` (headless: PNGs instead of an open3d
    window). Reads the unified per-block ``metadata.json`` written by
    :func:`~unboundednerfpytorch_tpu_torch.data.preprocess.extract_block_meta`
    and plots each split's camera frusta; when a ``split_block_train.json``
    block map is present (the block dir itself or ``<data_path>/train/``),
    also emits the top-down block-split map."""
    import argparse
    import json
    import os

    ap = argparse.ArgumentParser(description=_main.__doc__)
    ap.add_argument("--data_path", required=True,
                    help="block dir containing metadata.json")
    ap.add_argument("--out_dir", default=None,
                    help="PNG output dir (default: the data dir)")
    args = ap.parse_args(argv)
    out_dir = args.out_dir or args.data_path
    os.makedirs(out_dir, exist_ok=True)

    meta_path = os.path.join(args.data_path, "metadata.json")
    with open(meta_path) as f:
        meta = json.load(f)
    wrote = []
    colors = {"train": "tab:blue", "val": "tab:orange", "test": "tab:green"}
    for split, d in meta.items():
        poses = np.asarray(d["cam2world"], np.float64)
        if poses.size == 0:
            continue
        out = os.path.join(out_dir, f"cameras_{split}.png")
        plot_cameras(poses, out, color=colors.get(split, "tab:blue"),
                     title=f"{split} cameras ({len(poses)})")
        wrote.append(out)
    for cand in (
        os.path.join(args.data_path, "split_block_train.json"),
        os.path.join(args.data_path, "train", "split_block_train.json"),
        os.path.join(os.path.dirname(os.path.abspath(args.data_path)),
                     "train", "split_block_train.json"),
    ):
        if os.path.exists(cand):
            with open(cand) as f:
                blocks = json.load(f)
            out = os.path.join(out_dir, "block_split.png")
            plot_block_split(blocks, out)
            wrote.append(out)
            break
    print("\n".join(wrote))
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
