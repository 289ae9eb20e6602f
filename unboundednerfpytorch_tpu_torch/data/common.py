"""Dataset-type dispatch to the ``data_dict`` of the trainer and renderer.

The port's copy of ``unboundednerfpytorch_tpu/data/common.py`` for the two
layouts of the ``*_single`` configs: ``llff`` (Mip-NeRF-360,
``configs/nerf_unbounded``) and ``nerfpp`` (Tanks & Temples,
``configs/tankstemple_unbounded``). The ``data_dict`` holds numpy arrays on
the host, keyed HW, Ks, near, far, near_clip, i_train, i_val, i_test, poses,
render_poses, images, irregular_shape. Every other ``dataset_type`` raises
``NotImplementedError`` naming the ROADMAP item it waits for.
"""

from __future__ import annotations

import numpy as np

from unboundednerfpytorch_tpu_torch.configs.schema import DataConfig, ExpConfig

# dataset types of the JAX package that the port does not load yet
NOT_PORTED = ("blender", "blendedmvs", "tankstemple", "nsvf", "deepvoxels", "free",
              "nerfstudio", "co3d", "linemod", "waymo", "mega")


def inward_nearfar_heuristic(cam_o: np.ndarray, ratio: float = 0.05):
    dist = np.linalg.norm(cam_o[:, None] - cam_o, axis=-1)
    far = dist.max()
    return far * ratio, far


def _composite_bkgd(images: np.ndarray, white_bkgd: bool) -> np.ndarray:
    if images.shape[-1] == 4:
        if white_bkgd:
            return images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
        return images[..., :3] * images[..., -1:]
    return images


def _refuse(dt) -> None:
    if dt in NOT_PORTED:
        raise NotImplementedError(f"dataset_type {dt!r} is not ported yet (ROADMAP A15)")
    raise NotImplementedError(f"unknown dataset type {dt!r}")


def load_common_data(data_cfg: DataConfig) -> dict:
    from unboundednerfpytorch_tpu_torch.data import llff as llff_mod
    from unboundednerfpytorch_tpu_torch.data import loaders

    K = None
    depths = None
    near_clip = None
    dt = data_cfg.dataset_type

    if dt == "llff":
        images, depths, poses, bds, render_poses, i_test = llff_mod.load_llff_data(
            data_cfg.datadir,
            data_cfg.factor,
            data_cfg.width,
            data_cfg.height,
            recenter=True,
            bd_factor=data_cfg.bd_factor,
            spherify=data_cfg.spherify,
            load_depths=data_cfg.load_depths,
            movie_render_kwargs=dict(data_cfg.movie_render_kwargs),
        )
        hwf = poses[0, :3, -1]
        poses = poses[:, :3, :4]
        if not isinstance(i_test, list):
            i_test = [i_test]
        if data_cfg.llffhold > 0:
            i_test = np.arange(images.shape[0])[:: data_cfg.llffhold]
        i_val = i_test
        i_train = np.array(
            [i for i in np.arange(int(images.shape[0])) if i not in i_test]
        )
        if data_cfg.ndc:
            near, far = 0.0, 1.0
        else:
            near_clip = max(float(bds.min()) * 0.9, 0)
            near = 0
            far = inward_nearfar_heuristic(poses[i_train, :3, 3])[1]
    elif dt == "nerfpp":
        images, poses, render_poses, hwf, K, i_split = loaders.load_nerfpp_data(
            data_cfg.datadir,
            rerotate=False,
            training_ids=list(data_cfg.training_ids) or None,
        )
        i_train, i_val, i_test = i_split
        near_clip, far = inward_nearfar_heuristic(
            poses[np.asarray(i_train), :3, 3], ratio=0.02
        )
        near = 0
    else:
        _refuse(dt)

    H, W, focal = hwf
    H, W = int(H), int(W)
    HW = np.array([im.shape[:2] for im in images])
    irregular_shape = images.dtype is np.dtype("object")

    if K is None:
        K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    Ks = K[None].repeat(len(poses), axis=0) if K.ndim == 2 else K
    render_poses = np.asarray(render_poses)[..., :4]

    return dict(
        hwf=[H, W, focal],
        HW=HW,
        Ks=Ks,
        near=near,
        far=far,
        near_clip=near_clip,
        i_train=np.asarray(i_train),
        i_val=np.asarray(i_val),
        i_test=np.asarray(i_test),
        poses=np.asarray(poses, np.float32),
        render_poses=np.asarray(render_poses, np.float32),
        images=images.astype(np.float32),
        depths=depths,
        irregular_shape=irregular_shape,
    )


def load_everything(cfg: ExpConfig, sample_num: int = -1) -> dict:
    """The ``data_dict`` of ``cfg.data``. ``sample_num`` truncates only the
    waymo and mega datasets in the JAX package, neither of which the port
    loads yet: it is accepted and has no effect here, as there on the other
    types."""
    del sample_num
    data_dict = load_common_data(cfg.data)
    keep = [
        "HW", "Ks", "near", "far", "near_clip", "i_train", "i_val", "i_test",
        "poses", "render_poses", "images", "irregular_shape",
    ]
    return {k: data_dict[k] for k in keep if k in data_dict}
