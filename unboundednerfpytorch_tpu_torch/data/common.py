"""Dataset-type dispatch to the ``data_dict`` of the trainer and renderer.

The port's copy of ``unboundednerfpytorch_tpu/data/common.py`` for eleven
layouts: ``llff`` (Mip-NeRF-360 and LLFF, ``configs/nerf_unbounded``,
``configs/llff``), ``nerfpp`` (``configs/tankstemple_unbounded``, ``lf``),
``blender`` (NeRF-synthetic, ``configs/nerf``, ``configs/tiny``), ``nsvf``
(``configs/nsvf``), ``blendedmvs`` (``configs/blendedmvs``), ``deepvoxels``
(``configs/deepvoxels``), ``tankstemple`` (``configs/tankstemple``), ``free`` (F2-NeRF,
``configs/free_dataset``), ``nerfstudio`` (``configs/nerf_studio``),
``co3d`` (``configs/co3d``: composited on its masks), ``linemod``
(``configs/linemod``: per-view intrinsics after the crop, and
``object_poses``, the ground truth of ``--program linemod_eval``), and
``waymo`` and ``mega`` (``configs/waymo``, ``configs/mega``; routed by
:func:`load_everything`). The ``data_dict`` holds numpy arrays on the host,
keyed HW, Ks, near, far, near_clip, i_train, i_val, i_test, poses,
render_poses, images, irregular_shape (and object_poses for linemod). For
waymo and mega ``i_test`` is a generated trajectory without images: its
indices lie past the end of ``images``. An unknown ``dataset_type`` raises
``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np

from unboundednerfpytorch_tpu_torch.configs.schema import DataConfig, ExpConfig

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


def load_common_data(data_cfg: DataConfig) -> dict:
    from unboundednerfpytorch_tpu_torch.data import extra_loaders, loaders
    from unboundednerfpytorch_tpu_torch.data import linemod as linemod_mod
    from unboundednerfpytorch_tpu_torch.data import llff as llff_mod

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
    elif dt == "blender":
        images, poses, render_poses, hwf, i_split = loaders.load_blender_data(
            data_cfg.datadir, data_cfg.half_res, data_cfg.testskip)
        i_train, i_val, i_test = i_split
        near, far = 2.0, 6.0
        images = _composite_bkgd(images, data_cfg.white_bkgd)
    elif dt == "blendedmvs":
        images, poses, render_poses, hwf, K, i_split = loaders.load_blendedmvs_data(
            data_cfg.datadir)
        i_train, i_val, i_test = i_split
        near, far = inward_nearfar_heuristic(poses[np.asarray(i_train), :3, 3])
        if images.shape[-1] != 3:
            raise ValueError(f"blendedmvs images have {images.shape[-1]} channels, want 3")
    elif dt == "nsvf":
        images, poses, render_poses, hwf, i_split = loaders.load_nsvf_data(data_cfg.datadir)
        i_train, i_val, i_test = i_split
        near, far = inward_nearfar_heuristic(poses[np.asarray(i_train), :3, 3])
        images = _composite_bkgd(images, data_cfg.white_bkgd)
    elif dt == "deepvoxels":
        images, poses, render_poses, hwf, i_split = loaders.load_dv_data(
            scene=data_cfg.sequence_name or "greek", basedir=data_cfg.datadir,
            testskip=data_cfg.testskip)
        i_train, i_val, i_test = i_split
        hemi_R = np.mean(np.linalg.norm(poses[:, :3, -1], axis=-1))
        near, far = hemi_R - 1, hemi_R + 1
        if not data_cfg.white_bkgd:
            raise ValueError("deepvoxels scenes are composited on white: white_bkgd must be set")
    elif dt == "tankstemple":
        images, poses, render_poses, hwf, K, i_split = loaders.load_tankstemple_data(
            data_cfg.datadir, movie_render_kwargs=dict(data_cfg.movie_render_kwargs))
        i_train, i_val, i_test = i_split
        near_clip, far = inward_nearfar_heuristic(poses[np.asarray(i_train), :3, 3], ratio=0.02)
        near = 0
        images = _composite_bkgd(images, data_cfg.white_bkgd)
    elif dt == "free":
        images, depths, Ks_arr, poses, bds, render_poses, i_test = extra_loaders.load_free_data(
            data_cfg.datadir, data_cfg.factor, llffhold=data_cfg.llffhold,
            training_ids=list(data_cfg.training_ids) or None)
        i_val = i_test
        i_train = np.array([i for i in np.arange(int(images.shape[0])) if i not in i_test])
        near_clip = max(float(bds.min()) * 0.9, 0)
        near = 0
        far = 1.0 if data_cfg.ndc else inward_nearfar_heuristic(poses[i_train, :3, 3])[1]
        # per-view intrinsics and no hwf: returned here, as the JAX package does
        return dict(
            hwf=None, HW=np.array([im.shape[:2] for im in images]), Ks=Ks_arr, near=near,
            far=far, near_clip=near_clip, i_train=i_train, i_val=np.asarray(i_val),
            i_test=np.asarray(i_test), poses=poses[:, :3, :4],
            render_poses=np.asarray(render_poses)[:, :3, :4],
            images=images.astype(np.float32), depths=depths,
            irregular_shape=images.dtype is np.dtype("object"),
        )
    elif dt == "nerfstudio":
        images, depths, poses, bds, render_poses, i_test = extra_loaders.load_nerfstudio_data(
            data_cfg.datadir, data_cfg.factor, dvgohold=data_cfg.dvgohold)
        hwf = poses[0, :3, -1]
        poses = poses[:, :3, :4]
        if not isinstance(i_test, list):
            i_test = [i_test]
        if data_cfg.llffhold > 0:
            i_test = np.arange(images.shape[0])[:: data_cfg.llffhold]
        i_val = i_test
        i_train = np.array([i for i in np.arange(int(images.shape[0])) if i not in i_test])
        if data_cfg.ndc:
            near, far = 0.0, 1.0
        else:
            near_clip = max(float(bds.min()) * 0.9, 0)
            near = 0
            far = inward_nearfar_heuristic(poses[i_train, :3, 3])[1]
    elif dt == "co3d":
        images, masks, poses, render_poses, hwf, K, i_split = extra_loaders.load_co3d_data(
            data_cfg.datadir, data_cfg.annot_path, data_cfg.split_path,
            data_cfg.sequence_name)
        i_train, i_val, i_test = i_split
        near, far = inward_nearfar_heuristic(poses[np.asarray(i_train), :3, 3], ratio=0)
        for i in range(len(images)):
            m = masks[i][..., None]
            images[i] = images[i] * m + (1.0 - m) if data_cfg.white_bkgd else images[i] * m
    elif dt == "linemod":
        images, poses4, Ks_arr, obj_poses, i_train, i_test = linemod_mod.load_linemod_data(
            data_cfg.datadir, data_cfg.seq_name, width_max=data_cfg.width_max,
            height_max=data_cfg.height_max, white_bkgd=data_cfg.white_bkgd,
            testskip=data_cfg.testskip)
        poses = poses4[:, :3, :4]
        dists = np.linalg.norm(poses[np.asarray(i_train), :3, 3], axis=-1)
        near = float(data_cfg.near) if data_cfg.near is not None else max(
            float(dists.min()) * 0.5, 1e-3)
        far = float(data_cfg.far) if data_cfg.far is not None else float(dists.max()) * 1.5
        # per-view intrinsics after the crop, and the object poses: returned
        # here, as the JAX package does
        return dict(
            hwf=None, HW=np.array([im.shape[:2] for im in images]), Ks=Ks_arr, near=near,
            far=far, near_clip=near, i_train=np.asarray(i_train), i_val=np.asarray(i_test),
            i_test=np.asarray(i_test), poses=poses, render_poses=poses[np.asarray(i_test)],
            images=images.astype(np.float32), object_poses=obj_poses, irregular_shape=False,
        )
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
        raise NotImplementedError(f"unknown dataset type {dt!r}")

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


def load_everything(cfg: ExpConfig, sample_num: int = -1, diffuse: bool = False) -> dict:
    """The ``data_dict`` of ``cfg.data``: waymo and mega through their own
    loaders, the other types through :func:`load_common_data`.

    ``sample_num`` > 0 keeps that many views (every ``sample_interval``-th)
    of a waymo or mega capture and is ignored elsewhere, as in the JAX
    package. ``diffuse`` swaps a waymo capture's training images for the
    diffusion-made ones the config's ``diffusion`` table names
    (``diff_replace``: {image stem: replacement stem}, read from
    ``<datadir>/<diff_root>/``)."""
    d = cfg.data
    if d.dataset_type == "waymo":
        from unboundednerfpytorch_tpu_torch.data.waymo import load_waymo_data

        diffusion = dict(cfg.diffusion or ())
        data_dict = load_waymo_data(
            d.datadir, training_ids=list(d.training_ids) or None, sample_num=sample_num,
            sample_cam=d.sample_cam if d.sample_cam >= 0 else None,
            sample_interval=d.sample_interval, test_rotate_angle=d.test_rotate_angle,
            near=d.near, far=d.far, near_clip=d.near_clip,
            diffuse_map=dict(diffusion.get("diff_replace", ()) or ()) if diffuse else None,
            diff_root=str(diffusion.get("diff_root", "diffusion")))
    elif d.dataset_type == "mega":
        from unboundednerfpytorch_tpu_torch.data.mega import load_mega_data

        data_dict = load_mega_data(
            d.datadir, sample_num=sample_num,
            sample_cam=d.sample_cam if d.sample_cam >= 0 else None,
            sample_interval=d.sample_interval, near=d.near, far=d.far, near_clip=d.near_clip)
    else:
        data_dict = load_common_data(d)
    keep = [
        "HW", "Ks", "near", "far", "near_clip", "i_train", "i_val", "i_test",
        "poses", "render_poses", "images", "irregular_shape", "object_poses",
    ]
    return {k: data_dict[k] for k in keep if k in data_dict}
