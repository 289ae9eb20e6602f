"""How far the pose tuner brings perturbed poses back, by scene and lr schedule.

    python -m unboundednerfpytorch_tpu_torch.probes.pose_recovery [--device cpu]

For each scene, 20 views of 96x96 on white of a lone textured sphere
(``data/synthetic.py::orbit_scene``, the kind of capture phase 9a of
``chip_smoke.py`` trains on) and of four textured spheres at different
depths (``cluster_scene``): a fine-only DVGO of 64^3 voxels with the JAX
pose-tuner test's MLP is trained on it (600 steps of 4096 rays); the
training poses are perturbed by seeded 1-3 degree rotations and 1-3 %
translations of the camera distance, the images staying those of the true
poses; then ``train.pose_tune.tune_poses`` runs 1000 steps of 4096 pixels at
lr 3e-3, held constant (as the JAX test tunes) or annealed to a hundredth (as
``--program tune_pose`` anneals, to a thousandth). One JSON line a run: the
scene, the schedule, the model's PSNR, the mean rotation (degrees) and
camera-centre errors before and after, and the seconds. ``chip_smoke.py``
phase 10e runs the cluster with the constant lr and holds both errors to
half.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from unboundednerfpytorch_tpu_torch.configs.schema import (
    DataConfig, ExpConfig, ModelRenderConfig, TrainStageConfig,
)
from unboundednerfpytorch_tpu_torch.data import synthetic
from unboundednerfpytorch_tpu_torch.device import resolve_device
from unboundednerfpytorch_tpu_torch.train import loop
from unboundednerfpytorch_tpu_torch.train import pose_tune as pt

# the perturbation: rotation (degrees) and translation (share of the camera
# distance), each drawn uniformly from its range in a random direction
DEG, SHIFT = (1.0, 3.0), (0.01, 0.03)


def scene(name: str, views: int, hw: int) -> dict:
    """``cluster`` (:func:`synthetic.cluster_scene`) or ``sphere``: the lone
    sphere of :func:`synthetic.orbit_scene` on white, with the cluster's
    cameras, focal length, near and far."""
    if name == "cluster":
        return synthetic.cluster_scene(views, hw, hw, seed=0)
    data = synthetic.orbit_scene(views, hw, hw, seed=0, cam_radius=3.0, focal_scale=1.2,
                                 near_clip=1.0, alpha=True)
    rgba = data["images"]
    data["images"] = rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:])
    data.update(near=1.0, far=6.0, near_clip=None)
    return data


def train_model(data: dict, voxels: int, steps: int, rays: int, device):
    """A fine-only DVGO of ``voxels`` (the JAX pose-tuner test's MLP: k0 6
    channels, 2 layers of 24) trained ``steps`` steps of ``rays`` rays on
    ``data``. Returns (forward_fn(rays_o, rays_d, viewdirs) of the frozen
    model, its family, its config, its last PSNR)."""
    cfg = ExpConfig(
        data=DataConfig(white_bkgd=True),
        coarse_train=dataclasses.replace(TrainStageConfig(), N_iters=0),
        fine_train=TrainStageConfig(N_iters=steps, N_rand=rays, pervoxel_lr=False,
                                    ray_sampler="flatten", pg_scale=(),
                                    skip_zero_grad_fields=("density", "k0")),
        fine_model_and_render=ModelRenderConfig(
            num_voxels_rgb=voxels, num_voxels_density=voxels, num_voxels_base_rgb=voxels,
            num_voxels_base_density=voxels, rgbnet_dim=6, rgbnet_width=24, rgbnet_depth=2,
            alpha_init=1e-2, fast_color_thres=1e-4, maskout_near_cam_vox=False))
    family, mcfg, params, psnr = loop.run_train(cfg, data, device=device,
                                                log_fn=lambda _: None, log_every=steps)
    params.requires_grad_(False)
    fwd = loop.make_forward(mcfg, {"near": float(data["near"]), "bg": 1.0,
                                   "stepsize": cfg.fine_model_and_render.stepsize})
    return (lambda ro, rd, vd: fwd(params, ro, rd, vd, None)), family, mcfg, float(psnr)


def perturb(poses: np.ndarray, rng: np.random.Generator, deg=DEG, shift=SHIFT) -> np.ndarray:
    """Camera-to-world ``poses`` [N, 3, 4] (float64), each rotated by an
    angle drawn from ``deg`` about a random axis of its camera frame and its
    centre moved by a share of its distance from the origin drawn from
    ``shift`` in a random direction."""
    start = poses.copy()
    for k, c2w in enumerate(poses):
        axis = rng.normal(size=3)
        w = torch.as_tensor(axis / np.linalg.norm(axis) * np.radians(rng.uniform(*deg)))
        start[k, :, :3] = c2w[:, :3] @ pt.so3_exp(w[None])[0].numpy()
        move = rng.normal(size=3)
        start[k, :, 3] = c2w[:, 3] + move / np.linalg.norm(move) * rng.uniform(
            *shift) * np.linalg.norm(c2w[:, 3])
    return start


def pose_errors(a: np.ndarray, b: np.ndarray) -> tuple:
    """(mean rotation error in degrees, mean camera-centre distance) of poses
    [N, 3, 4] ``a`` against ``b``."""
    cos = [(np.trace(x[:3, :3].T @ y[:3, :3]) - 1) / 2 for x, y in zip(a, b)]
    ang = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
    return float(ang.mean()), float(np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=-1).mean())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=1000, help="tune steps a run")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    for name in ("sphere", "cluster"):
        data = scene(name, 20, 96)
        t0 = time.time()
        model, _, mcfg, psnr = train_model(data, 64**3, 600, 4096, dev)
        train_s = time.time() - t0
        true = np.asarray(data["poses"])[:, :3, :4].astype(np.float64)
        start = perturb(true, np.random.default_rng(12))
        for lr_final in (None, 3e-5):
            t0 = time.time()
            tuned, _, _ = pt.tune_poses(model, data["images"], start.astype(np.float32),
                                        data["Ks"], steps=args.steps, lr=3e-3,
                                        lr_final=lr_final, n_rand=4096, device=dev,
                                        log_fn=lambda _: None)
            (ang0, dist0), (ang1, dist1) = pose_errors(start, true), pose_errors(
                tuned.astype(np.float64), true)
            print(json.dumps({
                "scene": name, "lr": 3e-3, "lr_final": lr_final, "steps": args.steps,
                "world_size": list(mcfg.world_size), "psnr": psnr, "train_s": train_s,
                "rotation_deg": [ang0, ang1], "translation": [dist0, dist1],
                "tune_s": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
