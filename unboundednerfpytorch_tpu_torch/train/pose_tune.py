"""Gradient-based camera-pose refinement (``--program tune_pose``).

The port's copy of ``unboundednerfpytorch_tpu/train/pose_tune.py``: each
training image gets an se(3) delta ``(omega, t)``, a right perturbation in
the camera frame (``R' = R exp([omega]x)``, ``t' = t + R t_delta``; the
identity at zero). A step draws ``n_rand`` pixels (image, row, column), makes
their rays from the perturbed poses (:func:`pixel_rays`, the 'center' rays
of ``ops.rays.get_rays``), renders them through the frozen model and moves
the deltas down the gradient of the photometric MSE.

The gradient reaches the deltas through everything the forward computes
from the rays: the entry into the box, the sample points, their
interpolation weights into the grids and the view directions (the forwards
keep their sampling differentiable when the rays require a gradient,
:func:`..models.common.sample_grad`), and the density gradient of the fused
march, which treats its shift and interval as constants, as the JAX custom
VJP does. Adam on the [N, 6] deltas is ``torch.optim.Adam`` (optax's
defaults) with the lr decaying exponentially, not stepwise, from ``lr`` to
``lr_final`` over the run, as optax's ``exponential_decay``. The pixels
come from an explicit ``torch.Generator``, so a run repeats itself; its
draws are not the JAX package's.
"""

from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np
import torch


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle [..., 3] -> rotation [..., 3, 3], with series
    near theta = 0 and the square root taken of a safe value there, so the
    gradient at zero (where the optimization starts) is finite."""
    theta2 = torch.sum(omega * omega, dim=-1, keepdim=True)
    small = theta2 < 1e-12
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, torch.ones_like(theta2), theta2))
    wx, wy, wz = omega[..., 0], omega[..., 1], omega[..., 2]
    zeros = torch.zeros_like(wx)
    K = torch.stack([torch.stack([zeros, -wz, wy], -1),
                     torch.stack([wz, zeros, -wx], -1),
                     torch.stack([-wy, wx, zeros], -1)], -2)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(K.shape)
    return eye + a[..., None] * K + b[..., None] * (K @ K)


def apply_pose_delta(c2w: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Camera-to-world pose(s) [..., 3, 4] right-perturbed by ``delta``
    [..., 6] = (omega, t) in the camera frame: [..., 3, 4]."""
    R = c2w[..., :3, :3]
    t = c2w[..., :3, 3]
    R_new = R @ so3_exp(delta[..., :3])
    t_new = t + torch.einsum("...ij,...j->...i", R, delta[..., 3:])
    return torch.cat([R_new, t_new[..., None]], dim=-1)


def pixel_rays(K: torch.Tensor, c2w: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
               W: int, H: int, inverse_y: bool = False, flip_x: bool = False,
               flip_y: bool = False):
    """Rays (rays_o, rays_d, viewdirs) [N, 3] of pixel columns ``px`` and rows
    ``py`` [N] through per-ray intrinsics ``K`` [N, 3, 3] and poses ``c2w``
    [N, 3, 4], differentiable in ``c2w``: ``get_rays(..., mode='center')``
    at those pixels."""
    i = px.to(torch.float32) + 0.5
    j = py.to(torch.float32) + 0.5
    if flip_x:
        i = (W - 1 - px).to(torch.float32) + 0.5
    if flip_y:
        j = (H - 1 - py).to(torch.float32) + 0.5
    x = (i - K[:, 0, 2]) / K[:, 0, 0]
    if inverse_y:
        dirs = torch.stack([x, (j - K[:, 1, 2]) / K[:, 1, 1], torch.ones_like(x)], -1)
    else:
        dirs = torch.stack([x, -(j - K[:, 1, 2]) / K[:, 1, 1], -torch.ones_like(x)], -1)
    rays_d = torch.einsum("nc,nrc->nr", dirs, c2w[:, :3, :3])
    rays_o = c2w[:, :3, 3]
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    return rays_o, rays_d, viewdirs


def pick_pixels(generator: torch.Generator, n_rand: int, n_img: int, H: int, W: int):
    """(image, row, column) [n_rand] each, drawn from ``generator`` in that
    order."""
    dev = generator.device
    img = torch.randint(0, n_img, (n_rand,), generator=generator, device=dev)
    py = torch.randint(0, H, (n_rand,), generator=generator, device=dev)
    px = torch.randint(0, W, (n_rand,), generator=generator, device=dev)
    return img, py, px


def tune_loss(forward_fn: Callable, delta: torch.Tensor, images: torch.Tensor,
              poses: torch.Tensor, Ks: torch.Tensor, picks, *, inverse_y: bool = False,
              flip_x: bool = False, flip_y: bool = False) -> torch.Tensor:
    """The MSE of the rendered picked pixels against ``images`` [N, H, W, 3]
    with the poses [N, 3, 4] perturbed by ``delta`` [N, 6];
    ``forward_fn(rays_o, rays_d, viewdirs)`` returns a RenderResult."""
    img, py, px = picks
    H, W = images.shape[1:3]
    gt = images[img, py, px]
    c2w = apply_pose_delta(poses[img], delta[img])
    ro, rd, vd = pixel_rays(Ks[img], c2w, px, py, W, H, inverse_y=inverse_y, flip_x=flip_x,
                            flip_y=flip_y)
    return torch.mean(torch.square(forward_fn(ro, rd, vd).rgb_marched - gt))


def tune_poses(forward_fn: Callable, images, poses, Ks, *, steps: int = 400, lr: float = 1e-3,
               n_rand: int = 2048, inverse_y: bool = False, flip_x: bool = False,
               flip_y: bool = False, seed: int = 0, lr_final: float | None = None,
               log_fn: Callable[[str], None] = print, log_every: int = 100, device=None):
    """Optimize per-image se(3) deltas against the frozen model behind
    ``forward_fn(rays_o, rays_d, viewdirs) -> RenderResult``. ``images``
    [N, H, W, 3], ``poses`` [N, 3, 4] (camera to world) and ``Ks`` [N, 3, 3]
    are moved to ``device`` (``None`` -> ``cuda``, which raises without a
    GPU). Returns (tuned poses [N, 3, 4], deltas [N, 6], history
    ``{"mse": [(step, mse), ...]}``), numpy."""
    from unboundednerfpytorch_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    images_t = torch.as_tensor(np.asarray(images), dtype=torch.float32, device=dev)
    poses_t = torch.as_tensor(np.asarray(poses), dtype=torch.float32, device=dev)[:, :3, :4]
    Ks_t = torch.as_tensor(np.asarray(Ks), dtype=torch.float32, device=dev)
    N, H, W = images_t.shape[:3]
    delta = torch.zeros((N, 6), dtype=torch.float32, device=dev, requires_grad=True)
    opt = torch.optim.Adam([delta], lr=lr)
    rate = lr_final / lr if lr_final is not None and lr_final < lr else 1.0
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: rate ** (s / max(steps, 1)))
    gen = torch.Generator(device=dev).manual_seed(seed)
    history = {"mse": []}
    for s in range(1, steps + 1):
        picks = pick_pixels(gen, n_rand, N, H, W)
        opt.zero_grad(set_to_none=True)
        loss = tune_loss(forward_fn, delta, images_t, poses_t, Ks_t, picks,
                         inverse_y=inverse_y, flip_x=flip_x, flip_y=flip_y)
        loss.backward()
        opt.step()
        sched.step()
        if s == 1 or s % log_every == 0 or s == steps:
            mse = float(loss.detach())
            history["mse"].append((s, mse))
            log_fn(f"tune_pose iter {s:5d} / mse {mse:.6f} / psnr "
                   f"{-10.0 * np.log10(max(mse, 1e-12)):.2f}")
    with torch.no_grad():
        tuned = apply_pose_delta(poses_t, delta)
    return tuned.cpu().numpy(), delta.detach().cpu().numpy(), history


def run_tune_pose(args, cfg, data_dict, exp_dir: str, device=None, log_fn=print) -> str:
    """The command line's program: load the trained fine model (``--ft_path``,
    a checkpoint directory or a reference ``.tar``, else the merged block
    checkpoint ``<exp_dir>/fine_last_merged``, else ``<exp_dir>/fine_last``,
    as the JAX package resolves it), refine the training
    views' poses (``--tune_steps`` steps at ``--tune_lr``, annealed to a
    thousandth of it, ``min(N_rand, 4096)`` pixels a step), and save
    ``tuned_poses.npy``, ``tuned_deltas.npy`` and ``tune_pose_history.json``
    in ``exp_dir``. Returns the path of ``tuned_poses.npy``. ``device``:
    ``None`` -> ``cuda`` (raises without a GPU)."""
    from unboundednerfpytorch_tpu_torch.device import resolve_device
    from unboundednerfpytorch_tpu_torch.train.loop import make_forward
    from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt

    dev = resolve_device(device)
    # as run_render resolves it: --ft_path, else the merged block
    # checkpoint, else fine_last
    path = getattr(args, "ft_path", "")
    if not path:
        path = os.path.join(exp_dir, "fine_last_merged")
        if not os.path.exists(os.path.join(path, "meta.json")):
            path = os.path.join(exp_dir, "fine_last")
    is_ref_tar = os.path.isfile(path) and path.endswith(".tar")
    if not is_ref_tar and not os.path.exists(os.path.join(path, "meta.json")):
        raise FileNotFoundError(f"tune_pose needs a trained model at {path}: run --program "
                                "train first")
    _, mcfg, params, _, _ = ckpt.load_model(path, device=dev, with_opt_state=False)
    if is_ref_tar:
        from unboundednerfpytorch_tpu_torch.utils.reference_import import overlay_render_knobs

        mcfg = overlay_render_knobs(mcfg, cfg.fine_model_and_render)
    params.requires_grad_(False)
    render_kwargs = {
        "near": float(data_dict["near"]),
        "far": float(data_dict["far"]),
        "bg": 1.0 if cfg.data.white_bkgd else 0.0,
        "stepsize": cfg.fine_model_and_render.stepsize,
    }
    fwd_core = make_forward(mcfg, render_kwargs)
    i_train = np.asarray(data_dict["i_train"])
    images = np.stack([np.asarray(data_dict["images"][i]) for i in i_train])
    poses = np.asarray(data_dict["poses"])[i_train][:, :3, :4]
    Ks = np.asarray(data_dict["Ks"])[i_train]
    lr = getattr(args, "tune_lr", 1e-3)
    tuned, deltas, history = tune_poses(
        lambda ro, rd, vd: fwd_core(params, ro, rd, vd, None), images, poses, Ks,
        steps=getattr(args, "tune_steps", 400), lr=lr, lr_final=lr * 1e-3,
        n_rand=min(cfg.fine_train.N_rand, 4096), inverse_y=cfg.data.inverse_y,
        flip_x=cfg.data.flip_x, flip_y=cfg.data.flip_y, log_fn=log_fn, device=dev)
    out = os.path.join(exp_dir, "tuned_poses.npy")
    np.save(out, tuned)
    np.save(os.path.join(exp_dir, "tuned_deltas.npy"), deltas)
    with open(os.path.join(exp_dir, "tune_pose_history.json"), "w") as f:
        json.dump(history, f)
    log_fn(f"tune_pose: saved refined train poses to {out} (+ deltas, history)")
    return out
