"""A seeded synthetic unbounded scene, made with numpy.

Counterpart in spirit of ``unboundednerfpytorch_tpu/data/synthetic.py``: a
scene with known geometry so the trainer runs end to end with no dataset on
disk. Cameras orbit the origin at alternating elevations (the 360-capture
pattern of the Mip-NeRF-360 scenes). The scene is a textured sphere at the
origin inside a far sky: each pixel's colour is found in closed form
(ray-sphere intersection), so full-resolution views cost seconds.
"""

from __future__ import annotations

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
                near_clip: float = 0.5, n_test: int = 0) -> dict:
    """A reference-shaped data_dict (numpy) of ``n_views`` training views and
    ``n_test`` held-out views (``i_test``), which sit half-way between
    training cameras on the same orbit; the training views do not depend on
    ``n_test``.

    The seed sets the texture phases and the orbit's starting angle.
    ``sphere_radius`` is the world radius of the object at the origin.
    """
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0.0, 2.0 * np.pi, 3)
    theta0 = rng.uniform(0.0, 2.0 * np.pi)
    focal = 0.8 * W
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
        images.append(np.clip(rgb, 0.0, 1.0).reshape(H, W, 3).astype(np.float32))

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
