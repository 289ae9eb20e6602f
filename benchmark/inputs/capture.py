"""The benchmark's capture: an orbit around a textured ball under a sky, made
on the device from the seed.

A torch copy of the port's ``data/synthetic.py::orbit_scene`` (which builds
its images with numpy on the host), so that a capture of bicycle's 194 views
is made in a fraction of a second on the card. ``n_views`` cameras stand on
a circle of radius ``cam_radius`` at alternating elevations of 0.35 and 0.65
rad, looking at the origin, where a ball of radius ``sphere_radius`` sits;
every ``llffhold``-th view is held out, as the LLFF loader does, and the
others train. The seed sets the texture's three phases and the orbit's first
angle. Both the program and the plain reference read these tensors.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

SPHERE_RADIUS = 0.8
CAM_RADIUS = 3.0
NEAR_CLIP = 0.5
FOCAL_SCALE = 0.8


def derive_seed(seed: int, stream: int) -> int:
    """A seed of its own for each random stream of a run, from the run's
    ``--seed`` (any whole number; a torch generator takes 64 bits)."""
    return (int(seed) * 1_000_003 + int(stream) * 7_919) % (1 << 62)


def look_at(pos: torch.Tensor) -> torch.Tensor:
    """OpenGL-style camera-to-world [n, 4, 4] (the camera looks down -z) of
    cameras at ``pos`` [n, 3] looking at the origin, z up."""
    fwd = -pos / torch.linalg.norm(pos, dim=-1, keepdim=True)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=pos.dtype, device=pos.device).expand_as(fwd)
    right = torch.linalg.cross(fwd, up, dim=-1)
    right = right / torch.linalg.norm(right, dim=-1, keepdim=True)
    c2w = torch.zeros((pos.shape[0], 4, 4), dtype=pos.dtype, device=pos.device)
    c2w[:, :3, 0] = right
    c2w[:, :3, 1] = torch.linalg.cross(right, fwd, dim=-1)
    c2w[:, :3, 2] = -fwd
    c2w[:, :3, 3] = pos
    c2w[:, 3, 3] = 1.0
    return c2w


def orbit_poses(theta: torch.Tensor, elev: torch.Tensor) -> torch.Tensor:
    pos = CAM_RADIUS * torch.stack([torch.cos(theta) * torch.cos(elev),
                                    torch.sin(theta) * torch.cos(elev), torch.sin(elev)], -1)
    return look_at(pos)


def intrinsics(H: int, W: int) -> np.ndarray:
    f = FOCAL_SCALE * W
    return np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], dtype=np.float32)


def pixel_dirs(H: int, W: int, pix: torch.Tensor) -> torch.Tensor:
    """Camera-space directions [n, 3] of flat pixel indices ``pix`` (pixel
    centres, OpenGL convention), as ``ops/rays.py::get_rays`` makes them."""
    f = FOCAL_SCALE * W
    i = (pix % W).to(torch.float32) + 0.5
    j = torch.div(pix, W, rounding_mode="floor").to(torch.float32) + 0.5
    return torch.stack([(i - W * 0.5) / f, -(j - H * 0.5) / f, -torch.ones_like(i)], -1)


def shade(pos: torch.Tensor, d: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """Colour [n, 3] of rays from ``pos`` ([3], or [n, 3] one a ray) along
    unit ``d`` [n, 3]: the ball's texture where the ray meets it, the sky
    elsewhere (f32)."""
    b = (d * pos).sum(-1)
    disc = b * b - ((pos * pos).sum(-1) - SPHERE_RADIUS**2)
    hit = disc > 0
    t = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
    p = pos + t[:, None] * d
    ph = phase.to(d.dtype)
    sky = torch.stack([
        0.55 + 0.3 * torch.sin(2.0 * d[:, 0] + 3.0 * d[:, 2] + ph[0]),
        0.55 + 0.3 * torch.sin(2.5 * d[:, 1] - 1.3 + ph[1]),
        0.6 + 0.3 * torch.cos(3.0 * d[:, 0] * d[:, 1] + 0.4 + ph[2]),
    ], -1)
    tex = (torch.sin(6.0 * p[:, :1] + ph[0]) * torch.sin(5.0 * p[:, 1:2] + ph[1])
           * torch.sin(4.0 * p[:, 2:3] + ph[2]))
    base = torch.tensor([0.85, 0.45, 0.3], dtype=d.dtype, device=d.device) + 0.1 * torch.sin(ph)
    ball = base * (0.55 + 0.45 * tex)
    return torch.clamp(torch.where(hit[:, None], ball, sky), 0.0, 1.0)


@dataclasses.dataclass
class Capture:
    """The training views of one capture: poses [n, 4, 4] f32, the texture
    phases, and (for a train cell) the images [n, H, W, 3] f32 on the host."""

    H: int
    W: int
    poses: torch.Tensor
    phase: torch.Tensor
    images: torch.Tensor | None

    @property
    def K(self) -> np.ndarray:
        return intrinsics(self.H, self.W)

    def data_dict(self) -> dict:
        """The loader's dict of the training views, as the port's training
        and bbox functions read it."""
        n = self.poses.shape[0]
        poses = self.poses.detach().cpu().numpy()
        return {
            "HW": np.array([[self.H, self.W]] * n),
            "Ks": np.stack([self.K] * n),
            "near": NEAR_CLIP, "far": 100.0, "near_clip": NEAR_CLIP,
            "i_train": np.arange(n), "i_val": np.arange(0), "i_test": np.arange(0),
            "poses": poses,
            "images": None if self.images is None else self.images.numpy(),
            "irregular_shape": False,
        }

    def view_colours(self, view: int, pix: torch.Tensor) -> torch.Tensor:
        """The colours of flat pixels ``pix`` of training view ``view``,
        computed anew (what the image holds there)."""
        c2w = self.poses[view].to(pix.device)
        d = pixel_dirs(self.H, self.W, pix) @ c2w[:3, :3].T
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        return shade(c2w[:3, 3], d, self.phase.to(pix.device))


def orbit_capture(seed: int, n_views: int, H: int, W: int, llffhold: int, device,
                  images: bool = True) -> Capture:
    """The training views of an ``n_views`` orbit (every ``llffhold``-th
    held out). With ``images`` each view is rendered on ``device`` and the
    stack is handed to the host, where the port's loader keeps its images."""
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, 1))
    u = torch.rand(4, generator=gen, device=device, dtype=torch.float64)
    phase = (u[:3] * 2 * math.pi).to(torch.float32)
    k = torch.arange(n_views, device=device, dtype=torch.float64)
    theta = u[3] * 2 * math.pi + 2 * math.pi * k / n_views
    elev = torch.where(k % 2 == 0, 0.35, 0.65).to(torch.float64)
    keep = torch.tensor([v % llffhold != 0 for v in range(n_views)], device=device)
    poses = orbit_poses(theta, elev)[keep].to(torch.float32)
    imgs = None
    if images:
        pix = torch.arange(H * W, device=device)
        cap = Capture(H, W, poses, phase, None)
        imgs = torch.empty((poses.shape[0], H, W, 3), dtype=torch.float32,
                           pin_memory=torch.device(device).type == "cuda")
        for v in range(poses.shape[0]):
            imgs[v].copy_(cap.view_colours(v, pix).reshape(H, W, 3), non_blocking=True)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    return Capture(H, W, poses, phase, imgs)


def orbit_view_poses(seed: int, n: int, device) -> torch.Tensor:
    """``n`` render poses on the capture's orbit drawn from the seed: angle
    uniform on the circle, elevation uniform between the capture's two."""
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, 2))
    u = torch.rand((n, 2), generator=gen, device=device, dtype=torch.float64)
    return orbit_poses(u[:, 0] * 2 * math.pi, 0.35 + 0.3 * u[:, 1]).to(torch.float32)


def view_rays(H: int, W: int, c2w: torch.Tensor):
    """(origins, directions, unit view directions) [H * W, 3] of every pixel
    of a camera ``c2w`` [4, 4] (or [3, 4]), by the float operations of the
    port's ``ops/rays.py::get_rays_of_a_view`` in their order, so that the
    two agree to the bit on one device: a sample that lies on a voxel's
    rounding edge or a budget's last place then falls alike on both sides."""
    dev = c2w.device
    K = torch.as_tensor(intrinsics(H, W), device=dev)
    i = torch.arange(W, dtype=torch.float32, device=dev)[None, :].repeat(H, 1) + 0.5
    j = torch.arange(H, dtype=torch.float32, device=dev)[:, None].repeat(1, W) + 0.5
    dirs = torch.stack([(i - K[0][2]) / K[0][0], -(j - K[1][2]) / K[1][1],
                        -torch.ones_like(i)], -1)
    c2w = c2w.to(torch.float32)
    rd = torch.einsum("hwc,rc->hwr", dirs, c2w[:3, :3])
    ro = c2w[:3, 3].expand(rd.shape)
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    return ro.reshape(-1, 3), rd.reshape(-1, 3), vd.reshape(-1, 3)


@torch.no_grad()
def scene_box(cap, inner_r: float, world_bound_scale: float) -> tuple:
    """(center, radius) [3] of the contraction: the cube around the points
    at the near clip on every ray of the training views (times
    ``unbounded_inner_r``), scaled by ``world_bound_scale``."""
    lo = hi = None
    for v in range(cap.poses.shape[0]):
        ro, rd, _ = view_rays(cap.H, cap.W, cap.poses[v])
        p = ro + rd * NEAR_CLIP
        vmin, vmax = p.amin(0), p.amax(0)
        lo = vmin if lo is None else torch.minimum(lo, vmin)
        hi = vmax if hi is None else torch.maximum(hi, vmax)
    center = (lo + hi) * 0.5
    r = (center - lo).max() * inner_r
    lo, hi = (center - r).double(), (center + r).double()
    s = world_bound_scale
    if abs(s - 1) > 1e-9:
        shift = (hi - lo) * (s - 1) / 2
        lo, hi = lo - shift, hi + shift
    return ((lo + hi) * 0.5).float(), ((hi - lo) * 0.5).float()


def training_rays(cap: Capture, idx: torch.Tensor):
    """(origins, directions, view directions, colours) [n, 3] of rays
    ``idx`` of the flattened training views (view-major, then row-major
    pixels, as the port's ray store lays them out), each view's made whole
    as the store makes it, and its colours as its image holds them."""
    hw = cap.H * cap.W
    view = torch.div(idx, hw, rounding_mode="floor")
    out = torch.empty((4, idx.shape[0], 3), dtype=torch.float32, device=idx.device)
    all_pix = torch.arange(hw, device=idx.device)
    for v in torch.unique(view).tolist():
        sel = view == v
        pix = idx[sel] % hw
        ro, rd, vd = view_rays(cap.H, cap.W, cap.poses[v].to(idx.device))
        rgb = cap.view_colours(v, all_pix)
        for k, t in enumerate((ro, rd, vd, rgb)):
            out[k, sel] = t[pix]
    return out[0], out[1], out[2], out[3]
