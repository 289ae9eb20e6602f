"""The bounded capture of a Blender-like scene and the scene written into a
model: cameras on the upper hemisphere around a Gaussian blob on white,
made on the device from the seed.

``n_views`` cameras stand at radius ``radius`` (the configuration's
``capture``; Blender's synthetic scenes put theirs at 4.03) on a spiral over
the upper hemisphere, from 3 to 71 degrees of elevation, looking at the
origin, with the benchmark's intrinsics (``capture.intrinsics``); every view
trains, near and far are the Blender loader's 2 and 6. The scene is a
separable Gaussian blob ``G(p) = exp(-sum_i (p_i / SIGMA_i)^2 / 2)`` at the
origin: an image shows the textured ellipsoid ``G = exp(-1/2)`` where a ray
meets it, white elsewhere. A model holds it as raw density ``(SOLID -
act_shift) G(p)``: its own ``act_shift`` plus the raw density reads
``SOLID`` at the centre, so a ray through the core stops there, and
``act_shift`` far from it (:func:`written_density` for a voxel grid,
:func:`vm_leaves` for a VM field). The seed sets the spiral's first
angle and the texture's phases. The program and the plain reference read
these tensors alike.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from benchmark.inputs import capture as capture_mod
from benchmark.inputs.capture import derive_seed

NEAR, FAR = 2.0, 6.0
SIGMA = (0.62, 0.55, 0.40)  # a ship's proportions: long, wide, low
SOLID = 7.0


def blob_axis(coords: torch.Tensor, axis: int) -> torch.Tensor:
    """G's factor along ``axis`` at 1-D coordinates: G(p) is the product of
    the three."""
    return torch.exp(-0.5 * (coords / SIGMA[axis]) ** 2)


def axis_nodes(xyz_min, xyz_max, world_size, device) -> list:
    """The world coordinates of a lattice's nodes on each axis, f32
    ``lo (1 - u) + hi u`` for u = i / (n - 1) (the port's lattices')."""
    u = [torch.arange(int(n), dtype=torch.float32, device=device) / float(int(n) - 1)
         for n in world_size]
    return [float(lo) * (1.0 - a) + float(hi) * a for lo, hi, a in zip(xyz_min, xyz_max, u)]


@torch.no_grad()
def written_density(world_size, xyz_min, xyz_max, act_shift: float, device) -> torch.Tensor:
    """A voxel grid's raw density [X, Y, Z] holding the scene at its nodes."""
    ax = [blob_axis(a, i) for i, a in enumerate(axis_nodes(xyz_min, xyz_max, world_size, device))]
    g = ax[0][:, None, None] * ax[1][None, :, None] * ax[2][None, None, :]
    return (SOLID - float(act_shift)) * g


def _shade(pos: torch.Tensor, d: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """Colour [n, 3] of unit rays ``d`` [n, 3] from ``pos`` [3]: the textured
    ellipsoid where a ray meets it, white elsewhere."""
    s = torch.tensor(SIGMA, dtype=d.dtype, device=d.device)
    o, e = pos / s, d / s
    a = (e * e).sum(-1)
    b = (o * e).sum(-1)
    disc = b * b - a * ((o * o).sum(-1) - 1.0)
    hit = disc > 0
    t = (-b - torch.sqrt(torch.clamp_min(disc, 0.0))) / a
    p = pos + t[:, None] * d
    ph = phase.to(d.dtype)
    tex = (torch.sin(9.0 * p[:, :1] + ph[0]) * torch.sin(8.0 * p[:, 1:2] + ph[1])
           * torch.sin(7.0 * p[:, 2:3] + ph[2]))
    base = torch.tensor([0.55, 0.42, 0.3], dtype=d.dtype, device=d.device) + 0.1 * torch.sin(ph)
    body = base * (0.6 + 0.4 * tex)
    return torch.clamp(torch.where(hit[:, None], body, torch.ones_like(body)), 0.0, 1.0)


@dataclasses.dataclass
class BoundedCapture(capture_mod.Capture):
    """The training views: as ``capture.Capture``, with the Blender loader's
    near and far and no near clip."""

    def data_dict(self) -> dict:
        d = super().data_dict()
        del d["near_clip"]
        d.update(near=NEAR, far=FAR)
        return d

    def view_colours(self, view: int, pix: torch.Tensor) -> torch.Tensor:
        c2w = self.poses[view].to(pix.device)
        d = capture_mod.pixel_dirs(self.H, self.W, pix) @ c2w[:3, :3].T
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        return _shade(c2w[:3, 3], d, self.phase.to(pix.device))


def hemisphere_poses(seed: int, n_views: int, radius: float, device):
    """(camera-to-world [n, 4, 4] f32 of ``n_views`` cameras on a spiral over
    the upper hemisphere (even steps of sin(elevation), the golden angle
    between neighbours) looking at the origin, the texture's phases [3])."""
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, 1))
    u = torch.rand(4, generator=gen, device=device, dtype=torch.float64)
    k = torch.arange(n_views, device=device, dtype=torch.float64)
    elev = torch.asin(0.05 + 0.9 * (k + 0.5) / n_views)
    theta = u[3] * 2 * math.pi + k * math.pi * (3.0 - math.sqrt(5.0))
    pos = radius * torch.stack([torch.cos(theta) * torch.cos(elev),
                                torch.sin(theta) * torch.cos(elev), torch.sin(elev)], -1)
    return capture_mod.look_at(pos).to(torch.float32), (u[:3] * 2 * math.pi).to(torch.float32)


def capture(cfg: dict, seed: int, device, images: bool) -> BoundedCapture:
    """The configuration's capture. With ``images`` each view is rendered on
    ``device`` and the stack handed to the host, where the port's loader
    keeps its images."""
    c = cfg["capture"]
    H, W = int(c["H"]), int(c["W"])
    poses, phase = hemisphere_poses(seed, int(c["n_views"]), float(c["radius"]), device)
    cap = BoundedCapture(H, W, poses, phase, None)
    if images:
        pix = torch.arange(H * W, device=device)
        cap.images = torch.empty((poses.shape[0], H, W, 3), dtype=torch.float32,
                                 pin_memory=torch.device(device).type == "cuda")
        for v in range(poses.shape[0]):
            cap.images[v].copy_(cap.view_colours(v, pix).reshape(H, W, 3), non_blocking=True)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    return cap


# the VM leaves of a field in ``TensoRFGrid``'s layout, planes and vectors
VM_SHAPES = {"xy_plane": (0, 1), "xz_plane": (0, 2), "yz_plane": (1, 2), "x_vec": (0,),
             "y_vec": (1,), "z_vec": (2,)}
# each field's random stream (``capture.derive_seed``)
VM_STREAMS = {"density": 6, "k0": 7}
# each plane's complementary vector
VM_PAIRS = (("xy_plane", "z_vec"), ("xz_plane", "y_vec"), ("yz_plane", "x_vec"))


@torch.no_grad()
def vm_leaves(stream: int, n_comp: int, channels: int, xyz_min, xyz_max, world_size,
              act_shift: float | None, seed: int, device) -> dict:
    """The leaves of a VM field of ``channels`` at the window's step, by name
    (``TensoRFGrid``'s layout: planes [A, B, R], vectors [A, R], ``f_vec``
    [3R, channels] where ``channels`` > 1), drawn on ``device`` from the seed
    (``stream`` a field's own): planes and vectors N(0, 0.1^2) and ``f_vec``
    U(+-sqrt(6 / (6 fan_in))), the initialiser's distributions. Given
    ``act_shift`` (a density), component 0 of each plane and its vector
    holds the scene instead, the blob's factors on the lattice's nodes, so
    that the three products sum to ``(SOLID - act_shift) G``."""
    R, ws = int(n_comp), [int(n) for n in world_size]
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, stream))
    out = {name: 0.1 * torch.randn([ws[a] for a in axes] + [R], generator=gen, device=device)
           for name, axes in VM_SHAPES.items()}
    if channels > 1:
        bound = math.sqrt(6.0 / (6.0 * 3 * R))
        out["f_vec"] = (torch.rand((3 * R, channels), generator=gen, device=device) * 2 - 1) * bound
    if act_shift is not None:
        g = [blob_axis(a, i) for i, a in enumerate(axis_nodes(xyz_min, xyz_max, ws, device))]
        s = math.sqrt((SOLID - float(act_shift)) / 3.0)
        for plane, vec in VM_PAIRS:
            a, b = VM_SHAPES[plane]
            out[plane][..., 0] = s * g[a][:, None] * g[b][None, :]
            out[vec][:, 0] = s * g[VM_SHAPES[vec][0]]
    return out
