"""Camera projection models: pinhole and fisheye, radial-tangential lens
distortion, NDC conversion and distortion-aware pixel-to-ray generation.

The port's copy of ``unboundednerfpytorch_tpu/data/cameras.py``:
:class:`ProjectionType`, :func:`intrinsic_matrix` and
:func:`colmap_distortion_params` in numpy (the COLMAP tooling,
``data/colmap.py``, reads them), :func:`distort` as plain arithmetic on
whatever arrays it is given, and :func:`undistort`, :func:`convert_to_ndc`
and :func:`pixels_to_rays` as torch functions in float32 on an explicit
device (``None`` -> ``cuda``, raising without a GPU; ``"cpu"`` for the plain
path). The Newton undistortion runs a fixed 10 iterations with the JAX
package's ``eps`` guard and no early exit, as its ``lax.fori_loop`` does; the
three ray bundles that the mip-cone radii need (the pixel, +dx, +dy) go
through the intrinsic and pose products as one stacked batch.
"""

from __future__ import annotations

import enum
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from unboundednerfpytorch_tpu_torch.device import resolve_device


class ProjectionType(enum.Enum):
    """Camera projection type."""

    PERSPECTIVE = "perspective"
    FISHEYE = "fisheye"


def intrinsic_matrix(fx: float, fy: float, cx: float, cy: float) -> np.ndarray:
    """Pinhole intrinsic matrix, OpenCV convention."""
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]], dtype=np.float32)


def colmap_distortion_params(model: str, params) -> Tuple[Optional[dict], ProjectionType]:
    """(distortion parameters or None, projection type) of a COLMAP camera
    model; the parameter layouts are COLMAP's ``src/base/camera_models.h``."""
    params = np.asarray(params, dtype=np.float64)
    if model in ("SIMPLE_PINHOLE", "PINHOLE"):
        return None, ProjectionType.PERSPECTIVE
    if model == "SIMPLE_RADIAL":  # [f, cx, cy, k1]
        return dict(k1=float(params[3])), ProjectionType.PERSPECTIVE
    if model == "RADIAL":  # [f, cx, cy, k1, k2]
        return dict(k1=float(params[3]), k2=float(params[4])), ProjectionType.PERSPECTIVE
    if model == "OPENCV":  # [fx, fy, cx, cy, k1, k2, p1, p2]
        d = dict(k1=float(params[4]), k2=float(params[5]),
                 p1=float(params[6]), p2=float(params[7]))
        return d, ProjectionType.PERSPECTIVE
    if model == "OPENCV_FISHEYE":  # [fx, fy, cx, cy, k1, k2, k3, k4]
        d = dict(k1=float(params[4]), k2=float(params[5]),
                 k3=float(params[6]), k4=float(params[7]))
        return d, ProjectionType.FISHEYE
    raise ValueError(f"unsupported COLMAP camera model {model!r}")


def distort(x, y, k1=0.0, k2=0.0, k3=0.0, k4=0.0, p1=0.0, p2=0.0):
    """The forward radial-tangential distortion (the map that
    :func:`undistort` inverts), on numpy arrays or tensors alike."""
    r = x * x + y * y
    d = 1.0 + r * (k1 + r * (k2 + r * (k3 + r * k4)))
    xd = d * x + 2 * p1 * x * y + p2 * (r + 2 * x * x)
    yd = d * y + 2 * p2 * x * y + p1 * (r + 2 * y * y)
    return xd, yd


def _residual_and_jacobian(x, y, xd, yd, k1, k2, k3, k4, p1, p2):
    """The residual distort(x, y) - (xd, yd) and its 2x2 Jacobian."""
    r = x * x + y * y
    d = 1.0 + r * (k1 + r * (k2 + r * (k3 + r * k4)))
    fx = d * x + 2 * p1 * x * y + p2 * (r + 2 * x * x) - xd
    fy = d * y + 2 * p2 * x * y + p1 * (r + 2 * y * y) - yd

    d_r = k1 + r * (2.0 * k2 + r * (3.0 * k3 + r * 4.0 * k4))
    d_x = 2.0 * x * d_r
    d_y = 2.0 * y * d_r

    fx_x = d + d_x * x + 2.0 * p1 * y + 6.0 * p2 * x
    fx_y = d_y * x + 2.0 * p1 * x + 2.0 * p2 * y
    fy_x = d_x * y + 2.0 * p2 * y + 2.0 * p1 * x
    fy_y = d + d_y * y + 2.0 * p2 * x + 6.0 * p1 * y
    return fx, fy, fx_x, fx_y, fy_x, fy_y


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) else a,
                           dtype=torch.float32, device=device)


def undistort(xd, yd, k1=0.0, k2=0.0, k3=0.0, k4=0.0, p1=0.0, p2=0.0, eps: float = 1e-9,
              max_iterations: int = 10, device=None):
    """The undistorted (x, y) of the distorted (xd, yd), float32 tensors on
    ``device``: ``max_iterations`` 2x2 Newton steps from (xd, yd), a step
    left out where the Jacobian's determinant is within ``eps`` of 0."""
    dev = resolve_device(device)
    xd, yd = _tensor(xd, dev), _tensor(yd, dev)
    x, y = xd, yd
    for _ in range(max_iterations):
        fx, fy, fx_x, fx_y, fy_x, fy_y = _residual_and_jacobian(x, y, xd, yd, k1, k2, k3, k4,
                                                                p1, p2)
        den = fy_x * fx_y - fx_x * fy_y
        safe = den.abs() > eps
        den_safe = torch.where(safe, den, torch.ones_like(den))
        zero = torch.zeros_like(den)
        x = x + torch.where(safe, (fx * fy_y - fy * fx_y) / den_safe, zero)
        y = y + torch.where(safe, (fy * fx_x - fx * fy_x) / den_safe, zero)
    return x, y


def convert_to_ndc(origins, directions, pixtocam, near: float = 1.0, device=None):
    """Rays into the NDC cube of a forward-facing pinhole camera (NeRF's
    appendix C): each origin slid along its ray to the near plane (oz =
    -near), so that the NDC near bound is 0, and each direction from the
    projected near point to the projected point at infinity, so that the
    far bound is 1. Float32 tensors on ``device``."""
    dev = resolve_device(device)
    origins, directions = _tensor(origins, dev), _tensor(directions, dev)
    pixtocam = _tensor(pixtocam, dev)
    t = -(near + origins[..., 2]) / directions[..., 2]
    origins = origins + t[..., None] * directions
    dx, dy, dz = directions.unbind(-1)
    ox, oy, oz = origins.unbind(-1)
    xmult = 1.0 / pixtocam[0, 2]  # -2 * focal_x / cx
    ymult = 1.0 / pixtocam[1, 2]
    origins_ndc = torch.stack([xmult * ox / oz, ymult * oy / oz, -torch.ones_like(oz)], -1)
    infinity_ndc = torch.stack([xmult * dx / dz, ymult * dy / dz, torch.ones_like(oz)], -1)
    return origins_ndc, infinity_ndc - origins_ndc


def pixels_to_rays(pix_x_int, pix_y_int, pixtocams, camtoworlds,
                   distortion_params: Optional[Mapping[str, float]] = None,
                   pixtocam_ndc=None, camtype: ProjectionType = ProjectionType.PERSPECTIVE,
                   device=None):
    """Rays through pixel centres with optional lens undistortion, fisheye
    projection, NDC remap and mip-cone radii, float32 tensors on ``device``.

    The arguments broadcast over leading dims: ``pix_{x,y}_int`` of shape
    SH, ``pixtocams`` SH+[3, 3], ``camtoworlds`` SH+[3, 4]. Returns
    (origins, directions, viewdirs, radii, imageplane), the radii half the
    mean distance to the +1-pixel neighbour rays scaled by 2/sqrt(12) (the
    footprint of a uniform square pixel, Mip-NeRF's convention)."""
    dev = resolve_device(device)
    pix_x, pix_y = _tensor(pix_x_int, dev), _tensor(pix_y_int, dev)
    pixtocams, camtoworlds = _tensor(pixtocams, dev), _tensor(camtoworlds, dev)

    def pix_to_dir(x, y):  # +0.5: through the pixel's centre
        return torch.stack([x + 0.5, y + 0.5, torch.ones_like(x)], -1)

    pixel_dirs = torch.stack([pix_to_dir(pix_x, pix_y), pix_to_dir(pix_x + 1, pix_y),
                              pix_to_dir(pix_x, pix_y + 1)], 0)
    mat_vec = lambda a, b: torch.matmul(a, b[..., None])[..., 0]  # noqa: E731
    camera_dirs = mat_vec(pixtocams, pixel_dirs)
    if distortion_params is not None:
        x, y = undistort(camera_dirs[..., 0], camera_dirs[..., 1], **distortion_params,
                         device=dev)
        camera_dirs = torch.stack([x, y, torch.ones_like(x)], -1)
    if camtype == ProjectionType.FISHEYE:
        # equidistant fisheye: the planar radius is the polar angle theta
        theta = torch.sqrt(torch.sum(camera_dirs[..., :2] ** 2, -1)).clamp(max=np.pi)
        big = theta > 1e-8  # sin(theta) / theta -> 1 as theta -> 0
        sin_over_theta = torch.where(big, torch.sin(theta) / torch.where(
            big, theta, torch.ones_like(theta)), torch.ones_like(theta))
        camera_dirs = torch.stack([camera_dirs[..., 0] * sin_over_theta,
                                   camera_dirs[..., 1] * sin_over_theta, torch.cos(theta)], -1)
    # OpenCV (right, down, forward) -> OpenGL (right, up, back)
    camera_dirs = camera_dirs * torch.tensor([1.0, -1.0, -1.0], device=dev)
    imageplane = camera_dirs[0, ..., :2]

    directions, dx, dy = mat_vec(camtoworlds[..., :3, :3], camera_dirs).unbind(0)
    origins = torch.broadcast_to(camtoworlds[..., :3, -1], directions.shape)
    viewdirs = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
    if pixtocam_ndc is None:
        dx_norm = torch.linalg.norm(dx - directions, dim=-1)
        dy_norm = torch.linalg.norm(dy - directions, dim=-1)
    else:
        origins_dx, _ = convert_to_ndc(origins, dx, pixtocam_ndc, device=dev)
        origins_dy, _ = convert_to_ndc(origins, dy, pixtocam_ndc, device=dev)
        origins, directions = convert_to_ndc(origins, directions, pixtocam_ndc, device=dev)
        dx_norm = torch.linalg.norm(origins_dx - origins, dim=-1)
        dy_norm = torch.linalg.norm(origins_dy - origins, dim=-1)
    radii = (0.5 * (dx_norm + dy_norm))[..., None] * 2.0 / np.sqrt(12.0)
    return origins, directions, viewdirs, radii, imageplane
