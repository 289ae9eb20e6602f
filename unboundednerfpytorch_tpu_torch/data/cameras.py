"""The COLMAP camera models' lens parameters and projection type.

The port's copy of the part of ``unboundednerfpytorch_tpu/data/cameras.py``
that the COLMAP tooling (``data/colmap.py``) reads: :class:`ProjectionType`
and :func:`colmap_distortion_params`, both numpy and ``enum``. The rest of
that module (distortion-aware ray generation) serves Block-NeRF and waits
for ROADMAP A18b.
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

import numpy as np


class ProjectionType(enum.Enum):
    """Camera projection type."""

    PERSPECTIVE = "perspective"
    FISHEYE = "fisheye"


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
