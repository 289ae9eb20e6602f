"""The port's camera models (``data/cameras.py``) against the JAX package's
on the CPU: the cases of the JAX package's ``tests/test_cameras.py``, each
run through both packages and against its own expectation.

Tolerances: the intrinsic matrix, the COLMAP dispatch and ``distort`` are
equal; every other value is float32 in both packages, whose Newton steps,
matrix products and square roots round in another order. Against JAX they
agree within 2e-6 absolute plus 1e-5 relative of a value (the largest gap
seen here is 1.4e-6, three float32 ulps of an NDC origin of 6.8); against the analytic expectations the JAX tests'
own tolerances hold (1e-6 to 1e-7 absolute, the radius 1e-6 relative).
"""

import numpy as np
import pytest
import torch

from unboundednerfpytorch_tpu.data import cameras as jcam
from unboundednerfpytorch_tpu_torch.data import cameras

ATOL, RTOL = 2e-6, 1e-5


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got),
                               np.asarray(want), rtol=rtol, atol=atol)


def both(fn_name, *args, **kwargs):
    want = getattr(jcam, fn_name)(*args, **kwargs)
    got = getattr(cameras, fn_name)(*args, **kwargs, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(np.shape(w))
        close(g, w)
    return got


def _pinhole_pixtocam(fx, fy, cx, cy):
    return np.linalg.inv(cameras.intrinsic_matrix(fx, fy, cx, cy))


def test_the_numpy_parts_equal_jax():
    np.testing.assert_array_equal(cameras.intrinsic_matrix(50.0, 51.0, 25.0, 24.0),
                                  jcam.intrinsic_matrix(50.0, 51.0, 25.0, 24.0))
    for model, params in (("PINHOLE", [50, 50, 25, 25]), ("SIMPLE_RADIAL", [50, 25, 25, 0.1]),
                          ("RADIAL", [50, 25, 25, 0.1, 0.2]),
                          ("OPENCV", [50, 50, 25, 25, 0.1, 0.02, 0.003, 0.004]),
                          ("OPENCV_FISHEYE", [50, 50, 25, 25, 0.1, 0.02, 0.003, 0.004])):
        got, want = cameras.colmap_distortion_params(model, params), \
            jcam.colmap_distortion_params(model, params)
        assert got[0] == want[0] and got[1].value == want[1].value
    with pytest.raises(ValueError):
        cameras.colmap_distortion_params("FOV", [1, 2, 3, 4, 5])
    rng = np.random.default_rng(0)
    x, y = rng.uniform(-0.4, 0.4, (2, 64))
    params = dict(k1=0.05, k2=-0.02, k3=0.004, p1=0.001, p2=-0.002)
    for g, w in zip(cameras.distort(x, y, **params), jcam.distort(x, y, **params)):
        np.testing.assert_array_equal(g, w)


def test_undistort_inverts_distort():
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.4, 0.4, size=(64,))
    y = rng.uniform(-0.4, 0.4, size=(64,))
    params = dict(k1=0.05, k2=-0.02, k3=0.004, p1=0.001, p2=-0.002)
    xd, yd = cameras.distort(x, y, **params)
    xu, yu = both("undistort", xd, yd, **params)
    close(xu, x, atol=1e-6, rtol=0)
    close(yu, y, atol=1e-6, rtol=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cameras.undistort(xd, yd, **params)  # the card unless told otherwise


def test_undistort_identity_when_no_distortion():
    x = np.linspace(-0.3, 0.3, 11)
    xu, yu = both("undistort", x, -x)
    close(xu, x.astype(np.float32), atol=1e-12, rtol=0)
    close(yu, -x.astype(np.float32), atol=1e-12, rtol=0)


def test_undistort_takes_the_eps_guard_as_jax():
    """Where the Jacobian's determinant is within ``eps`` of 0 no step is
    taken: with an ``eps`` over every determinant the point stays where it
    is, to the bit, in both packages."""
    xd = np.array([0.0, 0.5, 2.0, -3.0], np.float32)
    for xu in both("undistort", xd, -xd, k1=-1.0 / 3.0, p1=0.01, eps=1e3):
        assert xu.abs().tolist() == np.abs(xd).tolist()


def test_pixels_to_rays_pinhole_center_pixel():
    pixtocam = _pinhole_pixtocam(64.0, 64.0, 32.5, 32.5)
    o, d, v, r, ip = both("pixels_to_rays", np.array([32]), np.array([32]), pixtocam,
                          np.eye(4)[:3])
    close(o[0], [0, 0, 0], atol=1e-7, rtol=0)
    close(v[0], [0, 0, -1], atol=1e-7, rtol=0)
    close(ip[0], [0, 0], atol=1e-7, rtol=0)
    close(r[0, 0], (0.5 * (1 / 64 + 1 / 64)) * 2 / np.sqrt(12.0), atol=0, rtol=1e-6)


def test_pixels_to_rays_applies_pose_rotation_and_origin():
    pixtocam = _pinhole_pixtocam(50.0, 50.0, 25.0, 25.0)
    Ry = np.array([[0, 0, 1.0], [0, 1, 0], [-1, 0, 0]])
    c2w = np.concatenate([Ry, np.array([[1.0], [2.0], [3.0]])], axis=1)
    o, d, v, _, _ = both("pixels_to_rays", np.array([12]), np.array([7]), pixtocam, c2w)
    close(o[0], [1, 2, 3], atol=1e-7, rtol=0)
    close(d[0], Ry @ np.array([(12.5 - 25) / 50, -(7.5 - 25) / 50, -1.0]), atol=1e-6, rtol=0)
    close(torch.linalg.norm(v[0]), 1.0, atol=0, rtol=1e-6)


def test_pixels_to_rays_fisheye_preserves_polar_angle():
    pixtocam = _pinhole_pixtocam(100.0, 100.0, 50.0, 50.0)
    xs, ys = np.array([80, 95, 50]), np.array([50, 60, 85])
    _, _, v, _, _ = cameras_and_jax_fisheye(xs, ys, pixtocam)
    for i in range(len(xs)):
        theta = np.hypot((xs[i] + 0.5 - 50) / 100, (ys[i] + 0.5 - 50) / 100)
        close(v[i] @ torch.tensor([0, 0, -1.0]), np.cos(theta), atol=1e-6, rtol=0)


def cameras_and_jax_fisheye(xs, ys, pixtocam):
    """The fisheye call of each package (each takes its own enum)."""
    want = jcam.pixels_to_rays(xs, ys, pixtocam, np.eye(4)[:3],
                               camtype=jcam.ProjectionType.FISHEYE)
    got = cameras.pixels_to_rays(xs, ys, pixtocam, np.eye(4)[:3],
                                 camtype=cameras.ProjectionType.FISHEYE, device="cpu")
    for g, w in zip(got, want):
        close(g, w)
    return got


def test_pixels_to_rays_undistorts():
    pixtocam = _pinhole_pixtocam(100.0, 100.0, 50.0, 50.0)
    params = dict(k1=0.08, k2=-0.01, p1=0.002, p2=-0.001)
    _, d, _, _, _ = both("pixels_to_rays", np.array([70]), np.array([30]), pixtocam,
                         np.eye(4)[:3], distortion_params=params)
    d = d[0].numpy().astype(np.float64)
    xd, yd = cameras.distort(d[0] / -d[2], -d[1] / -d[2], **params)
    np.testing.assert_allclose([xd, yd], [(70.5 - 50) / 100, (30.5 - 50) / 100], atol=1e-6)


def test_convert_to_ndc_near_far_bounds():
    rng = np.random.default_rng(1)
    o, d = rng.normal(size=(2, 32, 3))
    o[:, 2] = np.abs(o[:, 2])
    d[:, 2] = -np.abs(d[:, 2]) - 0.1
    pixtocam = _pinhole_pixtocam(80.0, 80.0, 40.0, 40.0)
    o_ndc, d_ndc = both("convert_to_ndc", o, d, pixtocam, near=1.0)
    close(o_ndc[:, 2], np.full(32, -1.0), atol=1e-6, rtol=0)
    close((o_ndc + d_ndc)[:, 2], np.full(32, 1.0), atol=1e-6, rtol=0)


@pytest.mark.parametrize("camera", ["OPENCV", "OPENCV_FISHEYE"])
def test_a_distorted_view_with_ndc_against_jax(camera):
    """A whole 24x36 view of an OPENCV and an OPENCV_FISHEYE camera with a
    pose, and the NDC remap on the first, every output against JAX."""
    params, camtype = cameras.colmap_distortion_params(
        camera, [30.0, 31.0, 18.0, 12.0, 0.06, -0.01, 0.002, -0.001])
    jtype = jcam.ProjectionType(camtype.value)
    pixtocam = _pinhole_pixtocam(30.0, 31.0, 18.0, 12.0)
    rng = np.random.default_rng(2)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    c2w = np.concatenate([q * np.sign(np.linalg.det(q)), rng.standard_normal((3, 1))], 1)
    ys, xs = np.meshgrid(np.arange(24), np.arange(36), indexing="ij")
    ndc = pixtocam if camera == "OPENCV" else None
    want = jcam.pixels_to_rays(xs, ys, pixtocam, c2w, distortion_params=params,
                               pixtocam_ndc=ndc, camtype=jtype)
    got = cameras.pixels_to_rays(xs, ys, pixtocam, c2w, distortion_params=params,
                                 pixtocam_ndc=ndc, camtype=camtype, device="cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        close(g, w)
