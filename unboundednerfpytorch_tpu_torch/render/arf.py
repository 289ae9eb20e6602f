"""ARF (Artistic Radiance Fields) stylizer.

The port's copy of ``unboundednerfpytorch_tpu/render/arf.py`` (the
reference's ``arf.py``): covariance colour matching of a rendered image set
to a style image through the SVDs of the two 3x3 colour covariances,
returning the stylized set and the 4x4 colour transform. The linear algebra
runs in torch on the render's device; the style image is read through the
port's ``data.png.imread`` (PIL) and resized with OpenCV's area filter, as
the JAX package does.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def load_style_img(style_img_path: str, content_h: int, content_w: int) -> np.ndarray:
    """Resize the style image so its long side matches the content long side,
    then halve (arf.py:25-50). Returns [Hs, Ws, C] float32 in [0, 1]."""
    import cv2

    from unboundednerfpytorch_tpu_torch.data.png import imread

    style = imread(style_img_path).astype(np.float32) / 255.0
    sh, sw = style.shape[:2]
    long_side = max(content_h, content_w)
    if sh > sw:
        style = cv2.resize(style, (int(long_side / sh * sw), long_side),
                           interpolation=cv2.INTER_AREA)
    else:
        style = cv2.resize(style, (long_side, int(long_side / sw * sh)),
                           interpolation=cv2.INTER_AREA)
    return cv2.resize(style, (style.shape[1] // 2, style.shape[0] // 2),
                      interpolation=cv2.INTER_AREA)


def match_colors_for_image_set(image_set: np.ndarray, style_img: np.ndarray, device=None):
    """Covariance colour transfer (arf.py:51-89) in float32 on ``device``
    (``None`` -> ``cuda``, raising without a GPU; ``"cpu"`` for the plain
    path).

    image_set [N, H, W, 3], style_img [Hs, Ws, 3] in [0, 1]. Returns
    (stylized set [N, H, W, 3], color_tf [4, 4]) as numpy."""
    from unboundednerfpytorch_tpu_torch.device import resolve_device

    device = resolve_device(device)
    sh = np.shape(image_set)
    x = torch.as_tensor(np.asarray(image_set, np.float32), device=device).reshape(-1, 3)
    s = torch.as_tensor(np.asarray(style_img, np.float32), device=device).reshape(-1, 3)

    mu_c = x.mean(0, keepdim=True)
    mu_s = s.mean(0, keepdim=True)
    cov_c = (x - mu_c).T @ (x - mu_c) / x.shape[0]
    cov_s = (s - mu_s).T @ (s - mu_s) / s.shape[0]

    u_c, sig_c, _ = torch.linalg.svd(cov_c)
    u_s, sig_s, _ = torch.linalg.svd(cov_s)

    scl_c = torch.diag(1.0 / torch.sqrt(torch.clamp(sig_c, 1e-8, 1e8)))
    scl_s = torch.diag(torch.sqrt(torch.clamp(sig_s, 1e-8, 1e8)))

    tmp_mat = u_s @ scl_s @ u_s.T @ u_c @ scl_c @ u_c.T
    tmp_vec = mu_s.reshape(1, 3) - mu_c.reshape(1, 3) @ tmp_mat.T

    out = torch.clamp(x @ tmp_mat.T + tmp_vec, 0.0, 1.0).reshape(sh)

    color_tf = torch.eye(4, device=device)
    color_tf[:3, :3] = tmp_mat
    color_tf[:3, 3] = tmp_vec[0]
    return out.cpu().numpy(), color_tf.cpu().numpy()


class ARF:
    """Style image load and stylization of a render set (``run_render``'s
    ``--style_root``): ``<style_root>/<style_id>.jpg``. The transfer runs on
    ``device`` (``None`` -> ``cuda``)."""

    def __init__(self, style_root: str, style_id, content_h: int, content_w: int,
                 device=None):
        from unboundednerfpytorch_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        path = os.path.join(style_root, f"{style_id}.jpg")
        self.np_style_img = load_style_img(path, content_h, content_w)

    def match_colors_for_image_set(self, image_set: np.ndarray, save_dir: str | None = None):
        if save_dir:
            from unboundednerfpytorch_tpu_torch.utils.observability import write_png_file

            write_png_file(os.path.join(save_dir, "style_image.png"),
                           np.clip(self.np_style_img * 255.0, 0, 255).astype(np.uint8))
        return match_colors_for_image_set(image_set, self.np_style_img, device=self.device)
