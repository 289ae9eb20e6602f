"""Block-NeRF's composed inference: the blocks that hold a view, each
block's render, the visibility gate and the inverse-distance blend.

Counterpart of ``unboundednerfpytorch_tpu/models/block_nerf/compose.py``:

* :func:`filter_blocks`: the blocks whose element list holds the view;
* :func:`distance_weight`: ``|origin - centroid| ** -p``;
* :func:`render_block`: one block's render of a whole view in chunks of
  rays, the last chunk padded by repeating the last ray;
* the gate: a block whose mean fine visibility is at most
  ``VISIBILITY_GATE`` is dropped;
* :func:`inverse_interpolation`: the normalised-weight blend of the blocks'
  8-bit colour and depth maps, on the host, the weighted sum truncated to
  ``uint8``, over the maps as the JAX package lists them before it adds
  the blend.
"""

from __future__ import annotations

import numpy as np
import torch

from unboundednerfpytorch_tpu_torch.models.block_nerf import rendering as R

VISIBILITY_GATE = 0.05  # the mean fine visibility a block must pass


def filter_blocks(image_name: str, block_split: dict) -> list:
    """The blocks whose element list holds ``image_name``."""
    return [block for block, info in block_split.items()
            for element in info["elements"] if element[0] == image_name]


def distance_weight(origin, centroid, p: int = 4) -> float:
    return float(np.linalg.norm(np.asarray(origin) - np.asarray(centroid)) ** -p)


@torch.no_grad()
def render_block(model, rays, ts, chunk: int = 4096, **render_kwargs) -> dict:
    """One block's render of ``rays`` [N, 10] (``ts`` [N]) in chunks of
    ``chunk`` rays, on the model's device, without jitter: numpy
    {"rgb_fine" [N, 3], "depth_fine" [N], "transmittance_fine_vis" [N] (the
    mean over the ray's samples)}."""
    dev = model.appearance.device
    rays = torch.as_tensor(rays, dtype=torch.float32, device=dev)
    ts = torch.as_tensor(ts, device=dev)
    n = rays.shape[0]
    n_pad = (-n) % chunk
    if n_pad:
        rays = torch.cat([rays, rays[-1:].expand(n_pad, -1)])
        ts = torch.cat([ts, ts[-1:].expand(n_pad)])
    outs = {"rgb_fine": [], "depth_fine": [], "transmittance_fine_vis": []}
    for i in range(0, rays.shape[0], chunk):
        res = R.render_rays(model, rays[i:i + chunk], ts[i:i + chunk], **render_kwargs)
        outs["rgb_fine"].append(res["rgb_fine"].cpu().numpy())
        outs["depth_fine"].append(res["depth_fine"].cpu().numpy())
        outs["transmittance_fine_vis"].append(
            res["transmittance_fine_vis"].mean(-1).cpu().numpy())
    return {k: np.concatenate(v)[:n] for k, v in outs.items()}


def inverse_interpolation(block_results: dict, H: int, W: int):
    """The blend of {block: {"rgb_fine" [HW, 3], "depth_fine" [HW],
    "distance_weight"}}: (rgb maps, depth maps), each a dict by block plus
    ``compose``, 8-bit."""
    weights = []
    img_rgb, img_depth = {}, {}
    for block, res in block_results.items():
        rgb = np.clip(res["rgb_fine"].reshape(H, W, 3), 0, 1)
        img_rgb[block] = (rgb * 255).astype(np.uint8)
        depth = np.nan_to_num(res["depth_fine"].reshape(H, W))
        mi, ma = depth.min(), depth.max()
        img_depth[block] = (255 * (depth - mi) / max(ma - mi, 1e-8)).astype(np.uint8)
        weights.append(res["distance_weight"])
    total = sum(weights)
    weights = [w / total for w in weights]
    img_rgb["compose"] = sum(w * rgb for w, rgb in zip(weights, list(img_rgb.values()))
                             ).astype(np.uint8)
    img_depth["compose"] = sum(w * d for w, d in zip(weights, list(img_depth.values()))
                               ).astype(np.uint8)
    return img_rgb, img_depth


def compose_view(block_models: dict, candidate_blocks, block_centroids: dict, rays, ts,
                 H: int, W: int, p: int = 4, chunk: int = 4096, **render_kwargs):
    """One view composed: each candidate block rendered
    (:func:`render_block`), those at or under the visibility gate dropped,
    the rest blended by :func:`distance_weight` from the view's origin.
    Returns (rgb maps, depth maps), or (None, None) where no block passes."""
    origin = np.asarray(rays[0, :3].cpu() if torch.is_tensor(rays) else rays[0, :3])
    results = {}
    for block in candidate_blocks:
        res = render_block(block_models[block], rays, ts, chunk=chunk, **render_kwargs)
        if float(res["transmittance_fine_vis"].mean()) <= VISIBILITY_GATE:
            continue
        res["distance_weight"] = distance_weight(origin, block_centroids[block], p=p)
        results[block] = res
    if not results:
        return None, None
    return inverse_interpolation(results, H, W)
