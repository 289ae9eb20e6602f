"""Full-image rendering and evaluation.

Counterpart of ``unboundednerfpytorch_tpu/render/renderer.py``:
``render_image``, ``render_viewpoints``, ``depth_to_vis``. A view's rays are
cut into fixed-size chunks (the last padded by repeating its last ray) and
each chunk goes through ``forward_fn`` under ``torch.no_grad()``. Every
chunk's outputs stay on the device; the image is copied to the host once,
so a view costs one synchronisation and not one per chunk.

The JAX module's ``_batched_renderer`` and ``aux_format`` keep multi-GB
tables out of compiled executables and negotiate their layouts; eager
PyTorch has neither problem, so they have no counterpart, and ``aux`` is
simply handed to ``forward_fn``. With ``mesh`` (a
:class:`..parallel.mesh.Mesh`, the JAX ``mesh=``) a view renders
cooperatively: each chunk's rays are shared out over the data axis, every
rank renders its share of every chunk, and one all-gather a view puts the
image together on every rank. Rays are independent, so the image is the
single-device one.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from unboundednerfpytorch_tpu_torch.device import from_host, resolve_device, to_host
from unboundednerfpytorch_tpu_torch.ops import rays as ray_ops
from unboundednerfpytorch_tpu_torch.utils import metrics as M
from unboundednerfpytorch_tpu_torch.utils.profiling import span

DEFAULT_CHUNK = 8192  # the reference's render chunk


def render_image(
    forward_fn: Callable,
    H: int,
    W: int,
    K,
    c2w,
    *,
    ndc: bool = False,
    inverse_y: bool = False,
    flip_x: bool = False,
    flip_y: bool = False,
    chunk: int = DEFAULT_CHUNK,
    aux=None,
    rays_fn=None,
    device=None,
    mesh=None,
):
    """Render one view. ``forward_fn(ro, rd, vd)`` (or, with ``aux``,
    ``forward_fn(aux, ro, rd, vd)``) returns a RenderResult. Returns
    (rgb [H, W, 3], depth [H, W], alphainv_last [H, W]) as numpy.

    ``rays_fn``: optional whole-image override, called as
    ``rays_fn(ro, rd, vd)`` with the flat padded rays; must return
    (rgb, depth, alphainv_last) tensors.

    ``device``: ``None`` -> ``cuda`` (raises without a GPU); ``"cpu"`` for the
    plain path. ``mesh``: the cooperative render (module doc); every rank of
    its data axis must call it for the view.
    """
    dev = resolve_device(device)
    ranks = 1 if mesh is None or mesh.data_group is None else mesh.data
    if ranks > 1 and rays_fn is not None:
        raise ValueError("a cooperative render takes no whole-image rays_fn")
    chunk = -(-chunk // ranks) * ranks  # a chunk shares out evenly
    with torch.no_grad():
        with span("render/rays"):
            # K may arrive as float64 (render_viewpoints); rays are float32
            ro, rd, vd = ray_ops.get_rays_of_a_view(
                H, W, from_host(np.asarray(K), None, dev), from_host(np.asarray(c2w), None, dev),
                ndc=ndc, inverse_y=inverse_y, flip_x=flip_x, flip_y=flip_y)
            ro, rd, vd = (x.reshape(-1, 3) for x in (ro, rd, vd))
            n = ro.shape[0]
            n_pad = (-n) % chunk
            if n_pad:
                pad = lambda x: torch.cat([x, x[-1:].expand(n_pad, 3)])
                ro, rd, vd = pad(ro), pad(rd), pad(vd)
        if rays_fn is not None:
            rgbs, depths, bgws = rays_fn(ro, rd, vd)
        else:
            share = chunk // ranks
            first = 0 if ranks == 1 else mesh.data_index * share
            outs = []
            for a in range(0, ro.shape[0], chunk):
                with span("render/chunk"):
                    sl = slice(a + first, a + first + share)
                    if aux is not None:
                        res = forward_fn(aux, ro[sl], rd[sl], vd[sl])
                    else:
                        res = forward_fn(ro[sl], rd[sl], vd[sl])
                    outs.append((res.rgb_marched, res.depth, res.alphainv_last))
            rgbs, depths, bgws = (torch.cat(parts) for parts in zip(*outs))
            if ranks > 1:
                rgbs, depths, bgws = _gather_shares(mesh, share, rgbs, depths, bgws)
        # one device-to-host copy per image
        packed = to_host(torch.cat([rgbs.reshape(-1, 3)[:n], depths.reshape(-1, 1)[:n],
                                    bgws.reshape(-1, 1)[:n]], dim=1)).numpy()
    rgb = np.ascontiguousarray(packed[:, :3]).reshape(H, W, 3)
    depth = np.ascontiguousarray(packed[:, 3]).reshape(H, W)
    bgw = np.ascontiguousarray(packed[:, 4]).reshape(H, W)
    return rgb, depth, bgw


def _gather_shares(mesh, share: int, rgbs, depths, bgws):
    """Every rank's share of every chunk, put back in ray order."""
    mine = torch.cat([rgbs.reshape(-1, 3), depths.reshape(-1, 1), bgws.reshape(-1, 1)], dim=1)
    parts = [torch.empty_like(mine) for _ in range(mesh.data)]
    dist.all_gather(parts, mine.contiguous(), group=mesh.data_group)
    # [ranks, chunks, share, 5] -> [chunks, ranks, share, 5]
    whole = torch.stack(parts).reshape(mesh.data, -1, share, 5).transpose(0, 1).reshape(-1, 5)
    return whole[:, :3], whole[:, 3], whole[:, 4]


def render_viewpoints(
    forward_fn: Callable,
    poses,
    HW,
    Ks,
    *,
    gt_imgs=None,
    ndc: bool = False,
    inverse_y: bool = False,
    flip_x: bool = False,
    flip_y: bool = False,
    chunk: int = DEFAULT_CHUNK,
    eval_ssim: bool = True,
    eval_lpips: bool = False,
    lpips_nets: tuple = ("alex",),
    verbose: bool = True,
    log_fn=print,
    aux=None,
    render_factor: float = 0,
    render_video_flipy: bool = False,
    render_video_rot90: int = 0,
    image_fn=None,
    device=None,
    mesh=None,
):
    """Render a split of poses and (optionally) evaluate against ground truth.

    ``gt_imgs``: one image a pose, or None for a pose without one (its view
    gets no metrics). ``render_factor``: downsample H/W/K by this factor for
    fast previews; GT metrics are skipped (sizes differ). ``render_video_flipy`` /
    ``render_video_rot90``: post-transforms of the rendered stack.
    ``image_fn(H, W, K, c2w)``: whole-image override. ``mesh``: each view
    renders cooperatively over its data axis (:func:`render_image`).

    Returns dict(rgbs, depths, bgmaps, psnrs, ssims, lpips, seconds);
    ``lpips`` is a list of per-view {net: value} dicts, ``seconds`` the host
    time of each view's render (it ends in the image's copy to the host, so
    the device has finished), without the metrics.
    """
    HW = np.asarray(HW)
    Ks = np.asarray(Ks, np.float64)
    if render_factor:
        HW = (HW / render_factor).astype(int)
        Ks = Ks.copy()
        Ks[:, :2, :3] /= render_factor
        gt_imgs = None
    rgbs, depths, bgmaps = [], [], []
    psnrs, ssims, lpips_vals, seconds = [], [], [], []
    lpips_skipped = False
    for i, c2w in enumerate(np.asarray(poses)):
        H, W = (int(v) for v in HW[i])
        K = Ks[i]
        t0 = time.perf_counter()
        if image_fn is not None:
            rgb, depth, bgw = image_fn(H, W, K, c2w[:3, :4])
        else:
            rgb, depth, bgw = render_image(
                forward_fn, H, W, K, c2w[:3, :4], ndc=ndc, inverse_y=inverse_y,
                flip_x=flip_x, flip_y=flip_y, chunk=chunk, aux=aux, device=device, mesh=mesh)
        seconds.append(time.perf_counter() - t0)
        rgbs.append(rgb)
        depths.append(depth)
        bgmaps.append(bgw)
        if gt_imgs is not None and gt_imgs[i] is not None:
            gt = np.asarray(gt_imgs[i])
            psnrs.append(M.psnr(rgb, gt))
            if eval_ssim:
                ssims.append(M.rgb_ssim(rgb, gt, max_val=1.0))
            if eval_lpips:
                try:
                    lpips_vals.append({net: M.rgb_lpips(gt, rgb, net_name=net)
                                       for net in lpips_nets})
                except ImportError:
                    # never omit a table metric silently: record the skip and
                    # announce it in the summary below
                    lpips_skipped = True
    if render_video_flipy:
        rgbs = [r[::-1] for r in rgbs]
        depths = [d[::-1] for d in depths]
        bgmaps = [b[::-1] for b in bgmaps]
    if render_video_rot90:
        k = int(render_video_rot90)
        rgbs = [np.rot90(r, k=k, axes=(0, 1)) for r in rgbs]
        depths = [np.rot90(d, k=k, axes=(0, 1)) for d in depths]
        bgmaps = [np.rot90(b, k=k, axes=(0, 1)) for b in bgmaps]
    if psnrs and verbose:
        log_fn(f"render eval: psnr {np.mean(psnrs):.2f}")
        if ssims:
            log_fn(f"render eval: ssim {np.mean(ssims):.4f}")
        if lpips_vals:
            for net in lpips_vals[0]:
                log_fn(f"render eval: lpips/{net} "
                       f"{np.mean([v[net] for v in lpips_vals]):.4f}")
    if lpips_skipped:
        log_fn("render eval: LPIPS SKIPPED (optional `lpips` package absent; the "
               "reference's tables include it: install `lpips` to restore the metric)")
    return {
        "rgbs": np.stack(rgbs) if rgbs else np.zeros((0,)),
        "depths": np.stack(depths) if depths else np.zeros((0,)),
        "bgmaps": np.stack(bgmaps) if bgmaps else np.zeros((0,)),
        "psnrs": psnrs,
        "ssims": ssims,
        "lpips": lpips_vals,
        "seconds": seconds,
    }


def depth_to_vis(depth: np.ndarray, p_low: float = 2.0, p_high: float = 98.0):
    """Percentile-normalized depth visualization."""
    lo, hi = np.percentile(depth, [p_low, p_high])
    x = np.clip((depth - lo) / max(hi - lo, 1e-8), 0, 1)
    return (255 * x).astype(np.uint8)
