"""The Block-NeRF ray renderer: cone Gaussians, stratified coarse samples,
inverse-CDF resampling for the fine level, and cumprod compositing.

Counterpart of ``unboundednerfpytorch_tpu/models/block_nerf/rendering.py``.
The JAX package computes all of it as XLA operations of its own (no Pallas
kernel), and so are these plain PyTorch operations; the fine level always has
``n_samples + n_importance + 1`` intervals. Randomness comes from a
``torch.Generator`` (the stratified jitter, and the sigma noise), or the
jitter is handed in as ``jitter`` (the uniform draws, ``[N, n_samples + 1]``).
"""

from __future__ import annotations

import torch

from unboundednerfpytorch_tpu_torch.models.block_nerf import model as M


def get_cone_mean_conv(t_samples, rays_o, rays_d, radii):
    """Each interval's cone Gaussian: the mean distance (mip-NeRF eq. 7), the
    mean point, and the diagonal covariance in world space."""
    t0, t1 = t_samples[..., :-1], t_samples[..., 1:]
    middle_t = (t0 + t1) / 2
    diff_t = (t1 - t0) / 2
    denom = 3 * middle_t**2 + diff_t**2
    mean_t = middle_t + (2 * middle_t * diff_t**2) / denom
    variance_t = diff_t**2 / 3 - (4 / 15) * (diff_t**4 * (12 * middle_t**2 - diff_t**2) / denom**2)
    radii = radii.reshape(-1, 1)
    variance_r = radii**2 * (middle_t**2 / 4 + (5 / 12) * diff_t**2
                             - (4 / 15) * diff_t**4 / denom)
    mean = rays_o[:, None, :] + rays_d[:, None, :] * mean_t[..., None]
    dod = rays_d**2
    direct_norm = torch.sum(dod, dim=-1, keepdim=True) + 1e-10
    diag_cov = (variance_t[..., None] * dod[:, None, :]
                + variance_r[..., None] * (1 - dod / direct_norm)[:, None, :])
    return mean_t, mean, diag_cov


def sample_pdf(bins, weights, n_importance: int, alpha: float = 1e-2):
    """Inverse-CDF sampling of ``n_importance + 1`` depths a ray at the
    evenly spaced u of [0, 1] (deterministic, as the reference). The cdf of
    the weights plus ``alpha`` is non-decreasing, so the right bisection
    counts its entries <= u; a bin whose cdf step is under ``alpha`` takes a
    step of 1."""
    n_rays, n_bins = weights.shape
    weights = weights + alpha
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    u = torch.linspace(0.0, 1.0, n_importance + 1, dtype=bins.dtype, device=bins.device)
    u = u.expand(n_rays, n_importance + 1).contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, 0, n_bins)
    above = torch.clamp(inds, 0, n_bins)
    cdf_lo = torch.gather(cdf, 1, below)
    cdf_hi = torch.gather(cdf, 1, above)
    bins_pad = torch.cat([bins, bins[:, -1:]], dim=-1)
    bin_lo = torch.gather(bins_pad, 1, torch.clamp(below, 0, n_bins - 1))
    bin_hi = torch.gather(bins_pad, 1, torch.clamp(above, 0, n_bins - 1))
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < alpha, torch.ones_like(denom), denom)
    return bin_lo + (u - cdf_lo) / denom * (bin_hi - bin_lo)


def volume_rendering(rgbs, sigmas, z_vals, mean_t, noise=None) -> dict:
    """Compositing with the exclusive cumprod of ``1 - alpha + 1e-10``;
    ``noise`` (like ``sigmas``) is added to the sigmas first. ``rgbs`` None:
    transmittance, weights and opacity only."""
    deltas = z_vals[:, 1:] - z_vals[:, :-1]
    if noise is not None:
        sigmas = sigmas + noise
    alphas = 1.0 - torch.exp(-deltas * torch.relu(sigmas))
    shifted = torch.cat([torch.ones_like(alphas[:, :1]), 1.0 - alphas + 1e-10], dim=-1)
    Ti = torch.cumprod(shifted[:, :-1], dim=-1)
    weights = alphas * Ti
    out = {"transmittance": Ti, "weights": weights, "opacity": torch.sum(weights, dim=-1),
           "z_vals": z_vals}
    if rgbs is not None:
        out["rgb"] = torch.einsum("ns,nsc->nc", weights, rgbs)
        out["depth"] = torch.sum(weights * mean_t, dim=-1)
    return out


def render_rays(model: M.BlockNeRF, rays, ts, generator: torch.Generator | None = None,
                n_samples: int = 64, n_importance: int = 64, use_disp: bool = False,
                xyz_freqs: int = 10, dir_freqs: int = 4, exposure_freqs: int = 4,
                sigma_noise: bool = False, compute_rgb: bool = True, jitter=None) -> dict:
    """The coarse-to-fine render of ``rays`` [N, 10] (origin, direction,
    radius, exposure, near, far) with appearance ids ``ts`` [N]: depths
    log-linear (``use_disp``) or linear from near to far, jittered within
    their strata by ``jitter`` or by uniform draws from ``generator`` (none
    without either), the coarse level, ``n_importance + 1`` depths resampled
    from its detached weights, merged and sorted, and the fine level.
    Returns rgb and depth and the real and distilled transmittances of both
    levels. ``compute_rgb`` False composites no colour."""
    n_rays = rays.shape[0]
    rays_o, rays_d, radii, exposure, near, far = torch.split(rays, [3, 3, 1, 1, 1, 1], dim=-1)
    z_steps = torch.linspace(0.0, 1.0, n_samples + 1, dtype=rays.dtype, device=rays.device)
    if use_disp:
        z_vals = torch.exp(torch.log(near) * (1 - z_steps) + torch.log(far) * z_steps)
    else:
        z_vals = near * (1 - z_steps) + far * z_steps
    z_vals = z_vals.expand(n_rays, n_samples + 1)
    if jitter is None and generator is not None:
        jitter = torch.rand(z_vals.shape, generator=generator, device=generator.device).to(
            rays.device)
    if jitter is not None:
        mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        upper = torch.cat([mid, z_vals[:, -1:]], dim=-1)
        lower = torch.cat([z_vals[:, :1], mid], dim=-1)
        z_vals = lower + (upper - lower) * jitter

    dir_enc = M.pos_embedding(rays_d, dir_freqs)
    exp_enc = M.pos_embedding(exposure, exposure_freqs)
    app_enc = model.appearance[ts.long()]

    def run_level(z):
        s = z.shape[1] - 1
        mean_t, mean, diag_cov = get_cone_mean_conv(z, rays_o, rays_d, radii[:, 0])
        xyz_enc = M.inter_pos_embedding(mean, diag_cov, xyz_freqs)
        tile = lambda e: e[:, None, :].expand(n_rays, s, e.shape[-1])
        rgb, sigma = M.block_nerf_apply(model, xyz_enc, tile(dir_enc), tile(exp_enc),
                                        tile(app_enc))
        vis = M.visibility_apply(model, xyz_enc, tile(dir_enc))
        noise = None
        if sigma_noise and generator is not None:
            noise = torch.randn(sigma.shape, generator=generator,
                                device=generator.device).to(sigma.device)
        return volume_rendering(rgb if compute_rgb else None, sigma, z, mean_t, noise), vis

    coarse, vis_coarse = run_level(z_vals)
    z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
    z_fine_new = sample_pdf(z_mid, coarse["weights"][:, 1:-1].detach(), n_importance)
    z_fine, _ = torch.sort(torch.cat([z_vals, z_fine_new], dim=-1), dim=-1)
    fine, vis_fine = run_level(z_fine)
    return {
        "rgb_coarse": coarse.get("rgb"),
        "rgb_fine": fine.get("rgb"),
        "depth_fine": fine.get("depth"),
        "opacity_fine": fine["opacity"],
        "transmittance_coarse_real": coarse["transmittance"],
        "transmittance_fine_real": fine["transmittance"],
        "transmittance_coarse_vis": vis_coarse,
        "transmittance_fine_vis": vis_fine,
    }
