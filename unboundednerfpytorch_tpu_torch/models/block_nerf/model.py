"""The Block-NeRF network: the integrated positional encoding of a cone's
Gaussians, the 8-layer skip MLP conditioned on view direction, exposure and
appearance, and the visibility MLP.

Counterpart of ``unboundednerfpytorch_tpu/models/block_nerf/model.py``. The
JAX ``BlockNeRFParams`` is a pytree of ``MLP`` s; here :class:`BlockNeRF` is
an ``nn.Module`` with the same parts: ``xyz_layers`` (``D`` linear layers,
the encoding concatenated back in before each layer of ``skips``),
``xyz_final``, ``dir_layers`` (three layers), ``sigma_head``, ``rgb_head``,
``vis_layers`` (four layers), ``vis_head`` and the ``appearance`` table.
Every layer is an ``nn.Linear`` drawn from U(+-1/sqrt(fan_in)) (biases too),
the table from N(0, 0.01^2). The products are plain matrix products, as the
JAX package computes them outside any kernel of its own.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from unboundednerfpytorch_tpu_torch.fields.mlp import MLP


def pos_embedding(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[sin(2^k x), cos(2^k x)] for k = 0..n_freqs-1, in that order, without
    the identity: dim -> dim * 2 * n_freqs."""
    out = []
    for k in range(n_freqs):
        out += [torch.sin(2.0**k * x), torch.cos(2.0**k * x)]
    return torch.cat(out, dim=-1)


def inter_pos_embedding(mu: torch.Tensor, diag_cov: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """The integrated encoding of the Gaussian (mu, diag_cov):
    [sin(2^k mu), cos(2^k mu)] * exp(-0.5 * 4^k * diag_cov) for each k."""
    out = []
    for k in range(n_freqs):
        f = 2.0**k
        damp = torch.exp(-0.5 * (f * f) * diag_cov)
        out += [torch.sin(f * mu) * damp, torch.cos(f * mu) * damp]
    return torch.cat(out, dim=-1)


def default_dims(xyz_freqs: int = 10, dir_freqs: int = 4, exposure_freqs: int = 4,
                 appearance_dim: int = 32) -> dict:
    return {"in_xyz": 3 * 2 * xyz_freqs, "in_dir": 3 * 2 * dir_freqs,
            "in_exp": 2 * exposure_freqs, "in_app": appearance_dim}


class BlockNeRF(nn.Module):
    """One block's networks and appearance table (the JAX ``create``)."""

    def __init__(self, n_appearance: int = 1, D: int = 8, W: int = 256, skips=(4,),
                 xyz_freqs: int = 10, dir_freqs: int = 4, exposure_freqs: int = 4,
                 appearance_dim: int = 32, vis_width: int = 128,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.dims = dict(n_appearance=int(n_appearance), D=int(D), W=int(W),
                         skips=[int(s) for s in skips], xyz_freqs=int(xyz_freqs),
                         dir_freqs=int(dir_freqs), exposure_freqs=int(exposure_freqs),
                         appearance_dim=int(appearance_dim), vis_width=int(vis_width))
        dims = default_dims(xyz_freqs, dir_freqs, exposure_freqs, appearance_dim)
        mlp = lambda d_in, hidden, d_out, depth: MLP(d_in, hidden, d_out, depth,
                                                     zero_final_bias=False, generator=generator,
                                                     device=device)
        self.skips = tuple(int(s) for s in skips)
        self.xyz_layers = nn.ModuleList(
            mlp(dims["in_xyz"] if i == 0 else W + dims["in_xyz"] if i in self.skips else W,
                W, W, 1).layers[0]
            for i in range(D))
        self.xyz_final = mlp(W, W, W, 1)
        self.dir_layers = mlp(W + dims["in_dir"] + dims["in_exp"] + dims["in_app"],
                              W // 2, W // 2, 3)
        self.sigma_head = mlp(W, W, 1, 1)
        self.rgb_head = mlp(W // 2, W // 2, 3, 1)
        self.vis_layers = mlp(dims["in_xyz"] + dims["in_dir"], vis_width, vis_width, 4)
        self.vis_head = mlp(vis_width, vis_width, 1, 1)
        self.appearance = nn.Parameter(
            torch.randn((n_appearance, appearance_dim), generator=generator).to(device) * 0.01)


def block_nerf_apply(model: BlockNeRF, xyz_enc, dir_enc=None, exp_enc=None, app_enc=None,
                     sigma_only: bool = False):
    """The Block-NeRF forward: the skip trunk, sigma (softplus), and the rgb
    (sigmoid) of the direction, exposure and appearance stack, a ReLU after
    every one of its layers. Returns (rgb, sigma), or sigma alone."""
    x = xyz_enc
    for i, layer in enumerate(model.xyz_layers):
        if i in model.skips:
            x = torch.cat([x, xyz_enc], dim=-1)
        x = torch.relu(layer(x))
    sigma = F.softplus(model.sigma_head(x))[..., 0]
    if sigma_only:
        return sigma
    h = torch.cat([model.xyz_final(x), dir_enc]
                  + ([exp_enc] if exp_enc is not None else [])
                  + ([app_enc] if app_enc is not None else []), dim=-1)
    h = torch.relu(model.dir_layers(h))
    return torch.sigmoid(model.rgb_head(h)), sigma


def visibility_apply(model: BlockNeRF, xyz_enc, dir_enc):
    """The visibility MLP (the transmittance it distils), softplus output."""
    h = torch.relu(model.vis_layers(torch.cat([xyz_enc, dir_enc], dim=-1)))
    return F.softplus(model.vis_head(h))[..., 0]


def block_nerf_loss(results: dict, target_rgb, lambda_mu: float = 0.01,
                    visi_loss: float = 1e-2) -> dict:
    """The four terms: the coarse (times ``lambda_mu``) and fine photometric
    MSE, and the visibility MLP's MSE against the detached real
    transmittance of each level."""
    return {
        "rgb_coarse": lambda_mu * torch.mean((results["rgb_coarse"] - target_rgb) ** 2),
        "rgb_fine": torch.mean((results["rgb_fine"] - target_rgb) ** 2),
        "transmittance_coarse": lambda_mu * visi_loss * torch.mean(
            (results["transmittance_coarse_real"].detach()
             - results["transmittance_coarse_vis"]) ** 2),
        "transmittance_fine": visi_loss * torch.mean(
            (results["transmittance_fine_real"].detach() - results["transmittance_fine_vis"]) ** 2),
    }
