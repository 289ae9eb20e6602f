"""Block-NeRF training: one step (the coarse-to-fine render, the four-term
loss, Adam) and the loop over one block's ray store.

Counterpart of ``unboundednerfpytorch_tpu/models/block_nerf/training.py``
on one device. The optimizer is ``torch.optim.Adam`` (betas 0.9 and 0.999,
epsilon 1e-8 outside the square root, as optax's) with the learning rate of
``optax.exponential_decay(lr, decay_steps, decay_rate)``: continuous decay,
``lr * decay_rate ** (count / decay_steps)`` at the count of updates made
before this one. Rays are drawn uniformly from the store by a
``torch.Generator``. The JAX ``train_block`` builds its step with the
default learning rate and decay whatever its caller asked for; here ``lr``
and ``decay_steps`` reach the optimizer (ROADMAP C).

Data parallelism (``mesh``, the JAX ``train_block(mesh=...)``): every rank
draws the global batch's ray indices and stratified jitter from a
generator seeded alike and takes its slice; its loss terms, all means over
the rays, enter the backward scaled by its share, the gradients are summed
over the data group, and Adam runs on every replica, so a step is the
single-device step on the global batch.
"""

from __future__ import annotations

import torch

from unboundednerfpytorch_tpu_torch.models.block_nerf import model as M
from unboundednerfpytorch_tpu_torch.models.block_nerf import rendering as R
from unboundednerfpytorch_tpu_torch.parallel import mesh as mesh_mod

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def make_optimizer(model: torch.nn.Module, lr: float = 5e-4, decay_steps: int = 250_000,
                   decay_rate: float = 0.1):
    """(Adam, its schedule): call ``scheduler.step()`` after each
    ``optimizer.step()``."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: decay_rate ** (count / decay_steps))
    return opt, sched


def train_step(model: M.BlockNeRF, optimizer, scheduler, batch: dict,
               generator: torch.Generator | None = None, jitter=None, n_samples: int = 64,
               n_importance: int = 64, lambda_mu: float = 0.01, visi_loss: float = 1e-2,
               use_disp: bool = True, mesh: mesh_mod.Mesh | None = None,
               **render_kwargs) -> dict:
    """One step on ``batch`` (rays, ts, rgbs); the stratified jitter is
    ``jitter`` or drawn from ``generator``. Returns the loss, its terms and
    the fine PSNR as tensors. With ``mesh`` the batch is this rank's slice
    of the global batch and the step is the global batch's (module doc)."""
    results = R.render_rays(model, batch["rays"], batch["ts"], generator=generator,
                            jitter=jitter, n_samples=n_samples, n_importance=n_importance,
                            use_disp=use_disp, **render_kwargs)
    losses = M.block_nerf_loss(results, batch["rgbs"], lambda_mu=lambda_mu, visi_loss=visi_loss)
    total = sum(losses.values())
    optimizer.zero_grad(set_to_none=True)
    share = 1.0 if mesh is None else 1.0 / mesh.data
    (total if share == 1.0 else total * share).backward()
    if mesh is not None:
        mesh_mod.all_reduce_grads(model, mesh)
        losses = mesh_mod.all_reduce_sum({k: v * share for k, v in losses.items()},
                                         mesh.data_group)
        total = sum(losses[k] for k in sorted(losses))
    optimizer.step()
    scheduler.step()
    return {"loss": total.detach(), "psnr": -10.0 * torch.log10(losses["rgb_fine"].detach()),
            **{k: v.detach() for k, v in losses.items()}}


def train_block(model: M.BlockNeRF, ray_store: dict, n_steps: int, batch_size: int = 1024,
                generator: torch.Generator | None = None, log_every: int = 500, log_fn=print,
                lr: float = 5e-4, decay_steps: int = 250_000, use_disp: bool = True,
                n_samples: int = 64, n_importance: int = 64, callback=None,
                mesh: mesh_mod.Mesh | None = None, **render_kwargs) -> dict:
    """Train one block for ``n_steps`` steps of ``batch_size`` rays drawn
    uniformly from ``ray_store`` ({"rays" [N, 10], "rgbs" [N, 3], "ts" [N]},
    tensors on the model's device). ``callback(step, metrics)`` runs after
    each step. Returns the last step's metrics as floats. ``mesh``: data
    parallelism over its data axis, which must divide ``batch_size``; the
    draws are the single-device run's."""
    dev = ray_store["rays"].device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    optimizer, scheduler = make_optimizer(model, lr, decay_steps)
    n = ray_store["rgbs"].shape[0]
    part = None if mesh is None else mesh.batch_slice(batch_size)
    metrics = {}
    for i in range(1, n_steps + 1):
        idx = torch.randint(0, n, (batch_size,), generator=generator, device=generator.device)
        jitter = None
        if part is not None:
            # the global batch's jitter, drawn where render_rays would draw it
            jitter = torch.rand((batch_size, n_samples + 1), generator=generator,
                                device=generator.device)[part].to(dev)
            idx = idx[part]
        batch = {k: v[idx.to(dev)] for k, v in ray_store.items()}
        metrics = train_step(model, optimizer, scheduler, batch, generator=generator,
                             jitter=jitter, n_samples=n_samples, n_importance=n_importance,
                             use_disp=use_disp, mesh=mesh, **render_kwargs)
        if callback is not None:
            callback(i, metrics)
        if i % log_every == 0 or i == n_steps:
            log_fn(f"block step {i}: loss {float(metrics['loss']):.5f} "
                   f"psnr {float(metrics['psnr']):.2f}")
    return {k: float(v) for k, v in metrics.items()}

