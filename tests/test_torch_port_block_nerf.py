"""The port's Block-NeRF against the JAX package's, on the CPU.

The JAX blocks are made by ``block_nerf.create`` at D=6 (so that the skip at
layer 4 fires), W=32, visibility width 16, appearance width 8, four
appearance ids and the default frequencies (10, 4, 4), and carried across
by ``convert.block_nerf_tree_from_object`` / ``block_nerf_from_numpy``
(JAX weights are [in, out], ``nn.Linear``'s [out, in]). Rays come from
numpy with a seed. Renders take 8 coarse and 16 fine samples.

Tolerances: every output's max |port - JAX| within 1e-5 of the output's
max |JAX| (``close``): the same float32 formulas, summed in another order,
agree to a few 1e-7 here. Gradients of the loss with respect to every
parameter the same way. One Adam step from the same parameters with the
same stratified jitter (the port's ``render_rays`` takes the uniform draws
as ``jitter``; the test draws them as JAX's ``render_rays`` does from its
key): every parameter within 1e-6 absolute of optax's; the learning rate
after 0 and 1000 updates equal to ``optax.exponential_decay``'s within
float32 rounding. ``compose_view`` on three blocks (one whose visibility
head is pushed under the gate): the same blocks dropped and the composed
``uint8`` frame equal to the bit.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from unboundednerfpytorch_tpu.models import block_nerf as JB
from unboundednerfpytorch_tpu.models.block_nerf import compose as jcompose
from unboundednerfpytorch_tpu.models.block_nerf import training as jtraining
from unboundednerfpytorch_tpu_torch import convert
from unboundednerfpytorch_tpu_torch.models import block_nerf as TB
from unboundednerfpytorch_tpu_torch.models.block_nerf import compose, training
from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt

DIMS = dict(D=6, W=32, vis_width=16, appearance_dim=8)
N_APP = 4
RENDER = dict(n_samples=8, n_importance=16)
RTOL = 1e-5
N_RAYS = 48


def close(name, got, ref, rtol=RTOL):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= rtol * float(np.abs(ref).max()), f"{name}: {err} vs max {np.abs(ref).max()}"


def make_rays(rng, n=N_RAYS, near=0.05, far=6.0):
    o = rng.uniform(-1, 1, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d, rng.uniform(1e-3, 1e-2, (n, 1)), rng.uniform(0.5, 1.5, (n, 1)),
                           np.full((n, 1), near), np.full((n, 1), far)], -1).astype(np.float32)


def jax_block(seed: int):
    return JB.create(jax.random.PRNGKey(seed), n_appearance=N_APP, **DIMS)


def port_block(jp):
    return convert.block_nerf_from_numpy(
        convert.block_nerf_tree_from_object(jax.tree.map(np.asarray, jp)))


@pytest.fixture(scope="module")
def block():
    rng = np.random.default_rng(0)
    jp = jax_block(0)
    return jp, port_block(jp), make_rays(rng), rng.integers(0, N_APP, N_RAYS).astype(np.int32)


def test_the_embeddings_keep_the_jax_order():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 7, 3)).astype(np.float32)
    cov = rng.uniform(0, 0.05, (5, 7, 3)).astype(np.float32)
    for n in (1, 4, 10):
        close(f"pos_embedding {n}", TB.pos_embedding(torch.tensor(x), n),
              JB.pos_embedding(jnp.asarray(x), n))
        close(f"inter_pos_embedding {n}",
              TB.inter_pos_embedding(torch.tensor(x), torch.tensor(cov), n),
              JB.inter_pos_embedding(jnp.asarray(x), jnp.asarray(cov), n))


def test_cone_pdf_and_compositing_equal_jax(block):
    _, _, rays, _ = block
    rng = np.random.default_rng(2)
    z = np.sort(rng.uniform(0.05, 6.0, (N_RAYS, 9)), -1).astype(np.float32)
    t = lambda a: torch.tensor(a)
    got = TB.get_cone_mean_conv(t(z), t(rays[:, :3]), t(rays[:, 3:6]), t(rays[:, 6]))
    ref = JB.get_cone_mean_conv(jnp.asarray(z), jnp.asarray(rays[:, :3]),
                                jnp.asarray(rays[:, 3:6]), jnp.asarray(rays[:, 6]))
    for name, g, r in zip(("mean_t", "mean", "diag_cov"), got, ref):
        close(name, g, r)
    # weights with zeros, a spike and ties: the bisection and the alpha floor
    w = rng.uniform(0, 1, (N_RAYS, 6)).astype(np.float32)
    w[::3] = 0.0
    w[1::3, 2] = 50.0
    bins = z[:, 1:-1]
    close("sample_pdf", TB.sample_pdf(t(bins), t(w), 16),
          JB.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 16))
    sig = rng.normal(0, 3, (N_RAYS, 8)).astype(np.float32)
    rgb = rng.uniform(0, 1, (N_RAYS, 8, 3)).astype(np.float32)
    mean_t = 0.5 * (z[:, 1:] + z[:, :-1])
    got = TB.volume_rendering(t(rgb), t(sig), t(z), t(mean_t))
    ref = JB.volume_rendering(*(jnp.asarray(a) for a in (rgb, sig, z, mean_t)))
    assert set(got) == set(ref)
    for k in ref:
        close(k, got[k], ref[k])


@pytest.mark.parametrize("use_disp", [False, True])
def test_render_rays_without_jitter_equals_jax(block, use_disp):
    jp, model, rays, ts = block
    ref = jax.jit(lambda p, r, t: JB.render_rays(p, r, t, key=None, use_disp=use_disp,
                                                 **RENDER))(jp, jnp.asarray(rays), jnp.asarray(ts))
    with torch.no_grad():
        got = TB.render_rays(model, torch.tensor(rays), torch.tensor(ts), use_disp=use_disp,
                             **RENDER)
    assert set(got) == set(ref)
    assert got["transmittance_fine_real"].shape == (N_RAYS, 8 + 16 + 1)
    for k in ref:
        close(k, got[k], ref[k])


def jax_loss(params, rays, ts, rgbs):
    res = JB.render_rays(params, rays, ts, key=None, use_disp=True, **RENDER)
    losses = JB.block_nerf_loss(res, rgbs)
    return sum(losses.values()), losses


def port_grads(model: TB.BlockNeRF) -> dict:
    tree = {}
    for name in convert.BLOCK_NERF_MLPS:
        mod = getattr(model, name)
        layers = mod if name == "xyz_layers" else mod.layers
        tree[name] = {"weights": [lin.weight.grad.numpy().T for lin in layers],
                      "biases": [lin.bias.grad.numpy() for lin in layers]}
    tree["appearance"] = model.appearance.grad.numpy()
    return tree


def leaves(tree: dict):
    for name in convert.BLOCK_NERF_MLPS:
        for kind in ("weights", "biases"):
            for i, a in enumerate(tree[name][kind]):
                yield f"{name}.{kind}[{i}]", a
    yield "appearance", tree["appearance"]


def test_the_loss_and_its_gradients_equal_jax(block):
    jp, _, rays, ts = block
    model = port_block(jp)
    rgbs = np.random.default_rng(3).uniform(0, 1, (N_RAYS, 3)).astype(np.float32)
    (_, ref_losses), ref_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jp, jnp.asarray(rays), jnp.asarray(ts), jnp.asarray(rgbs))
    res = TB.render_rays(model, torch.tensor(rays), torch.tensor(ts), use_disp=True, **RENDER)
    losses = TB.block_nerf_loss(res, torch.tensor(rgbs))
    assert set(losses) == set(ref_losses)
    for k in ref_losses:
        close(k, losses[k], ref_losses[k])
    sum(losses.values()).backward()
    ref_tree = convert.block_nerf_tree_from_object(jax.tree.map(np.asarray, ref_grads))
    for (name, got), (_, ref) in zip(leaves(port_grads(model)), leaves(ref_tree)):
        close(f"grad {name}", got, ref)


def test_one_adam_step_with_the_same_jitter_equals_optax(block):
    jp, _, rays, ts = block
    model = port_block(jp)
    before_tree = convert.block_nerf_tree_from_object(jax.tree.map(np.array, jp))
    jp = jax.tree.map(jnp.array, jp)  # the JAX step donates what it is given
    rgbs = np.random.default_rng(4).uniform(0, 1, (N_RAYS, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    # the draws of the JAX render_rays: split off one key, uniform over [N, S + 1]
    jitter = np.asarray(jax.random.uniform(jax.random.split(key)[1], (N_RAYS, 9)))
    tx = jtraining.make_optimizer()
    state = jtraining.BlockTrainState(params=jp, opt_state=tx.init(jp),
                                      step=jnp.zeros((), jnp.int32))
    step = jtraining.make_train_step(**RENDER)
    state, ref_metrics = step(state, {"rays": jnp.asarray(rays), "ts": jnp.asarray(ts),
                                      "rgbs": jnp.asarray(rgbs)}, key)
    opt, sched = training.make_optimizer(model)
    got_metrics = training.train_step(
        model, opt, sched, {"rays": torch.tensor(rays), "ts": torch.tensor(ts),
                            "rgbs": torch.tensor(rgbs)}, jitter=torch.tensor(jitter), **RENDER)
    close("psnr", got_metrics["psnr"], ref_metrics["psnr"])
    ref_tree = convert.block_nerf_tree_from_object(jax.tree.map(np.asarray, state.params))
    got_tree = convert.block_nerf_to_numpy(model)
    moved = 0.0
    for (name, got), (_, ref), (_, before) in zip(leaves(got_tree), leaves(ref_tree),
                                                  leaves(before_tree)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=name)
        moved = max(moved, float(np.abs(ref - before).max()))
    assert moved > 1e-4  # the step moved the parameters by about the learning rate
    schedule = optax.exponential_decay(5e-4, 250_000, 0.1)
    opt, sched = training.make_optimizer(model)
    for count in range(1001):
        if count in (0, 1000):
            np.testing.assert_allclose(opt.param_groups[0]["lr"], float(schedule(count)),
                                       rtol=2e-7, err_msg=f"lr at count {count}")
        sched.step()


def test_compose_view_gates_and_blends_as_jax():
    rng = np.random.default_rng(5)
    H, W = 6, 8
    jps = {f"block_{b}": jax_block(10 + b) for b in range(3)}
    # the third block's visibility head pushed under the gate
    vh = jps["block_2"].vis_head
    jps["block_2"] = jps["block_2"].replace(vis_head=vh.replace(
        biases=(vh.biases[0] - 30.0,)))
    models = {b: port_block(p) for b, p in jps.items()}
    c2w = np.eye(4)[:3]
    c2w[:, 3] = [0.1, -0.2, 0.3]
    info = {"c2w": c2w.tolist(), "intrinsics": [8.0, 8.0], "W": W, "H": H,
            "equivalent_exposure": 1.1}
    from unboundednerfpytorch_tpu_torch.models.block_nerf import dataset

    rays, _, ts, _ = dataset.build_image_rays(info, None, 1, img_downscale=1, near=0.05,
                                              far=6.0)
    centroids = {b: rng.uniform(-2, 2, 3).tolist() for b in jps}
    ref_rgb, ref_depth = jcompose.compose_view(jps, list(jps), centroids, jnp.asarray(rays),
                                               jnp.asarray(ts), H, W, chunk=20, **RENDER)
    got_rgb, got_depth = compose.compose_view(models, list(models), centroids, rays, ts, H, W,
                                              chunk=20, **RENDER)
    assert list(got_rgb) == list(ref_rgb) == ["block_0", "block_1", "compose"]
    for k in ref_rgb:
        np.testing.assert_array_equal(got_rgb[k], ref_rgb[k], err_msg=k)
        np.testing.assert_array_equal(got_depth[k], ref_depth[k], err_msg=k)
    assert compose.filter_blocks("a", {"b0": {"elements": [["a", 0]]},
                                       "b1": {"elements": [["c", 0]]}}) == ["b0"]


def test_a_jax_msgpack_block_carries_over_and_the_port_checkpoint_round_trips(tmp_path):
    from flax import serialization

    jp = jax_block(3)
    template = jax_block(4)
    restored = serialization.from_bytes(template, serialization.to_bytes(
        jax.tree.map(np.asarray, jp)))
    tree = convert.block_nerf_tree_from_object(restored)
    model = convert.block_nerf_from_numpy(tree)
    assert model.dims == {"n_appearance": N_APP, "D": 6, "W": 32, "skips": [4], "xyz_freqs": 10,
                          "dir_freqs": 4, "exposure_freqs": 4, "appearance_dim": 8,
                          "vis_width": 16}
    ckpt.save_block_nerf(str(tmp_path / "block_0"), model, {"block": "block_0", "steps": 1})
    loaded, meta = ckpt.load_block_nerf(str(tmp_path / "block_0"))
    assert meta["block"] == "block_0" and meta["model_kwargs"] == model.dims
    for (name, got), (_, ref) in zip(leaves(convert.block_nerf_to_numpy(loaded)), leaves(tree)):
        np.testing.assert_array_equal(got, ref, err_msg=name)
    assert json.load(open(tmp_path / "block_0" / "meta.json"))["steps"] == 1
    assert sorted(os.listdir(tmp_path / "block_0")) == ["meta.json", "params.npz"]
