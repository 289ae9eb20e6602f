"""The port's train step and trainer against the JAX package, and the
port's rules: no JAX import, no silent fall back to the CPU.

Three full train steps (forward, all five losses, backward, dense TV
injection, masked Adam with ``skip_zero_grad``, lr decay, ``rand_bkgd``)
run from identical parameters on identical batches in both packages; the
JAX side is ``make_train_step`` with its XLA TV expression, the port's is
the plain TV version (the CPU wrapper of the CUDA kernel). The random
backgrounds are the JAX draws, handed to the port.

Tolerance after three steps: 1e-4 relative / 2e-5 absolute on every
parameter. Adam divides by sqrt(v), so a gradient that differs in its last
bits moves a voxel by a few ulps of lr, not of the gradient.
"""

import ast
import dataclasses
import math
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unboundednerfpytorch_tpu.configs.schema import TrainStageConfig as JTrainStageConfig
from unboundednerfpytorch_tpu.models import fourier_grid as jfg
from unboundednerfpytorch_tpu.train import step as jstep
from unboundednerfpytorch_tpu_torch import resolve_device
from unboundednerfpytorch_tpu_torch.configs import loader
from unboundednerfpytorch_tpu_torch.configs.schema import TrainStageConfig
from unboundednerfpytorch_tpu_torch.data import synthetic
from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
from unboundednerfpytorch_tpu_torch.ops.cuda import build
from unboundednerfpytorch_tpu_torch.train import loop
from unboundednerfpytorch_tpu_torch.train import step as tstep
from test_torch_port_model import make_pair, make_rays

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRAIN_KW = dict(
    N_rand=48, lrate_density=0.1, lrate_k0=0.1, lrate_rgbnet=1e-3, lrate_decay=20,
    weight_main=1.0, weight_entropy_last=0.01, weight_nearclip=1.0, weight_distortion=0.01,
    weight_rgbper=0.1, tv_before=1000, tv_dense_before=1000, weight_tv_density=1e-2,
    weight_tv_k0=1e-3, skip_zero_grad_fields=("density", "k0"), pg_scale=())


def test_three_train_steps_match_jax():
    jcfg, jp, tcfg, tp = make_pair(seed=7)
    near_thres = 0.3
    ws_max = float(max(jcfg.world_size))
    jtrain = JTrainStageConfig(**TRAIN_KW)
    ttrain = TrainStageConfig(**TRAIN_KW)

    def jfwd(params, ro, rd, vd, key, img_index=None):
        return jfg.forward(params, jcfg, ro, rd, vd, rand_bkgd_key=key)

    j_step = jax.jit(jstep.make_train_step(jfwd, jtrain, world_size_max=ws_max,
                                           near_thres=near_thres, lr_anchor=1))
    j_state = jstep.create_train_state(jp, jtrain)
    t_step = tstep.make_train_step(
        lambda p, ro, rd, vd, bg: fg.forward(p, tcfg, ro, rd, vd, bg_color=bg), ttrain,
        world_size_max=float(max(tcfg.world_size)), near_thres=near_thres, lr_anchor=1)
    t_state = tstep.create_train_state(tp, ttrain)

    rng = np.random.default_rng(11)
    for s in range(3):
        o, d, vd = make_rays(n=TRAIN_KW["N_rand"], seed=20 + s)
        rgb = rng.random((o.shape[0], 3)).astype(np.float32)
        key = jax.random.PRNGKey(100 + s)
        batch = dict(rays_o=o, rays_d=d, viewdirs=vd, rgb=rgb)
        j_state, j_m = j_step(j_state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        bg = torch.from_numpy(np.array(jax.random.uniform(key, (o.shape[0], 3))))
        t_m = t_step(t_state, {k: torch.from_numpy(v) for k, v in batch.items()}, bg)
        for name in ("loss", "mse", "psnr", "loss_entropy", "loss_nearclip", "loss_distortion",
                     "loss_rgbper", "lr_scale"):
            assert float(t_m[name]) == pytest.approx(float(j_m[name]), rel=1e-4, abs=1e-6), name
    assert float(j_m["loss_rgbper"]) > 0 and float(j_m["loss_distortion"]) > 0

    jparams = j_state.params
    pairs = [(t_state.params.density.grid, jparams.density.grid),
             (t_state.params.k0.grid, jparams.k0.grid)]
    pairs += [(lin.weight.T, w) for lin, w in zip(t_state.params.rgbnet.layers,
                                                   jparams.rgbnet.weights)]
    pairs += [(lin.bias, b) for lin, b in zip(t_state.params.rgbnet.layers, jparams.rgbnet.biases)]
    for got, want in pairs:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=2e-5)
    # dense TV moved every voxel of both grids, hit or not
    assert not np.any(np.asarray(jparams.k0.grid) == np.asarray(jp.k0.grid))
    assert t_state.step == 3 == int(j_state.step)


def _tiny_bicycle(n_iters=6):
    """configs/nerf_unbounded/bicycle_single.py, cut to 24^3 voxels and a
    16-sample budget, its fine stage run from the final grid (pg_scale=())."""
    cfg = loader.load_config(str(ROOT / "configs" / "nerf_unbounded" / "bicycle_single.py"))
    vox = 24**3
    fm = dataclasses.replace(cfg.fine_model_and_render, num_voxels_density=vox,
                             num_voxels_rgb=vox, num_voxels_base_density=vox,
                             num_voxels_base_rgb=vox, sample_budget=16)
    ft = dataclasses.replace(cfg.fine_train, pg_scale=(), N_iters=n_iters, N_rand=256)
    return dataclasses.replace(cfg, fine_model_and_render=fm, fine_train=ft)


def test_run_train_on_cpu():
    cfg = _tiny_bicycle()
    data = synthetic.orbit_scene(4, 16, 24, seed=0)
    xyz_min, xyz_max = loop.bbox_mod.compute_bbox_by_cam_frustrm(cfg, data, "FourierGrid",
                                                                 device="cpu")
    seed_fn = synthetic.occupancy_seed((xyz_min + xyz_max) / 2, (xyz_max - xyz_min) / 2)
    build.reset_launch_counts()
    seen = []
    family, mcfg, params, psnr = loop.run_train(
        cfg, data, seed=0, device="cpu", log_fn=lambda _: None,
        callback=lambda step, m: seen.append((step, float(m["loss"]))), coarse_mask_fn=seed_fn)
    assert family == "FourierGrid"
    assert [s for s, _ in seen] == list(range(1, 7))
    assert all(math.isfinite(v) for _, v in seen) and math.isfinite(psnr)
    assert params.k0.grid.dtype == torch.bfloat16 and params.k0.grid.shape[0] == 7
    assert mcfg.sample_budget == 16 and 2 * mcfg.n_inner > 16
    assert 0 < float(params.mask_cache.mask.float().mean()) < 1
    assert not build.LAUNCHES  # the CPU path runs the plain versions only


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.run_train(_tiny_bicycle(1), synthetic.orbit_scene(2, 8, 8))


def test_wrappers_never_send_a_device_tensor_to_the_plain_version():
    """Only a CPU tensor takes the plain path; any other device goes to the
    kernel's launcher, which refuses what is not on the GPU."""
    from unboundednerfpytorch_tpu_torch.ops.cuda import march, tv

    p = torch.zeros((1, 3, 3, 3, 1), device="meta")
    with pytest.raises(ValueError, match="GPU"):
        tv.tv_add_grad(p, p, 0.1, 0.1, 0.1, 1.0, True)
    d = torch.zeros((4, 5), device="meta")
    with pytest.raises(ValueError, match="GPU"):
        march.fused_alpha2weights(d, d.bool(), 0.0, 0.5)
    assert not build.LAUNCHES


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax():
    files = sorted((ROOT / "unboundednerfpytorch_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax", "unboundednerfpytorch_tpu"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad
