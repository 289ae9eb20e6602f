"""The port's TensoRF grid (``nerf/ship.tensorf.py``) against the JAX
package on the CPU.

Small grids: 7 x 6 x 5 and a DVGO box of about 16^3 voxels, n_comp 3 (the
density) and 4 (k0's 6 channels), JAX leaves drawn by its own ``create`` and
carried into the port by ``convert``.

Tolerances: ``grid_sample_2d`` on planes and lines, the scalar query, the
resize and the smooth-L1 TV gradient are equal to the bit (the same
operations in the same order); the multi-channel query and the dense grid to
1e-6 of the largest value (a matmul and an einsum sum their 3R products in
another order); the DVGO forward with TensoRF fields as the dense forward is
held (``test_torch_port_dvgo.py``): 1e-5 absolute; a train step with the TV
on: the loss to 1e-4 relative and every leaf after Adam's step to 2e-5
absolute and 1e-4 relative, but for at most 0.1% of the elements (a
gradient 0 on one side only, or under Adam's eps), each within one step.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unboundednerfpytorch_tpu.configs.schema import ExpConfig as JExpConfig
from unboundednerfpytorch_tpu.configs.schema import ModelRenderConfig as JModelRenderConfig
from unboundednerfpytorch_tpu.configs.schema import TrainStageConfig as JTrainStageConfig
from unboundednerfpytorch_tpu.fields.grids import TensoRFGrid as JTensoRFGrid
from unboundednerfpytorch_tpu.models import dvgo as jdvgo
from unboundednerfpytorch_tpu.ops import interp as jinterp
from unboundednerfpytorch_tpu.train import loop as jloop
from unboundednerfpytorch_tpu.train import step as jstep
from unboundednerfpytorch_tpu_torch import convert
from unboundednerfpytorch_tpu_torch.cli import main as cli
from unboundednerfpytorch_tpu_torch.configs.schema import ModelRenderConfig, TrainStageConfig
from unboundednerfpytorch_tpu_torch.data import synthetic
from unboundednerfpytorch_tpu_torch.fields.grids import TENSORF_LEAVES, TensoRFGrid
from unboundednerfpytorch_tpu_torch.models import dvgo
from unboundednerfpytorch_tpu_torch.ops import interp
from unboundednerfpytorch_tpu_torch.ops.tv import tensorf_tv_grads
from unboundednerfpytorch_tpu_torch.train import loop
from unboundednerfpytorch_tpu_torch.train import step as tstep
from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt
from torch_threads import torch_threads  # noqa: F401: the workers' share of the cores

ROOT = pathlib.Path(__file__).resolve().parents[1]
LO, HI = (-1.0, -1.2, -0.8), (1.0, 0.9, 1.1)
XYZ_MIN, XYZ_MAX = (-1.0, -1.2, -0.8), (1.1, 1.0, 1.2)
NEAR, STEPSIZE = 0.2, 0.5
MODEL_KW = dict(num_voxels_density=16**3, num_voxels_rgb=16**3, num_voxels_base_density=16**3,
                num_voxels_base_rgb=16**3, rgbnet_dim=6, rgbnet_width=16, rgbnet_depth=2,
                alpha_init=1e-2, fast_color_thres=1e-4, maskout_near_cam_vox=False,
                density_type="TensoRFGrid", k0_type="TensoRFGrid",
                density_config=(("n_comp", 3),), k0_config=(("n_comp", 4),))
TRAIN_KW = dict(N_rand=48, lrate_density=0.02, lrate_k0=0.02, lrate_rgbnet=1e-3,
                lrate_decay=20, weight_main=1.0, weight_entropy_last=0.01, weight_rgbper=0.1,
                pg_scale=(), tv_before=100, tv_dense_before=100, weight_tv_density=1e-2,
                weight_tv_k0=1e-3, skip_zero_grad_fields=("density", "k0"))


def t_(a):
    return torch.from_numpy(np.asarray(a))


def grid_pair(channels, R, seed=1, ws=(7, 6, 5)):
    jg = JTensoRFGrid.create(channels, ws, LO, HI, n_comp=R, key=jax.random.PRNGKey(seed))
    leaves = {k: np.asarray(getattr(jg, k)) for k in TENSORF_LEAVES
              if getattr(jg, k) is not None}
    return jg, TensoRFGrid(channels, ws, LO, HI, n_comp=R, leaves=leaves)


def points(n=300, seed=0):
    return np.random.default_rng(seed).uniform(-1.3, 1.3, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("shape", [(7, 6, 5), (9, 1, 3), (1, 1, 2)])
def test_grid_sample_2d_matches_jax_on_planes_and_lines(shape):
    """Bilinear, align-corners, zero padding, coordinates in and out of
    [0, 1]; a width of 1 is a line (its two outer corners dropped)."""
    rng = np.random.default_rng(3)
    plane = rng.standard_normal(shape).astype(np.float32)
    xy = rng.uniform(-0.2, 1.2, (40, 3, 2)).astype(np.float32)
    if shape[1] == 1:
        xy[..., 1] = 0.0
    want = np.asarray(jinterp.grid_sample_2d(jnp.asarray(plane), jnp.asarray(xy)))
    got = interp.grid_sample_2d(t_(plane), t_(xy)).numpy()
    np.testing.assert_array_equal(got, want)
    idx, w = interp.bilerp_corners(t_(xy), shape[:2])
    assert idx.shape[-1] == (2 if shape[1] == 1 else 4)


@pytest.mark.parametrize("channels,R", [(1, 3), (6, 4)])
def test_query_and_dense_grid_match_jax(channels, R):
    jg, tg = grid_pair(channels, R)
    pts = points()
    want = np.asarray(jg(jnp.asarray(pts)))
    got = tg(t_(pts)).detach().numpy()
    scale = np.abs(want).max()
    assert got.shape == want.shape == (300, channels) and scale > 0
    if channels == 1:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
    want = np.asarray(jg.get_dense_grid())
    got = tg.get_dense_grid().detach().numpy()
    assert got.shape == (7, 6, 5, channels)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("channels", [1, 6])
def test_scale_volume_grid_and_tv_match_jax(channels):
    jg, tg = grid_pair(channels, 3, seed=2)
    jg2 = jg.scale_volume_grid((9, 8, 11))
    tg.scale_volume_grid((9, 8, 11))
    assert tg.world_size == jg2.world_size == (9, 8, 11)
    for k, p in tg.leaves().items():
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(getattr(jg2, k)), k)
        assert p.requires_grad
    want = jax.grad(jstep._tensorf_tv_loss)(jg2, 0.3, 0.5, 0.7)
    got = tensorf_tv_grads(tg.leaves(), 0.3, 0.5, 0.7)
    assert set(got) == {k for k in TENSORF_LEAVES if k != "f_vec"}
    for k, g in got.items():
        w = np.asarray(getattr(want, k))
        assert np.abs(w).max() > 0
        np.testing.assert_array_equal(g.numpy(), w, k)


def make_pair(seed=0, **overrides):
    """(JAX config, JAX params, port config, port params) of a DVGO model
    with TensoRF fields, the JAX leaves from its ``build_model``."""
    kw = {**MODEL_KW, **overrides}
    fam, jcfg, jp = jloop.build_model(JExpConfig(), JModelRenderConfig(**kw),
                                      JTrainStageConfig(pg_scale=()), np.array(XYZ_MIN),
                                      np.array(XYZ_MAX), jax.random.PRNGKey(seed))
    assert fam == "dvgo" and isinstance(jp.k0, JTensoRFGrid)
    tcfg = dvgo.config_from(ModelRenderConfig(**kw), XYZ_MIN, XYZ_MAX, kw["num_voxels_rgb"])
    tp = convert.params_from_numpy("dvgo", convert.tree_from_params_object(jp), "cpu")
    return jcfg, jp, tcfg, tp


def make_rays(n=48, seed=1):
    rng = np.random.default_rng(seed)
    center = (np.asarray(XYZ_MIN) + np.asarray(XYZ_MAX)) / 2
    o = center + rng.standard_normal((n, 3)) * 2.5
    d = (center + rng.standard_normal((n, 3)) * 0.4 - o) * rng.uniform(0.3, 3.0, (n, 1))
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return [a.astype(np.float32) for a in (o, d, vd)]


def test_dvgo_with_tensorf_fields_builds_and_forwards_as_jax():
    jcfg, jp, tcfg, tp = make_pair(seed=3)
    assert isinstance(tp.density, TensoRFGrid) and tp.density.f_vec is None
    assert tp.k0.f_vec.shape == (4 + 4 + 4, 6) and tp.k0.world_size == jcfg.world_size
    fresh = dvgo.create(tcfg, torch.Generator().manual_seed(0))
    assert [tuple(p.shape) for p in fresh.k0.parameters()] == [
        tuple(p.shape) for p in tp.k0.parameters()]
    assert dvgo.build_render_cache(tp, tcfg) is None  # as JAX: DenseGrid only
    o, d, vd = make_rays(seed=4)
    want = jdvgo.forward(jp, jcfg, jnp.asarray(o), jnp.asarray(d), jnp.asarray(vd),
                         near=NEAR, stepsize=STEPSIZE, bg=1.0)
    got = dvgo.forward(tp, tcfg, t_(o), t_(d), t_(vd), near=NEAR, stepsize=STEPSIZE, bg=1.0)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert 0 < int(got.mask.sum())
    for field in ("rgb_marched", "alphainv_last", "weights", "raw_alpha", "raw_rgb",
                  "raw_density"):
        np.testing.assert_allclose(getattr(got, field).detach().numpy(),
                                   np.asarray(getattr(want, field)), rtol=0, atol=1e-5,
                                   err_msg=field)


def test_a_train_step_with_tensorf_fields_and_tv_matches_jax():
    jcfg, jp, tcfg, tp = make_pair(seed=5)
    o, d, vd = make_rays(TRAIN_KW["N_rand"], seed=6)
    batch = dict(rays_o=o, rays_d=d, viewdirs=vd,
                 rgb=np.random.default_rng(7).random((o.shape[0], 3)).astype(np.float32))
    jtrain, ttrain = JTrainStageConfig(**TRAIN_KW), TrainStageConfig(**TRAIN_KW)
    jfwd = lambda p, ro, rd, vd_, key, img_index=None: jdvgo.forward(
        p, jcfg, ro, rd, vd_, near=NEAR, stepsize=STEPSIZE, bg=1.0)
    tfwd = loop.make_forward(tcfg, {"near": NEAR, "bg": 1.0, "stepsize": STEPSIZE})
    ws_max = float(max(jcfg.world_size))
    j_state = jstep.create_train_state(jp, jtrain)
    # eager, as the forward test runs it: under jit XLA rounds the forward
    # otherwise, and a sample at fast_color_thres may flip
    j_state, j_m = jstep.make_train_step(jfwd, jtrain, world_size_max=ws_max)(
        j_state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    t_state = tstep.create_train_state(tp, ttrain)
    t_m = tstep.make_train_step(tfwd, ttrain, world_size_max=ws_max)(
        t_state, {k: t_(v) for k, v in batch.items()}, None)
    for name in ("loss", "mse", "psnr"):
        assert float(t_m[name]) == pytest.approx(float(j_m[name]), rel=1e-4, abs=1e-6), name
    lr = TRAIN_KW["lrate_density"]
    for field in ("density", "k0"):
        for k, p in getattr(t_state.params, field).leaves().items():
            got, want = p.detach().numpy(), np.asarray(getattr(getattr(j_state.params, field), k))
            start = np.asarray(getattr(getattr(jp, field), k))
            assert np.abs(want - start).max() > 0, (field, k)
            off = np.abs(got - want) > 2e-5 + 1e-4 * np.abs(want)
            assert off.mean() <= 1e-3, (field, k, int(off.sum()))
            assert (np.abs(got - want)[off] <= 1.1 * lr).all()


def test_boundary_and_occupancy_refresh_match_jax():
    """A pg_scale boundary: the planes and vectors resampled, the cache
    refreshed from ``get_dense_grid``'s density."""
    jcfg, jp, tcfg, tp = make_pair(seed=8)
    n = 2 * MODEL_KW["num_voxels_rgb"]
    jp2, jcfg2 = jdvgo.scale_volume_grid(jp, jcfg, n)
    tp2, tcfg2 = dvgo.scale_volume_grid(tp, tcfg, n, report={})
    assert tcfg2.world_size == jcfg2.world_size == tp2.density.world_size
    for field in ("density", "k0"):
        for k, p in getattr(tp2, field).leaves().items():
            np.testing.assert_array_equal(p.detach().numpy(),
                                          np.asarray(getattr(getattr(jp2, field), k)))
    np.testing.assert_array_equal(tp2.mask_cache.mask.numpy(), np.asarray(jp2.mask_cache.mask))


def test_checkpoint_and_convert_round_trip_tensorf_leaves(tmp_path):
    jcfg, jp, tcfg, tp = make_pair(seed=9)
    tree = convert.tree_from_params_object(jp)
    jtrain, ttrain = JTrainStageConfig(**TRAIN_KW), TrainStageConfig(**TRAIN_KW)
    j_state = jstep.create_train_state(jp, jtrain)
    j_opt = convert.opt_state_tree_from_object(j_state.opt_state._replace(
        step=jnp.asarray(3, jnp.int32),
        exp_avg=jax.tree.map(lambda x: x + 0.25, j_state.opt_state.exp_avg)))
    assert sorted(j_opt["exp_avg"]["k0"]) == sorted(TENSORF_LEAVES)
    t_state = tstep.create_train_state(tp, ttrain, start_step=3,
                                       opt_state=convert.opt_state_from_numpy(j_opt, "dvgo"))
    path = str(tmp_path / "fine_last")
    ckpt.save_model(path, "dvgo", tcfg, tp, global_step=3,
                    opt_state=t_state.optimizer.state_dict())
    fam, cfg2, tp2, step, opt = ckpt.load_model(path)
    assert (fam, cfg2, step) == ("dvgo", tcfg, 3) and isinstance(tp2.k0, TensoRFGrid)
    back = convert.params_to_numpy(tp2)
    for field in ("density", "k0"):
        for k in TENSORF_LEAVES:
            if k in tree[field]:
                np.testing.assert_array_equal(back[field][k], tree[field][k])
    assert "f_vec" not in back["density"] and back["k0"]["channels"] == 6
    opt_back = convert.opt_state_to_numpy(
        {k: v if k == "step" else {n: [t_(a) for a in ms] for n, ms in v.items()}
         for k, v in opt.items()}, "dvgo")
    flat_g, flat_w = ckpt._flatten(opt_back), ckpt._flatten(j_opt)
    assert sorted(flat_g) == sorted(flat_w)
    for k in flat_w:
        np.testing.assert_array_equal(flat_g[k], flat_w[k], err_msg=k)


def test_ship_tensorf_trains_renders_and_exports_through_the_command_line(tmp_path, capsys):
    """nerf/ship.tensorf.py at a small size on a NeRF-synthetic capture:
    a DenseGrid coarse stage, the TensoRF fine stage across a boundary, the
    uncached render of the test views, and export_coarse."""
    data = synthetic.orbit_scene(8, 24, 24, seed=5, n_test=2, cam_radius=4.0,
                                 focal_scale=1.39, alpha=True)
    scene = synthetic.write_blender_scene(str(tmp_path / "ship"), data)
    cfg = tmp_path / "ship.py"
    cfg.write_text(
        f"_base_ = {str(ROOT / 'configs' / 'nerf' / 'ship.tensorf.py')!r}\n"
        f"basedir = {str(tmp_path / 'logs')!r}\ndata = dict(datadir={scene!r})\n"
        "coarse_train = dict(N_iters=3, N_rand=128)\n"
        "fine_train = dict(N_iters=4, N_rand=128, pg_scale=[2])\n"
        "coarse_model_and_render = dict(num_voxels=12**3, num_voxels_base=12**3)\n"
        "fine_model_and_render = dict(num_voxels=16**3, num_voxels_base=16**3)\n")
    cli.main(["--config", str(cfg), "--i_print", "1"], device="cpu")
    out = capsys.readouterr().out
    exp = tmp_path / "logs" / "dvgo_ship_tensorf"
    meta = json.load(open(exp / "fine_last" / "meta.json"))
    assert meta["model_kwargs"]["k0_type"] == "TensoRFGrid" and meta["global_step"] == 4
    assert "render cache: none" in out
    psnr = [float(line.split()[-1]) for line in out.splitlines() if line.startswith("test: psnr")]
    assert len(psnr) == 1 and np.isfinite(psnr[0])
    _, mcfg, params, _, _ = ckpt.load_model(str(exp / "fine_last"))
    assert isinstance(params.k0, TensoRFGrid) and params.k0.world_size == mcfg.world_size
    assert dataclasses.asdict(mcfg)["density_config"] == (("n_comp", 8),)
    cli.main(["--config", str(cfg), "--program", "export_coarse"], device="cpu")
    with np.load(exp / "coarse_volume.npz") as vol:
        assert vol["alpha"].ndim == 3 and np.isfinite(vol["alpha"]).all()
