"""The port's ``pg_scale`` boundary against the JAX package, on the CPU.

Grid upsampling (``resize_grid_3d``), the occupancy refresh
(``max_pool_3d_same``, ``scale_volume_grid``, ``update_occupancy_cache``) and
the trainer's boundary block (``train.loop.pg_scale_boundary``: act_shift,
the deferred sample budget, the optimizer rebuilt, the lr re-anchored), each
on the same numpy-seeded inputs in both packages, at 3 banks and 12^3 -> 16^3
-> 20^3 voxels; then ``run_train`` through a tiny bicycle config with two
boundaries, saved, loaded and rendered.

Tolerances. The resize and the pool are the same f32 expressions in both
packages: 1e-6 of the grid's largest value. A bf16 grid: the JAX package's
resize returns float32 (its grid silently stops being bf16 at the first
boundary), the port rounds that result once to bf16 and keeps the configured
dtype, so the port's grid must equal the JAX values rounded to bf16. Masks
must be equal; the inputs are kept off ``fast_color_thres`` (the test checks
how far) so that no voxel's verdict hangs on a rounding. Steps across a
boundary: the tolerances of ``test_three_train_steps_match_jax``.
"""

import dataclasses
import os
import pathlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unboundednerfpytorch_tpu.configs.schema import ModelRenderConfig as JModelRenderConfig
from unboundednerfpytorch_tpu.configs.schema import TrainStageConfig as JTrainStageConfig
from unboundednerfpytorch_tpu.models import fourier_grid as jfg
from unboundednerfpytorch_tpu.ops import interp as jinterp
from unboundednerfpytorch_tpu.train import step as jstep
from unboundednerfpytorch_tpu_torch import convert, render
from unboundednerfpytorch_tpu_torch.configs import loader
from unboundednerfpytorch_tpu_torch.configs.schema import ModelRenderConfig, TrainStageConfig
from unboundednerfpytorch_tpu_torch.data import synthetic
from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
from unboundednerfpytorch_tpu_torch.ops import interp
from unboundednerfpytorch_tpu_torch.ops.cuda import build
from unboundednerfpytorch_tpu_torch.train import loop
from unboundednerfpytorch_tpu_torch.train import step as tstep
from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt
from test_torch_port_model import MODEL_KW, XYZ_MIN, XYZ_MAX, jax_params_to_numpy, make_rays
from test_torch_port_train import TRAIN_KW
from torch_threads import torch_threads  # noqa: F401: the workers' share of the cores

ROOT = pathlib.Path(__file__).resolve().parents[1]
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bf16_round(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", [(16, 16, 16), (12, 16, 12), (12, 12, 12), (1, 16, 5),
                                  (20, 9, 16)])
def test_resize_grid_3d_matches_jax(size, dtype):
    """Up, down, an untouched axis, no change at all, and a new axis of size
    1; and a source axis of size 1."""
    rng = np.random.default_rng(0)
    for shape in ((12, 12, 12, 3), (12, 1, 12, 2)):
        g = rng.standard_normal(shape).astype(np.float32) * 5.0
        jg = jnp.asarray(g, jnp.dtype(dtype))
        want = np.asarray(jinterp.resize_grid_3d(jg, size).astype(jnp.float32))
        tg = torch.from_numpy(np.array(jg.astype(jnp.float32))).to(TORCH_DTYPE[dtype])
        got = interp.resize_grid_3d(tg, size)
        assert got.dtype == torch.float32 and got.shape == want.shape == (*size, shape[-1])
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("x_old,x_new", [(16, 24), (8, 28), (24, 16), (16, 23)])
@pytest.mark.parametrize("ways", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slab_resize_joins_to_the_whole_resize(dtype, ways, x_old, x_new, monkeypatch):
    """``FourierGrid.scale_volume_grid`` of a grid cut into ``ways``
    x-slabs, each rank's field in turn in one process. Where ``ways``
    divides the new X, each slab is resized from the planes that
    ``halo.resize_source`` hands it (its own, and the neighbours' planes
    that ``halo.resize_plan`` says it reads, taken here from the whole grid:
    the exchange itself runs on gloo ranks in test_torch_port_parallel.py),
    stays cut, and the slabs joined equal the whole grid's resize to the bit
    (up, a fourfold up, down). Where it does not (16 -> 23), each rank joins
    the old slabs (``mesh._gather_x``) and holds the whole resize."""
    from unboundednerfpytorch_tpu_torch.fields.grids import FourierGrid, resize_banks
    from unboundednerfpytorch_tpu_torch.parallel import halo
    from unboundednerfpytorch_tpu_torch.parallel import mesh as mesh_mod

    rng = np.random.default_rng(x_old * 100 + x_new)
    whole = torch.tensor(rng.standard_normal((3, x_old, 5, 6, 2)), dtype=torch.float32)
    whole = whole.to(TORCH_DTYPE[dtype])
    size = (x_new, 7, 4)
    want = resize_banks(whole, size)
    xs = x_old // ways

    def source(slab, shard, n_new):
        _, _, a, b = halo.resize_plan(shard.count, shard.X, n_new)[shard.index]
        assert shard.index * xs - a <= xs and b - (shard.index + 1) * xs <= xs
        return whole[:, a:b], a

    monkeypatch.setattr(halo, "resize_source", source)
    monkeypatch.setattr(mesh_mod, "_gather_x", lambda slab, shard: whole.clone())
    got = []
    for k in range(ways):
        field = FourierGrid(2, (x_old, 5, 6), XYZ_MIN, XYZ_MAX, num_freqs=1,
                            grid=whole[:, k * xs:(k + 1) * xs].clone())
        field.shard = halo.GridShard(index=k, count=ways, X=x_old)
        field.scale_volume_grid(size)
        assert field.grid.dtype == whole.dtype and field.world_size == size
        if x_new % ways:
            assert field.shard is None and torch.equal(field.grid, want), k
        else:
            assert field.shard.X == x_new and field.grid.shape[1] == x_new // ways
            got.append(field.grid)
    if got:
        assert torch.equal(torch.cat(got, dim=1), want)
    assert torch.equal(want[0], interp.resize_grid_3d(whole[0], size).to(whole.dtype))


@pytest.mark.parametrize("window", [3, 5])
def test_max_pool_3d_same_matches_jax(window):
    vol = np.random.default_rng(1).standard_normal((9, 10, 11)).astype(np.float32)
    want = np.asarray(jinterp.max_pool_3d_same(jnp.asarray(vol), window))
    got = interp.max_pool_3d_same(torch.from_numpy(vol), window)
    np.testing.assert_array_equal(got.numpy(), want)
    # the border's window hangs over the edge, where -inf is padded
    assert got[0, 0, 0] == vol[:window // 2 + 1, :window // 2 + 1, :window // 2 + 1].max()


@pytest.mark.parametrize("stride,window", [(0, 3), (1, 3), (2, 3), (3, 5), (4, 7)])
def test_occupancy_dilation_window_matches_jax(stride, window):
    kw = {**MODEL_KW, "budget_probe_stride": stride}
    jcfg = jfg.config_from(JModelRenderConfig(**kw), XYZ_MIN, XYZ_MAX, 12**3, 12**3)
    tcfg = fg.config_from(ModelRenderConfig(**kw), XYZ_MIN, XYZ_MAX, 12**3, 12**3)
    assert fg._occupancy_dilation_window(tcfg) == jfg._occupancy_dilation_window(jcfg) == window


def make_state(dtype="float32", seed=0, vox=12**3, **overrides):
    """(JAX config, JAX params, port config, port params) at ``vox`` voxels:
    a density that leaves the refreshed mask neither full nor empty, and an
    occupancy cache with a third of its voxels already off."""
    kw = {**MODEL_KW, "grid_dtype": dtype, **overrides}
    jcfg = jfg.config_from(JModelRenderConfig(**kw), XYZ_MIN, XYZ_MAX, vox, vox)
    tcfg = fg.config_from(ModelRenderConfig(**kw), XYZ_MIN, XYZ_MAX, vox, vox)
    rng = np.random.default_rng(seed)
    jp = jfg.create(jcfg, jax.random.PRNGKey(seed))
    dgrid = rng.standard_normal(jp.density.grid.shape) * 6.0 - 7.0
    kgrid = rng.standard_normal(jp.k0.grid.shape) * 0.5
    mask = rng.random(jp.mask_cache.mask.shape) > 0.33
    jp = jp.replace(density=jp.density.replace(grid=jnp.asarray(dgrid, jp.density.grid.dtype)),
                    k0=jp.k0.replace(grid=jnp.asarray(kgrid, jp.k0.grid.dtype)),
                    mask_cache=jp.mask_cache.replace(mask=jnp.asarray(mask)))
    return jcfg, jp, tcfg, convert.fourier_grid_params_from_numpy(jax_params_to_numpy(jp), "cpu")


def _off_the_threshold(jp, jcfg, ws) -> float:
    """How far the nearest voxel's pooled alpha lies from ``fast_color_thres``,
    relative to it. Float32 alpha, 1 - exp(..), is a multiple of 2^-24, which
    near a threshold of 1e-4 is a grain of 6e-4 of it: so this is measured on
    the float64 alpha of the pooled float32 density (JAX values; alpha rises
    with density, so pooling commutes with it). One part in 10^5 of alpha is
    1e-5 absolute in density, ten float32 roundings of a density of 10."""
    axes = [jnp.linspace(mn, mx, n) for mn, mx, n in zip(jcfg.xyz_min, jcfg.xyz_max, ws)]
    density = jp.density(jnp.stack(jnp.meshgrid(*axes, indexing="ij"), -1))[..., 0]
    pooled = np.asarray(jinterp.max_pool_3d_same(
        density, window=jfg._occupancy_dilation_window(jcfg)), np.float64)
    softplus = np.logaddexp(0.0, pooled + float(jp.act_shift))
    alpha = -np.expm1(-softplus * jcfg.voxel_size_ratio_density)
    return float(np.abs(alpha - jcfg.fast_color_thres).min() / jcfg.fast_color_thres)


OFF_THRESHOLD = 1e-5


def _assert_grids_match(tp, jp, dtype):
    for name in ("density", "k0"):
        got = getattr(tp, name).grid
        want = np.asarray(getattr(jp, name).grid.astype(jnp.float32))
        assert got.dtype == TORCH_DTYPE[dtype] and tuple(got.shape) == want.shape
        if dtype == "bfloat16":  # the JAX result rounded once, as the port stores it
            want = _bf16_round(want)
        np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scale_volume_grid_matches_jax(dtype):
    """12^3 -> 16^3 -> 20^3: both grids, the config, and the mask (the old
    mask looked up at the new lattice AND the pooled alpha above the
    threshold). After the first boundary the JAX grids are float32 whatever
    the config says, so the second boundary starts in each package from its
    own grids: the port's from the bf16 it kept."""
    jcfg, jp, tcfg, tp = make_state(dtype)
    old_k0 = tp.k0.grid
    for vox in (16**3, 20**3):
        jp_old, jcfg_old = jp, jcfg
        jp, jcfg = jfg.scale_volume_grid(jp, jcfg, vox, vox)
        report = {}
        out, tcfg = fg.scale_volume_grid(tp, tcfg, vox, vox, report=report)
        assert out is tp and tp.k0.grid is not old_k0 and isinstance(tp.k0.grid, torch.nn.Parameter)
        pooled = report.pop("pooled_alpha")  # what the refresh held against the threshold
        assert pooled.shape == tcfg.world_size_density
        assert bool((tp.mask_cache.mask <= (pooled > tcfg.fast_color_thres)).all())
        assert set(report) == {"resize", "refresh", "carried"} and min(report.values()) > 0
        assert report["carried"] == pytest.approx(float(np.mean(
            _jax_old_mask_at(jp_old, jcfg_old, jcfg.world_size_density))))
        assert tcfg == tcfg.with_num_voxels(vox, vox) and tcfg.num_voxels_density == vox
        assert tuple(tp.density.grid.shape[1:4]) == tcfg.world_size_density == jcfg.world_size_density
        assert tuple(tp.k0.grid.shape[1:4]) == tcfg.world_size_rgb
        _assert_grids_match(tp, jp, dtype)
        if dtype == "bfloat16":
            assert jp.k0.grid.dtype == jnp.float32  # the finding: not the configured dtype
            # the JAX package's refresh, from the grids the port keeps
            jp = jp.replace(
                density=jp.density.replace(grid=jp.density.grid.astype(jnp.bfloat16)),
                k0=jp.k0.replace(grid=jp.k0.grid.astype(jnp.bfloat16)))
            jp = jp.replace(mask_cache=jp.mask_cache.replace(
                mask=_jax_old_mask_at(jp_old, jcfg_old, jcfg.world_size_density)
                & _jax_refresh_verdict(jp, jcfg)))
        assert _off_the_threshold(jp, jcfg, jcfg.world_size_density) > OFF_THRESHOLD
        got, want = tp.mask_cache.mask.numpy(), np.asarray(jp.mask_cache.mask)
        np.testing.assert_array_equal(got, want)
        assert 0.05 < got.mean() < 0.95 and got.shape == tcfg.world_size_density
        assert tp.mask_cache.xyz_min == tuple(jp.mask_cache.xyz_min)


def _jax_old_mask_at(jp_old, jcfg_old, ws):
    """The old occupancy cache looked up at the nodes of the new lattice."""
    axes = [jnp.linspace(mn, mx, n) for mn, mx, n in zip(jcfg_old.xyz_min, jcfg_old.xyz_max, ws)]
    return jp_old.mask_cache(jnp.stack(jnp.meshgrid(*axes, indexing="ij"), -1))


def _jax_refresh_verdict(jp, jcfg):
    alpha = jfg._dense_alpha_chunked(jp, jcfg, jcfg.world_size_density)
    pooled = jinterp.max_pool_3d_same(alpha, window=jfg._occupancy_dilation_window(jcfg))
    return pooled > jcfg.fast_color_thres


def test_dense_alpha_does_not_depend_on_the_slab():
    jcfg, jp, tcfg, tp = make_state()
    ws = tcfg.world_size_density
    want = np.asarray(jfg._dense_alpha_chunked(jp, jcfg, ws))
    whole = fg._dense_alpha_chunked(tp, tcfg, ws)
    slabs = fg._dense_alpha_chunked(tp, tcfg, ws, max_pts_per_slab=3 * ws[1] * ws[2] + 5)
    assert torch.equal(whole, slabs)
    # alpha is 1 - exp(..): its values are multiples of 2^-24, one step apart at most
    np.testing.assert_allclose(whole.numpy(), want, rtol=1e-5, atol=1.2e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride", [2, 3])
def test_update_occupancy_cache_matches_jax(dtype, stride):
    """Pool windows of 3 and 5 (``budget_probe_stride`` 2 and 3)."""
    jcfg, jp, tcfg, tp = make_state(dtype, seed=3, budget_probe_stride=stride)
    before = tp.mask_cache.mask.clone()
    want = np.asarray(jfg.update_occupancy_cache(jp, jcfg).mask_cache.mask)
    assert _off_the_threshold(jp, jcfg, jp.mask_cache.mask.shape) > OFF_THRESHOLD
    assert fg.update_occupancy_cache(tp, tcfg) is tp
    got = tp.mask_cache.mask
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool((got <= before).all()) and 0 < int(got.sum()) < int(before.sum())


def test_steps_across_a_boundary_match_jax():
    """Two steps at 12^3, the boundary at step 3 applied to both states, two
    more steps at 16^3, on identical batches: metrics (``lr_scale`` back at 1
    at the boundary), the budget deferred until the boundary, every
    parameter, the mask and act_shift."""
    boundary = 3
    kw = {**TRAIN_KW, "pg_scale": (boundary,)}
    jtrain, ttrain = JTrainStageConfig(**kw), TrainStageConfig(**kw)
    final = {**MODEL_KW, "num_voxels_density": 16**3, "num_voxels_rgb": 16**3}
    j_model, t_model = JModelRenderConfig(**final), ModelRenderConfig(**final)
    jcfg, jp, tcfg, tp = make_state(seed=7)
    budget = jcfg.sample_budget
    assert budget > 0
    # no seed mask: the budget waits for the first refresh
    jcfg, tcfg = (dataclasses.replace(c, sample_budget=0) for c in (jcfg, tcfg))
    near_thres = 0.3

    def compile_both(jcfg, tcfg, anchor):
        def jfwd(params, ro, rd, vd, key, img_index=None):
            return jfg.forward(params, jcfg, ro, rd, vd, rand_bkgd_key=key)

        j = jax.jit(jstep.make_train_step(jfwd, jtrain, world_size_max=float(max(jcfg.world_size)),
                                          near_thres=near_thres, lr_anchor=anchor))
        t = tstep.make_train_step(
            lambda p, ro, rd, vd, bg: fg.forward(p, tcfg, ro, rd, vd, bg_color=bg), ttrain,
            world_size_max=float(max(tcfg.world_size)), near_thres=near_thres, lr_anchor=anchor)
        return j, t

    j_step, t_step = compile_both(jcfg, tcfg, 1)
    j_state = jstep.create_train_state(jp, jtrain)
    t_state = tstep.create_train_state(tp, ttrain)
    rng = np.random.default_rng(11)
    for s in range(1, 5):
        if s == boundary:
            # the JAX loop's block (train/loop.py), written out
            params, jcfg = jfg.scale_volume_grid(j_state.params, jcfg, 16**3, 16**3)
            params = params.replace(act_shift=params.act_shift - jtrain.decay_after_scale)
            jcfg = dataclasses.replace(jcfg, sample_budget=budget)
            j_state = jstep.create_train_state(params, jtrain, start_step=s - 1)
            old_moments = t_state.optimizer.exp_avg
            t_state, tcfg, record = loop.pg_scale_boundary(t_state, tcfg, t_model, ttrain, s,
                                                           deferred_budget=budget)
            j_step, t_step = compile_both(jcfg, tcfg, s)
            assert record["step"] == s and record["sample_budget"] == budget == tcfg.sample_budget
            assert record["sample_budget_before"] == 0
            assert record["world_size_density"] == tcfg.world_size_density == (15, 15, 15)
            assert set(record["seconds"]) == {"resize", "refresh", "rebuild"}
            assert record["occupancy"] == pytest.approx(float(np.mean(params.mask_cache.mask)))
            assert 0 < record["occupancy"] < record["occupancy_carried"] < 1
            np.testing.assert_array_equal(t_state.params.mask_cache.mask.numpy(),
                                          np.asarray(params.mask_cache.mask))
            # Adam starts over on the new parameters
            opt = t_state.optimizer
            assert opt.step_count == 0 and opt.exp_avg is not old_moments
            assert set(opt.exp_avg) == {p for p in t_state.params.parameters()}
            assert all(float(m.abs().max()) == 0 for m in opt.exp_avg.values())
            assert t_state.step == s - 1 == int(j_state.step)
        o, d, vd = make_rays(n=kw["N_rand"], seed=20 + s)
        rgb = rng.random((o.shape[0], 3)).astype(np.float32)
        key = jax.random.PRNGKey(100 + s)
        batch = dict(rays_o=o, rays_d=d, viewdirs=vd, rgb=rgb)
        j_state, j_m = j_step(j_state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        bg = torch.from_numpy(np.array(jax.random.uniform(key, (o.shape[0], 3))))
        t_m = t_step(t_state, {k: torch.from_numpy(v) for k, v in batch.items()}, bg)
        for name in ("loss", "mse", "psnr", "loss_entropy", "loss_nearclip", "loss_distortion",
                     "loss_rgbper", "lr_scale"):
            assert float(t_m[name]) == pytest.approx(float(j_m[name]), rel=1e-4, abs=1e-6), \
                (s, name)
        assert (float(t_m["lr_scale"]) == 1.0) == (s in (1, boundary))

    jparams = j_state.params
    assert t_state.params.act_shift == pytest.approx(float(jparams.act_shift))
    assert t_state.params.act_shift == pytest.approx(tcfg.act_shift - ttrain.decay_after_scale)
    pairs = [(t_state.params.density.grid, jparams.density.grid),
             (t_state.params.k0.grid, jparams.k0.grid)]
    pairs += [(lin.weight.T, w) for lin, w in zip(t_state.params.rgbnet.layers,
                                                   jparams.rgbnet.weights)]
    pairs += [(lin.bias, b) for lin, b in zip(t_state.params.rgbnet.layers, jparams.rgbnet.biases)]
    for got, want in pairs:
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=2e-5)
    assert t_state.step == 4 == int(j_state.step)


def _tiny_bicycle_with_boundaries():
    """configs/nerf_unbounded/bicycle_single.py cut to 24^3 voxels, a
    16-sample budget and 7 steps with boundaries at 3 and 5. The density's lr
    and a scalar threshold are set so that three steps already empty some
    voxels: the recipe's own take thousands."""
    cfg = loader.load_config(str(ROOT / "configs" / "nerf_unbounded" / "bicycle_single.py"))
    vox = 24**3
    fm = dataclasses.replace(cfg.fine_model_and_render, num_voxels_density=vox,
                             num_voxels_rgb=vox, num_voxels_base_density=vox,
                             num_voxels_base_rgb=vox, sample_budget=16, color_budget=6,
                             fast_color_thres=7e-5, fast_color_thres_schedule=())
    ft = dataclasses.replace(cfg.fine_train, pg_scale=(3, 5), N_iters=7, N_rand=1024,
                             lrate_density=2.0)
    return dataclasses.replace(cfg, fine_model_and_render=fm, fine_train=ft)


@pytest.fixture(scope="module")
def trained_across_boundaries(tmp_path_factory):
    exp_dir = str(tmp_path_factory.mktemp("exp"))
    cfg = _tiny_bicycle_with_boundaries()
    data = synthetic.orbit_scene(4, 16, 24, seed=0, n_test=2)
    seen, said = [], []
    build.reset_launch_counts()
    out = loop.run_train(cfg, data, seed=0, device="cpu", log_fn=said.append,
                         callback=lambda step, m: seen.append((step, dict(m))), exp_dir=exp_dir)
    assert not build.LAUNCHES  # the CPU path runs the plain versions only
    return cfg, data, exp_dir, out, seen, said


def test_run_train_crosses_boundaries_on_cpu(trained_across_boundaries):
    cfg, _, _, (family, mcfg, params, psnr), seen, said = trained_across_boundaries
    assert family == "FourierGrid" and [s for s, _ in seen] == list(range(1, 8))
    assert all(np.isfinite(float(m["loss"])) for _, m in seen) and np.isfinite(psnr)
    records = {s: m["pg_scale"] for s, m in seen if "pg_scale" in m}
    assert sorted(records) == [3, 5]
    fm = cfg.fine_model_and_render
    start = fg.config_from(fm, (-1,) * 3, (1,) * 3, fm.num_voxels_density // 4,
                           fm.num_voxels_rgb // 4)
    sizes = [start.with_num_voxels(v, v).world_size_density
             for v in (fm.num_voxels_density // 2, fm.num_voxels_density)]
    assert [records[s]["world_size_density"] for s in (3, 5)] == sizes
    assert sizes[0] != sizes[1] != start.world_size_density
    # the grids end at the config's own size, in its dtype
    assert mcfg.num_voxels_density == fm.num_voxels_density
    assert tuple(params.k0.grid.shape) == (7, *sizes[1], 12)
    assert params.k0.grid.dtype == params.density.grid.dtype == torch.bfloat16
    assert tuple(params.mask_cache.mask.shape) == sizes[1]
    # the budget switches on at the first boundary, the mask falls below 1
    # there and never rises
    assert [records[s]["sample_budget"] for s in (3, 5)] == [16, 16] and mcfg.sample_budget == 16
    assert [records[s]["sample_budget_before"] for s in (3, 5)] == [0, 16]
    assert 1 > records[3]["occupancy"] > records[5]["occupancy"] > 0
    assert records[3]["occupancy_carried"] == 1  # no seed: the cache starts all true
    assert records[5]["occupancy"] < records[5]["occupancy_carried"] < 1
    assert float(params.mask_cache.mask.float().mean()) == pytest.approx(records[5]["occupancy"])
    # the lr returns to its base at a boundary and decays from there
    scales = [m["lr_scale"] for _, m in seen]
    assert [x == 1.0 for x in scales] == [True, False, True, False, True, False, False]
    assert params.act_shift == pytest.approx(mcfg.act_shift - 2 * cfg.fine_train.decay_after_scale)
    assert sum("pg_scale: grids" in line for line in said) == 2


def test_boundaries_outside_the_stage_are_never_reached():
    cfg = _tiny_bicycle_with_boundaries()
    cfg = dataclasses.replace(cfg, fine_train=dataclasses.replace(
        cfg.fine_train, pg_scale=(50, 60), N_iters=2, N_rand=128))
    seen = []
    _, mcfg, params, _ = loop.run_train(
        cfg, synthetic.orbit_scene(2, 8, 12, seed=0), seed=0, device="cpu",
        log_fn=lambda _: None, callback=lambda step, m: seen.append(m))
    assert not any("pg_scale" in m for m in seen)
    # the grids start at a quarter of the voxels and stay there; the budget
    # was held off for the whole stage, and the config handed on carries it
    assert mcfg.num_voxels_density == 24**3 // 4 and mcfg.sample_budget == 16
    assert tuple(params.k0.grid.shape[1:4]) == mcfg.world_size_rgb


def test_checkpoint_after_boundaries_loads_and_renders(trained_across_boundaries):
    cfg, data, exp_dir, (_, mcfg, params, _), _, _ = trained_across_boundaries
    family, cfg2, p2, step, _ = ckpt.load_model(os.path.join(exp_dir, "fine_last"))
    assert family == "FourierGrid" and step == 7 and cfg2 == mcfg
    assert cfg2.sample_budget == 16  # the true budget, not a deferral-zeroed one
    assert torch.equal(p2.k0.grid, params.k0.grid) and p2.k0.grid.dtype == torch.bfloat16
    assert torch.equal(p2.density.grid, params.density.grid)
    assert torch.equal(p2.mask_cache.mask, params.mask_cache.mask)
    assert p2.act_shift == pytest.approx(params.act_shift)
    said = []
    out = render.run_render(types.SimpleNamespace(chunk=128), cfg, data, exp_dir, device="cpu",
                            log_fn=said.append)["test"]
    assert out["rgbs"].shape == (2, 16, 24, 3) and np.isfinite(out["rgbs"]).all()
    assert any(line.startswith("render cache: two-stage") for line in said)
