"""The port's render path against the JAX package's, module by module.

A tiny model (16^3 voxels, 3 banks, k0 4 channels, 12-sample budget,
``color_budget`` 5) gets random grids from a numpy seed in the JAX package
and is carried into the port by ``convert.py``; the same rays and views go
through both on the CPU. The mask cache stays all-true (a sample on a
voxel's half-way point could round to either voxel with the last ulp of
``t``).

Tolerances, as float32 sums run in another order: cache tables bit-equal
(indexed copies); lattice evaluation and bake 1e-5 of the field's largest
value (a lattice node's coordinate differs in its last bit, which the grid's
size amplifies); forwards through a
render cache 1e-5 absolute on rgb, depth, ``alphainv_last``, weights and
``color_overflow_frac``; rendered images 1e-5, PSNR and SSIM 1e-4;
checkpoints bit-equal.
"""

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unboundednerfpytorch_tpu.models import fourier_grid as jfg
from unboundednerfpytorch_tpu.render import cam_paths as jcam
from unboundednerfpytorch_tpu.render import renderer as jrenderer
from unboundednerfpytorch_tpu.train import loop as jloop
from unboundednerfpytorch_tpu.utils import checkpoint as jckpt
from unboundednerfpytorch_tpu.utils import metrics as jmetrics
from unboundednerfpytorch_tpu_torch import convert, render
from unboundednerfpytorch_tpu_torch.configs import loader
from unboundednerfpytorch_tpu_torch.data import synthetic
from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
from unboundednerfpytorch_tpu_torch.ops.cuda import build
from unboundednerfpytorch_tpu_torch.render import cam_paths, renderer
from unboundednerfpytorch_tpu_torch.train import loop
from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt
from unboundednerfpytorch_tpu_torch.utils import metrics
from test_torch_port_model import XYZ_MAX, XYZ_MIN, make_pair, make_rays
from test_torch_port_train import ROOT, _tiny_bicycle
from torch_threads import torch_threads  # noqa: F401: the workers' share of the cores

TWO_STAGE = dict(color_budget=5)
H, W, CHUNK = 17, 24, 128  # 408 rays: three full chunks and a padded one


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rays_t(n=96, seed=1):
    return [_t(a) for a in make_rays(n, seed)]


def _assert_tables_equal(got, want):
    assert (got is None) == (want is None)
    if got is None:
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w.astype(jnp.float32)))


def _assert_result_close(got, want, tol=1e-5):
    for field in ("rgb_marched", "depth", "alphainv_last", "weights"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=0, atol=tol, err_msg=field)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert got.rgb_compacted == want.rgb_compacted
    if want.color_overflow_frac is None:
        assert got.color_overflow_frac is None
    else:
        assert float(got.color_overflow_frac) == pytest.approx(
            float(want.color_overflow_frac), abs=1e-5)


# ---------------------------------------------------------------------------
# the render cache and the forwards through it


@pytest.mark.parametrize("overrides,branch", [
    (dict(TWO_STAGE, density_bake_scale=2.0), "two-stage, baked density"),
    (dict(TWO_STAGE, density_bake_scale=2.0, density_bake_dtype="bfloat16"),
     "two-stage, baked density"),
    (TWO_STAGE, "two-stage, exact density"),
    (dict(TWO_STAGE, grid_dtype="bfloat16"), "two-stage, exact density"),
    ({}, "single-stage fused tables"),
    (dict(grid_dtype="bfloat16"), "single-stage fused tables"),
])
def test_render_cache_and_forward_match_jax(overrides, branch):
    jcfg, jp, tcfg, tp = make_pair(seed=3, **overrides)
    jcache = jfg.build_render_cache(jp, jcfg)
    said = []
    tcache = fg.build_render_cache(tp, tcfg, log_fn=said.append)
    assert tcache.branch.startswith(branch) and branch in said[0]
    assert tcache.density_fold == jcache.density_fold
    assert tcache.density_dims == jcache.density_dims
    assert tcache.density_num_freqs == jcache.density_num_freqs
    _assert_tables_equal(tcache.tables, jcache.tables)
    _assert_tables_equal(tcache.k0_tables, jcache.k0_tables)
    if tcache.density_dims is None:
        _assert_tables_equal(tcache.density_tables, jcache.density_tables)
    else:  # the baked bank is a float32 evaluation, not a copy: 1e-5 of the
        # largest density (about 16 here); in bfloat16, one step of it
        bf16 = overrides.get("density_bake_dtype") == "bfloat16"
        want_table = np.asarray(jcache.density_tables[0].astype(jnp.float32))
        np.testing.assert_allclose(
            tcache.density_tables[0].float().numpy(), want_table, rtol=0,
            atol=(2.0**-7 if bf16 else 1e-5) * max(1.0, np.abs(want_table).max()))
    o, d, vd = make_rays(96, seed=4)
    want = jfg.forward(jp, jcfg, jnp.asarray(o), jnp.asarray(d), jnp.asarray(vd), bg=1.0,
                       cache=jcache)
    with torch.no_grad():
        got = fg.forward(tp, tcfg, _t(o), _t(d), _t(vd), bg=1.0, cache=tcache)
    # a bfloat16 bake may round a value across the threshold in one package only
    if overrides.get("density_bake_dtype") != "bfloat16":
        _assert_result_close(got, want)
    if "color_budget" in overrides:
        assert got.rgb_compacted and got.raw_rgb.shape == (96, 5, 3)
        assert 0.0 < float(got.color_overflow_frac) < 1.0  # some rays overflow, some do not
    else:
        assert not got.rgb_compacted and got.color_overflow_frac is None


def test_two_stage_equals_single_stage_where_no_ray_overflows():
    """The exactness ``_forward_two_stage`` states: with the exact density,
    a ray with at most ``color_budget`` survivors renders as the uncached
    single-stage forward renders it."""
    _, _, tcfg, tp = make_pair(seed=5, **TWO_STAGE)
    o, d, vd = _rays_t(128, seed=6)
    with torch.no_grad():
        two = fg.forward(tp, tcfg, o, d, vd, bg=1.0, cache=fg.build_render_cache(tp, tcfg))
        one = fg.forward(tp, tcfg, o, d, vd, bg=1.0)
    keep = two.mask.sum(-1) <= tcfg.color_budget
    assert 10 < int(keep.sum()) < 128
    np.testing.assert_allclose(two.rgb_marched[keep].numpy(), one.rgb_marched[keep].numpy(),
                               rtol=0, atol=1e-5)
    assert float((two.rgb_marched[~keep] - one.rgb_marched[~keep]).abs().max()) > 1e-4
    for field in ("weights", "alphainv_last", "depth"):
        np.testing.assert_allclose(getattr(two, field).numpy(), getattr(one, field).numpy(),
                                   rtol=0, atol=1e-6)


def test_two_stage_cache_with_threshold_off_takes_the_grids():
    """thres <= 0 would cut rays to their first color_budget samples: both
    packages fall through to the single-stage path, where a two-stage cache
    has no fused tables to offer."""
    jcfg, jp, tcfg, tp = make_pair(seed=7, **TWO_STAGE)
    o, d, vd = make_rays(48, seed=8)
    want = jfg.forward(jp, jcfg, jnp.asarray(o), jnp.asarray(d), jnp.asarray(vd),
                       fast_color_thres=0.0, cache=jfg.build_render_cache(jp, jcfg))
    with torch.no_grad():
        got = fg.forward(tp, tcfg, _t(o), _t(d), _t(vd), fast_color_thres=0.0,
                         cache=fg.build_render_cache(tp, tcfg))
    _assert_result_close(got, want)
    assert not got.rgb_compacted


def test_forward_overrides_match_jax():
    jcfg, jp, tcfg, tp = make_pair(seed=9)
    o, d, vd = make_rays(48, seed=10)
    kw = dict(stepsize=0.25, fast_color_thres=1e-3, bg=0.3)
    want = jfg.forward(jp, jcfg, jnp.asarray(o), jnp.asarray(d), jnp.asarray(vd), **kw)
    with torch.no_grad():
        got = fg.forward(tp, tcfg, _t(o), _t(d), _t(vd), **kw)
    _assert_result_close(got, want)
    base = fg.forward(tp, tcfg, _t(o), _t(d), _t(vd), bg=0.3)
    assert int(got.mask.sum()) < int(base.mask.sum())


def test_cache_guards():
    _, _, tcfg, tp = make_pair(seed=11, **TWO_STAGE)
    assert fg.build_render_cache(tp, dataclasses.replace(tcfg, packed_gather=False)) is None
    dev = torch.device("cpu")
    assert fg._hbm_bytes(dev) == int(16e9) == jfg._hbm_bytes()
    assert fg._pack_bytes_limit(dev) == jfg._pack_bytes_limit()
    assert fg._cache_bytes_limit(dev) == jfg._cache_bytes_limit()
    # the guard decides between a baked and an exact density
    big = dataclasses.replace(tcfg, density_bake_scale=2.0, num_voxels_density=500**3)
    assert fg._baked_density_dims(big, dev) is None
    ok = dataclasses.replace(tcfg, density_bake_scale=2.0)
    jok = dataclasses.replace(make_pair(**TWO_STAGE)[0], density_bake_scale=2.0)
    assert fg._baked_density_dims(ok, dev) == jfg._baked_density_dims(jok)
    assert fg._baked_density_dims(dataclasses.replace(ok, fourier_freq_num=0), dev) is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("slab_pts", [1 << 20, 700])
def test_eval_field_on_lattice_matches_jax(dtype, slab_pts):
    jcfg, jp, tcfg, tp = make_pair(seed=12, grid_dtype=dtype)
    ws = (21, 19, 23)
    want = jfg._eval_field_on_lattice(jp.k0, jcfg.xyz_min, jcfg.xyz_max, ws, jcfg.k0_dim,
                                      slab_pts)
    got = fg._eval_field_on_lattice(tp.k0, tcfg.xyz_min, tcfg.xyz_max, ws, tcfg.k0_dim, slab_pts)
    assert got.dtype == torch.float32 and tuple(got.shape) == (*ws, tcfg.k0_dim)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))


def test_bake_for_rendering_matches_jax():
    jcfg, jp, tcfg, tp = make_pair(seed=13)
    jbp, jbc = jfg.bake_for_rendering(jp, jcfg, scale=1.26)
    tbp, tbc = fg.bake_for_rendering(tp, tcfg, scale=1.26)
    assert tbc.fourier_freq_num == 0 and tbc.world_size_density == jbc.world_size_density
    assert tbp.density.num_freqs == 0 and tbp.density.grid.shape[0] == 1
    for name in ("density", "k0"):
        want_grid = np.asarray(getattr(jbp, name).grid)
        np.testing.assert_allclose(getattr(tbp, name).grid.detach().numpy(), want_grid, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(want_grid).max()))
    o, d, vd = make_rays(48, seed=14)
    want = jfg.forward(jbp, jbc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(vd), bg=1.0,
                       cache=jfg.build_render_cache(jbp, jbc))
    with torch.no_grad():
        got = fg.forward(tbp, tbc, _t(o), _t(d), _t(vd), bg=1.0,
                         cache=fg.build_render_cache(tbp, tbc))
    _assert_result_close(got, want, tol=2e-5)  # two lattice evaluations feed it


# ---------------------------------------------------------------------------
# make_forward and the background


def test_make_forward_composites_on_the_jax_background():
    """rand_bkgd off, white_bkgd on: neither make_forward hands ``bg`` to the
    FourierGrid forward, so both composite on 0.0."""
    jcfg, jp, tcfg, tp = make_pair(seed=15)
    rk = {"near": 0.0, "far": 1.0, "bg": 1.0, "stepsize": 0.5, "rand_bkgd": False}
    o, d, vd = make_rays(48, seed=16)
    want = jloop.make_forward("FourierGrid", jcfg, rk)(
        jp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(vd), jax.random.PRNGKey(0))
    with torch.no_grad():
        got = loop.make_forward(tcfg, rk)(tp, _t(o), _t(d), _t(vd), None)
        black = fg.forward(tp, tcfg, _t(o), _t(d), _t(vd), bg=0.0)
        white = fg.forward(tp, tcfg, _t(o), _t(d), _t(vd), bg=1.0)
    _assert_result_close(got, want)
    np.testing.assert_array_equal(got.rgb_marched.numpy(), black.rgb_marched.numpy())
    assert float((white.rgb_marched - got.rgb_marched).abs().max()) > 0.1


def test_make_forward_threads_stepsize_and_cache():
    jcfg, jp, tcfg, tp = make_pair(seed=17, **TWO_STAGE)
    rk = {"bg": 1.0, "stepsize": 0.25}
    o, d, vd = make_rays(48, seed=18)
    jcache, tcache = jfg.build_render_cache(jp, jcfg), fg.build_render_cache(tp, tcfg)
    want = jloop.make_forward("FourierGrid", jcfg, rk, cache=jcache)(
        jp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(vd), None)
    with torch.no_grad():
        got = loop.make_forward(tcfg, rk, cache=tcache)(tp, _t(o), _t(d), _t(vd))
        per_call = loop.make_forward(tcfg, rk)(tp, _t(o), _t(d), _t(vd), None, cache=tcache)
    _assert_result_close(got, want)
    assert got.rgb_compacted and per_call.rgb_compacted
    np.testing.assert_array_equal(got.rgb_marched.numpy(), per_call.rgb_marched.numpy())


# ---------------------------------------------------------------------------
# render_image, render_viewpoints


def _views(n=3):
    """Poses inside the model's box looking at its center (the 12-sample
    budget under an all-true occupancy keeps each ray's first samples, which
    must lie in the grid), with intrinsics."""
    center = (np.asarray(XYZ_MIN) + np.asarray(XYZ_MAX)) / 2
    poses = np.stack([
        synthetic.look_at_pose(center + 0.8 * np.array([np.cos(a), np.sin(a), 0.3]), center)
        for a in np.linspace(0.3, 4.0, n)]).astype(np.float32)
    K = np.array([[0.9 * W, 0, W / 2], [0, 0.9 * W, H / 2], [0, 0, 1]], np.float32)
    return poses, np.array([[H, W]] * n), np.stack([K] * n)


def _forward_pair(seed=19, **overrides):
    """Forwards through a two-stage cache, of a model dense enough to show
    in an image (alpha_init 0.5 puts act_shift at 0)."""
    jcfg, jp, tcfg, tp = make_pair(seed=seed, **{**TWO_STAGE, "alpha_init": 0.5, **overrides})
    jcache, tcache = jfg.build_render_cache(jp, jcfg), fg.build_render_cache(tp, tcfg)
    jfwd = lambda aux, ro, rd, vd: jfg.forward(aux[0], jcfg, ro, rd, vd, cache=aux[1])
    tfwd = lambda aux, ro, rd, vd: fg.forward(aux[0], tcfg, ro, rd, vd, cache=aux[1])
    return jfwd, (jp, jcache), tfwd, (tp, tcache)


@pytest.mark.parametrize("flags", [{}, {"inverse_y": True}, {"flip_x": True, "flip_y": True}])
def test_render_image_matches_jax(flags):
    jfwd, jaux, tfwd, taux = _forward_pair()
    poses, _, Ks = _views(1)
    want = jrenderer.render_image(jfwd, H, W, Ks[0], poses[0][:3, :4], chunk=CHUNK, aux=jaux,
                                  **flags)
    got = renderer.render_image(tfwd, H, W, Ks[0].astype(np.float64), poses[0][:3, :4],
                                chunk=CHUNK, aux=taux, device="cpu", **flags)
    for g, w, shape in zip(got, want, [(H, W, 3), (H, W), (H, W)]):
        assert g.shape == shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    assert np.ptp(got[0]) > 0.01 and got[0].mean() > 0.01  # an image, not a constant


def test_render_image_without_aux_and_with_rays_fn():
    _, _, tfwd, taux = _forward_pair()
    poses, _, Ks = _views(1)
    base = renderer.render_image(tfwd, H, W, Ks[0], poses[0][:3, :4], chunk=CHUNK, aux=taux,
                                 device="cpu")
    plain = renderer.render_image(lambda ro, rd, vd: tfwd(taux, ro, rd, vd), H, W, Ks[0],
                                  poses[0][:3, :4], chunk=CHUNK, device="cpu")
    seen = []

    def rays_fn(ro, rd, vd):
        seen.append(ro.shape[0])
        res = tfwd(taux, ro, rd, vd)
        return res.rgb_marched, res.depth, res.alphainv_last

    whole = renderer.render_image(None, H, W, Ks[0], poses[0][:3, :4], chunk=CHUNK,
                                  rays_fn=rays_fn, device="cpu")
    assert seen == [4 * CHUNK]  # 408 rays padded to four chunks
    for a, b, c in zip(base, plain, whole):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-6)


def test_render_viewpoints_matches_jax():
    jfwd, jaux, tfwd, taux = _forward_pair(seed=20)
    poses, HW, Ks = _views(3)
    gt = np.random.default_rng(21).random((3, H, W, 3)).astype(np.float32)
    jlog, tlog = [], []
    want = jrenderer.render_viewpoints(jfwd, poses, HW, Ks, gt_imgs=gt, chunk=CHUNK, aux=jaux,
                                       eval_lpips=True, log_fn=jlog.append)
    got = renderer.render_viewpoints(tfwd, poses, HW, Ks, gt_imgs=gt, chunk=CHUNK, aux=taux,
                                     eval_lpips=True, log_fn=tlog.append, device="cpu")
    for name in ("rgbs", "depths", "bgmaps"):
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(got["psnrs"], want["psnrs"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["ssims"], want["ssims"], rtol=0, atol=1e-4)
    assert len(got["seconds"]) == 3 and all(s > 0 for s in got["seconds"])
    # LPIPS needs a package neither side has: skipped, and the skip announced
    assert got["lpips"] == want["lpips"] == []
    assert any("LPIPS SKIPPED" in line for line in tlog)
    assert [line.split(":")[0] for line in tlog] == [line.split(":")[0] for line in jlog]


@pytest.mark.parametrize("kw", [dict(render_factor=2), dict(render_video_flipy=True),
                                dict(render_video_rot90=1),
                                dict(render_video_flipy=True, render_video_rot90=3)])
def test_render_viewpoints_transforms_match_jax(kw):
    jfwd, jaux, tfwd, taux = _forward_pair(seed=22)
    poses, HW, Ks = _views(2)
    gt = np.zeros((2, H, W, 3), np.float32)
    want = jrenderer.render_viewpoints(jfwd, poses, HW, Ks, gt_imgs=gt, chunk=CHUNK, aux=jaux,
                                       verbose=False, **kw)
    got = renderer.render_viewpoints(tfwd, poses, HW, Ks, gt_imgs=gt, chunk=CHUNK, aux=taux,
                                     verbose=False, device="cpu", **kw)
    assert got["rgbs"].shape == want["rgbs"].shape
    np.testing.assert_allclose(got["rgbs"], want["rgbs"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["depths"], want["depths"], rtol=0, atol=1e-5)
    assert len(got["psnrs"]) == len(want["psnrs"])  # none under render_factor


def test_render_viewpoints_image_fn_and_empty_split():
    out = renderer.render_viewpoints(
        None, np.zeros((2, 4, 4), np.float32), [[3, 5]] * 2, np.stack([np.eye(3)] * 2),
        image_fn=lambda h, w, K, c2w: (np.full((h, w, 3), 0.5, np.float32),
                                       np.zeros((h, w), np.float32), np.ones((h, w), np.float32)),
        device="cpu")
    assert out["rgbs"].shape == (2, 3, 5, 3) and out["psnrs"] == []
    empty = renderer.render_viewpoints(None, np.zeros((0, 4, 4)), np.zeros((0, 2)),
                                       np.zeros((0, 3, 3)), device="cpu")
    assert empty["rgbs"].shape == (0,)


def test_depth_to_vis_and_metrics_match_jax():
    rng = np.random.default_rng(23)
    a, b = rng.random((20, 30, 3)), rng.random((20, 30, 3))
    np.testing.assert_array_equal(renderer.depth_to_vis(a[..., 0]), jrenderer.depth_to_vis(a[..., 0]))
    assert metrics.psnr(a, b) == jmetrics.psnr(a, b)
    assert metrics.mse2psnr(0.01) == jmetrics.mse2psnr(0.01)
    assert metrics.rgb_ssim(a, b) == jmetrics.rgb_ssim(a, b)
    np.testing.assert_array_equal(metrics.rgb_ssim(a, b, return_map=True),
                                  jmetrics.rgb_ssim(a, b, return_map=True))
    np.testing.assert_array_equal(metrics.to8b(a * 1.5 - 0.2), jmetrics.to8b(a * 1.5 - 0.2))
    with pytest.raises(ImportError, match="lpips"):
        metrics.rgb_lpips(a, b)


# ---------------------------------------------------------------------------
# checkpoints and convert


def _save_format_1(path, cfg, params, global_step):
    """A checkpoint as the port wrote it before format 2: bfloat16 grids as
    float32 values, act_shift as float32, no ``stored_dtypes``."""
    os.makedirs(path)
    meta = {"global_step": global_step, "family": "FourierGrid",
            "model_kwargs": convert.config_to_dict(cfg), "has_opt_state": False,
            "format_version": 1}
    json.dump(meta, open(os.path.join(path, "meta.json"), "w"))
    np.savez(os.path.join(path, "params.npz"),
             **ckpt._flatten(convert.params_to_numpy(params)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip_is_bit_equal(tmp_path, dtype):
    """Format 3 (members named by step and listed in ``meta.json``, bfloat16
    grids as their 16-bit patterns) as written now, format 2 (the same
    archives as ``params.npz``) and format 1 (bfloat16 grids as float32
    values) as written before it: all load bit-equal."""
    _, _, tcfg, tp = make_pair(seed=24, grid_dtype=dtype, **TWO_STAGE)
    tp.mask_cache.mask[2:5] = False
    tp.act_shift = float(tp.act_shift) + 1e-9  # a float64 value
    for fmt in (1, 2, 3):
        path = str(tmp_path / f"format_{fmt}")
        if fmt == 1:
            _save_format_1(path, tcfg, tp, 7)
        else:
            ckpt.save_model(path, "FourierGrid", tcfg, tp, global_step=7)
            assert sorted(os.listdir(path)) == ["meta.json", "params-7.npz"]
            meta = json.load(open(os.path.join(path, "meta.json")))
            assert set(meta) == {"global_step", "family", "model_kwargs", "has_opt_state",
                                 "format_version", "stored_dtypes", "members"}
            assert meta["format_version"] == 3 and not meta["has_opt_state"]
            assert meta["members"] == {"params": "params-7.npz", "opt_state": None}
            assert meta["stored_dtypes"] == ({"density/grid": "bfloat16", "k0/grid": "bfloat16"}
                                             if dtype == "bfloat16" else {})
            with np.load(os.path.join(path, "params-7.npz")) as npz:  # 2 bytes an element
                assert npz["k0/grid"].dtype == (np.uint16 if dtype == "bfloat16" else np.float32)
            if fmt == 2:  # as the port wrote it before format 3
                os.rename(os.path.join(path, "params-7.npz"), os.path.join(path, "params.npz"))
                del meta["members"]
                meta["format_version"] = 2
                json.dump(meta, open(os.path.join(path, "meta.json"), "w"))
        family, cfg2, p2, step, opt = ckpt.load_model(path)
        assert (family, step, opt) == ("FourierGrid", 7, None) and cfg2 == tcfg
        assert p2.k0.grid.dtype == tp.k0.grid.dtype
        if fmt >= 2:
            assert p2.act_shift == tp.act_shift
        else:
            assert p2.act_shift == pytest.approx(tp.act_shift)
        for (na, a), (nb, b) in zip(sorted(tp.state_dict().items()),
                                    sorted(p2.state_dict().items())):
            assert na == nb and torch.equal(a, b), na
        assert p2.density.xyz_min == tp.density.xyz_min and p2.k0.num_freqs == tp.k0.num_freqs
    with pytest.raises(NotImplementedError):  # a family the port does not have
        ckpt.save_model(path, "tensorf", tcfg, tp)


def test_checkpoint_archives_are_numpy_archives(tmp_path):
    """The port writes each member in one piece and reads it from its offset:
    ``np.load`` reads what it writes, and it reads what ``np.savez`` writes
    (format 1), every dtype and shape the checkpoints hold."""
    rng = np.random.default_rng(0)
    arrays = {"density/grid": rng.random((3, 4, 5, 2)).astype(np.float32),
              "rgbnet/weights/0": rng.random((4, 6)).T, "k0/grid": np.arange(10, dtype=np.uint16),
              "act_shift": np.float64(-4.5), "mask_cache/mask": rng.random((5, 5)) > 0.5,
              "step": np.int32(7), "empty": np.zeros((0, 3), np.float32)}
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    ckpt._write_npz(ours, arrays)
    np.savez(theirs, **arrays)
    with np.load(ours) as npz:
        read_by_numpy = {k: npz[k] for k in npz.files}
    for got in (read_by_numpy, ckpt._read_npz(ours), ckpt._read_npz(theirs)):
        assert sorted(got) == sorted(arrays)
        for k, want in arrays.items():
            assert got[k].dtype == np.asarray(want).dtype and got[k].shape == np.shape(want), k
            np.testing.assert_array_equal(got[k], want)
    np.savez_compressed(theirs, **arrays)
    with pytest.raises(ValueError, match="compressed"):
        ckpt._read_npz(theirs)


def test_checkpoint_io_probe_runs_on_the_cpu(capsys):
    from unboundednerfpytorch_tpu_torch.probes import checkpoint_io

    rec = checkpoint_io.main("cpu", shape=(2, 3, 4, 5, 2))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == json.loads(
        json.dumps(rec))
    assert {"to_host_s", "np_savez_s", "port_write_s", "np_load_s", "port_read_s",
            "to_device_s"} <= set(rec) and rec["gb"] == 2 * 3 * 4 * 5 * 2 * (4 + 4 + 2) / 1e9


def test_checkpoint_keeps_the_optimizer_state(tmp_path):
    """The optimizer's state beside the parameters: the step count and both
    moments come back bit-equal; saving again without them drops its member
    (and a second save of one step does not overwrite the members that the
    current ``meta.json`` names), and ``with_opt_state=False`` skips reading
    them."""
    _, _, tcfg, tp = make_pair(seed=26, grid_dtype="bfloat16", **TWO_STAGE)
    state = loop.create_train_state(tp, dataclasses.replace(_tiny_bicycle().fine_train))
    gen = torch.Generator().manual_seed(0)
    for moments in (state.optimizer.exp_avg, state.optimizer.exp_avg_sq):
        for m in moments.values():
            m.copy_(torch.randn(m.shape, generator=gen))
    state.optimizer.step_count = 5
    path = str(tmp_path / "fine_last")
    ckpt.save_model(path, "FourierGrid", tcfg, tp, global_step=9,
                    opt_state=state.optimizer.state_dict())
    assert json.load(open(os.path.join(path, "meta.json")))["has_opt_state"]
    assert sorted(os.listdir(path)) == ["meta.json", "opt_state-9.npz", "params-9.npz"]
    *_, step, opt = ckpt.load_model(path)
    assert step == 9 and opt["step"] == 5
    want = state.optimizer.state_dict()
    for key in ("exp_avg", "exp_avg_sq"):
        assert sorted(opt[key]) == ["density", "k0", "rgbnet"]
        for name, ms in want[key].items():
            assert len(opt[key][name]) == len(ms)
            for got, m in zip(opt[key][name], ms):
                assert torch.equal(torch.from_numpy(got), m)
    assert ckpt.load_model(path, with_opt_state=False)[4] is None
    ckpt.save_model(path, "FourierGrid", tcfg, tp, global_step=9)
    assert sorted(os.listdir(path)) == ["meta.json", "params-9.1.npz"]
    assert ckpt.load_model(path)[3:] == (9, None)


def test_config_dict_round_trip_and_jax_meta():
    jcfg, _, tcfg, _ = make_pair(**TWO_STAGE)
    through_json = json.loads(json.dumps(convert.config_to_dict(tcfg)))
    assert convert.config_from_dict(through_json) == tcfg
    # the JAX package's model_kwargs hold more fields; the shared ones carry over
    from_jax = convert.config_from_dict(json.loads(json.dumps(dataclasses.asdict(jcfg))))
    assert from_jax == tcfg
    # and the port's model_kwargs build the JAX config
    assert jckpt._cfg_from_jsonable("FourierGrid", through_json) == jcfg


def test_jax_checkpoint_carried_over_renders_the_same_image(tmp_path):
    jcfg, jp, _, _ = make_pair(seed=25, grid_dtype="bfloat16", **TWO_STAGE)
    jp = jp.replace(mask_cache=jp.mask_cache.replace(
        mask=jp.mask_cache.mask.at[:2].set(False)))
    jpath, tpath = str(tmp_path / "jax_last"), str(tmp_path / "fine_last")
    jckpt.save_model(jpath, "FourierGrid", jcfg, jp, global_step=11)
    _, jcfg2, jp2, jstep, _ = jckpt.load_model(jpath)
    # the carry-over: one process with both packages, nothing of JAX inside the port
    tree = convert.tree_from_params_object(jp2)
    ckpt.save_model(tpath, "FourierGrid", convert.config_from_dict(dataclasses.asdict(jcfg2)),
                    convert.fourier_grid_params_from_numpy(tree, "cpu"), global_step=jstep)
    _, tcfg, tp, step, _ = ckpt.load_model(tpath)
    assert step == 11 and tp.k0.grid.dtype == torch.bfloat16
    np.testing.assert_array_equal(tp.mask_cache.mask.numpy(), np.asarray(jp.mask_cache.mask))
    assert tp.act_shift == pytest.approx(float(jp.act_shift))
    # all-true occupancy for the render itself (see the module's docstring)
    tp.mask_cache.mask[:] = True
    jp2 = jp2.replace(mask_cache=jp2.mask_cache.replace(mask=jnp.ones_like(jp2.mask_cache.mask)))
    poses, _, Ks = _views(1)
    jfwd = lambda aux, ro, rd, vd: jfg.forward(aux[0], jcfg2, ro, rd, vd, cache=aux[1])
    tfwd = lambda aux, ro, rd, vd: fg.forward(aux[0], tcfg, ro, rd, vd, cache=aux[1])
    want = jrenderer.render_image(jfwd, H, W, Ks[0], poses[0][:3, :4], chunk=CHUNK,
                                  aux=(jp2, jfg.build_render_cache(jp2, jcfg2)))
    got = renderer.render_image(tfwd, H, W, Ks[0], poses[0][:3, :4], chunk=CHUNK,
                                aux=(tp, fg.build_render_cache(tp, tcfg)), device="cpu")
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    # and back: the port's tree is what the JAX params take
    back = convert.params_to_numpy(tp)
    np.testing.assert_array_equal(back["k0"]["grid"],
                                  np.asarray(jp.k0.grid.astype(jnp.float32)))


def test_convert_refuses_what_the_port_lacks():
    """The converter carries the view grid and the appearance embeddings
    now; what it refuses is embeddings that are no [sample_num, dim]
    table."""
    _, jp, _, _ = make_pair()
    tree = convert.tree_from_params_object(jp)
    tree["img_embeddings"] = np.arange(6, dtype=np.float32).reshape(2, 3)
    tree["vd"] = {"grid": np.ones((1, 4, 4, 4, 3), np.float32), "xyz_min": (-1.0,) * 3,
                  "xyz_max": (1.0,) * 3, "num_freqs": 0}
    tp = convert.fourier_grid_params_from_numpy(tree, "cpu")
    back = convert.params_to_numpy(tp)
    np.testing.assert_array_equal(back["img_embeddings"], tree["img_embeddings"])
    np.testing.assert_array_equal(back["vd"]["grid"], tree["vd"]["grid"])
    tree["img_embeddings"] = np.zeros((2, 3, 1), np.float32)
    with pytest.raises(ValueError, match="img_embeddings"):
        convert.fourier_grid_params_from_numpy(tree, "cpu")


# ---------------------------------------------------------------------------
# run_train -> fine_last -> run_render, cam paths


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    exp_dir = str(tmp_path_factory.mktemp("exp"))
    cfg = _tiny_bicycle(4)
    cfg = dataclasses.replace(cfg, fine_model_and_render=dataclasses.replace(
        cfg.fine_model_and_render, color_budget=6))
    data = synthetic.orbit_scene(4, 16, 24, seed=0, n_test=2)
    xyz_min, xyz_max = loop.bbox_mod.compute_bbox_by_cam_frustrm(cfg, data, "FourierGrid",
                                                                 device="cpu")
    seed_fn = synthetic.occupancy_seed((xyz_min + xyz_max) / 2, (xyz_max - xyz_min) / 2)
    _, mcfg, params, _ = loop.run_train(cfg, data, seed=0, device="cpu", log_fn=lambda _: None,
                                        coarse_mask_fn=seed_fn, exp_dir=exp_dir)
    return cfg, data, exp_dir, mcfg, params


def test_run_train_saves_fine_last(trained):
    _, _, exp_dir, mcfg, params = trained
    family, cfg2, p2, step, _ = ckpt.load_model(os.path.join(exp_dir, "fine_last"))
    assert family == "FourierGrid" and step == 4 and cfg2 == mcfg
    assert cfg2.sample_budget == 16  # the true budget, not a deferral-zeroed one
    assert torch.equal(p2.k0.grid, params.k0.grid) and p2.k0.grid.dtype == torch.bfloat16
    assert torch.equal(p2.mask_cache.mask, params.mask_cache.mask)


def test_orbit_scene_held_out_views():
    base = synthetic.orbit_scene(4, 8, 12, seed=0)
    more = synthetic.orbit_scene(4, 8, 12, seed=0, n_test=2)
    assert list(more["i_train"]) == [0, 1, 2, 3] and list(more["i_test"]) == [4, 5]
    np.testing.assert_array_equal(more["images"][:4], base["images"])
    np.testing.assert_array_equal(more["poses"][:4], base["poses"])
    assert more["images"].shape == (6, 8, 12, 3) and len(base["i_test"]) == 0


@pytest.mark.parametrize("args", [{}, {"bake_render": True}, {"render_train": True,
                                                              "render_test": False}])
def test_run_render_on_cpu(trained, args):
    cfg, data, exp_dir, mcfg, _ = trained
    said = []
    build.reset_launch_counts()
    out = render.run_render(types.SimpleNamespace(chunk=CHUNK, **args), cfg, data, exp_dir,
                            device="cpu", log_fn=said.append)
    split, n = ("train", 4) if args.get("render_train") else ("test", 2)
    assert list(out) == [split]
    res = out[split]
    assert res["rgbs"].shape == (n, 16, 24, 3) and np.isfinite(res["rgbs"]).all()
    assert len(res["psnrs"]) == len(res["ssims"]) == n
    assert any(line.startswith("render cache: two-stage") for line in said)
    assert any(line.startswith(f"{split}: psnr") for line in said)
    assert ("baked render grids" in " ".join(said)) == bool(args.get("bake_render"))
    assert not build.LAUNCHES  # the CPU path runs the plain versions only


def test_run_render_dumps_images_and_video(trained, tmp_path):
    cfg, data, exp_dir, _, _ = trained
    data = dict(data, render_poses=data["poses"][:2])
    os.symlink(os.path.join(exp_dir, "fine_last"), tmp_path / "fine_last")
    args = types.SimpleNamespace(chunk=CHUNK, dump_images=True, render_video=True,
                                 render_test=False, render_video_factor=2)
    out = render.run_render(args, cfg, data, str(tmp_path), device="cpu", log_fn=lambda _: None)
    assert out["video"]["rgbs"].shape == (2, 8, 12, 3) and out["video"]["psnrs"] == []
    names = os.listdir(tmp_path)
    assert sorted(os.listdir(tmp_path / "render_video")) == [
        "000.png", "000_depth.png", "001.png", "001_depth.png"]
    # an mp4, or the PNG frames that stand in without a video backend
    assert any(n.startswith("render_video.") or n == "render_video_frames" for n in names)


def test_run_render_ft_path_and_refusals(trained, tmp_path, monkeypatch):
    cfg, data, exp_dir, _, _ = trained
    ns = types.SimpleNamespace
    # --auto_budget is ported: the budgets come from the scene's occupancy
    logs = []
    out = render.run_render(ns(chunk=CHUNK, ft_path=os.path.join(exp_dir, "fine_last"),
                               auto_budget=True), cfg, data, str(tmp_path), device="cpu",
                            log_fn=logs.append)
    assert out["test"]["rgbs"].shape[0] == 2 and any("auto budgets" in m for m in logs)
    # --constant_baked renders, through the cached forward it would take anyway
    logs = []
    out = render.run_render(ns(chunk=CHUNK, constant_baked=True), cfg, data, exp_dir,
                            device="cpu", log_fn=logs.append)
    assert out["test"]["rgbs"].shape[0] == 2 and any("--constant_baked" in m for m in logs)
    # --style_root is ported: the test views take the style image's colours
    style = np.random.default_rng(1).random((20, 30, 3)) * np.array([0.3, 0.6, 0.9])
    from PIL import Image

    Image.fromarray((style * 255).astype(np.uint8)).save(tmp_path / "7.jpg", quality=95)
    out = render.run_render(ns(chunk=CHUNK, style_root=str(tmp_path), style_id="7",
                               ft_path=os.path.join(exp_dir, "fine_last")), cfg, data,
                            str(tmp_path), device="cpu", log_fn=lambda _: None)
    from unboundednerfpytorch_tpu_torch.render import arf

    target = arf.load_style_img(str(tmp_path / "7.jpg"), 16, 24).reshape(-1, 3)
    got = out["test"]["rgbs"].reshape(-1, 3)
    np.testing.assert_allclose(got.mean(0), target.mean(0), atol=0.02)
    assert out["test"]["color_tf"].shape == (4, 4)
    assert (tmp_path / "style_image.png").is_file()
    # block checkpoints are ported: without fine_last (and fine_last_merged)
    # each block's fine_last_<b> renders its slice of the training views
    os.symlink(os.path.join(exp_dir, "fine_last"), tmp_path / "fine_last_0")
    out = render.run_render(ns(chunk=CHUNK), cfg, data, str(tmp_path), device="cpu",
                            log_fn=lambda _: None)
    assert [os.path.basename(p) for p in out["paths"]] == ["fine_last_0"]
    assert out["views"][0].tolist() == np.asarray(data["i_train"]).tolist()
    assert out["outs"][0]["rgbs"].shape[0] == len(data["i_train"])
    assert render.run_render_blocks(ns(), cfg, data, exp_dir, device="cpu") == {
        "paths": [], "views": [], "outs": []}
    # without a coarse_last the coarse export reads fine_last
    out = render.export_coarse_geometry(cfg, exp_dir, out_path=str(tmp_path / "vol.npz"),
                                        device="cpu", log_fn=lambda _: None)
    _, mcfg, params, _, _ = ckpt.load_model(os.path.join(exp_dir, "fine_last"))
    with np.load(out) as vol:
        assert vol["alpha"].shape == tuple(mcfg.world_size_density)
        assert vol["rgb"].shape == (*mcfg.world_size_rgb, 3)
        assert np.isfinite(vol["alpha"]).all() and (vol["rgb"] > 0).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render.run_render(ns(), cfg, data, exp_dir)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        renderer.render_viewpoints(None, data["poses"][:1], data["HW"][:1], data["Ks"][:1])


def test_constant_baked_render_matches_jax(trained, tmp_path, monkeypatch):
    """``--constant_baked`` on the trained FourierGrid, whose cache is
    two-stage (``sample_budget`` 16, ``fast_color_thres``, ``color_budget``
    6): the port's render program against the JAX command line's render
    program with the flag, which renders through its staged renderer of
    compile-time constant tables (``render/staged_const.py``, on the CPU),
    on the same checkpoint in the JAX layout. Rendered images and depths
    within 1e-5 (the render parity tolerance above). Both composite on the
    data's background (white: ``white_bkgd``), where the render without the
    flag composites on black, as the JAX package's does (ROADMAP C): the
    same depths, and images that differ by the background's share of each
    ray."""
    from unboundednerfpytorch_tpu import render as jrender
    from unboundednerfpytorch_tpu.configs import loader as jloader
    from unboundednerfpytorch_tpu.render import staged_const

    cfg, data, exp_dir, mcfg, params = trained
    assert mcfg.sample_budget > 0 and mcfg.fast_color_thres > 0 and mcfg.color_budget > 0
    ns = types.SimpleNamespace
    got = render.run_render(ns(chunk=CHUNK, constant_baked=True), cfg, data, exp_dir,
                            device="cpu", log_fn=lambda _: None)["test"]
    plain = render.run_render(ns(chunk=CHUNK), cfg, data, exp_dir, device="cpu",
                              log_fn=lambda _: None)["test"]
    ckpt.save_jax_model(str(tmp_path / "fine_last"), "FourierGrid", mcfg, params, global_step=4)
    staged, seen = [], []
    monkeypatch.setattr(staged_const, "make_staged_renderer", _spied(
        staged_const.make_staged_renderer, staged))
    monkeypatch.setattr(jrender, "render_viewpoints", _spied(jrender.render_viewpoints, seen))
    jcfg = jloader.load_config(str(ROOT / "configs" / "nerf_unbounded" / "bicycle_single.py"))
    jrender.run_render(ns(constant_baked=True), jcfg, data, str(tmp_path))
    assert staged and len(seen) == 1  # the staged renderer drew the test split
    want = seen[0]
    for key in ("rgbs", "depths"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=0, atol=1e-5,
                                   err_msg=key)
    np.testing.assert_array_equal(got["depths"], plain["depths"])
    assert cfg.data.white_bkgd and float((got["rgbs"] - plain["rgbs"]).min()) >= 0
    assert float((got["rgbs"] - plain["rgbs"]).max()) > 0.1


def _spied(fn, calls: list):
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        calls.append(out)
        return out
    return wrapped


def test_imprint_scene_makes_a_scene(trained):
    """The seeded geometry that the chip smoke run renders: rays that end on
    the ball, clear sky, and hazy rays that overflow the color budget."""
    _, data, exp_dir, _, _ = trained
    _, mcfg, params, _, _ = ckpt.load_model(os.path.join(exp_dir, "fine_last"))
    mcfg = dataclasses.replace(mcfg, fast_color_thres=1e-4)
    before = params.density.grid.detach().clone()
    synthetic.imprint_scene(params, mcfg.scene_center, mcfg.scene_radius, seed=0)
    assert not torch.equal(before[0], params.density.grid[0])
    assert torch.equal(before[1:], params.density.grid[1:])
    ro, rd, vd = loop.ray_ops.get_rays_of_a_view(
        16, 24, torch.as_tensor(data["Ks"][4]), torch.as_tensor(data["poses"][4][:3, :4]))
    with torch.no_grad():
        res = fg.forward(params, mcfg, ro.reshape(-1, 3), rd.reshape(-1, 3), vd.reshape(-1, 3),
                         cache=fg.build_render_cache(params, mcfg))
    opaque = res.alphainv_last < 0.01
    assert 20 < int(opaque.sum()) < 300 and int((res.alphainv_last > 0.99).sum()) > 20


def test_wrote_video_falls_back_to_frames(tmp_path, monkeypatch):
    import imageio.v2 as imageio

    def no_backend(*a, **k):
        raise ValueError("no video backend")

    monkeypatch.setattr(imageio, "mimwrite", no_backend)
    frames = np.zeros((3, 4, 6, 3), np.uint8)
    out = render.write_video(str(tmp_path / "v.mp4"), frames)
    assert out.endswith("v_frames") and len(os.listdir(out)) == 3


def test_cam_paths_match_jax(tmp_path):
    cfg = loader.load_config(str(ROOT / "configs" / "nerf_unbounded" / "bicycle_single.py"))
    from unboundednerfpytorch_tpu.configs import loader as jloader

    jcfg = jloader.load_config(str(ROOT / "configs" / "nerf_unbounded" / "bicycle_single.py"))
    data = synthetic.orbit_scene(12, 8, 12, seed=1)
    data["cam_idxs"] = [0, 0, 1] * 4
    kw = dict(straight_length=4, k_nearest=3, log_fn=lambda _: None)
    want = jcam.gen_cam_paths(jcfg, data, str(tmp_path / "jax"), **kw)
    got = cam_paths.gen_cam_paths(cfg, data, str(tmp_path / "port"), **kw)
    assert got == want
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for name in os.listdir(tmp_path / "port"):
        a, b = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        for key in b.files:
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5, atol=1e-5, err_msg=key)
    np.testing.assert_allclose(
        cam_paths.central_ray_dir(data["Ks"][0], data["poses"][0], 8, 12),
        jcam.central_ray_dir(data["Ks"][0], data["poses"][0], 8, 12))
    assert cam_paths.select_k_nearest_points(0, data["poses"][:, :3, 3], 2) == \
        jcam.select_k_nearest_points(0, data["poses"][:, :3, 3], 2)
