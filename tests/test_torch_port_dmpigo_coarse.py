"""The DMPIGO coarse stage of the ``custom/`` forward-facing configs
(``Madoka``, ``Otobai``, ``sm0*``) against the JAX package on the CPU.

The JAX ``run_train`` runs the coarse stage for any family, skips
``maskout_near_cam_vox``, the ``in_maskcache`` filter and ``pervoxel_lr``
outside DVGO (and FourierGrid, for the first), and hands
``dvgo.activate_density`` to ``compute_bbox_by_coarse_geo`` and to the fine
seed for DMPIGO parameters too: the per-plane ``act_shift`` [mpi_depth] is
added along the lattice's last axis. The port does the same; these tests
hold it there.

Small models: 20^3 voxels over 16 planes in a box of NDC's size, random
density N(0, 4^2) (N(-14, 4^2) for the seed) + the planes' bias.
Tolerances: the box to 1e-6; the seed's masks equal but for at most 0.1% of
the nodes (a pooled alpha at ``mask_cache_thres`` within rounding); alphas
to 1e-6.
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

from unboundednerfpytorch_tpu.configs.schema import ModelRenderConfig as JModelRenderConfig
from unboundednerfpytorch_tpu.models import dmpigo as jdmpigo
from unboundednerfpytorch_tpu.models import dvgo as jdvgo
from unboundednerfpytorch_tpu.ops import interp as jinterp
from unboundednerfpytorch_tpu.train import bbox as jbbox
from unboundednerfpytorch_tpu_torch import convert
from unboundednerfpytorch_tpu_torch.cli import main as cli
from unboundednerfpytorch_tpu_torch.configs import loader
from unboundednerfpytorch_tpu_torch.configs.schema import ModelRenderConfig
from unboundednerfpytorch_tpu_torch.data import synthetic
from unboundednerfpytorch_tpu_torch.models import dmpigo, dvgo
from unboundednerfpytorch_tpu_torch.ops import alpha as alpha_ops
from unboundednerfpytorch_tpu_torch.train import bbox, loop
from torch_threads import torch_threads  # noqa: F401: the workers' share of the cores

ROOT = pathlib.Path(__file__).resolve().parents[1]
CUSTOM = ["Madoka", "Madoka_long", "Otobai", "sm01_desktop", "sm02_multiple_desktop",
          "sm03_meeting"]
LO, HI = (-1.2, -0.9, -1.0), (1.1, 1.0, 1.0)
MODEL_KW = dict(num_voxels_density=20**3, num_voxels_rgb=20**3, mpi_depth=16,
                fast_color_thres=1e-3, rgbnet_dim=0)


@pytest.mark.parametrize("name", CUSTOM)
def test_the_custom_configs_run_a_dmpigo_coarse_stage(name):
    """Each is DMPIGO (NDC) with a coarse stage whose ``mpi_depth`` equals the
    fine stage's (128), so the seed's bias broadcasts plane for plane; the
    options the JAX package skips outside DVGO are on, and skipped."""
    cfg = loader.load_config(str(ROOT / "configs" / "custom" / f"{name}.py"))
    assert loop.model_family_name(cfg) == "dmpigo" and cfg.coarse_train.N_iters > 0
    cm, fm = cfg.coarse_model_and_render, cfg.fine_model_and_render
    assert cm.mpi_depth == fm.mpi_depth == 128
    assert cm.maskout_near_cam_vox and cfg.coarse_train.pervoxel_lr
    for model in (cm, fm):
        small = dataclasses.replace(model, num_voxels_rgb=16**3 * 8, num_voxels_density=16**3)
        fam, mcfg, params = loop.build_model(cfg, small, cfg.coarse_train, LO, HI,
                                             torch.Generator().manual_seed(0), "cpu")
        assert fam == "dmpigo" and mcfg.world_size[2] == 128


def make_pair(seed=0, lo=LO, hi=HI, offset=0.0, **overrides):
    kw = {**MODEL_KW, **overrides}
    jcfg = jdmpigo.config_from(JModelRenderConfig(**kw), lo, hi, kw["num_voxels_rgb"])
    tcfg = dmpigo.config_from(ModelRenderConfig(**kw), lo, hi, kw["num_voxels_rgb"])
    jp = jdmpigo.create(jcfg, jax.random.PRNGKey(seed))
    dgrid = np.random.default_rng(seed).standard_normal(jp.density.grid.shape) * 4.0 + offset
    jp = jp.replace(density=jp.density.replace(grid=jnp.asarray(dgrid, jnp.float32)))
    tp = convert.params_from_numpy("dmpigo", convert.tree_from_params_object(jp), "cpu")
    return jcfg, jp, tcfg, tp


def test_activate_density_gives_each_plane_its_own_bias():
    """On the coarse lattice [X, Y, D], ``dvgo.activate_density`` of DMPIGO
    parameters adds plane k's ``act_shift[k]`` to plane k (the bias the
    forward samples at that plane's z), over the interval
    ``voxel_size_ratio``: equal to JAX."""
    jcfg, jp, tcfg, tp = make_pair(seed=1)
    d = tp.density.grid[0, ..., 0].detach()
    got = dvgo.activate_density(tp, tcfg, d)
    want = np.asarray(jdvgo.activate_density(jp, jcfg, jnp.asarray(d.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    shift = tp.act_shift
    assert len(set(shift.tolist())) > 1
    for k in (0, 7, 15):
        plane = alpha_ops.raw2alpha(d[..., k], float(shift[k]), tcfg.voxel_size_ratio)
        np.testing.assert_array_equal(got[..., k].numpy(), plane.numpy())
    pts = torch.tensor([[[0.0, 0.0, LO[2] + (HI[2] - LO[2]) * k / 15]] for k in (0, 7, 15)])
    np.testing.assert_allclose(dmpigo.act_shift_at(tp, tcfg, pts)[:, 0].numpy(),
                               shift[[0, 7, 15]].numpy(), rtol=1e-6)


@pytest.mark.parametrize("thres", [1e-3, 0.9])
def test_the_coarse_box_matches_jax(thres):
    jcfg, jp, tcfg, tp = make_pair(seed=2)
    want = jbbox.compute_bbox_by_coarse_geo(
        jp, jcfg, lambda d: jdvgo.activate_density(jp, jcfg, d), thres)
    got = bbox.compute_bbox_by_coarse_geo(
        tp, tcfg, lambda d: dvgo.activate_density(tp, tcfg, d), thres)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)
    assert (np.asarray(got[1]) - np.asarray(got[0]) < np.asarray(HI) - np.asarray(LO)).any()


def jax_seed(jp, jcfg, ws, lo, hi, thres):
    """The JAX ``run_train``'s ``coarse_mask_fn`` (its closure, written out)."""
    axes = [jnp.linspace(mn, mx, int(n)) for mn, mx, n in zip(lo, hi, ws)]
    xyz = jnp.stack(jnp.meshgrid(*axes, indexing="ij"), -1)
    alpha = jdvgo.activate_density(jp, jcfg, jp.density(xyz)[..., 0])
    return np.asarray(jinterp.max_pool_3d_same(alpha) >= thres)


def test_the_fine_seed_matches_jax_and_takes_the_bias_by_plane_index():
    """The fine seed on a fine box inside the coarse one, [Xf, Yf, 16]: equal
    to the JAX seed. A fault of the reference, reproduced (ROADMAP queue C):
    the fine lattice's plane k takes the coarse plane k's bias, though it lies
    at another depth; the bias sampled at its depth gives other alphas."""
    jcfg, jp, tcfg, tp = make_pair(seed=3, offset=-14.0)
    lo, hi = (-0.8, -0.6, -0.7), (0.7, 0.8, 0.2)
    fine = dmpigo.config_from(ModelRenderConfig(**MODEL_KW), lo, hi, 30**3)
    ws = fine.world_size
    assert ws[2] == 16
    thres = 1e-3
    want = jax_seed(jp, jcfg, ws, lo, hi, thres)
    got = dvgo.coarse_mask_fn(tp.density, tp.act_shift, tcfg, thres)(ws, lo, hi).numpy()
    assert 0 < want.mean() < 1
    off = got != want
    assert off.mean() <= 1e-3, int(off.sum())
    # by index, not by depth
    axes = [torch.linspace(a, b, int(n)) for a, b, n in zip(lo, hi, ws)]
    dens = dvgo.density_on_lattice(tp.density, axes)
    by_index = alpha_ops.raw2alpha(dens, tp.act_shift, tcfg.voxel_size_ratio)
    xyz = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)
    by_depth = alpha_ops.raw2alpha(dens + dmpigo.act_shift_at(tp, tcfg, xyz.reshape(-1, 1, 3))
                                   .reshape(ws), 0.0, tcfg.voxel_size_ratio)
    np.testing.assert_allclose(dvgo.activate_density(tp, tcfg, dens).numpy(),
                               by_index.numpy(), rtol=0, atol=1e-7)
    assert (by_index - by_depth).abs().max() > 1e-3


def _forward_facing(tmp_path, n_views=8) -> str:
    data = synthetic.forward_facing_scene(n_views, 24, 32, seed=2)
    return synthetic.write_llff_scene(str(tmp_path / "Madoka" / "dense"), data, factor=2,
                                      bounds=(2.5, 9.0))


def test_run_train_skips_what_jax_skips_and_seeds_the_fine_stage(tmp_path, monkeypatch):
    """Madoka.py at a small size through ``run_train``: the coarse stage runs
    without maskout, the per-voxel lr or the filter; the fine stage trains on
    the coarse geometry's box, its cache seeded from the coarse alpha."""
    scene = _forward_facing(tmp_path)
    cfg_file = tmp_path / "madoka.py"
    cfg_file.write_text(
        f"_base_ = {str(ROOT / 'configs' / 'custom' / 'Madoka.py')!r}\n"
        f"basedir = {str(tmp_path / 'logs')!r}\ndata = dict(datadir={scene!r})\n"
        "coarse_train = dict(N_iters=6, N_rand=256)\n"
        "fine_train = dict(N_iters=3, N_rand=256, pg_scale=[2])\n"
        "coarse_model_and_render = dict(num_voxels=12**3 * 8, num_voxels_base=12**3 * 8, "
        "mpi_depth=16)\n"
        "fine_model_and_render = dict(num_voxels=16**3 * 8, num_voxels_base=16**3 * 8, "
        "mpi_depth=16, rgbnet_width=16)\n")
    from unboundednerfpytorch_tpu_torch.data import common

    cfg = loader.load_config(str(cfg_file))
    data = common.load_everything(cfg)
    calls = []
    for mod, name in ((dvgo, "maskout_near_cam_vox"), (dvgo, "voxel_count_views"),
                      (loop, "filter_in_maskcache")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: calls.append(_n))
    boxes, seeds = [], []
    geo = bbox.compute_bbox_by_coarse_geo
    monkeypatch.setattr(bbox, "compute_bbox_by_coarse_geo",
                        lambda *a: boxes.append(geo(*a)) or boxes[-1])
    seed_fn = dvgo.coarse_mask_fn
    monkeypatch.setattr(dvgo, "coarse_mask_fn",
                        lambda *a: (lambda *b: seeds.append(seed_fn(*a)(*b)) or seeds[-1]))
    fam, mcfg, params, _ = loop.run_train(cfg, data, device="cpu", log_fn=lambda _: None)
    assert fam == "dmpigo" and calls == [] and len(boxes) == len(seeds) == 1
    lo, hi = (np.asarray(x, np.float64) for x in boxes[0])
    shift = (hi - lo) * (cfg.fine_model_and_render.world_bound_scale - 1) / 2
    np.testing.assert_allclose(mcfg.xyz_min, lo - shift, rtol=1e-6)
    assert mcfg.world_size[2] == 16 and seeds[0].shape[2] == 16


def test_madoka_trains_and_renders_through_the_command_line(tmp_path, capsys):
    scene = _forward_facing(tmp_path)
    cfg_file = tmp_path / "madoka.py"
    cfg_file.write_text(
        f"_base_ = {str(ROOT / 'configs' / 'custom' / 'Madoka.py')!r}\n"
        f"basedir = {str(tmp_path / 'logs')!r}\ndata = dict(datadir={scene!r}, llffhold=4)\n"
        "coarse_train = dict(N_iters=3, N_rand=128)\n"
        "fine_train = dict(N_iters=3, N_rand=128)\n"
        "coarse_model_and_render = dict(num_voxels=8**3 * 8, num_voxels_base=8**3 * 8, "
        "mpi_depth=8)\n"
        "fine_model_and_render = dict(num_voxels=10**3 * 8, num_voxels_base=10**3 * 8, "
        "mpi_depth=8, rgbnet_width=16)\n")
    cli.main(["--config", str(cfg_file), "--i_print", "1"], device="cpu")
    out = capsys.readouterr().out
    exp = tmp_path / "logs" / "Madoka"
    for stage in ("coarse_last", "fine_last"):
        meta = json.load(open(exp / stage / "meta.json"))
        assert (meta["family"], meta["global_step"]) == ("dmpigo", 3)
    psnr = [float(line.split()[-1]) for line in out.splitlines() if line.startswith("test: psnr")]
    assert len(psnr) == 1 and np.isfinite(psnr[0])
