"""The Waymo and Mega-NeRF slice of the port against the JAX package, on the
CPU.

Captures are written by the port's seeded writers
(``data/synthetic.py::write_waymo_scene`` and ``write_mega_scene``): 12x16
views of the orbit scene, two cameras (73 and 74) with different focal
lengths and one image size, a diffusion-made replacement image, and for
mega one training view of another size.

- ``load_everything`` of both packages, with and without ``sample_cam``,
  ``sample_num`` / ``sample_interval``, ``training_ids`` (the names
  ``waymo_no_block.py`` keeps), the near/far overrides and ``--diffuse``:
  every key of the data_dict equal, exactly (both decode the same PNG
  files to the same bytes and run the same float64 numpy), dtypes too.
- ``bbox_waymo``, ``bbox_mega`` and the dispatch equal to the JAX package's
  to the bit.
- ``fourier_mse``: value and gradient against ``jnp.fft`` within 1e-6
  relative (float32, three-point transforms summed in another order).
- Three FourierGrid train steps on the waymo capture's rays with
  ``weight_freq=1.0``, ``weight_main=3.0`` and a 3-channel k0, from the same
  parameters on the same batches and backgrounds: every parameter within
  1e-4 relative / 2e-5 absolute of JAX's, the tolerance of
  ``test_torch_port_train.py``; the 3-channel k0 carried both ways.
- The command line on the CPU: ``train --diffuse --save_train_imgs`` then
  the render, whose test split is the generated trajectory: those views
  render without ground truth and get no PSNR, where the JAX package's
  ``images[i_test]`` raises; a mega capture likewise; ``--sample_num``
  reaches the loader.
"""

import argparse
import dataclasses
import json
import os
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unboundednerfpytorch_tpu.configs import loader as jloader
from unboundednerfpytorch_tpu.configs.schema import TrainStageConfig as JTrain
from unboundednerfpytorch_tpu.configs.schema import exp_config_from_dict as jax_cfg
from unboundednerfpytorch_tpu.data import common as jcommon
from unboundednerfpytorch_tpu.models import fourier_grid as jfg
from unboundednerfpytorch_tpu.ops import losses as jlosses
from unboundednerfpytorch_tpu.train import bbox as jbbox
from unboundednerfpytorch_tpu.train import step as jstep
from unboundednerfpytorch_tpu.utils import checkpoint as jckpt
from unboundednerfpytorch_tpu_torch import convert, render
from unboundednerfpytorch_tpu_torch.cli import main as cli
from unboundednerfpytorch_tpu_torch.configs import loader
from unboundednerfpytorch_tpu_torch.configs.schema import TrainStageConfig as TTrain
from unboundednerfpytorch_tpu_torch.configs.schema import exp_config_from_dict as port_cfg
from unboundednerfpytorch_tpu_torch.data import common, png, synthetic
from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
from unboundednerfpytorch_tpu_torch.ops import losses
from unboundednerfpytorch_tpu_torch.train import bbox, loop
from unboundednerfpytorch_tpu_torch.train import step as tstep
from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt
from test_torch_port_model import jax_params_to_numpy
from torch_threads import torch_threads  # noqa: F401: the workers' share of the cores

ROOT = pathlib.Path(__file__).resolve().parents[1]
H, W = 12, 16
N_CAM = 6  # views a camera; the last two of camera 74 are the val split


def _waymo_views():
    """12 views: camera 73 (focal 0.8 W), camera 74 (focal 0.9 W), one scene."""
    a = synthetic.orbit_scene(N_CAM, H, W, seed=2)
    b = synthetic.orbit_scene(N_CAM, H, W, seed=2, focal_scale=0.9)
    return {k: np.concatenate([a[k], b[k]]) for k in ("images", "poses", "Ks")}


AIRPLANE = np.full((H, W, 3), 0.25, np.float32)  # the diffusion-made image


@pytest.fixture(scope="module")
def waymo_scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("waymo"))
    return synthetic.write_waymo_scene(root, _waymo_views(), [73] * N_CAM + [74] * N_CAM,
                                       n_val=2, diffusion={"airplane": AIRPLANE})


@pytest.fixture(scope="module")
def mega_scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mega"))
    return synthetic.write_mega_scene(root, synthetic.orbit_scene(6, H, W, seed=4), n_val=2,
                                      odd=synthetic.orbit_scene(1, 8, 10, seed=5))


def _assert_same_data(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if np.isscalar(w) or w is None:
            assert g == w and type(g) is type(w), k
            continue
        assert np.asarray(g).dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=k)


DIFFUSION = dict(diff_root="diffusion", diff_replace={"73_1": "airplane"})
WAYMO_CASES = {
    "plain": ({}, {}),
    "sample_cam": ({"sample_cam": 74}, {}),
    "sample_num": ({"sample_interval": 2}, {"sample_num": 3}),
    "training_ids": ({"training_ids": [f"73_{i}" for i in range(50)]}, {}),
    "overrides": ({"near": 0.1, "far": 0.01, "near_clip": 0.1}, {}),
    "diffuse": ({}, {"diffuse": True}),
}


@pytest.mark.parametrize("case", sorted(WAYMO_CASES))
def test_waymo_load_everything_matches_jax(waymo_scene, case):
    data_kw, call_kw = WAYMO_CASES[case]
    cfg = {"data": dict(dataset_type="waymo", datadir=waymo_scene, inverse_y=True, **data_kw),
           "diffusion": DIFFUSION}
    got = common.load_everything(port_cfg(cfg), **call_kw)
    want = jcommon.load_everything(jax_cfg(cfg), **call_kw)
    _assert_same_data(got, want)
    n_train, n_val = len(got["i_train"]), len(got["i_val"])
    assert len(got["images"]) == n_train + n_val and len(got["i_test"]) == 200
    assert got["i_test"].max() >= len(got["images"])  # the trajectory has no images
    if case == "sample_cam":  # camera 74 only: its four training views
        assert n_train == 4 and np.allclose(got["Ks"][:4, 0, 0], 0.9 * W)
    elif case == "sample_num":  # views 0, 2, 4 of the sorted train split
        assert n_train == 3
    elif case == "training_ids":  # the camera-73 views only
        assert n_train == N_CAM and np.allclose(got["Ks"][:N_CAM, 0, 0], 0.8 * W)
    elif case == "overrides":
        assert (got["near"], got["far"], got["near_clip"]) == (0.1, 0.01, 0.1)
    else:
        assert n_train == 2 * N_CAM - 2
        np.testing.assert_allclose(np.unique(got["Ks"][:, 0, 0]), [0.8 * W, 0.9 * W], rtol=1e-6)
    plain = common.load_everything(port_cfg(cfg))
    swapped = [i for i in range(n_train) if not np.array_equal(got["images"][i],
                                                               plain["images"][i])]
    if case == "diffuse":  # exactly one training view became the replacement
        assert len(swapped) == 1
        np.testing.assert_array_equal(got["images"][swapped[0]],
                                      np.round(AIRPLANE * 255) / np.float32(255))


def test_the_unused_trajectory_and_resize_helpers_match_jax(waymo_scene):
    """What the JAX package keeps beside ``load_waymo_data`` and does not
    call (the straight trajectory, the resize, the hand-set poses) gives
    the same values in the port."""
    from unboundednerfpytorch_tpu.data import waymo as jwaymo
    from unboundednerfpytorch_tpu_torch.data import waymo

    meta = json.load(open(os.path.join(waymo_scene, "metadata.json")))
    tr = meta["train"]
    hw = [[h, w] for h, w in zip(tr["height"], tr["width"])]
    got = waymo.gen_straight_trajs(tr["cam2world"], hw, tr["K"], tr["cam_idx"], test_num=5)
    want = jwaymo.gen_straight_trajs(tr["cam2world"], hw, tr["K"], tr["cam_idx"], test_num=5)
    np.testing.assert_array_equal(np.stack(got[0]), np.stack(want[0]))
    assert got[1:] == want[1:]
    imgs = [np.random.default_rng(i).random((H, W, 3)).astype(np.float32) for i in range(2)]
    got = waymo.resize_imgs_to_common(hw[:1], hw[1:2], imgs, tr["K"][:1], tr["K"][1:2], factor=2)
    want = jwaymo.resize_imgs_to_common(hw[:1], hw[1:2], imgs, tr["K"][:1], tr["K"][1:2],
                                        factor=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    ids, pos, rot = ["73_0", "73_2"], {"73_2": [0.5, -1.0, 2.0]}, {"73_2": [10.0, 0.0, 5.0]}
    got = waymo.sample_metadata_by_training_ids(json.loads(json.dumps(meta)), ids, pos, rot)
    want = jwaymo.sample_metadata_by_training_ids(json.loads(json.dumps(meta)), ids, pos, rot)
    assert got == want and got["train"]["position"][1] == [0.5, -1.0, 2.0]


def test_mega_drops_the_view_of_another_size(mega_scene):
    cfg = {"data": dict(dataset_type="mega", datadir=mega_scene, inverse_y=True)}
    got = common.load_everything(port_cfg(cfg))
    _assert_same_data(got, jcommon.load_everything(jax_cfg(cfg)))
    meta = json.load(open(os.path.join(mega_scene, "metadata.json")))
    assert sorted(set(zip(meta["train"]["height"], meta["train"]["width"]))) == [(8, 10), (H, W)]
    assert len(meta["train"]["height"]) == 5 and len(got["i_train"]) == 4
    assert (got["HW"] == (H, W)).all() and len(got["i_test"]) == 100
    got3 = common.load_everything(port_cfg(cfg), sample_num=2)
    _assert_same_data(got3, jcommon.load_everything(jax_cfg(cfg), sample_num=2))
    assert len(got3["i_train"]) == 2 and len(got3["i_val"]) == 2


@pytest.mark.parametrize("layout", ["waymo", "mega"])
def test_camera_boxes_match_jax(layout, waymo_scene, mega_scene):
    scene = waymo_scene if layout == "waymo" else mega_scene
    cfg = {"data": dict(dataset_type=layout, datadir=scene, inverse_y=True,
                        unbounded_inner_r=0.8, boundary_ratio=0.05)}
    data = common.load_everything(port_cfg(cfg))
    got = bbox.compute_bbox_by_cam_frustrm(port_cfg(cfg), data, "FourierGrid", device="cpu")
    want = jbbox.compute_bbox_by_cam_frustrm(jax_cfg(cfg), data, "FourierGrid")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    poses = data["poses"][data["i_train"]]
    pairs = [(bbox.bbox_waymo(poses, 0.8), jbbox.bbox_waymo(poses, 0.8)),
             (bbox.bbox_waymo(poses, 1.0, 0.2, 0.1, 0.3),
              jbbox.bbox_waymo(poses, 1.0, 0.2, 0.1, 0.3)),
             (bbox.bbox_mega(poses, 0.8, 0.05), jbbox.bbox_mega(poses, 0.8, 0.05))]
    for got, want in pairs:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    lo, hi = bbox.bbox_waymo(poses, 1.0)  # at unbounded_inner_r=1 the cube holds every camera
    cams = poses[:, :3, 3]
    assert (lo <= cams.min(0)).all() and (hi >= cams.max(0)).all()


@pytest.mark.parametrize("shape", [(64, 3), (5, 7, 3), (9, 4)])
def test_fourier_mse_value_and_gradient_match_jax(shape):
    rng = np.random.default_rng(shape[0])
    pred, target = (rng.random(shape).astype(np.float32) for _ in range(2))
    want, want_g = jax.value_and_grad(jlosses.fourier_mse)(jnp.asarray(pred), jnp.asarray(target))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = losses.fourier_mse(p, torch.from_numpy(target))
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-9)
    assert float(losses.fourier_mse(torch.from_numpy(target), torch.from_numpy(target))) == 0.0


# ---------------------------------------------------------------------------
# the train step on the waymo capture

TRAIN = dict(N_rand=48, lrate_density=0.1, lrate_k0=0.1, lrate_rgbnet=1e-3, lrate_decay=20,
             weight_main=3.0, weight_freq=1.0, weight_entropy_last=1e-3, weight_rgbper=1e-2,
             weight_nearclip=0.0, weight_distortion=-1.0, tv_before=1000, tv_dense_before=1000,
             weight_tv_density=1e-2, weight_tv_k0=1e-3, skip_zero_grad_fields=("density", "k0"),
             pg_scale=())


def _waymo_pair(scene, seed=0):
    """(JAX config, JAX params, port config, port params, port data, the
    port's exp config) of waymo_no_block.py at 16^3 voxels, in float32,
    with random grids, in the capture's camera box."""
    path = str(ROOT / "configs" / "waymo" / "waymo_no_block.py")
    tcfg_all, jcfg_all = loader.load_config(path), jloader.load_config(path)
    small = dict(num_voxels_density=16**3, num_voxels_rgb=16**3, num_voxels_base_density=16**3,
                 num_voxels_base_rgb=16**3, rgbnet_width=16, grid_dtype="float32",
                 sample_budget=24)
    tfm = dataclasses.replace(tcfg_all.fine_model_and_render, **small)
    jfm = dataclasses.replace(jcfg_all.fine_model_and_render, **small)
    cfg = dataclasses.replace(tcfg_all, data=dataclasses.replace(tcfg_all.data, datadir=scene,
                                                                 training_ids=()))
    data = common.load_everything(cfg)
    lo, hi = bbox.compute_bbox_by_cam_frustrm(cfg, data, "FourierGrid")
    jcfg = jfg.config_from(jfm, lo, hi, 16**3, 16**3)
    tcfg = fg.config_from(tfm, lo, hi, 16**3, 16**3)
    assert tcfg.k0_dim == jcfg.k0_dim == 3
    rng = np.random.default_rng(seed)
    jp = jfg.create(jcfg, jax.random.PRNGKey(seed))
    jp = jp.replace(
        density=jp.density.replace(grid=jnp.asarray(
            rng.standard_normal(jp.density.grid.shape) * 4.0 - 4.0, jnp.float32)),
        k0=jp.k0.replace(grid=jnp.asarray(rng.standard_normal(jp.k0.grid.shape) * 0.5,
                                          jnp.float32)))
    tp = convert.fourier_grid_params_from_numpy(jax_params_to_numpy(jp), "cpu")
    return jcfg, jp, tcfg, tp, data, cfg


def test_three_waymo_train_steps_with_the_fourier_loss_match_jax(waymo_scene):
    jcfg, jp, tcfg, tp, data, cfg = _waymo_pair(waymo_scene)
    rays = loop.gather_training_rays(cfg, data, "cpu")
    jtrain, ttrain = JTrain(**TRAIN), TTrain(**TRAIN)

    def jfwd(params, ro, rd, vd, key, img_index=None):
        return jfg.forward(params, jcfg, ro, rd, vd, rand_bkgd_key=key)

    j_step = jax.jit(jstep.make_train_step(jfwd, jtrain, world_size_max=float(
        max(jcfg.world_size)), near_thres=0.0, lr_anchor=1))
    j_state = jstep.create_train_state(jp, jtrain)
    t_step = tstep.make_train_step(
        lambda p, ro, rd, vd, bg: fg.forward(p, tcfg, ro, rd, vd, bg_color=bg), ttrain,
        world_size_max=float(max(tcfg.world_size)), near_thres=0.0, lr_anchor=1)
    t_state = tstep.create_train_state(tp, ttrain)
    rng = np.random.default_rng(3)
    for s in range(3):
        sel = rng.choice(rays["rgb"].shape[0], TRAIN["N_rand"], replace=False)
        batch = {k: rays[k][sel].numpy() for k in ("rays_o", "rays_d", "viewdirs", "rgb")}
        key = jax.random.PRNGKey(50 + s)
        j_state, j_m = j_step(j_state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        bg = torch.from_numpy(np.array(jax.random.uniform(key, (TRAIN["N_rand"], 3))))
        t_m = t_step(t_state, {k: torch.from_numpy(v) for k, v in batch.items()}, bg)
        for name in ("loss", "mse", "loss_freq", "loss_entropy", "loss_rgbper", "lr_scale"):
            assert float(t_m[name]) == pytest.approx(float(j_m[name]), rel=1e-4, abs=1e-6), name
        assert float(t_m["loss_freq"]) > 0
    jparams = j_state.params
    pairs = [(t_state.params.density.grid, jparams.density.grid),
             (t_state.params.k0.grid, jparams.k0.grid)]
    pairs += [(lin.weight.T, w) for lin, w in zip(t_state.params.rgbnet.layers,
                                                   jparams.rgbnet.weights)]
    pairs += [(lin.bias, b) for lin, b in zip(t_state.params.rgbnet.layers, jparams.rgbnet.biases)]
    for got, want in pairs:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=2e-5)
    assert t_state.params.k0.grid.shape[-1] == 3


def test_a_three_channel_k0_converts_both_ways(tmp_path, waymo_scene):
    """JAX params -> port -> the port's checkpoint -> port -> JAX layout, to
    the bit; the port's model_kwargs build the JAX config, and the JAX
    package's checkpoint loads in the port."""
    jcfg, jp, tcfg, tp, _, _ = _waymo_pair(waymo_scene, seed=6)
    path = str(tmp_path / "fine_last")
    ckpt.save_model(path, "FourierGrid", tcfg, tp, global_step=2)
    fam, tcfg2, tp2, step, _ = ckpt.load_model(path)
    assert (fam, step, tcfg2, tp2.k0.grid.shape[-1]) == ("FourierGrid", 2, tcfg, 3)
    back, want = convert.params_to_numpy(tp2), jax_params_to_numpy(jp)
    for name in ("density", "k0"):
        np.testing.assert_array_equal(back[name]["grid"], np.asarray(want[name]["grid"]))
    for a, b in zip(back["rgbnet"]["weights"] + back["rgbnet"]["biases"],
                    want["rgbnet"]["weights"] + want["rgbnet"]["biases"]):
        np.testing.assert_array_equal(a, b)
    assert jckpt._cfg_from_jsonable("FourierGrid", convert.config_to_dict(tcfg2)) == jcfg
    jpath = str(tmp_path / "jax_last")
    jckpt.save_model(jpath, "FourierGrid", jcfg, jp, global_step=5)
    _, _, jp2, _, _ = jckpt.load_model(jpath)
    tp3 = convert.fourier_grid_params_from_numpy(convert.tree_from_params_object(jp2), "cpu")
    np.testing.assert_array_equal(tp3.k0.grid.detach().numpy(), np.asarray(jp.k0.grid))


# ---------------------------------------------------------------------------
# the command line


def _config(path, base, scene, logs, extra=""):
    path.write_text(f"""
_base_ = {str(ROOT / 'configs' / base)!r}
expname = 'tiny'
basedir = {str(logs)!r}
data = dict(datadir={str(scene)!r}{extra})
fine_train = dict(N_iters=4, N_rand=128, pg_scale=[2, 3])
fine_model_and_render = dict(num_voxels_density=16**3, num_voxels_base_density=16**3,
    num_voxels_rgb=16**3, num_voxels_base_rgb=16**3, sample_budget=24)
diffusion = dict(diff_root='diffusion', diff_replace={{'73_1': 'airplane'}})
""")
    return str(path)


N_TRAJECTORY = 2  # trajectory views the command-line tests render


@pytest.fixture
def cut_trajectory(monkeypatch):
    """``load_everything`` as the command line calls it, its test split cut
    to the val views and the first ``N_TRAJECTORY`` trajectory views (a
    render of all 200 would take a minute on the CPU); records the calls."""
    real, calls = common.load_everything, []

    def cut(cfg, **kw):
        d = real(cfg, **kw)
        d["i_test"] = np.concatenate([d["i_val"], d["i_test"][:N_TRAJECTORY]])
        calls.append((kw, d))
        return d

    monkeypatch.setattr(common, "load_everything", cut)
    renders = []
    real_render = render.run_render

    def spy(*args, **kw):
        out = real_render(*args, **kw)
        renders.append(out)
        return out

    monkeypatch.setattr(render, "run_render", spy)
    return calls, renders


def test_waymo_trains_with_diffuse_and_renders_its_trajectory(tmp_path, waymo_scene, capsys,
                                                             cut_trajectory):
    calls, renders = cut_trajectory
    cfg = _config(tmp_path / "cfg.py", "waymo/waymo_no_block.py", waymo_scene, tmp_path / "logs")
    assert cli.main(["--config", cfg, "--i_print", "1", "--diffuse", "--save_train_imgs"],
                    device="cpu") == 0
    (kw, data), = calls
    assert kw == {"sample_num": -1, "diffuse": True}
    # training_ids keep camera 73's training views, 73_1 replaced by the airplane
    assert len(data["i_train"]) == N_CAM
    saved = [png.imread(str(tmp_path / "logs" / "tiny" / "train_imgs" / f"{i:04d}.png"))
             for i in data["i_train"]]
    assert sum(np.array_equal(im, np.full((H, W, 3), 64, np.uint8)) for im in saved) == 1
    out = renders[-1]["test"]
    n_val = len(data["i_val"])
    assert out["rgbs"].shape == (n_val + N_TRAJECTORY, H, W, 3) and np.isfinite(out["rgbs"]).all()
    assert len(out["psnrs"]) == n_val and np.isfinite(out["psnrs"]).all()
    printed = capsys.readouterr().out
    assert "train finished" in printed and "test: psnr" in printed
    # the JAX package's run_render indexes images[i_test]: the trajectory's
    # indices lie past the end of its images
    jdata = jcommon.load_everything(jax_cfg({"data": dict(dataset_type="waymo",
                                                          datadir=waymo_scene)}))
    assert jdata["i_test"].max() >= len(jdata["images"])
    with pytest.raises(IndexError):
        np.asarray(jdata["images"])[jdata["i_test"]]


def test_mega_trains_and_renders_with_sample_num(tmp_path, mega_scene, capsys, cut_trajectory):
    calls, renders = cut_trajectory
    cfg = _config(tmp_path / "cfg.py", "mega/building.py", mega_scene, tmp_path / "logs")
    assert cli.main(["--config", cfg, "--i_print", "1", "--sample_num", "3"], device="cpu") == 0
    (kw, data), = calls
    assert kw == {"sample_num": 3, "diffuse": False} and len(data["i_train"]) == 3
    out = renders[-1]["test"]
    assert out["rgbs"].shape == (len(data["i_val"]) + N_TRAJECTORY, H, W, 3)
    assert len(out["psnrs"]) == len(data["i_val"]) and np.isfinite(out["rgbs"]).all()


def test_a_trajectory_alone_renders_without_metrics(tmp_path, waymo_scene, capsys):
    """Every test view past ``images``: no PSNR at all, nothing raised."""
    cfg_file = _config(tmp_path / "cfg.py", "waymo/waymo_no_block.py", waymo_scene,
                       tmp_path / "logs")
    cfg = loader.load_config(cfg_file)
    data = common.load_everything(cfg)
    loop.run_train(cfg, data, seed=0, device="cpu", log_fn=lambda _: None,
                   exp_dir=str(tmp_path / "logs" / "tiny"))
    data["i_test"] = data["i_test"][:2]
    out = render.run_render(argparse.Namespace(), cfg, data, str(tmp_path / "logs" / "tiny"),
                            device="cpu", log_fn=lambda _: None)["test"]
    assert out["rgbs"].shape == (2, H, W, 3) and out["psnrs"] == [] and out["ssims"] == []

