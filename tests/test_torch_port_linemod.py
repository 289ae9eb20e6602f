"""The port's LINEMOD path against the JAX package on the CPU: the loader
on a seeded sequence in the pvnet layout (``data/synthetic.py::
write_linemod_scene``), the pose metrics of ``utils/pose_eval.py``, and the
``configs/linemod/ape.py`` recipe through the command line (``train``, then
``--program tune_pose`` and ``--program linemod_eval``).

Tolerances: none for the data_dict (every key equal, dtype and values) nor
for the metrics (the same numpy on the same arrays: the summaries equal);
the PLY reader's points equal.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from unboundednerfpytorch_tpu.cli import main as jax_cli
from unboundednerfpytorch_tpu.configs import loader as jloader
from unboundednerfpytorch_tpu.data import common as jcommon
from unboundednerfpytorch_tpu.ops import rays as jrays
from unboundednerfpytorch_tpu.utils import pose_eval as jpose_eval
from unboundednerfpytorch_tpu_torch.cli import main as cli
from unboundednerfpytorch_tpu_torch.configs import loader
from unboundednerfpytorch_tpu_torch.data import common, synthetic
from unboundednerfpytorch_tpu_torch.ops import rays
from unboundednerfpytorch_tpu_torch.utils import pose_eval

ROOT = pathlib.Path(__file__).resolve().parents[1]


def write_config(tmp_path, crop=True, **extra) -> str:
    synthetic.write_linemod_scene(str(tmp_path / "linemod"), n_frames=10, n_test=3, seed=4)
    lines = [f"_base_ = {str(ROOT / 'configs' / 'linemod' / 'ape.py')!r}",
             f"basedir = {str(tmp_path / 'logs')!r}",
             f"data = dict(datadir={str(tmp_path / 'linemod')!r}"
             + ("" if crop else ", width_max=-1, height_max=-1") + ")"]
    lines += [f"{k} = {v!r}" for k, v in extra.items()]
    path = tmp_path / "ape.py"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("crop", [True, False])
def test_loader_data_dict_equals_jax(tmp_path, crop):
    cfg_file = write_config(tmp_path, crop=crop)
    got = common.load_everything(loader.load_config(cfg_file))
    want = jcommon.load_everything(jloader.load_config(cfg_file))
    assert got.keys() == want.keys() and "object_poses" in got
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    hw = (90, 90) if crop else (480, 640)
    assert got["images"].shape == (10, *hw, 3) and len(got["i_test"]) == 3
    # the object sits in every crop: composited on white outside its mask
    assert (got["images"] < 0.99).any(axis=(1, 2, 3)).all()
    rt = np.eye(4)
    rt[:3] = got["object_poses"][0]
    pose = np.eye(4)
    pose[:3] = got["poses"][0]
    np.testing.assert_allclose(pose @ rt, np.eye(4), atol=1e-5)


def test_linemod_rays_look_away_from_the_object(tmp_path):
    """A fault of the reference, reproduced (ROADMAP queue C): the loader
    hands the OpenCV camera poses of a LINEMOD sequence (the object ahead at
    +z) to rays made in the OpenGL convention (the configs set no
    ``inverse_y``), so the centre ray of every view points away from the
    object, in both packages."""
    cfg = loader.load_config(write_config(tmp_path))
    assert not cfg.data.inverse_y
    dd = common.load_everything(cfg)
    for c2w, K in zip(dd["poses"], dd["Ks"]):
        _, want, _ = jrays.get_rays_of_a_view(90, 90, K, c2w)
        _, got, _ = rays.get_rays_of_a_view(90, 90, torch.from_numpy(K), torch.from_numpy(c2w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        assert got[45, 45].numpy() @ -c2w[:3, 3] < 0  # the object lies behind


def test_pose_metrics_equal_jax():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.05, 0.05, size=(64, 3))
    gts, preds = [], []
    for i in range(12):
        R = np.linalg.qr(rng.standard_normal((3, 3)))[0]
        R *= np.sign(np.linalg.det(R))
        gt = np.concatenate([R, np.array([[0.01 * i], [0.0], [0.6]])], axis=1)
        pred = gt.copy()
        pred[:, 3] += rng.normal(0, 0.01 * (i % 4), 3)
        gts.append(gt)
        preds.append(pred)
    for name in ("ape", "eggbox"):  # eggbox is symmetric: ADD-S
        got = pose_eval.evaluate_linemod_sequence(name, pts, np.stack(preds), np.stack(gts))
        want = jpose_eval.evaluate_linemod_sequence(name, pts, np.stack(preds), np.stack(gts))
        # mask_ap is nan in both (no mask scored): compared as JSON
        assert json.dumps(got) == json.dumps(want) and 0 < got["add"] < 1
    ok = pose_eval.evaluate_linemod_sequence("ape", pts, np.stack(gts), np.stack(gts))
    assert all(ok[k] == 1.0 for k in ("proj2d", "add", "add2", "add5", "cmd5"))
    assert pose_eval.LINEMOD_K.tolist() == jpose_eval.LINEMOD_K.tolist()
    assert pose_eval.LINEMOD_DIAMETERS == jpose_eval.LINEMOD_DIAMETERS
    assert pose_eval.LINEMOD_CLASSES == jpose_eval.LINEMOD_CLASSES


@pytest.mark.parametrize("fmt", ["ascii", "binary"])
def test_ply_reader_equals_jax(tmp_path, fmt):
    path = tmp_path / "m.ply"
    pts = np.random.default_rng(2).standard_normal((5, 3)).astype(np.float32)
    head = (f"ply\nformat {'ascii' if fmt == 'ascii' else 'binary_little_endian'} 1.0\n"
            "element vertex 5\nproperty float x\nproperty float y\nproperty float z\n"
            "property uchar red\nend_header\n")
    if fmt == "ascii":
        path.write_text(head + "".join(f"{a} {b} {c} 7\n" for a, b, c in pts))
    else:
        rows = np.zeros(5, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1")])
        rows["x"], rows["y"], rows["z"] = pts.T
        path.write_bytes(head.encode() + rows.tobytes())
    got = pose_eval._read_ply_points(str(path))
    np.testing.assert_array_equal(got, jpose_eval._read_ply_points(str(path)))
    np.testing.assert_allclose(got, pts, rtol=1e-6)


def test_ape_trains_tunes_and_is_evaluated_through_the_command_line(tmp_path, capsys):
    """linemod/ape.py at a small size: ``train`` (fine-only DVGO on the
    host store, the render of the test views), ``--program tune_pose``
    (writes tuned_poses.npy), then ``--program linemod_eval`` in its
    sanity mode (every metric 1.0, the JAX program's summary to the bit) and
    with perturbed predictions (the scores fall, equal to JAX's)."""
    cfg_file = write_config(
        tmp_path, fine_train=dict(N_iters=3, N_rand=256, pg_scale=[2]),
        fine_model_and_render=dict(num_voxels=12**3, num_voxels_base=12**3))
    cfg = loader.load_config(cfg_file)
    assert cfg.data.load2gpu_on_the_fly and cfg.coarse_train.N_iters == 0
    cli.main(["--config", cfg_file, "--i_print", "1"], device="cpu")
    exp = tmp_path / "logs" / "fouriergrid_ape"
    assert json.load(open(exp / "fine_last" / "meta.json"))["global_step"] == 3
    cli.main(["--config", cfg_file, "--program", "tune_pose", "--tune_steps", "2"],
             device="cpu")
    tuned = np.load(exp / "tuned_poses.npy")
    assert tuned.shape == (7, 3, 4) and np.isfinite(tuned).all()
    capsys.readouterr()
    cli.main(["--config", cfg_file, "--program", "linemod_eval"], device="cpu")
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(got[k] == 1.0 for k in ("proj2d", "add", "add2", "add5", "cmd5"))
    jax_cli.main(["--config", cfg_file, "--program", "linemod_eval"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert json.dumps(got) == json.dumps(want)
    dd = common.load_everything(cfg)
    gts = dd["object_poses"][dd["i_test"]]
    bad = gts.copy()
    bad[:, :, 3] += np.array([0.0, 0.004, 0.03])[:, None]  # the last two fail 5 cm or ADD
    np.save(tmp_path / "preds.npy", bad)
    for run in (lambda a: cli.main(a, device="cpu"), jax_cli.main):
        run(["--config", cfg_file, "--program", "linemod_eval", "--pose_preds",
             str(tmp_path / "preds.npy")])
    lines = capsys.readouterr().out.strip().splitlines()
    got, want = json.loads(lines[0]), json.loads(lines[-1])
    assert json.dumps(got) == json.dumps(want) and got["add"] < 1.0 and got["proj2d"] < 1.0


LINEMOD = sorted(p.stem for p in (ROOT / "configs" / "linemod").glob("*.py")
                 if p.stem != "linemod_default")


def test_the_list_is_the_13_linemod_configs():
    assert len(LINEMOD) == 13 and "ape" in LINEMOD


@pytest.mark.parametrize("name", LINEMOD)
def test_each_linemod_config_builds_its_model(name):
    """Each object's config: the linemod loader with its crop, the host
    store, a fine-only DVGO; its model builds (small) in the port."""
    import torch

    from unboundednerfpytorch_tpu_torch.train import loop

    cfg = loader.load_config(str(ROOT / "configs" / "linemod" / f"{name}.py"))
    assert cfg.data.dataset_type == "linemod" and cfg.data.seq_name == name
    assert cfg.data.width_max > 0 and cfg.data.height_max > 0
    assert cfg.data.load2gpu_on_the_fly and cfg.coarse_train.N_iters == 0
    assert loop.model_family_name(cfg) == "dvgo"
    small = dataclasses.replace(cfg.fine_model_and_render, num_voxels_rgb=12**3,
                                num_voxels_density=12**3)
    fam, mcfg, params = loop.build_model(cfg, small, cfg.fine_train, (-1.0,) * 3, (1.0,) * 3,
                                         torch.Generator().manual_seed(0), "cpu")
    assert fam == "dvgo" and params.k0.grid.shape[-1] == 12
