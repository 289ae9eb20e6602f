"""The port's CO3D loader against the JAX package on the CPU, on seeded
sequences in the CO3D layout (``data/synthetic.py::write_co3d_scene``:
``frame_annotations.jgz``, ``set_lists.json``, images and masks), and the
``configs/co3d/teddybear.py`` recipe through the command line.

Tolerances: none for the loader (every key of the data_dict equal, dtype
and values, and of ``load_co3d_data``'s own outputs); frames of two sizes
fail alike in both packages (the same exception type).
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest
import torch

from unboundednerfpytorch_tpu.configs import loader as jloader
from unboundednerfpytorch_tpu.data import common as jcommon
from unboundednerfpytorch_tpu.data import extra_loaders as jextra
from unboundednerfpytorch_tpu_torch.cli import main as cli
from unboundednerfpytorch_tpu_torch.configs import loader
from unboundednerfpytorch_tpu_torch.data import common, extra_loaders, synthetic
from unboundednerfpytorch_tpu_torch.ops import rays
from unboundednerfpytorch_tpu_torch.train import loop

ROOT = pathlib.Path(__file__).resolve().parents[1]


def write_config(tmp_path, scene: dict, **extra) -> str:
    lines = [f"_base_ = {str(ROOT / 'configs' / 'co3d' / 'teddybear.py')!r}",
             f"basedir = {str(tmp_path / 'logs')!r}",
             "data = dict(" + ", ".join(f"{k}={scene[k]!r}" for k in
                                        ("datadir", "annot_path", "split_path")) + ")"]
    lines += [f"{k} = {v!r}" for k, v in extra.items()]
    path = tmp_path / "teddybear.py"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_load_co3d_data_equals_jax(tmp_path):
    scene = synthetic.write_co3d_scene(str(tmp_path / "co3d"), n_frames=8, n_test=2, H=30,
                                       W=24, seed=3, empty_frames=2)
    args = [scene[k] for k in ("datadir", "annot_path", "split_path", "sequence_name")]
    got, want = extra_loaders.load_co3d_data(*args), jextra.load_co3d_data(*args)
    for g, w in zip(got[:3] + got[4:5] + got[5:6], want[:3] + want[4:5] + want[5:6]):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[6] == want[6] == [list(range(6)), [6, 7], [6, 7]]  # empty frames dropped
    assert np.asarray(got[0]).shape == (8, 30, 24, 3)


@pytest.mark.parametrize("white", [True, False])
def test_data_dict_equals_jax(tmp_path, white):
    scene = synthetic.write_co3d_scene(str(tmp_path / "co3d"), n_frames=6, n_test=2, H=20,
                                       W=26, seed=4)
    cfg_file = write_config(tmp_path, scene, **({} if white else {"data": dict(
        datadir=scene["datadir"], annot_path=scene["annot_path"],
        split_path=scene["split_path"], white_bkgd=False)}))
    got = common.load_everything(loader.load_config(cfg_file))
    want = jcommon.load_everything(jloader.load_config(cfg_file))
    assert got.keys() == want.keys()
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert got["near"] == 0.0 and got["images"].shape == (6, 20, 26, 3)


def test_frames_of_two_sizes_fail_as_in_jax(tmp_path):
    """Real CO3D frames may differ in size. ``load_co3d_data`` then returns
    object arrays in both packages, and their common loaders cannot cast
    them (ValueError): neither trains on such a sequence (ROADMAP queue C),
    and the port's ray store refuses mixed sizes anyway."""
    scene = synthetic.write_co3d_scene(str(tmp_path / "co3d"), n_frames=6, n_test=2,
                                       sizes=[(24, 20), (20, 24)], seed=5)
    args = [scene[k] for k in ("datadir", "annot_path", "split_path", "sequence_name")]
    imgs = extra_loaders.load_co3d_data(*args)[0]
    assert imgs.dtype == object and imgs.shape == (6,)
    assert jextra.load_co3d_data(*args)[0].dtype == object
    cfg_file = write_config(tmp_path, scene)
    with pytest.raises(ValueError):
        jcommon.load_everything(jloader.load_config(cfg_file))
    with pytest.raises(ValueError):
        common.load_everything(loader.load_config(cfg_file))
    dd = {"i_train": np.arange(2), "HW": np.array([[24, 20], [20, 24]])}
    with pytest.raises(ValueError, match="mixed"):
        loop.gather_training_rays(loader.load_config(cfg_file), dd, "cpu")


def test_the_config_rays_meet_the_object(tmp_path):
    """The writer's cameras, read back with the configs' inverse_y, flip_x
    and flip_y, look at the sphere at the origin: the centre pixel's ray
    passes within the sphere's radius of it."""
    scene = synthetic.write_co3d_scene(str(tmp_path / "co3d"), n_frames=4, n_test=1, H=20,
                                       W=16, seed=6)
    cfg = loader.load_config(write_config(tmp_path, scene))
    assert cfg.data.inverse_y and cfg.data.flip_x and cfg.data.flip_y
    dd = common.load_everything(cfg)
    for c2w, K in zip(dd["poses"], dd["Ks"]):
        ro, rd = rays.get_rays(20, 16, torch.as_tensor(K), torch.as_tensor(c2w[:3, :4]),
                               inverse_y=True, flip_x=True, flip_y=True)
        o, d = ro[10, 8].numpy(), rd[10, 8].numpy() / np.linalg.norm(rd[10, 8].numpy())
        assert np.linalg.norm(o - (o @ d) * d) < 0.8 and o @ d < 0  # the radius: 0.8


def test_teddybear_trains_and_renders_through_the_command_line(tmp_path, capsys):
    """co3d/teddybear.py at a small size: the DVGO coarse stage, the fine
    stage on the coarse geometry's box, the render of the test views."""
    scene = synthetic.write_co3d_scene(str(tmp_path / "co3d"), n_frames=8, n_test=2, H=24,
                                       W=20, seed=7)
    cfg_file = write_config(
        tmp_path, scene, coarse_train=dict(N_iters=4, N_rand=256),
        fine_train=dict(N_iters=4, N_rand=256, pg_scale=[2]),
        coarse_model_and_render=dict(num_voxels=10**3, num_voxels_base=10**3),
        fine_model_and_render=dict(num_voxels=12**3, num_voxels_base=12**3))
    cli.main(["--config", cfg_file, "--i_print", "1"], device="cpu")
    out = capsys.readouterr().out
    exp = tmp_path / "logs" / "dvgo_co3d_teddybear"
    for stage in ("coarse_last", "fine_last"):
        meta = json.load(open(exp / stage / "meta.json"))
        assert (meta["family"], meta["global_step"]) == ("dvgo", 4)
    assert "fine box from the coarse geometry" in out
    psnr = [float(line.split()[-1]) for line in out.splitlines() if line.startswith("test: psnr")]
    assert len(psnr) == 1 and np.isfinite(psnr[0])


@pytest.mark.parametrize("name", ["teddybear", "donut_369_40208_78816"])
def test_each_co3d_config_builds_its_two_stages(name):
    """Both CO3D scenes: the co3d loader with the pytorch3d ray flags, DVGO
    with a coarse stage; both stages' models build (small) in the port."""
    import dataclasses

    cfg = loader.load_config(str(ROOT / "configs" / "co3d" / f"{name}.py"))
    assert cfg.data.dataset_type == "co3d" and cfg.data.sequence_name
    assert cfg.data.annot_path.endswith("frame_annotations.jgz")
    assert cfg.coarse_train.N_iters > 0 and loop.model_family_name(cfg) == "dvgo"
    for model, train in ((cfg.coarse_model_and_render, cfg.coarse_train),
                         (cfg.fine_model_and_render, cfg.fine_train)):
        small = dataclasses.replace(model, num_voxels_rgb=12**3, num_voxels_density=12**3)
        fam, _, _ = loop.build_model(cfg, small, train, (-1.0,) * 3, (1.0,) * 3,
                                     torch.Generator().manual_seed(0), "cpu")
        assert fam == "dvgo"
