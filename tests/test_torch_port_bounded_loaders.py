"""The port's bounded-scene loaders (blender, nsvf, blendedmvs, deepvoxels),
the DVGO configs they serve, and the two-stage recipe through the command
line, on the CPU.

- ``load_everything`` on seeded captures in each layout
  (``data/synthetic.py::write_{blender,nsvf,blendedmvs,deepvoxels}_scene``)
  equals the JAX package's: every key without a tolerance, dtypes too
  (blender with ``half_res`` and with ``testskip``, DeepVoxels with
  ``testskip``; its poses, written with the OpenCV flip, come back as the
  scene's).
- The 35 DVGO configs of ``nerf/`` (but ``ship.tensorf.py``), ``tiny/``,
  ``nsvf/``, ``deepvoxels/``, ``blendedmvs/`` and ``tankstemple/<Scene>{,_lg}``
  load through the port's ``configs.loader`` and build their coarse and fine
  models (at 16^3 voxels).
- ``train`` (coarse stage, then fine stage) -> ``render`` -> ``--program
  export_coarse`` through ``cli.main.main([...], device="cpu")`` on a blender
  capture, at 16^3 / 20^3 voxels and a few steps.
- A run stopped inside the coarse stage resumes there from ``coarse_last``
  and finishes the fine stage with the parameters of the run that was not
  stopped, to the bit.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from unboundednerfpytorch_tpu.configs.schema import exp_config_from_dict as jax_cfg
from unboundednerfpytorch_tpu.data import common as jcommon
from unboundednerfpytorch_tpu_torch.cli import main as cli
from unboundednerfpytorch_tpu_torch.configs import loader
from unboundednerfpytorch_tpu_torch.configs.schema import exp_config_from_dict as port_cfg
from unboundednerfpytorch_tpu_torch.data import common, synthetic
from unboundednerfpytorch_tpu_torch.train import loop
from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt
from torch_threads import torch_threads  # noqa: F401: the workers' share of the cores

ROOT = pathlib.Path(__file__).resolve().parents[1]
H, W = 12, 16


def _views(alpha: bool = True) -> dict:
    """8 training views and 4 held out: 2 val, 2 test."""
    data = synthetic.orbit_scene(8, H, W, seed=3, n_test=4, cam_radius=4.0, alpha=alpha)
    data["i_val"], data["i_test"] = data["i_test"][:2], data["i_test"][2:]
    return data


CASES = {
    "blender": ("blender", {}),
    "blender_half_res": ("blender", dict(half_res=True)),
    "blender_testskip": ("blender", dict(testskip=2)),
    "nsvf": ("nsvf", dict(inverse_y=True)),
    "blendedmvs": ("blendedmvs", dict(inverse_y=True)),
    "deepvoxels": ("deepvoxels", dict(sequence_name="vase")),
    "deepvoxels_testskip": ("deepvoxels", dict(sequence_name="vase", testskip=2)),
}


def _write(layout: str, root: str, data: dict) -> None:
    if layout == "blender":
        synthetic.write_blender_scene(root, data)
    elif layout == "nsvf":
        synthetic.write_nsvf_scene(root, data)
    elif layout == "blendedmvs":
        synthetic.write_blendedmvs_scene(root, data)
    else:
        synthetic.write_deepvoxels_scene(root, data, scene="vase")


@pytest.mark.parametrize("case", list(CASES))
def test_load_everything_matches_jax(tmp_path, case):
    layout, extra = CASES[case]
    data = _views()
    _write(layout, str(tmp_path), data)
    cfg = {"data": dict(dataset_type=layout, datadir=str(tmp_path), white_bkgd=True, **extra)}
    got = common.load_everything(port_cfg(cfg))
    want = jcommon.load_everything(jax_cfg(cfg))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if np.isscalar(w) or w is None:
            assert g == w and type(g) is type(w), k
            continue
        assert np.asarray(g).dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=k)
    skip = extra.get("testskip", 1)
    assert (len(got["i_train"]), len(got["i_test"])) == (8, 2 // skip)
    hw = (H // 2, W // 2) if extra.get("half_res") else (H, W)
    assert got["images"].shape[1:] == (*hw, 3)
    if layout == "deepvoxels":  # written with the OpenCV flip, read back with it
        order = np.concatenate([data["i_train"], data["i_val"][::skip], data["i_test"][::skip]])
        np.testing.assert_array_equal(got["poses"], np.asarray(data["poses"])[order])
    if layout == "blender":
        assert len(got["render_poses"]) == 160 and (got["near"], got["far"]) == (2.0, 6.0)


def test_pose_spherical_matches_jax():
    from unboundednerfpytorch_tpu.data import loaders as jloaders
    from unboundednerfpytorch_tpu_torch.data import loaders

    for args in ((30.0, -30.0, 4.0, False), (-170.0, 12.5, 2.7, True)):
        got, want = loaders.pose_spherical(*args), jloaders.pose_spherical(*args)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the 35 configs

CONFIGS = [f"nerf/{s}.py" for s in ("chair", "drums", "ficus", "hotdog", "lego", "materials",
                                     "mic", "ship")]
CONFIGS += ["tiny/lego_tiny.py"]
CONFIGS += [f"nsvf/{s}.py" for s in ("Bike", "Lifestyle", "Palace", "Robot", "Spaceship",
                                     "Steamtrain", "Toad", "Wineholder")]
CONFIGS += [f"deepvoxels/{s}.py" for s in ("armchair", "cube", "greek", "vase")]
CONFIGS += [f"blendedmvs/{s}.py" for s in ("Character", "Fountain", "Jade", "Statues")]
CONFIGS += [f"tankstemple/{s}{lg}.py" for s in ("Barn", "Caterpillar", "Family", "Ignatius",
                                                "Truck") for lg in ("", "_lg")]


def test_the_list_is_the_35_dvgo_configs():
    names = [str(p.relative_to(ROOT / "configs"))
             for d in ("nerf", "tiny", "nsvf", "deepvoxels", "blendedmvs")
             for p in (ROOT / "configs" / d).glob("*.py")]
    names += [str(p.relative_to(ROOT / "configs"))
              for p in (ROOT / "configs" / "tankstemple").glob("[A-Z]*.py")]
    names.remove("nerf/ship.tensorf.py")  # TensoRFGrid: test_torch_port_tensorf.py
    assert sorted(names) == sorted(CONFIGS) and len(CONFIGS) == 35


@pytest.mark.parametrize("name", CONFIGS)
def test_the_dvgo_configs_build_their_coarse_and_fine_models(name):
    cfg = loader.load_config(str(ROOT / "configs" / name))
    assert loop.model_family_name(cfg) == "dvgo" and cfg.coarse_train.N_iters > 0
    assert cfg.coarse_train.ray_sampler == "random" and cfg.coarse_train.pervoxel_lr
    assert cfg.fine_train.ray_sampler == "in_maskcache"
    assert cfg.coarse_model_and_render.maskout_near_cam_vox
    lo, hi = (-1.0, -1.2, -0.8), (1.0, 1.1, 0.9)
    for model, train, k0 in ((cfg.coarse_model_and_render, cfg.coarse_train, 3),
                             (cfg.fine_model_and_render, cfg.fine_train, 12)):
        small = dataclasses.replace(model, num_voxels_rgb=16**3, num_voxels_density=16**3)
        fam, mcfg, params = loop.build_model(cfg, small, train, lo, hi,
                                             torch.Generator().manual_seed(0), "cpu")
        assert fam == "dvgo" and loop.family_of(mcfg) == "dvgo"
        assert params.k0.grid.shape[-1] == k0 and params.k0.grid.dtype == torch.float32
        assert (params.rgbnet is None) == (k0 == 3)
    if name.startswith("tankstemple/"):
        assert cfg.data.load2gpu_on_the_fly and cfg.coarse_train.pervoxel_lr_downrate == 2
        want = 256**3 if name.endswith("_lg.py") else 160**3
        assert cfg.fine_model_and_render.num_voxels_rgb == want


def test_ship_tensorf_names_a18c():
    """ship.tensorf.py, which waited for ROADMAP A18c, builds TensoRF
    fields of its n_comp (8 for the density, 24 for k0's 12 channels)."""
    cfg = loader.load_config(str(ROOT / "configs" / "nerf" / "ship.tensorf.py"))
    small = dataclasses.replace(cfg.fine_model_and_render, num_voxels_rgb=16**3,
                                num_voxels_density=16**3)
    fam, mcfg, params = loop.build_model(cfg, small, cfg.fine_train, (-1.0,) * 3, (1.0,) * 3,
                                         torch.Generator().manual_seed(0), "cpu")
    assert fam == "dvgo" and mcfg.density_type == mcfg.k0_type == "TensoRFGrid"
    assert params.density.xy_plane.shape[-1] == 8 and params.density.f_vec is None
    assert params.k0.f_vec.shape == (72, 12)


# ---------------------------------------------------------------------------
# the two-stage recipe


def _capture(tmp_path) -> str:
    data = synthetic.orbit_scene(10, 24, 24, seed=5, n_test=4, cam_radius=4.0,
                                 focal_scale=1.39, alpha=True)
    data["i_val"], data["i_test"] = data["i_test"][:2], data["i_test"][2:]
    return synthetic.write_blender_scene(str(tmp_path / "lego"), data)


def _config(tmp_path, scene, coarse_steps=4, fine_steps=4) -> str:
    path = tmp_path / "cfg.py"
    path.write_text(f"""
_base_ = {str(ROOT / 'configs' / 'nerf' / 'lego.py')!r}
expname = 'tiny'
basedir = {str(tmp_path / 'logs')!r}
data = dict(datadir={scene!r})
coarse_train = dict(N_iters={coarse_steps}, N_rand=256)
coarse_model_and_render = dict(num_voxels=16**3, num_voxels_base=16**3)
fine_train = dict(N_iters={fine_steps}, N_rand=128, pg_scale=[2, 3])
fine_model_and_render = dict(num_voxels=20**3, num_voxels_base=20**3, rgbnet_width=16)
""")
    return str(path)


def test_train_render_and_export_coarse_through_the_command_line(tmp_path, capsys):
    cfg = _config(tmp_path, _capture(tmp_path))
    assert cli.main(["--config", cfg, "--i_print", "1"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "train finished" in out and "coarse: pervoxel_lr from 10 views" in out
    assert "fine: in_maskcache kept" in out and "fine box from the coarse geometry" in out
    psnr = [float(line.split()[-1]) for line in out.splitlines() if line.startswith("test: psnr")]
    assert len(psnr) == 1 and np.isfinite(psnr[0])
    exp = tmp_path / "logs" / "tiny"
    for stage, steps in (("coarse", 4), ("fine", 4)):
        meta = json.load(open(exp / f"{stage}_last" / "meta.json"))
        assert (meta["family"], meta["global_step"], meta["has_opt_state"]) == ("dvgo", steps, True)
        records = [json.loads(line) for line in open(exp / f"{stage}_metrics.jsonl")]
        assert [r["step"] for r in records if "loss" in r] == [1, 2, 3, 4]
    assert cli.main(["--config", cfg, "--program", "export_coarse"], device="cpu") == 0
    _, mcfg, _, _, _ = ckpt.load_model(str(exp / "coarse_last"))
    with np.load(exp / "coarse_volume.npz") as vol:
        assert vol["alpha"].shape == mcfg.world_size and vol["rgb"].shape == (*mcfg.world_size, 3)
        assert vol["alpha"].dtype == np.float32 and np.isfinite(vol["alpha"]).all()
    out_path = tmp_path / "elsewhere.npz"
    cli.main(["--config", cfg, "--program", "export_coarse", "--export_coarse_only",
              str(out_path)], device="cpu")
    assert out_path.is_file()


class Stop(Exception):
    pass


def test_a_run_stopped_in_the_coarse_stage_resumes_there(tmp_path):
    """Stopped after coarse step 3 (its periodic save at step 2), the run
    starts again from ``coarse_last`` at step 2 (the optimizer's state
    restored, the random sampler and the per-voxel lr made again) and ends
    with the fine model of the run that was not stopped, to the bit."""
    scene = _capture(tmp_path)
    cfg = loader.load_config(_config(tmp_path, scene, coarse_steps=5))
    data = common.load_everything(cfg)
    kw = dict(device="cpu", log_every=1, save_every=2)
    whole = loop.run_train(cfg, data, exp_dir=str(tmp_path / "whole"), log_fn=lambda _: None,
                           **kw)

    def stop(step, metrics):
        if step == 3:
            raise Stop

    exp = str(tmp_path / "stopped")
    with pytest.raises(Stop):
        loop.run_train(cfg, data, exp_dir=exp, callback=stop, log_fn=lambda _: None, **kw)
    assert json.load(open(f"{exp}/coarse_last/meta.json"))["global_step"] == 2
    logs = []
    again = loop.run_train(cfg, data, exp_dir=exp, log_fn=logs.append, **kw)
    assert any(m.startswith("coarse: resumed from") and "at step 2" in m for m in logs)
    for stage in ("coarse", "fine"):
        a = ckpt.load_model(str(tmp_path / "whole" / f"{stage}_last"))[2].state_dict()
        b = ckpt.load_model(f"{exp}/{stage}_last")[2].state_dict()
        for k in a:
            assert torch.equal(a[k], b[k]), (stage, k)
    assert again[1] == whole[1]
    # a third start finds both stages finished: nothing is trained again
    logs = []
    loop.run_train(cfg, data, exp_dir=exp, log_fn=logs.append, **kw)
    assert sum("stands at its last step" in m for m in logs) == 2
