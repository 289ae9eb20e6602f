"""The migration command lines (``tools.import_reference_ckpt``,
``tools.export_reference_ckpt``), ``import_checkpoint``'s ``out_dir``,
``family`` and ``overrides`` and ``RenderService``'s ``stepsize``, against
the JAX package's on the CPU.

A reference ``.tar`` of a small FourierGrid and a small DVGO model goes
through both packages' import command lines (``--family``, and
``--stepsize`` and ``--t_boundary`` for FourierGrid); the port reads both output directories
(the JAX one without flax) to the same leaves and configs, every value
equal. The port's export of its directory and the JAX export of its own
give the same tensors.
"""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax

from unboundednerfpytorch_tpu.configs.schema import ExpConfig as JExpConfig
from unboundednerfpytorch_tpu.configs.schema import ModelRenderConfig as JModelRenderConfig
from unboundednerfpytorch_tpu.configs.schema import TrainStageConfig as JTrainStageConfig
from unboundednerfpytorch_tpu.train import loop as jloop
from unboundednerfpytorch_tpu.utils import reference_import as jri
from unboundednerfpytorch_tpu_torch import convert
from unboundednerfpytorch_tpu_torch.tools import export_reference_ckpt, import_reference_ckpt
from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt
from unboundednerfpytorch_tpu_torch.utils import reference_import as ri

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODEL_KW = dict(num_voxels_density=10**3, num_voxels_rgb=10**3, num_voxels_base_density=10**3,
                num_voxels_base_rgb=10**3, rgbnet_dim=6, rgbnet_width=16, rgbnet_depth=3,
                alpha_init=1e-2, fast_color_thres=1e-4, maskout_near_cam_vox=False,
                fourier_freq_num=1, stepsize=0.5)


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_tar(path, family):
    exp = JExpConfig()
    if family == "FourierGrid":
        exp = dataclasses.replace(exp, model="FourierGrid")
    fam, jcfg, jp = jloop.build_model(exp, JModelRenderConfig(**MODEL_KW),
                                      JTrainStageConfig(pg_scale=()), np.array((-1.0, -1, -1)),
                                      np.array((1.0, 1, 1)), jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    jp = jp.replace(density=jp.density.replace(grid=jax.numpy.asarray(
        rng.standard_normal(jp.density.grid.shape), jp.density.grid.dtype)))
    torch.save(jri.convert_to_reference(fam, jcfg, jp, global_step=6), path)
    return fam


@pytest.mark.parametrize("family", ["FourierGrid", "dvgo"])
def test_the_tar_round_trip_through_both_command_lines(family, tmp_path, capsys):
    tar = str(tmp_path / "run.tar")
    assert reference_tar(tar, family) == family
    # the render knobs of a FourierGrid config (a DVGO config has neither)
    knobs = ["--stepsize", "0.25", "--t_boundary", "1.5"] if family == "FourierGrid" else []
    assert jax_tool("import_reference_ckpt").main([tar, "--out", str(tmp_path / "jax"),
                                                   "--family", family, *knobs]) == 0
    assert import_reference_ckpt.main([tar, "--out", str(tmp_path / "port"), "--family", family,
                                       *knobs], device="cpu") == 0
    assert f"imported {family} checkpoint (step 6" in capsys.readouterr().out

    fam_j, cfg_j, p_j, step_j, _ = ckpt.load_model(str(tmp_path / "jax"))  # the JAX layout
    fam_p, cfg_p, p_p, step_p, opt = ckpt.load_model(str(tmp_path / "port"))
    assert (fam_j, step_j) == (fam_p, step_p) == (family, 6) and opt is None
    assert cfg_p == cfg_j
    if family == "FourierGrid":
        assert (cfg_p.stepsize, cfg_p.t_boundary) == (0.25, 1.5)
    want, got = convert.params_to_numpy(p_j), convert.params_to_numpy(p_p)
    for name in ("density", "k0"):
        np.testing.assert_array_equal(got[name]["grid"], want[name]["grid"])
    np.testing.assert_array_equal(got["mask_cache"]["mask"], want["mask_cache"]["mask"])

    jax_tool("export_reference_ckpt").main([str(tmp_path / "jax"), "--out",
                                            str(tmp_path / "jax.tar")])
    assert export_reference_ckpt.main([str(tmp_path / "port"), "--out",
                                       str(tmp_path / "port.tar")]) == 0
    a = torch.load(tmp_path / "jax.tar", weights_only=False)
    b = torch.load(tmp_path / "port.tar", weights_only=False)
    assert a["global_step"] == b["global_step"] == 6
    assert set(a["model_state_dict"]) == set(b["model_state_dict"])
    for k, v in a["model_state_dict"].items():
        assert torch.equal(b["model_state_dict"][k], v), k


def test_import_checkpoint_takes_the_family_and_overrides(tmp_path):
    tar = str(tmp_path / "run.tar")
    reference_tar(tar, "dvgo")
    knobs = {"fast_color_thres": 0.0625}
    want = jri.import_checkpoint(tar, family="dvgo", overrides=knobs)
    fam, cfg, _, step = ri.import_checkpoint(tar, out_dir=str(tmp_path / "out"), family="dvgo",
                                             overrides=knobs, device="cpu")
    assert (fam, step, cfg.fast_color_thres) == (want[0], want[3], want[1].fast_color_thres) == \
        ("dvgo", 6, 0.0625)
    assert ckpt.load_model(str(tmp_path / "out"))[1] == cfg
    with pytest.raises(ValueError, match="family"):
        ri.import_checkpoint(tar, family="nerf", device="cpu")


def test_the_server_takes_a_stepsize(tmp_path):
    from unboundednerfpytorch_tpu_torch.tools.serve import RenderService

    tar = str(tmp_path / "run.tar")
    reference_tar(tar, "FourierGrid")
    assert import_reference_ckpt.main([tar, "--out", str(tmp_path / "out")], device="cpu") == 0
    default = RenderService(str(tmp_path / "out"), device="cpu")
    chosen = RenderService(str(tmp_path / "out"), stepsize=0.125, device="cpu")
    assert default.render_kwargs["stepsize"] == default.mcfg.stepsize == 0.5
    assert chosen.render_kwargs["stepsize"] == 0.125
    assert chosen.render(w=8, h=6)[:4] == b"\x89PNG"
