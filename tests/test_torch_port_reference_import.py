"""The port's import and export of reference ``.tar`` checkpoints
(``utils/reference_import.py``) against the JAX package on the CPU.

Small models of each family (12^3 voxels, one Fourier frequency, rgbnet
width 16; DVGO also with TensoRF fields) are drawn by the JAX package's
``build_model``, turned into the reference's checkpoint dict by its
``convert_to_reference`` and imported by both packages. Tolerances: every
imported leaf equal to JAX's to the bit (``convert.tree_from_params_object``
against ``convert.params_to_numpy``); one forward of the imported models
within 1e-5 absolute and 1e-4 relative, as the families' forwards are held
elsewhere; the exported dicts equal tensor for tensor. Then ``--ft_path
<run>.tar`` through the port's command line on the CPU: ``render`` (the
native checkpoint's view within 1e-4: the reference stores its box and scene
centre as float32), ``train`` (resumed without the optimizer's state) and
``tune_pose``.
"""

import dataclasses
import pathlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unboundednerfpytorch_tpu.configs.schema import ExpConfig as JExpConfig
from unboundednerfpytorch_tpu.configs.schema import ModelRenderConfig as JModelRenderConfig
from unboundednerfpytorch_tpu.configs.schema import TrainStageConfig as JTrainStageConfig
from unboundednerfpytorch_tpu.train import loop as jloop
from unboundednerfpytorch_tpu.utils import checkpoint as jckpt
from unboundednerfpytorch_tpu.utils import reference_import as jri
from unboundednerfpytorch_tpu_torch import convert
from unboundednerfpytorch_tpu_torch.cli import main as cli
from unboundednerfpytorch_tpu_torch.configs.schema import ModelRenderConfig
from unboundednerfpytorch_tpu_torch.data import synthetic
from unboundednerfpytorch_tpu_torch.render import run_render
from unboundednerfpytorch_tpu_torch.train import loop
from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt
from unboundednerfpytorch_tpu_torch.utils import reference_import as ri

ROOT = pathlib.Path(__file__).resolve().parents[1]
XYZ_MIN, XYZ_MAX = (-1.0, -1.2, -0.8), (1.1, 1.0, 1.2)
MODEL_KW = dict(num_voxels_density=12**3, num_voxels_rgb=12**3, num_voxels_base_density=12**3,
                num_voxels_base_rgb=12**3, rgbnet_dim=6, rgbnet_width=16, rgbnet_depth=3,
                alpha_init=1e-2, fast_color_thres=1e-4, maskout_near_cam_vox=False,
                fourier_freq_num=1, mpi_depth=8, stepsize=0.5)
TENSORF = dict(density_type="TensoRFGrid", k0_type="TensoRFGrid",
               density_config=(("n_comp", 3),), k0_config=(("n_comp", 4),))
CASES = {"FourierGrid": ("FourierGrid", {}), "dvgo": ("dvgo", {}), "dcvgo": ("dcvgo", {}),
         "dmpigo": ("dmpigo", {}), "dvgo_tensorf": ("dvgo", TENSORF)}
RENDER_KW = {"near": 0.2, "far": 6.0, "bg": 1.0, "stepsize": 0.5}


def jax_model(name, seed=0):
    """(family, JAX config, JAX params) with random grids (density N(-1,
    3^2), k0 N(0, 0.5^2)) and a mask that drops a fifth of the voxels."""
    family, extra = CASES[name]
    exp = JExpConfig()
    if family == "FourierGrid":
        exp = dataclasses.replace(exp, model="FourierGrid")
    elif family == "dcvgo":
        exp = dataclasses.replace(exp, data=dataclasses.replace(exp.data, unbounded_inward=True))
    elif family == "dmpigo":
        exp = dataclasses.replace(exp, data=dataclasses.replace(exp.data, ndc=True))
    fam, jcfg, jp = jloop.build_model(exp, JModelRenderConfig(**{**MODEL_KW, **extra}),
                                      JTrainStageConfig(pg_scale=()), np.array(XYZ_MIN),
                                      np.array(XYZ_MAX), jax.random.PRNGKey(seed))
    assert fam == family
    rng = np.random.default_rng(seed)
    rep = {}
    if not extra:
        rep["density"] = jp.density.replace(grid=jnp.asarray(
            rng.standard_normal(jp.density.grid.shape) * 3.0 - 1.0, jp.density.grid.dtype))
        rep["k0"] = jp.k0.replace(grid=jnp.asarray(
            rng.standard_normal(jp.k0.grid.shape) * 0.5, jp.k0.grid.dtype))
    mask = rng.random(jp.mask_cache.mask.shape) > 0.2
    rep["mask_cache"] = jp.mask_cache.replace(mask=jnp.asarray(mask))
    return family, jcfg, jp.replace(**rep)


def assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want) - {"vd", "img_embeddings"}, path
        for k in got:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}/{i}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert np.asarray(got).tolist() == np.asarray(want).tolist(), path


def rays(n=64, seed=1):
    rng = np.random.default_rng(seed)
    center = (np.asarray(XYZ_MIN) + np.asarray(XYZ_MAX)) / 2
    o = center + rng.standard_normal((n, 3)) * 2.0
    d = center + rng.standard_normal((n, 3)) * 0.4 - o
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return [a.astype(np.float32) for a in (o, d, vd)]


@pytest.mark.parametrize("name", list(CASES))
def test_convert_reference_ckpt_matches_jax(name):
    family, jcfg, jp = jax_model(name)
    ref = jri.convert_to_reference(family, jcfg, jp, global_step=7)
    jfam, jcfg2, jp2, jstep = jri.convert_reference_ckpt(ref)
    fam, tcfg, tp, step = ri.convert_reference_ckpt(ref, device="cpu")
    assert (fam, step) == (jfam, jstep) == (family, 7) == (ri.detect_family(ref["model_kwargs"]),
                                                           7)
    want = {f.name: getattr(jcfg2, f.name) for f in dataclasses.fields(jcfg2)}
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == want[f.name], f.name
    assert_trees_equal(convert.params_to_numpy(tp), convert.tree_from_params_object(jp2))
    tp.requires_grad_(False)
    o, d, vd = rays()
    jres = jloop.make_forward(family, jcfg2, RENDER_KW)(jp2, jnp.asarray(o), jnp.asarray(d),
                                                        jnp.asarray(vd), None)
    tres = loop.make_forward(tcfg, RENDER_KW)(tp, *(torch.from_numpy(a) for a in (o, d, vd)))
    want = np.asarray(jres.rgb_marched)
    assert 0.05 < float(np.asarray(jres.alphainv_last).mean()) < 0.95  # the rays meet density
    np.testing.assert_allclose(tres.rgb_marched.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_convert_to_reference_matches_jax(name):
    """The port's export of the model carried from JAX: the same keys, the
    same tensors (dtype and values), the same model_kwargs."""
    family, jcfg, jp = jax_model(name, seed=2)
    want = jri.convert_to_reference(family, jcfg, jp, global_step=3)
    _, tcfg, tp, _ = ri.convert_reference_ckpt(want, device="cpu")
    got = ri.convert_to_reference(family, tcfg, tp, global_step=3)
    assert got["global_step"] == 3 and got["optimizer_state_dict"] == {}
    assert set(got["model_state_dict"]) == set(want["model_state_dict"])
    for k, w in want["model_state_dict"].items():
        g = got["model_state_dict"][k]
        assert g.dtype == w.dtype and torch.equal(g, w), k
    assert set(got["model_kwargs"]) == set(want["model_kwargs"])
    for k, w in want["model_kwargs"].items():
        assert np.asarray(got["model_kwargs"][k]).tolist() == np.asarray(w).tolist(), k


def test_export_checkpoint_matches_jax(tmp_path):
    """A checkpoint directory of each package, the same model in it, exported
    to a .tar by each package's ``export_checkpoint``."""
    family, jcfg, jp = jax_model("FourierGrid", seed=4)
    jckpt.save_model(str(tmp_path / "jax"), family, jcfg, jp, global_step=9)
    _, tcfg, tp, _ = ri.convert_reference_ckpt(jri.convert_to_reference(family, jcfg, jp),
                                               device="cpu")
    ckpt.save_model(str(tmp_path / "port"), family, tcfg, tp, global_step=9)
    jri.export_checkpoint(str(tmp_path / "jax"), str(tmp_path / "jax.tar"))
    back = ri.export_checkpoint(str(tmp_path / "port"), str(tmp_path / "port.tar"))
    want = torch.load(tmp_path / "jax.tar", weights_only=False)
    got = torch.load(tmp_path / "port.tar", weights_only=False)
    assert got["global_step"] == want["global_step"] == back["global_step"] == 9
    assert set(got["model_state_dict"]) == set(want["model_state_dict"])
    for k, w in want["model_state_dict"].items():
        assert torch.equal(got["model_state_dict"][k], w), k
    for k, w in want["model_kwargs"].items():
        assert np.asarray(got["model_kwargs"][k]).tolist() == np.asarray(w).tolist(), k
    # the .tar loads through load_model as a checkpoint directory does
    fam, cfg2, p2, step, opt = ckpt.load_model(str(tmp_path / "port.tar"))
    assert (fam, step, opt) == (family, 9, None)
    assert_trees_equal(convert.params_to_numpy(p2), convert.params_to_numpy(tp))


def test_overlay_render_knobs_matches_jax():
    from unboundednerfpytorch_tpu.models import fourier_grid as jfg

    family, jcfg, jp = jax_model("FourierGrid")
    ref = jri.convert_to_reference(family, jcfg, jp)
    _, jcfg, _, _ = jri.convert_reference_ckpt(ref)
    _, tcfg, _, _ = ri.convert_reference_ckpt(ref, device="cpu")
    knobs = dict(stepsize=0.25, t_boundary=1.9, sample_budget=64, color_budget=12,
                 budget_probe_stride=2, density_bake_scale=1.5, packed_gather=False,
                 num_voxels_rgb=99**3, rgbnet_width=7)
    got = ri.overlay_render_knobs(tcfg, ModelRenderConfig(**knobs))
    want = jri.overlay_render_knobs(jcfg, JModelRenderConfig(**knobs))
    assert isinstance(want, jfg.FourierGridConfig)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.stepsize, got.num_voxels_rgb) == (0.25, tcfg.num_voxels_rgb)
    assert ri.overlay_render_knobs(tcfg, ModelRenderConfig(stepsize=tcfg.stepsize,
                                                           **{k: getattr(tcfg, k) for k in (
        "t_boundary", "sample_budget", "color_budget", "budget_probe_stride",
        "density_bake_scale", "packed_gather")})) is tcfg


def test_what_the_port_does_not_model_is_refused():
    """What a checkpoint's model_kwargs build must fit its tensors: a view
    grid without ``vd.*`` tensors and a coarse colour head over a k0 of
    several banks are refused where the JAX import refuses them, and a
    tensor of another shape than its model_kwargs give. The view grid, the
    coarse head and appearance embeddings themselves are imported
    (``tests/test_torch_port_colour_heads.py``): stray ``img_embeddings.*``
    are dropped, as the JAX import drops them."""
    family, jcfg, jp = jax_model("FourierGrid")
    ref = jri.convert_to_reference(family, jcfg, jp)
    kw, sd = ref["model_kwargs"], ref["model_state_dict"]
    for change, error in ((dict(num_voxels_viewdir=8**3), KeyError),
                          (dict(rgbnet_dim=0), ValueError)):
        bad = {**ref, "model_kwargs": {**kw, **change}}
        with pytest.raises(error):
            jri.convert_reference_ckpt(bad)
        with pytest.raises(error):
            ri.convert_reference_ckpt(bad, device="cpu")
    extra = {**ref, "model_kwargs": {**kw, "img_emb_dim": 4, "sample_num": 3},
             "model_state_dict": {**sd, "img_embeddings.weight": torch.zeros(3, 4)}}
    _, _, tp, _ = ri.convert_reference_ckpt(extra, device="cpu")
    _, _, jp2, _ = jri.convert_reference_ckpt(extra)
    assert tp.img_embeddings is None and jp2.img_embeddings is None
    bad = {**ref, "model_kwargs": {**kw, "num_voxels_rgb": 9**3}}
    with pytest.raises(ValueError, match="k0.grid"):
        ri.convert_reference_ckpt(bad, device="cpu")


def test_the_import_runs_on_the_card_unless_told_otherwise(monkeypatch, tmp_path):
    """``convert_reference_ckpt`` and ``import_checkpoint`` with no device go
    to ``cuda``, as the port's other entry points do: without a GPU they
    raise before they convert anything."""
    family, jcfg, jp = jax_model("dvgo")
    ref = jri.convert_to_reference(family, jcfg, jp)
    torch.save(ref, tmp_path / "run.tar")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ri.convert_reference_ckpt(ref)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ri.import_checkpoint(str(tmp_path / "run.tar"))


# ---------------------------------------------------------------------------
# --ft_path <run>.tar through the command line


def _write_config(path, scene, logs, n_iters):
    path.write_text(f"""
_base_ = {str(ROOT / 'configs' / 'nerf_unbounded' / 'bicycle_single.py')!r}
expname = 'ref'
basedir = {str(logs)!r}
data = dict(datadir={str(scene)!r})
fine_train = dict(N_iters={n_iters}, N_rand=64, pg_scale=[])
fine_model_and_render = dict(num_voxels_density=16**3, num_voxels_base_density=16**3,
    num_voxels_rgb=16**3, num_voxels_base_rgb=16**3, sample_budget=0, grid_dtype='float32',
    fourier_freq_num=1)
""")
    return str(path)


@pytest.fixture(scope="module")
def tar_run(tmp_path_factory):
    """(config path, its data_dict, experiment directory, the .tar of its
    fine_last): 3 steps of the config through ``run_train``."""
    from unboundednerfpytorch_tpu_torch.configs.loader import load_config
    from unboundednerfpytorch_tpu_torch.data.common import load_everything

    root = tmp_path_factory.mktemp("reftar")
    synthetic.write_llff_scene(str(root / "scene"), synthetic.orbit_scene(9, 12, 16, seed=5))
    cfg = _write_config(root / "cfg.py", root / "scene", root / "logs", 3)
    data = load_everything(load_config(cfg))
    exp_dir = root / "logs" / "ref"
    loop.run_train(load_config(cfg), data, device="cpu", log_fn=lambda _: None,
                   exp_dir=str(exp_dir))
    ri.export_checkpoint(str(exp_dir / "fine_last"), str(root / "run.tar"))
    return cfg, data, exp_dir, str(root / "run.tar")


@pytest.mark.parametrize("program", ["render", "train", "tune_pose"])
def test_the_command_line_takes_a_reference_tar(tar_run, program, tmp_path, capsys,
                                                monkeypatch):
    cfg, data, exp_dir, tar = tar_run
    from unboundednerfpytorch_tpu_torch import render as render_mod
    from unboundednerfpytorch_tpu_torch.configs.loader import load_config

    if program == "render":
        native = run_render(types.SimpleNamespace(ft_path=str(exp_dir / "fine_last")),
                            load_config(cfg), data, str(tmp_path), device="cpu",
                            log_fn=lambda _: None)
        got = []
        monkeypatch.setattr(render_mod, "run_render",
                            lambda *a, **k: got.append(run_render(*a, **k)) or got[-1])
        assert cli.main(["--config", cfg, "--program", "render", "--ft_path", tar],
                        device="cpu") == 0
        # the same float32 leaves (the config's grids are float32, as a
        # .tar's are) through the same forward; the reference stores the box,
        # scene_center and scene_radius as float32, which moves bg_len by
        # 4.8e-8 and the centre by 1.5e-8: the views agree to 1e-4 (8.3e-6 here)
        np.testing.assert_allclose(got[0]["test"]["rgbs"], native["test"]["rgbs"], rtol=0,
                                   atol=1e-4)
    elif program == "train":
        logs = tmp_path / "logs"
        cfg5 = _write_config(tmp_path / "cfg5.py", pathlib.Path(cfg).parent / "scene", logs, 5)
        assert cli.main(["--config", cfg5, "--ft_path", tar], device="cpu") == 0
        out = capsys.readouterr().out
        assert f"fine: resumed from {tar} at step 3 (without the optimizer's state" in out
        _, _, _, step, opt = ckpt.load_model(str(logs / "ref" / "fine_last"))
        assert step == 5 and opt["step"] == 2  # fresh moments: two updates since the .tar
    else:
        out_dir = tmp_path / "logs"
        cfgp = _write_config(tmp_path / "cfgp.py", pathlib.Path(cfg).parent / "scene", out_dir,
                             3)
        assert cli.main(["--config", cfgp, "--program", "tune_pose", "--ft_path", tar,
                         "--tune_steps", "2"], device="cpu") == 0
        tuned = np.load(out_dir / "ref" / "tuned_poses.npy")
        assert tuned.shape == (7, 3, 4) and np.isfinite(tuned).all()  # 9 views, 2 held out
