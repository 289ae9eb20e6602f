"""The port's command line on the CPU (``cli.main.main([...], device="cpu")``).

A small on-disk scene in the Mip-NeRF-360 layout (the port's writer, 10
views of 12x16) and a config whose ``_base_`` is the repository's
``configs/nerf_unbounded/bicycle_single.py``, cut to 24^3 voxels and two
``pg_scale`` boundaries: ``train`` (periodic saves, then the render the
command line runs after training), ``train`` again with more steps (the implicit
resume), ``--render_only``, ``export_bbox`` (its ``cam.npz`` against the
JAX command line's on the same config), ``export_baked`` and a render of its
output, and ``gen_trace``. Every program and option the port refuses raises
``NotImplementedError`` naming its ROADMAP item (``--num_per_block`` trains
blocks); without a GPU the command line raises unless the CPU is asked for.

The other families through the same command line: ``train`` then the render
of the test views for ``nerf_unbounded/bicycle.py`` (DCVGO, 24^3 voxels) and
``llff/fern.py`` (DMPIGO on NDC rays, 20^3 voxels, ``mpi_depth`` 16) on
written scenes. A checkpoint save killed at any point leaves the previous
checkpoint whole, and a non-zero ``fine_train.i_panel`` writes the held-out
panels.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from unboundednerfpytorch_tpu_torch.cli import main as cli
from unboundednerfpytorch_tpu_torch.data import png, synthetic
from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt
from torch_threads import torch_threads  # noqa: F401: the workers' share of the cores

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _write_config(path, scene, logs, n_iters):
    path.write_text(f"""
_base_ = {str(ROOT / 'configs' / 'nerf_unbounded' / 'bicycle_single.py')!r}
expname = 'tiny'
basedir = {str(logs)!r}
data = dict(datadir={str(scene)!r})
fine_train = dict(N_iters={n_iters}, N_rand=256, pg_scale=[2, 4])
fine_model_and_render = dict(num_voxels_density=24**3, num_voxels_base_density=24**3,
    num_voxels_rgb=24**3, num_voxels_base_rgb=24**3, sample_budget=16, color_budget=6)
""")
    return str(path)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(config path, experiment directory) of the small scene."""
    root = tmp_path_factory.mktemp("cli")
    synthetic.write_llff_scene(str(root / "scene"), synthetic.orbit_scene(10, 12, 16, seed=3))
    cfg = _write_config(root / "cfg.py", root / "scene", root / "logs", 5)
    return cfg, root / "logs" / "tiny"


def test_train_saves_resumes_and_renders(trained, capsys):
    cfg, exp_dir = trained
    assert cli.main(["--config", cfg, "--i_weights", "2", "--i_print", "1",
                     "--save_train_imgs"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "train finished" in out and "test: psnr" in out  # the render after training
    meta = json.load(open(exp_dir / "fine_last" / "meta.json"))
    assert (meta["global_step"], meta["has_opt_state"]) == (5, True)
    args = (exp_dir / "args.txt").read_text()
    assert "i_weights = 2" in args and "program = train" in args
    assert len(list((exp_dir / "train_imgs").iterdir())) == 8  # views 0 and 8 are held out
    assert png.read_png(str(exp_dir / "train_imgs" / "0001.png")).shape == (12, 16, 3)
    records = [json.loads(line) for line in open(exp_dir / "fine_metrics.jsonl")]
    assert [r["step"] for r in records if "loss" in r] == [1, 2, 3, 4, 5]
    budget = {r["step"]: r["pg_scale"]["sample_budget"] for r in records if "pg_scale" in r}
    assert budget == {2: 16, 4: 16}
    # the same command with two more steps resumes where the first ended
    _write_config(pathlib.Path(cfg), exp_dir.parent.parent / "scene", exp_dir.parent, 7)
    cli.main(["--config", cfg, "--i_print", "1"], device="cpu")
    out = capsys.readouterr().out
    assert f"fine: resumed from {exp_dir / 'fine_last'} at step 5" in out
    assert "fine iter      6" in out and "fine iter      5" not in out
    assert json.load(open(exp_dir / "fine_last" / "meta.json"))["global_step"] == 7


def test_render_export_and_trace_programs(trained, capsys, monkeypatch):
    cfg, exp_dir = trained
    if not (exp_dir / "fine_last").exists():
        cli.main(["--config", cfg], device="cpu")
    cli.main(["--config", cfg, "--render_only", "--render_test", "--dump_images"], device="cpu")
    rendered = sorted(p.name for p in (exp_dir / "render_test").iterdir())
    assert rendered == ["000.png", "000_depth.png", "001.png", "001_depth.png"]
    assert png.read_png(str(exp_dir / "render_test" / "001.png")).shape == (12, 16, 3)

    cli.main(["--config", cfg, "--program", "export_bbox"], device="cpu")
    monkeypatch.setenv("UNBNERF_COMPILE_CACHE", "off")
    from unboundednerfpytorch_tpu.cli import main as jax_cli

    jax_out = str(exp_dir / "jax_cam.npz")
    jax_cli.main(["--config", cfg, "--program", "export_bbox",
                  "--export_bbox_and_cams_only", jax_out])
    with np.load(exp_dir / "cam.npz") as got, np.load(jax_out) as want:
        assert sorted(got.files) == sorted(want.files) == ["poses", "xyz_max", "xyz_min"]
        np.testing.assert_array_equal(got["poses"], want["poses"])
        for k in ("xyz_min", "xyz_max"):  # float32 corner points, another summation order
            assert got[k].dtype == want[k].dtype
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)

    cli.main(["--config", cfg, "--program", "export_baked"], device="cpu")
    meta = json.load(open(exp_dir / "baked_last" / "meta.json"))
    assert meta["model_kwargs"]["fourier_freq_num"] == 0 and not meta["has_opt_state"]
    capsys.readouterr()
    cli.main(["--config", cfg, "--program", "render", "--ft_path", str(exp_dir / "baked_last")],
             device="cpu")
    assert "test: psnr" in capsys.readouterr().out

    cli.main(["--config", cfg, "--program", "gen_trace"], device="cpu")
    with np.load(exp_dir / "cam_paths" / "rot_cam.npz") as rot:
        assert rot["cam_lst"].shape[1:] == (5, 3)
    assert np.asarray(json.load(open(exp_dir / "render_poses.json"))).shape == (120, 3, 4)


@pytest.mark.parametrize("program", ["sfm"])
def test_programs_not_ported_are_refused(program):
    """Every program of the JAX command line is ported now (``sfm`` last): it
    reads its config first."""
    assert not hasattr(cli, "REFUSED_PROGRAMS")
    with pytest.raises(FileNotFoundError, match="unused.py"):
        cli.main(["--config", "unused.py", "--program", program], device="cpu")


@pytest.mark.parametrize("program", ["tune_pose", "linemod_eval"])
def test_the_pose_programs_reach_their_config(program):
    """tune_pose and linemod_eval are ported: they read the config first."""
    with pytest.raises(FileNotFoundError, match="unused.py"):
        cli.main(["--config", "unused.py", "--program", program], device="cpu")


@pytest.mark.parametrize("option", [["--num_per_block", "4"], ["--block_parallel"],
                                    ["--grid_parallel", "2"], ["--diffuse"]],
                         ids=lambda o: o[0])
def test_options_not_ported_are_refused(option, tmp_path):
    """Every one of these options is ported now (ROADMAP A18b brought the
    last two): ``--diffuse`` reaches the loader; ``--num_per_block`` trains
    (two blocks of two views on a tiny waymo_block.py capture, and their
    merge), and with ``--block_parallel`` too, in one process the blocks in
    turn in their shared box; ``--grid_parallel 2`` trains and renders on
    two gloo ranks (``parallel.spawn.run_main``, as ``torchrun`` would run
    the command line), a config of 25^3 voxels whose 24-plane grids are cut
    over both."""
    if option == ["--diffuse"]:  # ported: it reaches the loader, after the config
        with pytest.raises(FileNotFoundError, match="unused.py"):
            cli.main(["--config", "unused.py", *option], device="cpu")
        return
    exp_dir = tmp_path / "logs" / "tiny"
    if option[0] in ("--num_per_block", "--block_parallel"):
        from test_torch_port_blocks import write_block_capture

        cfg = write_block_capture(tmp_path, steps=1)
        extra = ["--block_parallel"] if option[0] == "--block_parallel" else []
        assert cli.main(["--config", cfg, "--num_per_block", "2", *extra], device="cpu") == 0
        for name in ("block_0/fine_last", "block_1/fine_last", "fine_last_0", "fine_last_1",
                     "fine_last_merged"):
            assert (exp_dir / name / "meta.json").exists(), name
        return
    from unboundednerfpytorch_tpu_torch.parallel import spawn

    synthetic.write_llff_scene(str(tmp_path / "scene"), synthetic.orbit_scene(6, 12, 16, seed=3))
    cfg = _write_config(tmp_path / "cfg.py", tmp_path / "scene", tmp_path / "logs", 4)
    text = pathlib.Path(cfg).read_text().replace("24**3", "25**3")
    pathlib.Path(cfg).write_text(text)
    argv = ["--config", cfg, *option, "--render_test", "--i_print", "1"]
    assert spawn.run(spawn.run_main, 2, str(tmp_path / "store"),
                     "unboundednerfpytorch_tpu_torch.cli.main", argv) == [0, 0]
    _, mcfg, params, step, _ = ckpt.load_model(str(exp_dir / "fine_last"), device="cpu")
    assert step == 4 and params.density.world_size == (24, 24, 24)
    assert params.density.grid.shape[1] == 24  # saved whole
    assert (exp_dir / "args.txt").read_text().count("grid_parallel = 2") == 1


def test_every_flag_of_the_jax_command_line_parses():
    from unboundednerfpytorch_tpu.cli import main as jax_cli

    def flags(parser):
        return {(a.dest, tuple(a.option_strings), a.default) for a in parser._actions}

    assert flags(cli.build_parser()) == flags(jax_cli.build_parser())


def test_the_command_line_needs_a_gpu_unless_the_cpu_is_asked_for(trained, monkeypatch):
    cfg, _ = trained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", cfg, "--program", "export_bbox"])
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(ROOT)}
    for module in ("unboundednerfpytorch_tpu_torch", "unboundednerfpytorch_tpu_torch.cli.main"):
        done = subprocess.run([sys.executable, "-m", module, "--config", cfg, "--program",
                               "export_bbox"], capture_output=True, text=True, env=env,
                              cwd=str(ROOT), timeout=120)
        assert done.returncode != 0 and "no CUDA device" in done.stderr, module
    done = subprocess.run([sys.executable, "-m", "unboundednerfpytorch_tpu_torch", "--help"],
                          capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=120)
    assert done.returncode == 0 and "--program" in done.stdout


def _family_config(path, base, scene, logs, vox, extra=""):
    path.write_text(f"""
_base_ = {str(ROOT / 'configs' / base)!r}
expname = 'tiny'
basedir = {str(logs)!r}
data = dict(datadir={str(scene)!r})
fine_train = dict(N_iters=4, N_rand=128, pg_scale=[2, 3])
fine_model_and_render = dict(num_voxels_density={vox}, num_voxels_base_density={vox},
    num_voxels_rgb={vox}, num_voxels_base_rgb={vox}{extra})
""")
    return str(path)


@pytest.mark.parametrize("base,family", [("nerf_unbounded/bicycle.py", "dcvgo"),
                                         ("llff/fern.py", "dmpigo")])
def test_other_families_train_and_render(tmp_path, capsys, base, family):
    if family == "dcvgo":
        data = synthetic.orbit_scene(9, 12, 16, seed=0)
        scene = synthetic.write_llff_scene(str(tmp_path / "scene"), data, factor=4)
        cfg = _family_config(tmp_path / "cfg.py", base, scene, tmp_path / "logs", 24**3)
    else:
        data = synthetic.forward_facing_scene(9, 12, 16, seed=0)
        scene = synthetic.write_llff_scene(str(tmp_path / "scene"), data, factor=4,
                                           bounds=(2.5, 9.0))
        cfg = _family_config(tmp_path / "cfg.py", base, scene, tmp_path / "logs", 20**3,
                             ", mpi_depth=16")
    assert cli.main(["--config", cfg, "--i_print", "1"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "train finished" in out and "render cache: packed density+k0" in out
    psnr = [float(line.split()[-1]) for line in out.splitlines() if line.startswith("test: psnr")]
    assert len(psnr) == 1 and np.isfinite(psnr[0])
    meta = json.load(open(tmp_path / "logs" / "tiny" / "fine_last" / "meta.json"))
    assert (meta["family"], meta["global_step"]) == (family, 4)
    if family == "dmpigo":
        assert meta["model_kwargs"]["mpi_depth"] == 16


def _save(path, step, value):
    """A small FourierGrid model (bicycle_single's, at 6^3 voxels) whose
    density is ``value`` everywhere, saved with an optimizer state at
    ``step``."""
    from unboundednerfpytorch_tpu_torch.configs import loader
    from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
    from unboundednerfpytorch_tpu_torch.optim.masked_adam import MaskedAdam, ParamGroup

    fm = loader.load_config(str(ROOT / "configs" / "nerf_unbounded" /
                                "bicycle_single.py")).fine_model_and_render
    cfg = fg.config_from(fm, (-1.0,) * 3, (1.0,) * 3, 6**3, 6**3)
    params = fg.create(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        params.density.grid.fill_(value)
    opt = MaskedAdam([ParamGroup("density", [params.density.grid], 0.1, True)])
    opt.step_count = step
    ckpt.save_model(str(path), "FourierGrid", cfg, params, global_step=step,
                    opt_state=opt.state_dict())


@pytest.mark.parametrize("kill", ["params", "opt_state", "meta"])
def test_a_killed_save_leaves_the_previous_checkpoint_whole(tmp_path, monkeypatch, kill):
    """A save that dies while writing the parameters, between the members, or
    just before ``meta.json`` is renamed into place: the directory still
    loads as the previous checkpoint, parameters and optimizer state alike;
    the next save succeeds and leaves only its own members."""
    path = tmp_path / "fine_last"
    _save(path, 3, 1.0)
    write_npz, replace = ckpt._write_npz, os.replace

    def dying_write(target, arrays):
        if os.path.basename(target).startswith(kill):
            with open(target + ".tmp", "wb") as f:  # a member cut short
                f.write(b"PK\x03\x04")
            raise KeyboardInterrupt
        write_npz(target, arrays)

    def dying_replace(src, dst):
        if kill == "meta" and os.path.basename(dst) == "meta.json":
            raise KeyboardInterrupt
        replace(src, dst)

    monkeypatch.setattr(ckpt, "_write_npz", dying_write)
    monkeypatch.setattr(ckpt.os, "replace", dying_replace)
    with pytest.raises(KeyboardInterrupt):
        _save(path, 5, 2.0)
    monkeypatch.undo()
    family, _, params, step, opt = ckpt.load_model(str(path))
    assert (family, step, opt["step"]) == ("FourierGrid", 3, 3)
    assert torch.equal(params.density.grid, torch.ones_like(params.density.grid))
    _save(path, 5, 2.0)
    *_, params, step, opt = ckpt.load_model(str(path))
    assert (step, opt["step"]) == (5, 5) and float(params.density.grid.detach().max()) == 2.0
    assert sorted(p.name for p in path.iterdir()) == ["meta.json", "opt_state-5.npz",
                                                      "params-5.npz"]


def test_the_last_format_still_loads(tmp_path):
    """A directory of the port's format 2 (``params.npz``, ``opt_state.npz``,
    no member list in ``meta.json``) loads as it did."""
    path = tmp_path / "fine_last"
    _save(path, 3, 1.0)
    meta = json.load(open(path / "meta.json"))
    for kind in ("params", "opt_state"):
        os.rename(path / meta["members"][kind], path / f"{kind}.npz")
    del meta["members"]
    meta["format_version"] = 2
    json.dump(meta, open(path / "meta.json", "w"))
    _, _, params, step, opt = ckpt.load_model(str(path))
    assert step == opt["step"] == 3 and float(params.density.grid.detach().min()) == 1.0


def test_i_panel_is_refused(tmp_path):
    """Ported since: a non-zero ``fine_train.i_panel`` writes a held-out panel
    every ``i_panel`` steps and at the last step; here through ``fern.py``
    (DMPIGO on NDC rays, whose flag the panel's render takes)."""
    data = synthetic.forward_facing_scene(9, 12, 16, seed=0)
    scene = synthetic.write_llff_scene(str(tmp_path / "scene"), data, factor=4, bounds=(2.5, 9.0))
    cfg = _family_config(tmp_path / "cfg.py", "llff/fern.py", scene, tmp_path / "logs", 20**3,
                         ", mpi_depth=16")
    with open(cfg, "a") as f:
        f.write("fine_train = dict(N_iters=3, N_rand=64, pg_scale=[], i_panel=2)\n")
    assert cli.main(["--config", cfg], device="cpu") == 0
    panels = tmp_path / "logs" / "tiny" / "panels"
    records = [json.loads(line) for line in open(panels / "panels.jsonl")]
    assert [(r["stage"], r["step"]) for r in records] == [("fine", 2), ("fine", 3)]
    assert sorted(os.listdir(panels)) == ["fine_000002.png", "fine_000003.png", "panels.jsonl"]
    assert png.read_png(str(panels / "fine_000003.png")).shape == (12, 4 * 16, 3)
