"""The port's Tanks & Temples, free-trajectory, nerfstudio, Waymo and
Mega-NeRF loaders against the JAX package's, on the CPU, and the 23 configs
they serve.

- ``load_everything`` of both packages on a capture in each layout, written
  by the port's seeded writers (``data/synthetic.py``, 8 + 2 views of
  12x16): every key of the data_dict equal, exactly, dtypes too. Both
  packages decode the same PNG files to the same bytes (PIL, which
  ``imageio`` reads through), resize with the same ``cv2.INTER_AREA`` and
  run the same float64 numpy, so no tolerance is needed. The writers'
  images come back as written (the free and nerfstudio captures are stored
  at ``factor`` times the size, each pixel repeated, which the loaders'
  area resize undoes exactly).
- Each of the 23 configs (``free_dataset/*``, ``nerf_studio/*``,
  ``tankstemple/*_single``, ``waymo/*``, ``mega/*``) loads through the
  port's ``configs.loader`` and builds its model at 16^3 voxels.
- ``train -> render`` through ``cli.main.main([...], device="cpu")`` for
  ``tankstemple/barn_single.py``, ``free_dataset/grass.py``,
  ``nerf_studio/Giannini_Hall.py`` (FourierGrid, host ray store) and
  ``nerf_studio/dozer.py`` (DCVGO), each at 16^3 voxels and 4 steps.
- The six types that waited for ROADMAP A18a: blender, nsvf, deepvoxels and
  blendedmvs reach their loaders through the command line, and so do co3d
  and linemod.
- The corner gather in slices (the memory bound of an unbudgeted
  full-width step) equals the whole gather, forward and backward, to the
  bit; its probe on the card (``probes/gather_memory.py``) refuses the CPU.
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
from unboundednerfpytorch_tpu_torch.ops import interp
from unboundednerfpytorch_tpu_torch.train import loop
from torch_threads import torch_threads  # noqa: F401: the workers' share of the cores

ROOT = pathlib.Path(__file__).resolve().parents[1]
H, W = 12, 16
FACTOR = {"free": 2, "nerfstudio": 4}


def _views():
    return synthetic.orbit_scene(8, H, W, seed=1, n_test=2)


def _write(layout: str, root: str) -> dict:
    """The capture of ``layout`` under ``root``; returns its data config."""
    data = _views()
    if layout == "tankstemple":
        synthetic.write_tankstemple_scene(root, data)
        return dict(dataset_type=layout, datadir=root, inverse_y=True, white_bkgd=True)
    if layout == "free":
        synthetic.write_free_scene(root, data, factor=FACTOR[layout])
        return dict(dataset_type=layout, datadir=root, factor=FACTOR[layout], llffhold=4)
    if layout == "nerfstudio":
        synthetic.write_nerfstudio_scene(root, data, factor=FACTOR[layout])
        return dict(dataset_type=layout, datadir=root, factor=FACTOR[layout], dvgohold=4,
                    llffhold=-1)
    if layout == "waymo":
        synthetic.write_waymo_scene(root, data, [73] * 10, n_val=2)
    else:
        synthetic.write_mega_scene(root, data, n_val=2)
    return dict(dataset_type=layout, datadir=root, inverse_y=True)


LAYOUTS = ("tankstemple", "free", "nerfstudio", "waymo", "mega")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_load_everything_matches_jax(tmp_path, layout):
    cfg = {"data": _write(layout, str(tmp_path))}
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
    # the views come back as written, in order (the Waymo and Mega splits
    # are sorted by camera position; the Tanks & Temples one by split)
    written = np.round(np.clip(_views()["images"], 0, 1) * 255) / np.float32(255)
    if layout in ("free", "nerfstudio"):
        np.testing.assert_array_equal(got["images"], written)
        assert list(got["i_test"]) == [0, 4, 8]
    elif layout == "tankstemple":
        np.testing.assert_array_equal(got["images"], written)
        assert list(got["i_train"]) == list(range(8)) and list(got["i_test"]) == [8, 9]
        assert len(got["render_poses"]) == 200
    else:
        assert len(got["i_test"]) == (200 if layout == "waymo" else 100)
        assert got["i_test"].min() == len(got["images"])  # a trajectory without images
        assert {tuple(im.reshape(-1)[:6]) for im in got["images"]} == \
            {tuple(im.reshape(-1)[:6]) for im in written}


def test_free_training_ids_match_jax(tmp_path):
    cfg = {"data": {**_write("free", str(tmp_path)), "training_ids": [0, 2, 3, 5, 6, 9]}}
    got = common.load_everything(port_cfg(cfg))
    want = jcommon.load_everything(jax_cfg(cfg))
    for k in ("images", "poses", "Ks", "render_poses", "i_train", "i_test", "HW"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(got["images"]) == 6 and got["near_clip"] == want["near_clip"]


# ---------------------------------------------------------------------------
# the 23 configs

# (config, family, banks, grid dtype, host store, k0 channels)
CONFIGS = [(f"free_dataset/{s}.py", "FourierGrid", 7, "float32", False, 12)
           for s in ("grass", "hydrant", "lab", "pillar", "road", "sky", "stair")]
CONFIGS += [(f"nerf_studio/{s}.py", "FourierGrid", 7, "float32", True, 12)
            for s in ("Giannini_Hall", "stump")]
CONFIGS += [(f"nerf_studio/{s}.py", "dcvgo", 1, "float32", False, 12)
            for s in ("desolation", "dozer", "poster")]
CONFIGS += [(f"tankstemple/{s}_single.py", "FourierGrid", 7, "float32", True, 12)
            for s in ("barn", "caterpillar", "family")]
CONFIGS += [(f"waymo/{s}.py", "FourierGrid", 7, "bfloat16", False, k)
            for s, k in (("waymo_no_block", 3), ("waymo_block", 3), ("block_0_llff", 12),
                         ("block_0_tt", 12))]
CONFIGS += [(f"mega/{s}.py", "FourierGrid", 7, "bfloat16", False, 12)
            for s in ("building", "building_no_block", "quad", "rubble")]


def test_the_list_is_the_23_configs_of_the_five_layouts():
    names = sorted(str(p.relative_to(ROOT / "configs"))
                   for d in ("free_dataset", "nerf_studio", "waymo", "mega")
                   for p in (ROOT / "configs" / d).glob("*.py")
                   if not p.name.endswith(("_default.py", "_base.py")))
    names += sorted(str(p.relative_to(ROOT / "configs"))
                    for p in (ROOT / "configs" / "tankstemple").glob("*_single.py"))
    assert sorted(names) == sorted(c[0] for c in CONFIGS) and len(CONFIGS) == 23


@pytest.mark.parametrize("name,family,banks,dtype,host,k0", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_the_configs_of_this_slice_build_their_models(name, family, banks, dtype, host, k0):
    """Each loads through the port's ``configs.loader`` (layout, family,
    host store) and builds its model at 16^3 voxels (``pg_scale`` kept)."""
    cfg = loader.load_config(str(ROOT / "configs" / name))
    layout = name.split("/")[0].replace("free_dataset", "free").replace("nerf_studio", "nerfstudio")
    assert cfg.data.dataset_type == layout
    assert loop.model_family_name(cfg) == family and cfg.data.load2gpu_on_the_fly == host
    assert cfg.coarse_train.N_iters == 0
    fm = dataclasses.replace(cfg.fine_model_and_render, num_voxels_rgb=16**3,
                             num_voxels_density=16**3)
    fam, mcfg, params = loop.build_model(cfg, fm, cfg.fine_train, (-1.0, -1.0, -1.0),
                                         (1.0, 1.0, 1.0), torch.Generator().manual_seed(0), "cpu")
    assert fam == family and params.density.grid.shape[0] == banks
    assert params.k0.grid.shape[-1] == k0 and str(params.k0.grid.dtype) == f"torch.{dtype}"
    if name.startswith("waymo/waymo_"):  # the Fourier loss
        assert cfg.fine_train.weight_freq == 1.0


# ---------------------------------------------------------------------------
# the command line


def _config(path, base, scene, logs):
    path.write_text(f"""
_base_ = {str(ROOT / 'configs' / base)!r}
expname = 'tiny'
basedir = {str(logs)!r}
data = dict(datadir={str(scene)!r})
fine_train = dict(N_iters=4, N_rand=128, pg_scale=[2, 3])
fine_model_and_render = dict(num_voxels_density=16**3, num_voxels_base_density=16**3,
    num_voxels_rgb=16**3, num_voxels_base_rgb=16**3)
""")
    return str(path)


@pytest.mark.parametrize("base,layout,family", [
    ("tankstemple/barn_single.py", "tankstemple", "FourierGrid"),
    ("free_dataset/grass.py", "free", "FourierGrid"),
    ("nerf_studio/Giannini_Hall.py", "nerfstudio", "FourierGrid"),
    ("nerf_studio/dozer.py", "nerfstudio", "dcvgo")])
def test_train_and_render_through_the_command_line(tmp_path, capsys, base, layout, family):
    data = _views()
    scene = str(tmp_path / "scene")
    if layout == "tankstemple":
        synthetic.write_tankstemple_scene(scene, data)
    elif layout == "free":
        synthetic.write_free_scene(scene, data, factor=2)  # grass.py's factor
    else:
        synthetic.write_nerfstudio_scene(scene, data, factor=loader.load_config(
            str(ROOT / "configs" / base)).data.factor)
    cfg = _config(tmp_path / "cfg.py", base, scene, tmp_path / "logs")
    assert cli.main(["--config", cfg, "--i_print", "1"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "train finished" in out
    psnr = [float(line.split()[-1]) for line in out.splitlines() if line.startswith("test: psnr")]
    assert len(psnr) == 1 and np.isfinite(psnr[0])
    meta = json.load(open(tmp_path / "logs" / "tiny" / "fine_last" / "meta.json"))
    assert (meta["family"], meta["global_step"]) == (family, 4)


@pytest.mark.parametrize("dataset_type",
                         ("blender", "blendedmvs", "nsvf", "deepvoxels", "co3d", "linemod"))
def test_the_types_still_refused_name_a18a(tmp_path, dataset_type):
    """The six types that waited for ROADMAP A18a and A18c, all ported now:
    each reaches its loader through the command line, which finds no capture
    in an empty directory."""
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"_base_ = {str(ROOT / 'configs' / 'default.py')!r}\n"
                   f"data = dict(dataset_type={dataset_type!r}, datadir={str(tmp_path)!r})\n")
    with pytest.raises((FileNotFoundError, OSError, ValueError)):
        cli.main(["--config", str(cfg)], device="cpu")


# ---------------------------------------------------------------------------
# the gather in slices


def test_the_gather_memory_probe_needs_the_card():
    from unboundednerfpytorch_tpu_torch.probes import gather_memory

    with pytest.raises(RuntimeError, match="CUDA device"):
        gather_memory.main("cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_gather_in_slices_equals_the_whole_gather(monkeypatch, dtype):
    gen = torch.Generator().manual_seed(0)
    table = torch.randn((500, 12), generator=gen).to(dtype).requires_grad_(True)
    idx = torch.randint(0, 500, (1000, 8), generator=gen)
    w = torch.rand((1000, 8), generator=gen).requires_grad_(True)
    grad_out = torch.randn((1000, 12), generator=gen)

    def run():
        table.grad = w.grad = None
        out = interp.GatherTrilerp.apply(table, idx, w)
        out.backward(grad_out)
        return out.detach(), table.grad.clone(), w.grad.clone()

    whole = run()
    monkeypatch.setattr(interp, "SLICE_BYTES", 4 * 8 * 12 * 97)  # slices of 97 samples
    assert len(interp._slices(1000, 8, 12)) == 11
    for got, want in zip(run(), whole):
        assert torch.equal(got, want)
