"""Block training (``--num_per_block``, ``run_train_blocks``), ``merge_blocks``
and the block render of the port against the JAX package, on the CPU.

- The partition: for several ``len(i_train)`` / ``num_per_block`` pairs, the
  block count of the command line, each block's views, seed and directory,
  the skip of a block whose ``fine_last_<b>`` stands and the merge's inputs
  equal to the JAX ``run_train_blocks``' (both packages' ``run_train`` and
  checkpoint writers replaced by recorders).
- ``merge_blocks`` on two seeded FourierGrid checkpoints (bf16 grids, one
  Fourier frequency) and on two DVGO ones: the JAX package's merged
  checkpoint, converted, equals the port's merge, its grids to the bit (the
  elementwise minimum, taken in the stored dtype), the occupancy cache
  equal, the first block's MLP and step kept, no optimizer state.
- ``configs/waymo/waymo_block.py`` through the command line on a tiny
  Waymo-layout capture (the port's ``write_waymo_scene``, 12x16 views, four
  training views of camera 73): two blocks of two views, two steps each,
  write ``block_<b>/``, ``fine_last_<b>`` and ``fine_last_merged`` and
  render nothing; ``--render_only`` renders the merged model; with it moved
  aside, ``run_render_blocks`` renders each block's views with that
  block's checkpoint, ordered by block number (the JAX package's string
  sort, which pairs ``fine_last_10`` with block 2's views, is not
  reproduced).
"""

import glob
import json
import os
import pathlib
import shutil

import numpy as np
import pytest
import torch

import jax

from unboundednerfpytorch_tpu.train import loop as jloop
from unboundednerfpytorch_tpu.utils import checkpoint as jckpt
from unboundednerfpytorch_tpu_torch import convert, render
from unboundednerfpytorch_tpu_torch.cli import main as cli
from unboundednerfpytorch_tpu_torch.data import synthetic
from unboundednerfpytorch_tpu_torch.train import loop
from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt
from torch_threads import torch_threads  # noqa: F401: the workers' share of the cores

ROOT = pathlib.Path(__file__).resolve().parents[1]
H, W = 12, 16


def write_block_capture(root: pathlib.Path, steps: int = 2) -> str:
    """A Waymo-layout capture of four camera-73 training views (and two of
    camera 74, which ``waymo_block.py``'s ``sample_cam`` drops) and two val
    views, and a config on ``waymo_block.py`` cut to 12^3 voxels and
    ``steps`` steps. Returns the config's path."""
    a = synthetic.orbit_scene(6, H, W, seed=6)
    b = synthetic.orbit_scene(2, H, W, seed=6, focal_scale=0.9)
    views = {k: np.concatenate([a[k][:4], b[k], a[k][4:]]) for k in ("images", "poses", "Ks")}
    scene = synthetic.write_waymo_scene(str(root / "scene"), views, [73] * 4 + [74] * 2 + [73] * 2,
                                        n_val=2)
    path = root / "cfg.py"
    path.write_text(f"""
_base_ = {str(ROOT / 'configs' / 'waymo' / 'waymo_block.py')!r}
expname = 'tiny'
basedir = {str(root / 'logs')!r}
data = dict(datadir={scene!r})
fine_train = dict(N_iters={steps}, N_rand=64, pg_scale=[1])
fine_model_and_render = dict(num_voxels_density=12**3, num_voxels_base_density=12**3,
    num_voxels_rgb=12**3, num_voxels_base_rgb=12**3, sample_budget=16, color_budget=6)
""")
    return str(path)


def cut_test_split(monkeypatch):
    """``load_everything`` with the test split cut to the val views and one
    trajectory view (the 200 would take a minute on the CPU)."""
    from unboundednerfpytorch_tpu_torch.data import common

    real = common.load_everything

    def cut(cfg, **kw):
        d = real(cfg, **kw)
        d["i_test"] = np.concatenate([d["i_val"], d["i_test"][:1]])
        return d

    monkeypatch.setattr(common, "load_everything", cut)


@pytest.mark.parametrize("n_train,per", [(10, 5), (7, 2), (11, 3), (9, 4), (6, 2)])
def test_the_partition_seeds_and_paths_equal_jax(tmp_path, monkeypatch, n_train, per):
    block_num = max(1, n_train // per)  # the command line's count, in both packages
    data = {"i_train": np.arange(3, 3 + n_train)}
    calls = {"jax": [], "port": []}

    def recorder(side):
        def run_train(cfg, sub, seed=0, exp_dir=None, **kw):
            calls[side].append(("train", sub["i_train"].tolist(), seed,
                                os.path.relpath(exp_dir, tmp_path / side)))
            return "FourierGrid", None, None, 0.0
        return run_train

    def saver(side):
        return lambda path, *a, **kw: calls[side].append(
            ("save", os.path.relpath(path, tmp_path / side)))

    def merger(side):
        return lambda paths, out, **kw: calls[side].append(
            ("merge", [os.path.relpath(p, tmp_path / side) for p in paths],
             os.path.relpath(out, tmp_path / side)))

    monkeypatch.setattr(jloop, "run_train", recorder("jax"))
    monkeypatch.setattr(jckpt, "save_model", saver("jax"))
    monkeypatch.setattr(jckpt, "merge_blocks", merger("jax"))
    monkeypatch.setattr(loop, "run_train", recorder("port"))
    monkeypatch.setattr(ckpt, "save_model", saver("port"))
    monkeypatch.setattr(ckpt, "merge_blocks", merger("port"))
    for side in ("jax", "port"):  # block 1 already done: skipped
        os.makedirs(tmp_path / side / "fine_last_1")
        (tmp_path / side / "fine_last_1" / "meta.json").write_text("{}")
    jpaths = jloop.run_train_blocks(None, data, block_num, str(tmp_path / "jax"), seed=10,
                                    log_fn=lambda *_: None)
    paths = loop.run_train_blocks(None, data, block_num, str(tmp_path / "port"), seed=10,
                                  log_fn=lambda *_: None, device="cpu")
    assert calls["port"] == calls["jax"]
    assert [os.path.relpath(p, tmp_path / "port") for p in paths] == \
        [os.path.relpath(p, tmp_path / "jax") for p in jpaths]
    trained = [c for c in calls["port"] if c[0] == "train"]
    assert all(c[2] == 10 + int(c[3].split("_")[1]) for c in trained)
    assert "block_1" not in [c[3] for c in trained]


def seeded_pair(family: str, seed: int):
    """(JAX config, JAX params, port config, port params) of ``family``."""
    if family == "FourierGrid":
        from test_torch_port_model import make_pair

        return make_pair(seed, grid_dtype="bfloat16")
    from test_torch_port_dvgo import make_pair

    return make_pair(seed, offset=-12.0)


@pytest.mark.parametrize("family", ["FourierGrid", "dvgo"])
def test_merge_blocks_equals_jax(tmp_path, family):
    jpaths, tpaths, grids = [], [], []
    for b in range(2):
        jcfg, jp, tcfg, tp = seeded_pair(family, 20 + b)
        jpaths.append(str(tmp_path / f"jax_{b}"))
        tpaths.append(str(tmp_path / f"port_{b}"))
        jckpt.save_model(jpaths[-1], family, jcfg, jp, global_step=5 + b)
        ckpt.save_model(tpaths[-1], family, tcfg, tp, global_step=5 + b)
        grids.append({k: getattr(tp, k).grid.detach().float().clone() for k in ("density", "k0")})
    jckpt.merge_blocks(jpaths, str(tmp_path / "jax_merged"))
    ckpt.merge_blocks(tpaths, str(tmp_path / "port_merged"))
    jfam, _, jmerged, jstep, jopt = jckpt.load_model(str(tmp_path / "jax_merged"))
    fam, _, merged, step, opt = ckpt.load_model(str(tmp_path / "port_merged"))
    assert (fam, step, opt) == (jfam, jstep, jopt) == (family, 5, None)
    want = convert.params_from_numpy(family, convert.tree_from_params_object(
        jax.tree.map(np.asarray, jmerged)), "cpu")
    for k in ("density", "k0"):
        got = getattr(merged, k).grid.detach()
        assert got.dtype == getattr(want, k).grid.dtype
        assert torch.equal(got, getattr(want, k).grid)
        assert torch.equal(got.float(), torch.minimum(grids[0][k], grids[1][k]))
    mask = merged.mask_cache.mask
    assert torch.equal(mask, want.mask_cache.mask)
    assert 0 < int(mask.sum()) < mask.numel()  # the refresh cleared part of the cache
    for got, ref in zip(merged.rgbnet.parameters(), want.rgbnet.parameters()):
        assert torch.equal(got, ref)
    assert json.load(open(tmp_path / "port_merged" / "meta.json"))["has_opt_state"] is False


@pytest.fixture(scope="module")
def trained_blocks(tmp_path_factory):
    root = tmp_path_factory.mktemp("blocks")
    cfg = write_block_capture(root)
    mp = pytest.MonkeyPatch()
    renders = []
    real = render.run_render
    mp.setattr(render, "run_render", lambda *a, **kw: renders.append(1) or real(*a, **kw))
    try:
        assert cli.main(["--config", cfg, "--num_per_block", "2", "--i_print", "1",
                         "--running_block_id", "3"], device="cpu") == 0
    finally:
        mp.undo()
    assert renders == []  # as the JAX command line: no render after block training
    return cfg, root / "logs" / "tiny"


def test_num_per_block_trains_blocks_and_merges_through_the_command_line(trained_blocks):
    _, exp_dir = trained_blocks
    for b in range(2):
        meta = json.load(open(exp_dir / f"block_{b}" / "fine_last" / "meta.json"))
        assert meta["global_step"] == 2 and meta["has_opt_state"]
        assert not json.load(open(exp_dir / f"fine_last_{b}" / "meta.json"))["has_opt_state"]
    _, _, merged, _, _ = ckpt.load_model(str(exp_dir / "fine_last_merged"))
    blocks = [ckpt.load_model(str(exp_dir / f"fine_last_{b}"))[2] for b in range(2)]
    for k in ("density", "k0"):
        assert torch.equal(getattr(merged, k).grid,
                           torch.minimum(*(getattr(p, k).grid for p in blocks)))
    assert not (exp_dir / "fine_last").exists()
    assert "running_block_id = 3" in (exp_dir / "args.txt").read_text()


def test_render_only_takes_the_merged_model_then_the_blocks(trained_blocks, monkeypatch):
    cfg, exp_dir = trained_blocks
    cut_test_split(monkeypatch)
    results = []
    real = render.run_render
    monkeypatch.setattr(render, "run_render",
                        lambda *a, **kw: results.append(real(*a, **kw)) or results[-1])
    loads = []
    real_load = ckpt.load_model
    monkeypatch.setattr(ckpt, "load_model",
                        lambda path, **kw: loads.append(os.path.basename(path))
                        or real_load(path, **kw))
    assert cli.main(["--config", cfg, "--render_only"], device="cpu") == 0
    assert loads == ["fine_last_merged"]
    out = results[-1]["test"]
    assert out["rgbs"].shape == (3, H, W, 3) and len(out["psnrs"]) == 2
    assert np.isfinite(out["psnrs"]).all()

    shutil.move(str(exp_dir / "fine_last_merged"), str(exp_dir / "merged_aside"))
    try:
        loads.clear()
        assert cli.main(["--config", cfg, "--render_only"], device="cpu") == 0
    finally:
        shutil.move(str(exp_dir / "merged_aside"), str(exp_dir / "fine_last_merged"))
    blocks = results[-1]
    assert loads == ["fine_last_0", "fine_last_1"]
    assert [v.tolist() for v in blocks["views"]] == [[0, 1], [2, 3]]
    for out in blocks["outs"]:
        assert out["rgbs"].shape == (2, H, W, 3) and len(out["psnrs"]) == 2
    assert (exp_dir / "render_blocks.mp4").exists() or (exp_dir / "render_blocks_frames").is_dir()


def test_block_checkpoints_are_paired_by_block_number(tmp_path):
    for b in range(12):
        os.makedirs(tmp_path / f"fine_last_{b}")
    os.makedirs(tmp_path / "fine_last_merged")
    got = [os.path.basename(p) for p in render.block_checkpoints(str(tmp_path))]
    assert got == [f"fine_last_{b}" for b in range(12)]
    # the JAX run_render_blocks' order: block 2's views go to fine_last_10
    jax_order = [os.path.basename(p)
                 for p in sorted(glob.glob(os.path.join(tmp_path, "fine_last_[0-9]*")))]
    assert jax_order[2] == "fine_last_10" and got[2] == "fine_last_2"
