"""The port's headless viewers (``utils/visualize.py``, ``tools.vis_train``,
``tools.vis_volume``) against the JAX package's on the CPU.

The arrays each command hands to its plot (the frusta, the active voxels
and their colours, the box, the poses) are equal to the bit to the JAX
tools'; then each command writes its PNG. ``cam.npz`` comes from the port's
``--program export_bbox`` on a small capture; the volume is seeded.
"""

import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest

from unboundednerfpytorch_tpu.utils import visualize as jvis
from unboundednerfpytorch_tpu_torch.utils import visualize as vis

pytest.importorskip("matplotlib")
ROOT = pathlib.Path(__file__).resolve().parents[1]


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_tool(name):
    return importlib.import_module(f"unboundednerfpytorch_tpu_torch.tools.{name}")


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """(cam.npz from the port's export_bbox, a seeded coarse_volume.npz)."""
    from unboundednerfpytorch_tpu_torch.cli import main as cli
    from unboundednerfpytorch_tpu_torch.data import synthetic

    root = tmp_path_factory.mktemp("vis")
    synthetic.write_llff_scene(str(root / "scene"), synthetic.orbit_scene(9, 12, 16, seed=5))
    cfg = root / "cfg.py"
    cfg.write_text(f"_base_ = {str(ROOT / 'configs' / 'nerf_unbounded' / 'bicycle_single.py')!r}\n"
                   f"expname = 'vis'\nbasedir = {str(root / 'logs')!r}\n"
                   f"data = dict(datadir={str(root / 'scene')!r})\n")
    assert cli.main(["--config", str(cfg), "--program", "export_bbox"], device="cpu") == 0
    cam = root / "logs" / "vis" / "cam.npz"
    rng = np.random.RandomState(0)
    vol = root / "coarse_volume.npz"
    np.savez_compressed(vol, alpha=rng.rand(9, 7, 5).astype(np.float32),
                        rgb=rng.rand(9, 7, 5, 3).astype(np.float32))
    return str(cam), str(vol)


def recorded(monkeypatch, module, name, run):
    calls = []
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append((a, k)))
    run()
    monkeypatch.undo()
    assert len(calls) == 1
    return calls[0]


def assert_same_call(got, want):
    (ga, gk), (wa, wk) = got, want
    assert len(ga) == len(wa) and set(gk) == set(wk)
    for g, w in list(zip(ga, wa)) + [(gk[k], wk[k]) for k in wk]:
        if isinstance(w, str):  # the output path: each its own
            continue
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_the_frusta_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(3):
        c2w = np.concatenate([np.linalg.qr(rng.standard_normal((3, 3)))[0],
                              rng.standard_normal((3, 1))], 1)
        np.testing.assert_array_equal(vis._frustum_points(c2w, 0.3), jvis._frustum_points(c2w, 0.3))


@pytest.mark.parametrize("max_points", [200_000, 50])
def test_vis_volume_plots_what_jax_plots(exports, monkeypatch, tmp_path, max_points):
    cam, vol = exports
    argv = [vol, "0.5", "--cam", cam, "--max_points", str(max_points)]
    jtool, tool = jax_tool("vis_volume"), port_tool("vis_volume")

    def run_jax():
        monkeypatch.setattr(sys, "argv", ["vis_volume.py", *argv])
        assert jtool.main() == 0

    want = recorded(monkeypatch, jvis, "plot_volume", run_jax)
    got = recorded(monkeypatch, vis, "plot_volume", lambda: tool.main(argv))
    assert_same_call(got, want)
    out = str(tmp_path / "volume.png")
    assert tool.main([*argv, "--out", out]) == 0
    assert pathlib.Path(out).read_bytes()[:4] == b"\x89PNG"


def test_vis_train_plots_what_jax_plots(exports, monkeypatch, tmp_path):
    cam, _ = exports
    jtool, tool = jax_tool("vis_train"), port_tool("vis_train")

    def run_jax():
        monkeypatch.setattr(sys, "argv", ["vis_train.py", cam])
        assert jtool.main() == 0

    want = recorded(monkeypatch, jvis, "plot_cameras", run_jax)
    got = recorded(monkeypatch, vis, "plot_cameras", lambda: tool.main([cam]))
    assert_same_call(got, want)
    assert np.asarray(got[0][0]).shape == (9, 3, 4)  # the capture's poses
    out = str(tmp_path / "cams.png")
    assert tool.main([cam, "--out", out]) == 0
    assert pathlib.Path(out).read_bytes()[:4] == b"\x89PNG"


def test_the_camera_viewer_of_a_block_dir(tmp_path, capsys):
    """``python -m ...utils.visualize --data_path <block dir>``: a PNG of
    each split's cameras and the block-split map, as the JAX one writes."""
    from unboundednerfpytorch_tpu_torch.data import preprocess

    root = tmp_path / "root"
    for split in ("train", "val"):
        (root / split / "rgbs").mkdir(parents=True)
    meta = {f"img{k}": {"cam_idx": k % 2, "c2w": [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, float(k)]],
                        "W": 8, "H": 6, "intrinsics": [10.0, 10.0],
                        "origin_pos": [0.0, 0.0, float(k)]} for k in range(4)}
    json.dump({"block_0": {"centroid": [0, 0, 0], "elements": [["img0", 0], ["img1", 1]]}},
              open(root / "train" / "split_block_train.json", "w"))
    json.dump(meta, open(root / "train" / "train_all_meta.json", "w"))
    json.dump({"block_0": [["img2", 0]]}, open(root / "val" / "split_block_val.json", "w"))
    json.dump(meta, open(root / "val" / "val_all_meta.json", "w"))
    preprocess.extract_block_meta(str(root), 0, str(root / "block0"), copy_images=False)
    assert vis._main(["--data_path", str(root / "block0")]) == 0
    wrote = capsys.readouterr().out.strip().splitlines()
    assert len(wrote) == 4 and any(p.endswith("block_split.png") for p in wrote)
    assert all(pathlib.Path(p).read_bytes()[:4] == b"\x89PNG" for p in wrote)
