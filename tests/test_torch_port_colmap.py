"""The port's COLMAP tooling (``data/colmap.py``, ``data/cameras.py``,
``tools/colmap2standard.py``) and ``--program sfm`` against the JAX package
on the CPU.

Captures come from ``data/synthetic.py::write_colmap_scene``: a seeded
forward-facing scene (a ball before a wall, cameras looking down -z) with
the COLMAP sparse model of its known cameras and of 600 surface points,
binary or text. Every array is compared exactly: the port's module is the
JAX package's numpy code. No ``colmap`` binary is installed here:
``gen_poses`` skips it when ``sparse/0`` is whole, and ``run_colmap`` runs
against a stub executable put on ``PATH`` (a test double for the binary,
which writes the sparse model where the mapper would).
"""

import os
import pathlib
import shutil
import stat
import sys

import numpy as np
import pytest

from unboundednerfpytorch_tpu.configs.loader import load_config as jload_config
from unboundednerfpytorch_tpu.data import cameras as jcameras
from unboundednerfpytorch_tpu.data import colmap as jcolmap
from unboundednerfpytorch_tpu.data import common as jcommon
from unboundednerfpytorch_tpu_torch.cli import main as cli
from unboundednerfpytorch_tpu_torch.configs.loader import load_config
from unboundednerfpytorch_tpu_torch.data import cameras, colmap, common, synthetic
from unboundednerfpytorch_tpu_torch.tools import colmap2standard

ROOT = pathlib.Path(__file__).resolve().parents[1]
H, W, N_VIEWS = 12, 16, 9


def scene_data():
    return synthetic.forward_facing_scene(N_VIEWS, H, W, seed=4)


def write_scene(root, factor=1, text=False):
    data = scene_data()
    synthetic.write_colmap_scene(str(root), data, synthetic.forward_facing_points(600, seed=5),
                                 factor=factor, text=text)
    return data


@pytest.fixture(scope="module", params=["binary", "text"])
def model(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(request.param)
    write_scene(root, text=request.param == "text")
    return root


def _assert_same(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert np.asarray(got).dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


def test_readers_and_scene_manager_match_jax(model):
    sparse = str(model / "sparse" / "0")
    ext = ".bin" if (model / "sparse" / "0" / "cameras.bin").exists() else ".txt"
    kind = "binary" if ext == ".bin" else "text"
    for stem, name in (("cameras", "cameras"), ("images", "images"), ("points3D", "points3d")):
        reader = f"read_{name}_{kind}"
        path = os.path.join(sparse, stem + ext)
        _assert_same(getattr(colmap, reader)(path), getattr(jcolmap, reader)(path), stem)
    got, want = colmap.SceneManager(sparse).load(), jcolmap.SceneManager(sparse).load()
    for attr in ("cameras", "images", "name_to_image_id", "points3D", "point3D_ids",
                 "point3D_colors", "point3D_errors", "point3D_id_to_images"):
        _assert_same(getattr(got, attr), getattr(want, attr), attr)
    for iid in want.images:
        for fn in ("world_to_camera", "camera_to_world", "image_points3D"):
            np.testing.assert_array_equal(getattr(got, fn)(iid), getattr(want, fn)(iid))
    np.testing.assert_array_equal(got.camera_matrix(1), want.camera_matrix(1))
    assert got.filter_points3D(min_track_len=3) == want.filter_points3D(min_track_len=3) > 0
    np.testing.assert_array_equal(got.points3D, want.points3D)
    # the written model holds the scene's own cameras
    data = scene_data()
    for i, iid in enumerate(sorted(got.images)):
        c2w = got.camera_to_world(iid) @ np.diag([1.0, -1.0, -1.0, 1.0])
        np.testing.assert_allclose(c2w[:3], data["poses"][i][:3], atol=1e-6)


def test_camera_models_match_jax():
    params = np.arange(1.0, 13.0)
    for model in ("SIMPLE_PINHOLE", "PINHOLE", "SIMPLE_RADIAL", "RADIAL", "OPENCV",
                  "OPENCV_FISHEYE"):
        got, got_type = cameras.colmap_distortion_params(model, params)
        want, want_type = jcameras.colmap_distortion_params(model, params)
        assert got == want and got_type.value == want_type.value, model
        assert colmap.intrinsics_from_params(model, params) == jcolmap.intrinsics_from_params(
            model, params)
    with pytest.raises(ValueError, match="FOV"):
        cameras.colmap_distortion_params("FOV", params)


def test_gen_poses_matches_jax_and_holds_the_scene(tmp_path):
    """poses_bounds.npy of both packages on copies of one capture: equal, the
    poses the scene's in the LLFF storage convention within 1e-5, each view's
    near bound on the ball's front and its far bound at the wall."""
    data = write_scene(tmp_path / "port")
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    colmap.gen_poses(str(tmp_path / "port"))
    jcolmap.gen_poses(str(tmp_path / "jax"))
    got = np.load(tmp_path / "port" / "poses_bounds.npy")
    np.testing.assert_array_equal(got, np.load(tmp_path / "jax" / "poses_bounds.npy"))
    for row, c2w, K in zip(got, data["poses"], data["Ks"]):
        stored = row[:15].reshape(3, 5)
        want = np.concatenate([-c2w[:3, 1:2], c2w[:3, 0:1], c2w[:3, 2:4]], 1)
        np.testing.assert_allclose(stored[:, :4], want, atol=1e-5)
        np.testing.assert_allclose(stored[:, 4], [H, W, K[0, 0]], rtol=1e-6)
        assert 3.0 <= row[15] < 3.2 and row[16] == pytest.approx(8.0, abs=1e-9)
    assert colmap.save_poses_bounds(str(tmp_path / "port")).shape == (N_VIEWS, 17)


@pytest.mark.parametrize("out_mode", ["cams_meta", "poses_bounds", "poses_bounds_raw",
                                      "standard"])
def test_colmap2standard_matches_jax(out_mode, tmp_path):
    write_scene(tmp_path / "port")
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    argv = ["--data_dir", str(tmp_path / "port"), "--out_mode", out_mode]
    assert colmap2standard.main(argv) == 0
    if out_mode == "standard":
        jcolmap.colmap_to_standard(str(tmp_path / "jax"), str(tmp_path / "jax_standard"))
        got_root, want_root = tmp_path / "port_standard", tmp_path / "jax_standard"
        got = sorted(p.relative_to(got_root) for p in got_root.rglob("*") if p.is_file())
        want = sorted(p.relative_to(want_root) for p in want_root.rglob("*") if p.is_file())
        assert got == want and len(got) == 3 * N_VIEWS
        for rel in want:
            assert (got_root / rel).read_bytes() == (want_root / rel).read_bytes(), rel
        return
    want = jcolmap.export_cams_meta(str(tmp_path / "jax"), out_mode=out_mode)
    got = np.load(tmp_path / "port" / f"{out_mode}.npy")
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_a_fisheye_model_is_not_exported(tmp_path):
    write_scene(tmp_path, text=True)
    path = tmp_path / "sparse" / "0" / "cameras.txt"
    text = path.read_text().replace("PINHOLE", "OPENCV_FISHEYE")
    path.write_text(text.rstrip("\n") + " 0.1 0.01 0.0 0.0\n")
    with pytest.raises(ValueError, match="OPENCV_FISHEYE"):
        colmap.export_cams_meta(str(tmp_path))


def test_sfm_then_the_llff_loader_match_jax(tmp_path, capsys):
    """``--program sfm`` on a ``custom/Madoka.py`` capture (its views at
    images_2, the model of the full resolution), then ``load_everything``
    of both packages on what it wrote: the same data_dict."""
    write_scene(tmp_path / "Madoka", factor=2)
    cfg = tmp_path / "madoka.py"
    cfg.write_text(f"_base_ = {str(ROOT / 'configs' / 'custom' / 'Madoka.py')!r}\n"
                   f"basedir = {str(tmp_path / 'logs')!r}\n"
                   f"data = dict(datadir={str(tmp_path / 'Madoka')!r})\n")
    assert not (tmp_path / "Madoka" / "poses_bounds.npy").exists()
    # the program runs before the data load and on no device
    assert cli.main(["--config", str(cfg), "--program", "sfm"]) == 0
    assert "sfm: wrote" in capsys.readouterr().out
    got = common.load_everything(load_config(str(cfg)))
    want = jcommon.load_everything(jload_config(str(cfg)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, (np.ndarray, list, tuple)) or np.isscalar(w):
            g = np.asarray(got[k])
            assert g.dtype == np.asarray(w).dtype, k
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)
    assert got["images"].shape == (N_VIEWS, H, W, 3)


STUB = """#!{python}
# A test double for the COLMAP binary: it logs its arguments and, as the
# mapper, copies a prepared sparse model to its output path.
import os, shutil, sys
print("stub colmap", *sys.argv[1:])
if sys.argv[1] == "mapper":
    out = sys.argv[sys.argv.index("--output_path") + 1]
    shutil.copytree(os.environ["STUB_COLMAP_MODEL"], os.path.join(out, "0"))
"""


def test_run_colmap_with_a_stub_binary(tmp_path, monkeypatch):
    """``gen_poses`` on a capture without a sparse model runs the three
    COLMAP commands (feature extraction, matching, the mapper) through
    ``run_colmap``, then writes poses_bounds.npy, as the JAX package does."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    stub = bindir / "colmap"
    stub.write_text(STUB.format(python=sys.executable))
    stub.chmod(stub.stat().st_mode | stat.S_IXUSR)
    write_scene(tmp_path / "model")
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("STUB_COLMAP_MODEL", str(tmp_path / "model" / "sparse" / "0"))
    for name in ("port", "jax"):
        shutil.copytree(tmp_path / "model" / "images", tmp_path / name / "images")
    colmap.gen_poses(str(tmp_path / "port"))
    jcolmap.gen_poses(str(tmp_path / "jax"))
    log = (tmp_path / "port" / "colmap_output.txt").read_text()
    assert [line.split()[2] for line in log.splitlines()] == [
        "feature_extractor", "exhaustive_matcher", "mapper"]
    assert log == (tmp_path / "jax" / "colmap_output.txt").read_text().replace("jax", "port")
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "poses_bounds.npy"),
                                  np.load(tmp_path / "jax" / "poses_bounds.npy"))
