"""The port's data loaders against the JAX package's, on the CPU.

The image reader (``data/png.py``) against imageio, on files written by
imageio, by PIL and by the port's own writer with each of the five row
filters: JPEG and every PNG go through PIL, the numpy PNG decoder is the
last resort. ``load_everything`` of both packages on a Mip-NeRF-360 layout
written by the JAX ``write_fake_360_scene`` (spherify, ``llffhold=8``,
factor 8) and on a NeRF++ layout: images and split indices equal, poses,
``render_poses``, ``Ks``, ``near``, ``far`` and ``near_clip`` within 1e-6
(both run the same float64 numpy, so they agree to the bit today); the
training rays of both packages on each loaded scene within 1e-6. The port's
scene writers (``data/synthetic.py``) are read back by both loaders.
"""

import builtins
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unboundednerfpytorch_tpu.configs.schema import exp_config_from_dict as jax_cfg
from unboundednerfpytorch_tpu.data import common as jcommon
from unboundednerfpytorch_tpu.data import loaders as jloaders
from unboundednerfpytorch_tpu.data import synthetic as jsynthetic
from unboundednerfpytorch_tpu.ops import rays as jrays
from unboundednerfpytorch_tpu_torch.configs.schema import exp_config_from_dict as port_cfg
from unboundednerfpytorch_tpu_torch.data import common, loaders, png, synthetic
from unboundednerfpytorch_tpu_torch.ops import rays

GEOMETRY = ("poses", "render_poses", "Ks", "near", "far", "near_clip")


# ---------------------------------------------------------------------------
# the PNG reader


def _image(rng, channels, h=13, w=17):
    shape = (h, w) if channels == 1 else (h, w, channels)
    return rng.integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("writer", ["imageio", "PIL"])
def test_png_reader_matches_imageio(tmp_path, channels, writer):
    import imageio.v2 as imageio
    from PIL import Image

    rng = np.random.default_rng(channels)
    # noise, and a smooth image, on which the writers choose other row filters
    smooth = np.add.outer(np.arange(13), np.arange(17)).astype(np.uint8) * 7
    if channels > 1:
        smooth = np.repeat(smooth[..., None], channels, -1)
    for k, img in enumerate((_image(rng, channels), smooth)):
        path = str(tmp_path / f"{k}.png")
        if writer == "imageio":
            imageio.imwrite(path, img)
        else:
            Image.fromarray(img).save(path)
        got = png.imread(path)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, imageio.imread(path))
        np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "each"])
@pytest.mark.parametrize("channels", [3, 4])
def test_png_rows_of_each_filter_type(tmp_path, filters, channels):
    """Rows filtered by hand with one type, or the five types in turn."""
    import imageio.v2 as imageio

    img = _image(np.random.default_rng(5), channels, h=11, w=9)
    kinds = np.arange(11) % 5 if filters == "each" else filters
    path = str(tmp_path / "rows.png")
    png.write_png(path, img, filters=kinds)
    raw = png.zlib.decompress(b"".join(body for kind, body in png._chunks(open(path, "rb").read())
                                       if kind == b"IDAT"))
    assert list(raw[::9 * channels + 1]) == list(np.broadcast_to(kinds, (11,)))
    np.testing.assert_array_equal(png.read_png(path), img)
    np.testing.assert_array_equal(imageio.imread(path), img)


@pytest.mark.parametrize("kind", ["jpeg", "paeth_png", "palette_png"])
def test_imread_goes_through_pil_and_equals_imageio(tmp_path, monkeypatch, kind):
    """JPEG (which a machine without imageio could not read before) and
    Paeth-filtered PNG (which the numpy decoder undoes pixel by pixel) are
    read by PIL, neither by imageio nor by the numpy decoder, and equal what
    ``imageio.v2.imread`` gives."""
    import imageio.v2 as imageio
    from PIL import Image

    img = _image(np.random.default_rng(7), 3, h=40, w=56)
    path = str(tmp_path / ("a.jpg" if kind == "jpeg" else "a.png"))
    if kind == "jpeg":
        Image.fromarray(img).save(path, quality=90)
    elif kind == "paeth_png":
        png.write_png(path, img, filters=4)
    else:
        Image.fromarray(img).convert("P").save(path)
    want = imageio.imread(path)

    def not_here(*args, **kwargs):
        raise AssertionError("imread must not get here")

    monkeypatch.setattr(png, "read_png", not_here)
    monkeypatch.setattr(imageio, "imread", not_here)
    got = png.imread(path)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_imread_names_imageio_where_it_is_needed(tmp_path, monkeypatch):
    from PIL import Image

    Image.fromarray(_image(np.random.default_rng(1), 3)).save(tmp_path / "a.jpg")
    Image.fromarray(_image(np.random.default_rng(1), 3)).convert("P").save(tmp_path / "p.png")
    assert png.imread(str(tmp_path / "p.png")).shape[:2] == (13, 17)  # palette: imageio's
    real_import = builtins.__import__

    def no_imageio(name, *args, **kwargs):
        if name.startswith("imageio"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_imageio)
    for name in ("a.jpg", "p.png"):  # PIL reads them without imageio
        assert png.imread(str(tmp_path / name)).shape == (13, 17, 3)

    def neither(name, *args, **kwargs):
        if name.startswith("PIL"):
            raise ImportError(name)
        return no_imageio(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", neither)
    for name in ("a.jpg", "p.png"):
        with pytest.raises(RuntimeError, match="imageio"):
            png.imread(str(tmp_path / name))


def test_png_reader_rejects_a_damaged_file(tmp_path):
    path = str(tmp_path / "x.png")
    png.write_png(path, _image(np.random.default_rng(2), 3))
    data = bytearray(open(path, "rb").read())
    data[60] ^= 0xFF  # inside IDAT
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(path)


# ---------------------------------------------------------------------------
# load_everything against the JAX package


def _llff_cfg(datadir):
    return {"data": dict(dataset_type="llff", datadir=str(datadir), factor=8, spherify=True,
                         llffhold=8, unbounded_inward=True)}


def _nerfpp_cfg(datadir):
    return {"data": dict(dataset_type="nerfpp", datadir=str(datadir), inverse_y=True,
                         unbounded_inward=True, white_bkgd=True)}


def _write_nerfpp_with_imageio(root):
    """The layout of tests/test_loaders_formats.py::test_nerfpp, written by
    imageio."""
    import imageio.v2 as imageio

    rng = np.random.RandomState(3)
    for split, n in (("train", 4), ("test", 2)):
        for sub in ("intrinsics", "pose", "rgb"):
            os.makedirs(os.path.join(root, split, sub))
        for i in range(n):
            K = np.eye(4)
            K[0, 0] = K[1, 1] = 50.0
            K[0, 2], K[1, 2] = 5.0, 4.0
            np.savetxt(os.path.join(root, split, "intrinsics", f"{i:05d}.txt"), K.reshape(-1))
            th = 0.6 * (i if split == "train" else i + 4)
            c2w = np.eye(4)
            c2w[:3, 3] = [4.0 * np.cos(th), 4.0 * np.sin(th), 1.0]
            np.savetxt(os.path.join(root, split, "pose", f"{i:05d}.txt"), c2w.reshape(-1))
            imageio.imwrite(os.path.join(root, split, "rgb", f"{i:05d}.png"),
                            (rng.rand(8, 10, 3) * 255).astype(np.uint8))


def _assert_same_data(got, want):
    assert sorted(got) == sorted(want)
    for k in ("images", "HW", "i_train", "i_val", "i_test", "irregular_shape"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    for k in GEOMETRY:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64), rtol=0, atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def llff_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("llff")
    jsynthetic.write_fake_360_scene(str(root), n_views=12, H=32, W=40, factor=8)
    return root


@pytest.fixture(scope="module")
def nerfpp_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("nerfpp")
    _write_nerfpp_with_imageio(str(root))
    return root


@pytest.mark.parametrize("layout", ["llff", "nerfpp"])
def test_load_everything_matches_jax(layout, llff_scene, nerfpp_scene):
    cfg = _llff_cfg(llff_scene) if layout == "llff" else _nerfpp_cfg(nerfpp_scene)
    got = common.load_everything(port_cfg(cfg))
    want = jcommon.load_everything(jax_cfg(cfg))
    _assert_same_data(got, want)
    n = 12 if layout == "llff" else 6
    assert got["images"].shape[0] == n and got["images"].dtype == np.float32
    if layout == "llff":  # every 8th view held out, the rest trained on
        assert list(got["i_test"]) == [0, 8] and len(got["i_train"]) == 10
    else:
        assert list(got["i_train"]) == [0, 1, 2, 3] and list(got["i_test"]) == [4, 5]


@pytest.mark.parametrize("layout", ["llff", "nerfpp"])
def test_training_rays_match_jax(layout, llff_scene, nerfpp_scene):
    cfg = _llff_cfg(llff_scene) if layout == "llff" else _nerfpp_cfg(nerfpp_scene)
    inverse_y = layout == "nerfpp"
    d = common.load_everything(port_cfg(cfg))
    i_train = np.asarray(d["i_train"])
    H, W = (int(v) for v in d["HW"][0])
    images, poses, Ks = (np.asarray(d[k])[i_train].astype(np.float32)
                         for k in ("images", "poses", "Ks"))
    got = rays.get_training_rays_flatten(torch.from_numpy(images), torch.from_numpy(poses), H, W,
                                         torch.from_numpy(Ks), inverse_y=inverse_y)
    want = jrays.get_training_rays_flatten(jnp.asarray(images), jnp.asarray(poses), H, W,
                                           jnp.asarray(Ks), inverse_y=inverse_y)
    for name, g, w in zip(("rgb", "rays_o", "rays_d", "viewdirs", "img_index"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6, err_msg=name)


def test_nerfpp_training_ids_and_rerotate_match_jax(nerfpp_scene):
    split = os.path.join(str(nerfpp_scene), "train")
    assert loaders._load_nerfpp_split(split, [1, 3]) == jloaders._load_nerfpp_split(split, [1, 3])
    got = loaders.load_nerfpp_data(str(nerfpp_scene), rerotate=True)
    want = jloaders.load_nerfpp_data(str(nerfpp_scene), rerotate=True)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    hwf, K, i_split = got[3:]
    assert hwf == want[3] and i_split == want[5]
    np.testing.assert_array_equal(K, want[4])


def test_small_helpers_match_jax():
    rng = np.random.default_rng(0)
    cams = rng.standard_normal((7, 3))
    for ratio in (0.05, 0.02):
        assert common.inward_nearfar_heuristic(cams, ratio) == \
            jcommon.inward_nearfar_heuristic(cams, ratio)
    rgba = rng.random((2, 3, 4, 4)).astype(np.float32)
    for white in (False, True):
        np.testing.assert_array_equal(common._composite_bkgd(rgba, white),
                                      jcommon._composite_bkgd(rgba, white))
    rgb = rgba[..., :3]
    assert common._composite_bkgd(rgb, True) is rgb


# every dataset type of the JAX package but the two the port loaded first
OTHER_TYPES = ("blender", "blendedmvs", "tankstemple", "nsvf", "deepvoxels", "free",
               "nerfstudio", "co3d", "linemod", "waymo", "mega")


@pytest.mark.parametrize("dataset_type", OTHER_TYPES)
def test_other_dataset_types_name_their_roadmap_item(tmp_path, dataset_type):
    """Every dataset type of the JAX package is ported (co3d and linemod
    last): each gets past the dispatch to its loader, which finds no capture
    in an empty directory; only an unknown type is refused."""
    cfg = port_cfg({"data": dict(dataset_type=dataset_type, datadir=str(tmp_path))})
    with pytest.raises((FileNotFoundError, OSError, ValueError)):
        common.load_everything(cfg)
    with pytest.raises(NotImplementedError, match="unknown dataset type"):
        common.load_everything(port_cfg({"data": dict(dataset_type="sfm_only")}))


# ---------------------------------------------------------------------------
# the port's scene writers, read back


def test_written_llff_scene_loads_alike_and_keeps_the_orbit(tmp_path):
    """Both loaders read the port's Mip-NeRF-360 writer alike. The orbit's
    cameras all look at the sphere at the origin; after spherification
    they sit at a mean distance of 1 from the new origin and still look at
    it: the gauge is a rotation and a scale about the sphere's centre."""
    data = synthetic.orbit_scene(10, 12, 16, seed=1, n_test=0)
    synthetic.write_llff_scene(str(tmp_path), data)
    cfg = _llff_cfg(tmp_path)
    got = common.load_everything(port_cfg(cfg))
    _assert_same_data(got, jcommon.load_everything(jax_cfg(cfg)))
    np.testing.assert_array_equal(got["images"], np.round(data["images"] * 255) / np.float32(255))
    pos = got["poses"][:, :3, 3]
    assert abs(np.linalg.norm(pos, axis=-1).mean() - 1.0) < 1e-3
    back = got["poses"][:, :3, 2]  # the camera looks along -back, at the origin
    np.testing.assert_allclose(-back, -pos / np.linalg.norm(pos, axis=-1, keepdims=True),
                               atol=1e-4)


def test_written_forward_facing_scene_loads_alike_with_ndc(tmp_path):
    """The forward-facing writer (cameras on a small plane, all looking down
    -z; LLFF layout, no spherify, ``ndc``) is read alike by both loaders, its
    views held out every 8th, and its NDC training rays equal the JAX
    package's (the ray origins all on the near plane, z = -1)."""
    data = synthetic.forward_facing_scene(9, 12, 16, seed=3)
    synthetic.write_llff_scene(str(tmp_path), data, factor=4, bounds=(2.5, 9.0))
    cfg = {"data": dict(dataset_type="llff", datadir=str(tmp_path), factor=4, ndc=True)}
    got = common.load_everything(port_cfg(cfg))
    _assert_same_data(got, jcommon.load_everything(jax_cfg(cfg)))
    assert list(got["i_test"]) == [0, 8] and (got["near"], got["far"]) == (0.0, 1.0)
    np.testing.assert_array_equal(got["images"], np.round(data["images"] * 255) / np.float32(255))
    i_train = np.asarray(got["i_train"])
    images, poses, Ks = (np.asarray(got[k])[i_train].astype(np.float32)
                         for k in ("images", "poses", "Ks"))
    mine = rays.get_training_rays_flatten(torch.from_numpy(images), torch.from_numpy(poses[:, :3]),
                                          12, 16, torch.from_numpy(Ks), ndc=True)
    theirs = jrays.get_training_rays_flatten(jnp.asarray(images), jnp.asarray(poses[:, :3]), 12,
                                             16, jnp.asarray(Ks), ndc=True)
    for name, g, w in zip(("rgb", "rays_o", "rays_d", "viewdirs", "img_index"), mine, theirs):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(mine[1][:, 2].numpy(), -1.0, atol=1e-6)


def test_written_nerfpp_scene_gives_the_scenes_own_rays(tmp_path):
    """The NeRF++ writer stores OpenCV poses: read with ``inverse_y`` they
    give the rays the scene was rendered with (OpenGL poses, no inverse_y)."""
    data = synthetic.orbit_scene(4, 12, 16, seed=2, n_test=2)
    synthetic.write_nerfpp_scene(str(tmp_path), data)
    cfg = _nerfpp_cfg(tmp_path)
    got = common.load_everything(port_cfg(cfg))
    _assert_same_data(got, jcommon.load_everything(jax_cfg(cfg)))
    assert list(got["i_test"]) == [4, 5]
    for i in range(6):
        loaded = rays.get_rays_of_a_view(12, 16, torch.from_numpy(got["Ks"][i]),
                                         torch.from_numpy(got["poses"][i]), inverse_y=True)
        orig = rays.get_rays_of_a_view(12, 16, torch.from_numpy(data["Ks"][i]),
                                       torch.from_numpy(data["poses"][i][:3]))
        for a, b in zip(loaded, orig):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
