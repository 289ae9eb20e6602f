"""The port's Waymo ingestion against the JAX package's, on the CPU: the
TFRecord framing and tf.Example codec, the street scene, the TFRecord decode,
the block split, ``extract_block_meta``, Block-NeRF's ray stores, and the
two Block-NeRF entry points.

The capture is the port's ``data/synthetic.py``: ``street_scene`` views of
12x16 (the JAX ``make_street_scene``'s, to 1e-5), written as the Waymo
release's gzipped TFRecords (``write_waymo_tfrecords``), a training file of
two cameras and a validation file. Both packages decode them;
``write_block_nerf_scene`` lays the port's decode out as Block-NeRF reads it.

The native framing (``csrc/tfrecord_io.cpp``, built by the host's compiler;
its cases skip where none is found) against the Python framing and the JAX
package's native one: the same records and the same errors, on valid
streams, every truncation and a sweep of byte mutations (the JAX package's
``tests/test_tfrecord.py`` fuzz).

Tolerances: bytes, CRCs, JSON and images equal; the decode's camera-to-world
matrices within 1e-5 (least squares through a float32 SVD; the rest of the
metadata equal); the ray stores and generated trajectories equal, the same
numpy on the same decoded pixels.
"""

import json
import os

import numpy as np
import pytest

from unboundednerfpytorch_tpu.data import preprocess as jpre
from unboundednerfpytorch_tpu.data import synthetic as jsyn
from unboundednerfpytorch_tpu.data import tfrecord as jtfr
from unboundednerfpytorch_tpu.models.block_nerf import dataset as jdataset
from unboundednerfpytorch_tpu_torch.data import png, preprocess, synthetic, tfrecord
from unboundednerfpytorch_tpu_torch.models.block_nerf import dataset
from unboundednerfpytorch_tpu_torch.tools import eval_block_nerf, train_block_nerf
from torch_threads import torch_threads  # noqa: F401: the workers' share of the cores

H, W = 12, 16
N_TRAIN, N_VAL = 8, 2


def test_crc32c_and_its_mask_equal_jax():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 8, 255, 4096, 70_001, 300_000):  # from 1 << 16 on through numpy
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert tfrecord.crc32c(data) == jtfr.crc32c(data)
        assert tfrecord.masked_crc(data) == jtfr.masked_crc(data)
    assert tfrecord.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


@pytest.mark.parametrize("compress", [False, True])
def test_records_cross_between_the_packages(tmp_path, compress):
    rng = np.random.default_rng(1)
    payloads = [b"", b"a" * 3, rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()]
    ours, theirs = str(tmp_path / "port.tfrecord"), str(tmp_path / "jax.tfrecord")
    tfrecord.write_records(ours, payloads, compress=compress)
    jtfr.write_records(theirs, payloads, compress=compress)
    if not compress:  # gzip stamps the time; the framing itself is byte-equal
        assert open(ours, "rb").read() == open(theirs, "rb").read()
    for verify in (False, True):
        assert jtfr.read_records(ours, verify_crc=verify) == payloads
        assert tfrecord.read_records(theirs, verify_crc=verify) == payloads


def test_examples_encode_and_parse_as_jax():
    feats = {"image": b"\x89PNGfake", "names": [b"a", b"bc"], "height": [7],
             "width": np.array([9]), "cam_idx": [300],
             "equivalent_exposure": np.array([1.25], np.float32),
             "ray_origins": np.arange(12, dtype=np.float32) - 3.5}
    payload = tfrecord.encode_example(feats)
    assert payload == jtfr.encode_example(feats)
    ours, theirs = tfrecord.parse_example(payload), jtfr.parse_example(payload)
    assert set(ours) == set(theirs) == set(feats)
    for k in feats:
        if isinstance(theirs[k], np.ndarray):
            np.testing.assert_array_equal(ours[k], theirs[k])
            assert ours[k].dtype == theirs[k].dtype
        else:
            assert ours[k] == theirs[k]


def test_a_corrupted_crc_is_detected(tmp_path):
    path = str(tmp_path / "r.tfrecord")
    tfrecord.write_records(path, [b"hello world" * 10])
    raw = bytearray(open(path, "rb").read())
    raw[20] ^= 0xFF  # a payload byte
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="crc"):
        tfrecord.read_records(path, verify_crc=True)
    assert tfrecord.read_records(path) == jtfr.read_records(path)
    with pytest.raises(ValueError, match="truncated"):
        tfrecord.split_records(bytes(raw[:-3]))


@pytest.fixture
def native_framing():
    """The native framing's library; the test skips where no host C++
    compiler is found to build it."""
    from unboundednerfpytorch_tpu_torch.ops.cuda import build

    if build.host_compiler() is None:
        pytest.skip("no host C++ compiler to build the native framing")
    return tfrecord.native_framing()


def _outcome(split, buf, verify):
    try:
        return "ok", split(buf, verify)
    except ValueError as e:
        return "err", str(e)


def _stream(sizes, seed=0):
    rng = np.random.default_rng(seed)
    payloads = [bytes(rng.integers(0, 256, n, dtype=np.uint8)) for n in sizes]
    out = b""
    for p in payloads:
        length = int(len(p)).to_bytes(8, "little")
        out += length + tfrecord.masked_crc(length).to_bytes(4, "little") + p + \
            tfrecord.masked_crc(p).to_bytes(4, "little")
    return payloads, out


@pytest.mark.parametrize("verify", [False, True])
def test_the_native_framing_equals_the_python_framing_on_corrupt_streams(native_framing, verify):
    """Every truncation point and every 5th byte flipped: the native
    framing's records, or its error message, are the Python framing's, and
    it rejects the same streams as the JAX package's native framing."""
    _, data = _stream((0, 1, 37, 300))
    jnat = jtfr._native_lib()
    cases = [data[:cut] for cut in range(len(data) + 1)]
    for pos in range(0, len(data), 5):
        mutated = bytearray(data)
        mutated[pos] ^= 0xA5
        cases.append(bytes(mutated))
    for buf in cases:
        py = _outcome(tfrecord.split_records_python, buf, verify)
        assert _outcome(tfrecord.split_records_native, buf, verify) == py
        if jnat is not None:
            assert _outcome(jtfr._split_records_native, buf, verify)[0] == py[0]
        if py[0] == "ok":
            assert all(0 <= o and o + n <= len(buf) for o, n in py[1])


def test_read_records_splits_natively(native_framing, tmp_path):
    payloads, data = _stream((1, 100, 4096, 0, 70_000), seed=3)
    huge = int(2**64 - 8).to_bytes(8, "little")
    for verify in (False, True):  # a length near 2^64 does not wrap the bounds check
        bad = huge + tfrecord.masked_crc(huge).to_bytes(4, "little") + bytes(64)
        assert _outcome(tfrecord.split_records_native, bad, verify) == \
            _outcome(tfrecord.split_records_python, bad, verify)
        assert tfrecord.split_records_native(data, verify) == \
            tfrecord.split_records_python(data, verify) == \
            [(int(o), int(n)) for o, n in jtfr._split_records_python(data, verify)]
    path = str(tmp_path / "r.tfrecord")
    tfrecord.write_records(path, payloads, compress=True)
    before = dict(tfrecord.FRAMINGS)
    assert tfrecord.read_records(path, verify_crc=True) == payloads
    assert tfrecord.FRAMINGS["native"] == before.get("native", 0) + 1


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """The street scene as TFRecords, decoded by both packages."""
    root = tmp_path_factory.mktemp("waymo")
    views, images = synthetic.street_scene(N_TRAIN + N_VAL, H, W, n_steps=96)
    cams = [73, 74] * (N_TRAIN // 2) + [73] * N_VAL
    records = [synthetic.write_waymo_tfrecords(str(root / "waymo_train.tfrecord.gz"),
                                               views[:N_TRAIN], images[:N_TRAIN], cams[:N_TRAIN]),
               synthetic.write_waymo_tfrecords(str(root / "waymo_validation.tfrecord.gz"),
                                               views[N_TRAIN:], images[N_TRAIN:], cams[N_TRAIN:])]
    ours = preprocess.decode_waymo_tfrecords(records, str(root / "port"))
    theirs = jpre.decode_waymo_tfrecords(records, str(root / "jax"))
    return root, views, images, ours, theirs


def test_the_street_scene_equals_jax():
    views, images = synthetic.street_scene(4, 6, 8, n_steps=64)
    jviews, jimages = jsyn.make_street_scene(4, 6, 8, n_steps=64)
    assert views == jviews
    for got, ref in zip(images, jimages):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert synthetic.split_street_blocks(views) == jsyn.split_street_blocks(jviews)


def test_decode_waymo_tfrecords_equals_jax(capture):
    root, views, images, ours, theirs = capture
    assert json.load(open(root / "port" / "metadata.json")) == ours
    assert set(ours) == set(theirs) == {"train", "val"}
    for split in ours:
        assert len(ours[split]["file_path"]) == (N_TRAIN if split == "train" else N_VAL)
        for k in ours[split]:
            if k in ("cam2world", "position"):  # the port sums the pixels in float64
                np.testing.assert_allclose(ours[split][k], theirs[split][k], rtol=0, atol=1e-5)
            else:
                assert ours[split][k] == theirs[split][k], k
        for path in ours[split]["file_path"]:
            np.testing.assert_array_equal(png.imread(str(root / "port" / path)),
                                          png.imread(str(root / "jax" / path)))
    # the recovered pose is the view's (the rays were made from it)
    c2w = np.asarray(ours["train"]["cam2world"][1])
    np.testing.assert_allclose(c2w[:3], np.asarray(views[1]["c2w"]), atol=1e-5)


def test_the_decode_sums_the_pixels_in_float64(tmp_path):
    """JAX's fault, not reproduced: its decode averages a frame's ray
    origins in float32, row by row; at 400x600 a camera at x = -3.2 moves by
    some 8e-3. The port's sums run in float64."""
    from unboundednerfpytorch_tpu_torch.data.synthetic import look_at_pose

    c2w = look_at_pose(np.array([-3.2, 0.0, 0.55]), np.array([-1.0, 1.1, 0.25]))
    info = {"c2w": c2w[:3].tolist(), "intrinsics": [480.0, 480.0], "W": 600, "H": 400,
            "equivalent_exposure": 1.0, "image_name": "far"}
    path = synthetic.write_waymo_tfrecords(str(tmp_path / "waymo_train.tfrecord"), [info],
                                           [np.zeros((400, 600, 3), np.float32)], [73],
                                           compress=False)
    ours = preprocess.decode_waymo_tfrecords([path], str(tmp_path / "port"), splits=("train",))
    theirs = jpre.decode_waymo_tfrecords([path], str(tmp_path / "jax"), splits=("train",))
    got, ref = (np.asarray(m["train"]["cam2world"][0]) for m in (ours, theirs))
    np.testing.assert_allclose(got[:3], c2w[:3], rtol=0, atol=1e-6)
    assert np.abs(ref[:3, 3] - c2w[:3, 3]).max() > 1e-3


def test_the_block_split_equals_jax(capture):
    _, _, _, ours, _ = capture
    for r, overlap in ((2.0, 0.5), (1.0, 0.3), (3.5, 0.8)):
        assert preprocess.solve_block_diameter(r, overlap) == jpre.solve_block_diameter(r, overlap)
    origins = dict(zip(ours["train"]["file_path"], ours["train"]["position"]))
    for radius in (0.8, 2.0, 5.0):
        got = preprocess.split_blocks(origins, radius=radius, overlap=0.5)
        assert got == jpre.split_blocks(origins, radius=radius, overlap=0.5)
    assert len(preprocess.split_blocks(origins, radius=2.0)) >= 2


@pytest.fixture(scope="module")
def block_root(capture):
    root = capture[0]
    blocks = synthetic.write_block_nerf_scene(str(root / "port"), str(root / "blocks"),
                                              radius=2.5, overlap=0.5)
    assert len(blocks) >= 2
    return str(root / "blocks"), blocks


def test_extract_block_meta_equals_jax(block_root, tmp_path):
    root, blocks = block_root
    for b in range(len(blocks)):
        ours = preprocess.extract_block_meta(root, b, str(tmp_path / f"port{b}"))
        theirs = jpre.extract_block_meta(root, b, str(tmp_path / f"jax{b}"))
        assert ours == theirs
        for split in ("train", "val", "test"):
            for path in ours[split]["file_path"]:
                assert open(tmp_path / f"port{b}" / path, "rb").read() == \
                    open(tmp_path / f"jax{b}" / path, "rb").read()


def test_the_block_ray_stores_and_trajectories_equal_jax(block_root):
    root, blocks = block_root
    for block in blocks:
        for downscale in (1, 2):
            (ours, n), (theirs, jn) = (
                f(root, block=block, img_downscale=downscale, near=0.05, far=14.0)
                for f in (dataset.load_block_ray_store, jdataset.load_block_ray_store))
            assert n == jn and set(ours) == set(theirs)
            for k in ours:
                np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
        for got, ref in zip(dataset.load_val_rays(root, block, img_downscale=1),
                            jdataset.load_val_rays(root, block, img_downscale=1), strict=True):
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g, r)
    meta = json.load(open(os.path.join(root, "train", "train_all_meta.json")))
    names = list(meta)
    elements = blocks["block_0"]["elements"]
    for name in names:
        assert dataset.find_nearest_appearance_idx(meta[name], elements, meta) == \
            jdataset.find_nearest_appearance_idx(meta[name], elements, meta)
    pairs = [(dataset.gen_test_rays(meta[names[0]], 1, n_frames=3, img_downscale=2),
              jdataset.gen_test_rays(meta[names[0]], 1, n_frames=3, img_downscale=2)),
             (dataset.gen_compose_rays(meta, names[0], names[-1], 0, frame_step=2.0),
              jdataset.gen_compose_rays(meta, names[0], names[-1], 0, frame_step=2.0))]
    for got, ref in pairs:
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            for a, b in zip(g, r):
                np.testing.assert_array_equal(a, b)


def test_the_block_nerf_entry_points_train_and_compose_on_the_cpu(block_root, tmp_path,
                                                                   monkeypatch):
    root, blocks = block_root
    monkeypatch.chdir(tmp_path)
    common = ["--root_dir", root, "--img_downscale", "2", "--near", "0.05", "--far", "14"]
    for block in blocks:
        assert train_block_nerf.main(common + ["--block_index", block, "--steps", "2",
                                               "--batch_size", "32", "--n_samples", "4",
                                               "--n_importance", "4"], device="cpu") == 0
        meta = json.load(open(tmp_path / "logs" / "block_nerf" / block / "meta.json"))
        assert meta["block"] == block and meta["steps"] == 2 and np.isfinite(meta["psnr"])
        assert meta["model_kwargs"]["W"] == 256 and meta["model_kwargs"]["D"] == 8
    train_meta = json.load(open(os.path.join(root, "train", "train_all_meta.json")))
    # a view in two blocks that is neither block's centroid (at a centroid the
    # inverse-distance weight is infinite, in both packages)
    shared = [n for n in train_meta
              if sum(n in (e[0] for e in b["elements"]) for b in blocks.values()) > 1
              and not any(np.allclose(train_meta[n]["origin_pos"], b["centroid"])
                          for b in blocks.values())]
    assert shared, "no view lies in two blocks"
    out = tmp_path / "compose"
    assert eval_block_nerf.main(common + ["--ckpt_dir", "logs/block_nerf", "--out_dir", str(out),
                                          "--cam_begin", shared[0], "--cam_end", shared[0],
                                          "--chunk", "100"], device="cpu") == 0
    frame = png.imread(str(out / f"{shared[0]}.png"))
    assert frame.shape == (H // 2, W // 2, 3) and frame.dtype == np.uint8
    assert (out / "compose.mp4").exists() or (out / "compose_frames").is_dir()
    # --data_parallel 2 (ported, ROADMAP A18b): the first block's run again on
    # two gloo ranks, as torchrun would run it; the same parameters after its
    # two steps (1e-5 / 1e-6: the gradient sums run in another order)
    from unboundednerfpytorch_tpu_torch.parallel import spawn
    from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt

    first = next(iter(blocks))
    argv = common + ["--block_index", first, "--steps", "2", "--batch_size", "32",
                     "--n_samples", "4", "--n_importance", "4", "--data_parallel", "2",
                     "--exp_name", "block_nerf_dp"]
    assert spawn.run(spawn.run_main, 2, str(tmp_path / "store"),
                     "unboundednerfpytorch_tpu_torch.tools.train_block_nerf", argv) == [0, 0]
    dp, _ = ckpt.load_block_nerf(str(tmp_path / "logs" / "block_nerf_dp" / first))
    one, _ = ckpt.load_block_nerf(str(tmp_path / "logs" / "block_nerf" / first))
    for (name, got), want in zip(dp.state_dict().items(), one.state_dict().values()):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
