"""The port's training panels (``utils/observability.py``, ``i_panel``), its
render server (``tools/serve.py``) and ARF (``render/arf.py``) on the CPU.

``write_panel`` and ``record_panel`` against the JAX package's on the same
seeded images: the same PNG bytes (both write through PIL, with matplotlib's
colormap for the depth), PSNR and record. A tiny ``i_panel`` run through the
loop (DVGO at 16^3 on 6 views of 12x16): a panel every ``i_panel`` steps and
at the last, its PSNR that of ``render_image`` of the same view through the
trained model. ``RenderService`` on a random DVGO checkpoint and on its
reference ``.tar``, served on localhost: ``/health``, ``/meta`` and
``/render``, whose PNG decodes to ``render_image`` of the same pose to the
bit. ARF's colour transfer against the JAX package's within 1e-5 (float32
SVDs of 3x3 covariances).
"""

import dataclasses
import importlib.util
import io
import json
import pathlib
import threading
import urllib.request
from http.server import HTTPServer

import numpy as np
import pytest
import torch

from unboundednerfpytorch_tpu.render import arf as jarf
from unboundednerfpytorch_tpu.utils import observability as jobs
from unboundednerfpytorch_tpu_torch.configs.schema import (
    DataConfig, ExpConfig, ModelRenderConfig, TrainStageConfig,
)
from unboundednerfpytorch_tpu_torch.data import synthetic
from unboundednerfpytorch_tpu_torch.render import arf, renderer
from unboundednerfpytorch_tpu_torch.tools import serve
from unboundednerfpytorch_tpu_torch.train import loop
from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt
from unboundednerfpytorch_tpu_torch.utils import metrics as M
from unboundednerfpytorch_tpu_torch.utils import observability as obs
from unboundednerfpytorch_tpu_torch.utils import reference_import as ri

SMALL = dict(num_voxels_rgb=16**3, num_voxels_density=16**3, num_voxels_base_rgb=16**3,
             num_voxels_base_density=16**3, rgbnet_dim=6, rgbnet_width=16, rgbnet_depth=2,
             alpha_init=1e-2, fast_color_thres=1e-4, maskout_near_cam_vox=False)


def images(seed=0, H=10, W=14):
    rng = np.random.default_rng(seed)
    gt, pred = rng.random((2, H, W, 3)).astype(np.float32)
    depth = rng.uniform(1.0, 5.0, (H, W)).astype(np.float32)
    bgmap = (rng.random((H, W)) > 0.7).astype(np.float32)
    return gt, pred, depth, bgmap


@pytest.mark.parametrize("with_bgmap", [True, False])
def test_write_and_record_panel_match_jax(tmp_path, with_bgmap):
    gt, pred, depth, bgmap = images()
    bg = bgmap if with_bgmap else None
    np.testing.assert_array_equal(obs.depth_vis(depth, bg), jobs.depth_vis(depth, bg))
    got = obs.write_panel(str(tmp_path / "port.png"), gt, pred, depth, bg)
    want = jobs.write_panel(str(tmp_path / "jax.png"), gt, pred, depth, bg)
    assert got == want
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
    for mod, name in ((obs, "port"), (jobs, "jax")):
        for step in (3, 6):
            mod.record_panel(str(tmp_path / name), "fine", step, gt, pred * 0.5 + 0.25, depth,
                             bg)
    for rel in ("panels/panels.jsonl", "panels/fine_000003.png", "panels/fine_000006.png"):
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()


def test_i_panel_writes_panels_through_the_loop(tmp_path):
    data = synthetic.orbit_scene(6, 12, 16, seed=2, n_test=1)
    cfg = ExpConfig(data=DataConfig(white_bkgd=False),
                    coarse_train=dataclasses.replace(TrainStageConfig(), N_iters=0),
                    fine_train=TrainStageConfig(N_iters=5, N_rand=256, pg_scale=(), i_panel=2),
                    fine_model_and_render=ModelRenderConfig(**SMALL))
    fam, mcfg, params, _ = loop.run_train(cfg, data, device="cpu", log_fn=lambda _: None,
                                          exp_dir=str(tmp_path))
    records = [json.loads(line) for line in open(tmp_path / "panels" / "panels.jsonl")]
    assert [(r["stage"], r["step"]) for r in records] == [("fine", 2), ("fine", 4), ("fine", 5)]
    for r in records:
        assert (tmp_path / r["panel"]).is_file()
    from PIL import Image

    panel = np.asarray(Image.open(tmp_path / records[-1]["panel"]))
    assert panel.shape == (12, 4 * 16, 3)
    view = int(data["i_test"][0])
    params.requires_grad_(False)
    fwd = loop.make_forward(mcfg, {"near": data["near"], "far": data["far"], "bg": 0.0,
                                   "stepsize": cfg.fine_model_and_render.stepsize})
    rgb, _, _ = renderer.render_image(lambda ro, rd, vd: fwd(params, ro, rd, vd, None), 12, 16,
                                      data["Ks"][view], data["poses"][view][:3, :4],
                                      device="cpu")
    assert round(M.psnr(rgb, data["images"][view]), 3) == pytest.approx(records[-1]["psnr"],
                                                                        abs=1e-3)
    np.testing.assert_array_equal(panel[:, 16:32], obs._to8b(rgb))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A random DVGO model (16^3, density N(-1, 3^2)) as a checkpoint
    directory and as a reference .tar."""
    root = tmp_path_factory.mktemp("serve")
    _, mcfg, params = loop.build_model(ExpConfig(), ModelRenderConfig(**SMALL),
                                       TrainStageConfig(pg_scale=()), (-1.0, -1.0, -1.0),
                                       (1.0, 1.0, 1.0), torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        params.density.grid.normal_(-1.0, 3.0, generator=gen)
        params.k0.grid.normal_(0.0, 0.5, generator=gen)
    ckpt.save_model(str(root / "fine_last"), "dvgo", mcfg, params, global_step=12)
    ri.export_checkpoint(str(root / "fine_last"), str(root / "run.tar"))
    return str(root / "fine_last"), str(root / "run.tar")


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return r.headers["Content-Type"], r.read()


@pytest.mark.parametrize("which", ["directory", "tar"])
def test_render_service_answers_on_the_cpu(checkpoints, which):
    from PIL import Image

    path = checkpoints[0] if which == "directory" else checkpoints[1]
    service = serve.RenderService(path, device="cpu")
    srv = HTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    port = srv.server_address[1]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        kind, body = _get(port, "/health")
        health = json.loads(body)
        assert kind == "application/json" and health["status"] == "ok"
        meta = json.loads(_get(port, "/meta")[1])
        assert meta == {k: v for k, v in health.items() if k != "status"}
        assert (meta["family"], meta["step"]) == ("dvgo", 12)
        np.testing.assert_allclose(meta["scene_center"], 0.0, atol=1e-7)
        assert meta["scene_radius"] == pytest.approx(np.sqrt(3.0), rel=1e-6)
        kind, png = _get(port, "/render?theta=30&phi=-15&r=1.5&w=20&h=14")
        assert kind == "image/png"
        got = np.asarray(Image.open(io.BytesIO(png)))
        # the same pose through render_image, independently of the service
        _, mcfg, params, _, _ = ckpt.load_model(path)
        params.requires_grad_(False)
        fwd = loop.make_forward(mcfg, {"near": 0.05, "far": 1e9, "bg": 1.0, "stepsize": 1.0})
        th, ph = np.radians(30.0), np.radians(-15.0)
        pos = 1.5 * np.sqrt(3.0) * np.array([np.cos(ph) * np.cos(th), np.cos(ph) * np.sin(th),
                                             np.sin(ph)])
        K = np.array([[24.0, 0, 10.0], [0, 24.0, 7.0], [0, 0, 1]], np.float32)
        rgb, _, _ = renderer.render_image(
            lambda ro, rd, vd: fwd(params, ro, rd, vd, None), 14, 20, K,
            synthetic.look_at_pose(pos, np.zeros(3))[:3, :4], device="cpu")
        np.testing.assert_array_equal(got, M.to8b(rgb))
        assert 0 < got.std()
        with pytest.raises(urllib.error.HTTPError, match="404"):
            _get(port, "/nothing")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()


def _jax_serve():
    """The JAX package's server, ``tools/serve.py``: a script beside the
    package, loaded from its file as the JAX package's own test loads it."""
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "serve.py"
    spec = importlib.util.spec_from_file_location("jax_tools_serve", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _decode(png: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(png))).astype(np.int16)


def test_render_service_matches_jax_on_a_reference_tar(checkpoints):
    """The port's ``RenderService`` and the JAX package's on the same
    reference ``.tar``: ``meta()`` equal (family, step, the orbit's centre
    and radius), and the PNG of each query within one 8-bit level of JAX's
    on at most 2 % of its pixels (the two renders agree to about 1e-6 in
    float32, so a value next to a rounding edge of ``to8b`` may land on
    either side)."""
    jservice = _jax_serve().RenderService(checkpoints[1])
    service = serve.RenderService(checkpoints[1], device="cpu")
    assert service.meta() == jservice.meta()
    for q in (dict(theta=30, phi=-15, r=1.5, w=20, h=14),
              dict(theta=-110, phi=25, r=1.3, w=16, h=12, focal=0.9)):
        got, want = _decode(service.render(**q)), _decode(jservice.render(**q))
        assert got.shape == want.shape == (q["h"], q["w"], 3)
        diff = np.abs(got - want)
        assert diff.max() <= 1 and np.mean(diff > 0) <= 0.02, (diff.max(), np.mean(diff > 0))
        assert 0 < got.std()


def test_arf_on_colours_of_fewer_than_three_directions():
    """Colours on a plane of colour space, as a white-backed render of one
    texture gives (white, and a base colour times a scalar): the transfer
    clamps the content's singular values at 1e-8, so the stylized set takes
    the style's mean (within 1e-5, float32) and the covariance S^1/2 Q S^1/2
    (S the style's, Q the projector on the colours' span), which is not the
    style's own. Its tolerance is 1 % of S's largest entry: the float32
    covariance gives the missing direction a variance near 1e-10, which the
    clamp turns into a few 1e-6 of S's there."""
    rng = np.random.default_rng(5)
    white = rng.random(3 * 20 * 30) < 0.4
    x = np.where(white[:, None], 1.0,
                 rng.random((3 * 20 * 30, 1)) * np.array([0.8, 0.5, 0.3]))
    mix = np.array([[1.0, 0.4, 0.1], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]]) / 1.2
    style = (np.array([0.45, 0.5, 0.55]) + 0.08 * rng.standard_normal((40, 50, 3)) @ mix)
    got, _ = arf.match_colors_for_image_set(x.reshape(3, 20, 30, 3).astype(np.float32),
                                            style.astype(np.float32), device="cpu")
    assert 0 < got.min() and got.max() < 1  # nothing clipped

    def mean_cov(a):
        a = np.asarray(a, np.float64).reshape(-1, 3)
        return a.mean(0), np.cov(a.T, bias=True)

    (m, c), (ms, cs), (_, cc) = mean_cov(got), mean_cov(style.astype(np.float32)), mean_cov(x)
    w, u = np.linalg.eigh(cc)
    assert w[0] < 1e-12 < 1e-3 < w[1]  # a plane: exactly one direction without variance
    ws, us = np.linalg.eigh(cs)
    root = us @ np.diag(np.sqrt(ws)) @ us.T
    want = root @ u @ np.diag(w / np.maximum(w, 1e-8)) @ u.T @ root
    tol = 0.01 * np.abs(cs).max()
    np.testing.assert_allclose(m, ms, rtol=0, atol=1e-5)
    np.testing.assert_allclose(c, want, rtol=0, atol=tol)
    assert np.abs(c - cs).max() > 10 * tol


def test_arf_runs_on_the_card_unless_told_otherwise(monkeypatch, tmp_path):
    """``ARF`` and ``match_colors_for_image_set`` with no device go to
    ``cuda``, as the port's other entry points do: without a GPU they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        arf.match_colors_for_image_set(np.zeros((1, 2, 2, 3), np.float32),
                                       np.zeros((2, 2, 3), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        arf.ARF(str(tmp_path), 0, 2, 2)


def test_arf_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    renders = rng.random((3, 9, 11, 3)).astype(np.float32) * 0.6 + 0.2
    style8 = (rng.random((20, 30, 3)) ** 2 * 255).astype(np.uint8)
    from PIL import Image

    Image.fromarray(style8).save(tmp_path / "0.jpg", quality=95)
    style = arf.load_style_img(str(tmp_path / "0.jpg"), 9, 11)
    np.testing.assert_array_equal(style, jarf.load_style_img(str(tmp_path / "0.jpg"), 9, 11))
    got, tf = arf.match_colors_for_image_set(renders, style, device="cpu")
    want, jtf = jarf.match_colors_for_image_set(renders, style)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tf, jtf, rtol=0, atol=1e-5)
    stylizer = arf.ARF(str(tmp_path), 0, 9, 11, device="cpu")
    out, _ = stylizer.match_colors_for_image_set(renders, str(tmp_path))
    np.testing.assert_array_equal(out, got)
    assert (tmp_path / "style_image.png").is_file()
