"""The DVGO family's compacted forward against its dense forward, on the CPU.

``loop.make_forward`` runs the DCVGO, DVGO and DMPIGO forwards compacted:
after the march, k0 is looked up and the colour head run only at the samples
over both ``fast_color_thres`` thresholds, and their weighted colours are
added up a ray (``models/common.py::colour``). The dense forward colours
every sample slot (the forwards' default, which the JAX comparisons read).
Outside the kept mask the weights are 0, so the two give the same image,
weights, depth, losses and gradients but for the order of the sums: checked
here to 1e-6 for DCVGO, DVGO on a dense grid and on TensoRF fields, and
DMPIGO on NDC rays, each with and without the render cache (TensoRF has
none), with ``fast_color_thres`` 0 (every sample in the mask kept) and with
no sample kept (the background alone). Also the counter of the rows
coloured (``benchmark/spies/colour_rows.py``) and its two readers.

Tiny models: 20^3 voxels (DMPIGO 16 planes), random grids, rgbnet width 16.
"""

from __future__ import annotations

import contextlib
import copy
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.core import spec  # noqa: E402
from benchmark.core.spies import Spies  # noqa: E402
from unboundednerfpytorch_tpu_torch.configs.schema import (  # noqa: E402
    ModelRenderConfig, TrainStageConfig,
)
from unboundednerfpytorch_tpu_torch.models import common  # noqa: E402
from unboundednerfpytorch_tpu_torch.ops import rays as ray_ops  # noqa: E402
from unboundednerfpytorch_tpu_torch.train import bbox, loop  # noqa: E402
from unboundednerfpytorch_tpu_torch.train.step import (  # noqa: E402
    create_train_state, make_train_step,
)

N_RAYS = 48
XYZ_MIN, XYZ_MAX = (-2.0, -1.5, -1.0), (2.0, 2.5, 1.0)
MODEL_KW = dict(
    num_voxels_density=20**3, num_voxels_rgb=20**3, num_voxels_base_density=20**3,
    num_voxels_base_rgb=20**3, rgbnet_dim=4, rgbnet_width=16, alpha_init=1e-2,
    fast_color_thres=1e-3, bg_len=0.2, stepsize=0.5, mpi_depth=16,
    maskout_near_cam_vox=False)
TENSORF_KW = dict(density_type="TensoRFGrid", k0_type="TensoRFGrid",
                  density_config=(("n_comp", 2),), k0_config=(("n_comp", 3),))
TRAIN_KW = dict(
    N_rand=N_RAYS, lrate_density=0.1, lrate_k0=0.1, lrate_rgbnet=1e-3, lrate_decay=20,
    weight_main=1.0, weight_entropy_last=0.01, weight_distortion=0.01, weight_rgbper=0.1,
    tv_before=0, weight_tv_density=0.0, weight_tv_k0=0.0, pg_scale=())
RK = {"near": 0.2, "far": 1e9, "bg": 1.0, "stepsize": 0.5}
# (family, TensoRF fields, density offset): the offsets put some samples
# over the thresholds and leave most under them
FAMILIES = {"dcvgo": ("dcvgo", False, -4.0), "dvgo": ("dvgo", False, -4.0),
            "dvgo_tensorf": ("dvgo", True, -4.0), "dmpigo": ("dmpigo", False, -6.0)}
CASES = [(name, cache) for name in FAMILIES for cache in (False, True)
         if not (cache and FAMILIES[name][1])]  # TensoRF fields have no render cache


def ndc_setup():
    """A forward-facing 24x32 view's NDC rays (seeded pixels) and the NDC box
    of three such views."""
    H, W = 24, 32
    K = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, :2, 3] = np.random.default_rng(0).uniform(-0.3, 0.3, (3, 2))
    lo, hi = bbox.bbox_bounded(np.array([[H, W]] * 3), np.stack([K] * 3), poses, 0.0, 1.0,
                               ndc=True)
    ro, rd, vd = ray_ops.get_rays_of_a_view(H, W, torch.from_numpy(K),
                                            torch.from_numpy(poses[0, :3, :4]), ndc=True)
    pick = torch.from_numpy(np.random.default_rng(1).choice(H * W, N_RAYS, replace=False))
    return (lo, hi), [a.reshape(-1, 3)[pick] for a in (ro, rd, vd)]


def make(name, seed=0, offset=None, **overrides):
    """(family, model config, params, (rays_o, rays_d, viewdirs), target):
    random grids, density about ``offset``."""
    family, tensorf, default = FAMILIES[name]
    kw = {**MODEL_KW, **(TENSORF_KW if tensorf else {}), **overrides}
    if family == "dmpigo":
        (lo, hi), rays = ndc_setup()
    else:
        lo, hi = XYZ_MIN, XYZ_MAX
        rng = np.random.default_rng(seed + 1)
        center = (np.asarray(lo) + np.asarray(hi)) / 2
        o = center + rng.standard_normal((N_RAYS, 3)) * 1.5
        d = center + rng.standard_normal((N_RAYS, 3)) * 0.5 - o
        rays = [torch.from_numpy(a.astype(np.float32))
                for a in (o, d, d / np.linalg.norm(d, axis=-1, keepdims=True))]
    mod = loop.FAMILIES[family]
    mcfg = mod.config_from(ModelRenderConfig(**kw), lo, hi, kw["num_voxels_rgb"])
    g = torch.Generator().manual_seed(seed)
    params = mod.create(mcfg, g)
    offset = default if offset is None else offset
    with torch.no_grad():
        if tensorf:
            # the drawn planes and vectors (N(0, 0.1^2)) scaled, so that the
            # density's products span some +-8, about ``offset``
            for p in params.density.leaves().values():
                p.mul_(20.0)
            params.act_shift = params.act_shift + offset
        else:
            params.density.grid.copy_(torch.randn(params.density.grid.shape, generator=g) * 4
                                      + offset)
            params.k0.grid.copy_(torch.randn(params.k0.grid.shape, generator=g) * 0.5)
    target = torch.rand(N_RAYS, 3, generator=g)
    return family, mcfg, params, rays, target


@contextlib.contextmanager
def dense(monkeypatch):
    """``common.colour`` made to colour every sample slot: the dense forward,
    through the same calls of ``make_forward``."""
    orig = common.colour
    with monkeypatch.context() as m:
        m.setattr(common, "colour", lambda *args: orig(*args[:-1], False))
        yield


def close(a, b, rel=1e-6):
    """Equal to ``rel`` of the larger's largest element (and absolutely)."""
    tol = rel * max(1.0, float(b.abs().max()) if b.numel() else 1.0)
    torch.testing.assert_close(a, b, rtol=0.0, atol=tol)


def both_forwards(monkeypatch, family, mcfg, params, rays, cache):
    if cache:
        params.requires_grad_(False)
        table = loop.FAMILIES[family].build_render_cache(params, mcfg)
        assert table is not None
    fwd = loop.make_forward(mcfg, RK, cache=table if cache else None)
    with torch.no_grad():
        got = fwd(params, *rays)
        with dense(monkeypatch):
            want = fwd(params, *rays)
    return got, want


def check_forward(got, want):
    assert want.rgb_rows is None and want.raw_rgb.shape == (*want.mask.shape, 3)
    assert torch.equal(got.mask, want.mask)
    rows = want.mask.reshape(-1).nonzero()[:, 0]
    assert torch.equal(got.rgb_rows, rows) and got.raw_rgb.shape == (rows.numel(), 3)
    for f in ("rgb_marched", "weights", "alphainv_last", "depth"):
        close(getattr(got, f), getattr(want, f))
    if want.wsum_mid is not None:
        close(got.wsum_mid, want.wsum_mid)
    close(got.raw_rgb, want.raw_rgb.reshape(-1, 3)[rows])


@pytest.mark.parametrize("name,cache", CASES)
def test_the_compacted_forward_equals_the_dense_one(monkeypatch, name, cache):
    family, mcfg, params, rays, _ = make(name)
    got, want = both_forwards(monkeypatch, family, mcfg, params, rays, cache)
    n = int(want.mask.sum())
    assert 0 < n < 0.5 * want.mask.numel()  # the thresholds bite
    check_forward(got, want)


def one_step(family, mcfg, params, rays, target, monkeypatch=None):
    """One train step (the loop's forward, rgbper on): (loss, every
    parameter's gradient, the parameters after Adam)."""
    ft = TrainStageConfig(**TRAIN_KW)
    params = copy.deepcopy(params)
    state = create_train_state(params, ft)
    step = make_train_step(loop.make_forward(mcfg, RK), ft,
                           world_size_max=float(max(mcfg.world_size)))
    batch = {"rays_o": rays[0], "rays_d": rays[1], "viewdirs": rays[2], "rgb": target}
    with dense(monkeypatch) if monkeypatch is not None else contextlib.nullcontext():
        metrics = step(state, batch)
    named = dict(params.named_parameters())
    return (metrics, {k: p.grad for k, p in named.items()},
            {k: p.detach().clone() for k, p in named.items()})


@pytest.mark.parametrize("name", list(FAMILIES))
def test_a_compacted_train_step_equals_the_dense_one(monkeypatch, name):
    family, mcfg, params, rays, target = make(name, seed=3)
    got_m, got_g, got_p = one_step(family, mcfg, params, rays, target)
    want_m, want_g, want_p = one_step(family, mcfg, params, rays, target, monkeypatch)
    assert float(want_m["loss_rgbper"]) > 0
    for k in ("loss", "mse", "loss_rgbper", "loss_distortion", "loss_entropy"):
        close(got_m[k], want_m[k])
    assert got_g.keys() == want_g.keys()
    for k, g in want_g.items():
        assert (g is None) == (got_g[k] is None), k
        if g is not None:
            close(got_g[k], g)
    assert any(g is not None and g.abs().max() > 0 for k, g in want_g.items() if "k0" in k)
    for k, p in want_p.items():
        close(got_p[k], p)


@pytest.mark.parametrize("cache", [False, True])
def test_with_the_threshold_off_every_sample_of_the_mask_is_coloured(monkeypatch, cache):
    family, mcfg, params, rays, target = make("dcvgo", fast_color_thres=0.0)
    got, want = both_forwards(monkeypatch, family, mcfg, params, rays, cache)
    assert 0 < int(got.mask.sum()) == got.rgb_rows.numel()
    check_forward(got, want)
    if not cache:
        got_m, got_g, _ = one_step(family, mcfg, params, rays, target)
        want_m, want_g, _ = one_step(family, mcfg, params, rays, target, monkeypatch)
        close(got_m["loss"], want_m["loss"])
        for k, g in want_g.items():
            close(got_g[k], g)


@pytest.mark.parametrize("cache", [False, True])
def test_with_no_sample_kept_the_rays_give_the_background(monkeypatch, cache):
    family, mcfg, params, rays, target = make("dcvgo", offset=-60.0)
    got, want = both_forwards(monkeypatch, family, mcfg, params, rays, cache)
    assert not got.mask.any() and got.rgb_rows.numel() == 0 and got.raw_rgb.shape == (0, 3)
    check_forward(got, want)
    torch.testing.assert_close(got.rgb_marched, torch.full((N_RAYS, 3), RK["bg"]))
    if not cache:
        got_m, got_g, _ = one_step(family, mcfg, params, rays, target)
        want_m, want_g, _ = one_step(family, mcfg, params, rays, target, monkeypatch)
        close(got_m["loss"], want_m["loss"])
        for k, g in want_g.items():
            close(got_g[k], g)


class _Ctx:
    def __init__(self, totals):
        self.totals = totals


@pytest.mark.parametrize("cache", [False, True])
def test_the_counter_counts_the_rows_coloured_and_the_slots(monkeypatch, cache):
    family, mcfg, params, rays, _ = make("dcvgo")
    if cache:
        params.requires_grad_(False)
    table = loop.FAMILIES[family].build_render_cache(params, mcfg) if cache else None
    fwd = loop.make_forward(mcfg, RK, cache=table)
    spies = Spies(ROOT, {"colour_budget": 0})
    with spies.installed(), torch.no_grad():
        res = fwd(params, *rays)
        res2 = fwd(params, rays[0][:16], rays[1][:16], rays[2][:16])
    rows = int(res.mask.sum()) + int(res2.mask.sum())
    slots = res.mask.numel() + res2.mask.numel()
    assert 0 < rows < slots
    totals = spies.totals()
    assert totals["ops"]["colour_rows"] == (float(rows), float(slots))
    # the dense forward: every slot a row
    spies = Spies(ROOT, {"colour_budget": 0})
    with spies.installed(), torch.no_grad(), dense(monkeypatch):
        fwd(params, *rays)
    assert spies.totals()["ops"]["colour_rows"] == (float(res.mask.numel()),) * 2
    for metric in ("colour_share.train.dcvgo", "colour_share.render.dcvgo"):
        read = spec.module(ROOT, "metrics", metric).read
        assert read(_Ctx(totals)) == pytest.approx(rows / slots * 100.0)
        assert read(_Ctx({"ops": {}})) is None  # a program without the counter's target
