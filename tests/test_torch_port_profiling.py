"""The port's tracing (``utils/profiling.py``) and the host's waits on the
card (``device.py``), on the CPU.

``span`` opens a ``record_function`` range only while a profiler records.
A tiny FourierGrid and a tiny DCVGO (the configs of the benchmark's cells,
bicycle_single.py and bicycle.py, at 15^3 voxels) show, under a CPU
profiler, the ``backward/gather`` and ``backward/march`` spans inside the
step's ``train_step/backward`` (the march through ``FusedMarch`` with its
kernels replaced by their plain versions, as on the card); their train step
and their render view open one ``sync/*`` span for each call of the helpers,
and, once warm, a step copies nothing and a view only its camera and image,
every constant of theirs an ``h2d/reused`` span, but that DCVGO's forward
reads back one count, its kept samples' (``models/common.py::colour``); no
port module but ``device.py`` copies host values to the device or reads the
device's back. On the card (marked ``cuda``), every synchronisation that
CUDA reports during a step and a view comes from ``device.py``: FourierGrid's
none in a warm step and three in a warm view, DCVGO's one more a forward.
``trace`` writes a Chrome trace of a train step that holds its
``train_step/*`` ranges.
"""

import collections
import contextlib
import json
import pathlib
import sys
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import unboundednerfpytorch_tpu_torch
from unboundednerfpytorch_tpu_torch import device as device_mod
from unboundednerfpytorch_tpu_torch.configs.loader import load_config
from unboundednerfpytorch_tpu_torch.models import common
from unboundednerfpytorch_tpu_torch.ops.cuda import march
from unboundednerfpytorch_tpu_torch.render.renderer import render_image
from unboundednerfpytorch_tpu_torch.train import loop
from unboundednerfpytorch_tpu_torch.train.step import create_train_state, make_train_step
from unboundednerfpytorch_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = pathlib.Path(unboundednerfpytorch_tpu_torch.__file__).resolve().parent
HELPER = pathlib.Path(device_mod.__file__).resolve()
CONFIGS = {"FourierGrid": "bicycle_single.py", "dcvgo": "bicycle.py"}
N_RAYS, H, W, CHUNK = 64, 12, 16, 64  # a view of 3 chunks


def forwards(family, unit):
    """The reads back of a unit's forwards: DCVGO's, one a forward (its kept
    samples' count), a step's one, a view's one a chunk."""
    return 0 if family == "FourierGrid" else 1 if unit == "train" else -(-H * W // CHUNK)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA's synchronisation report has no CPU mode")


def tiny(tmp_path, family, dev):
    """(train_step, state, batch, render) of the family's benchmark config
    at 15^3 voxels, random grids, with the window's step (16,000: dense TV,
    Adam) and budgets small enough to cut the rays' samples."""
    f = tmp_path / f"{family}.py"
    f.write_text(f"""
_base_ = {str(ROOT / 'configs' / 'nerf_unbounded' / CONFIGS[family])!r}
fine_train = dict(N_rand={N_RAYS}, pg_scale=[])
fine_model_and_render = dict(num_voxels_density=16**3, num_voxels_base_density=16**3,
    num_voxels_rgb=16**3, num_voxels_base_rgb=16**3, rgbnet_width=16, sample_budget=24,
    color_budget=8)
""")
    cfg = load_config(str(f))
    fm, ft = cfg.fine_model_and_render, cfg.fine_train
    name, mcfg, params = loop.build_model(cfg, fm, ft, (-1.2,) * 3, (1.2,) * 3,
                                          torch.Generator().manual_seed(0), dev)
    assert name == family
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        params.density.grid.copy_(torch.randn(params.density.grid.shape, generator=g) * 4)
        params.k0.grid.copy_(torch.randn(params.k0.grid.shape, generator=g) * 0.5)
    rk = {"near": 0.0, "far": 1e9, "bg": 0.0, "stepsize": fm.stepsize}
    step = make_train_step(loop.make_forward(mcfg, rk), ft,
                           world_size_max=float(max(mcfg.world_size)))
    state = create_train_state(params, ft, start_step=15999)
    rays = torch.randn(3, N_RAYS, 3, generator=g)
    batch = {"rgb": rays[0].abs().clamp(max=1), "rays_o": rays[1] * 0.3, "rays_d": rays[2],
             "viewdirs": rays[2] / rays[2].norm(dim=-1, keepdim=True)}
    batch = {k: v.to(dev) for k, v in batch.items()}
    K = np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]])
    c2w = np.concatenate([np.eye(3), [[0.0], [0.0], [0.2]]], axis=1)

    def render():
        params.requires_grad_(False)
        cache = loop.FAMILIES[family].build_render_cache(params, mcfg)
        fwd = loop.make_forward(mcfg, rk, cache=cache)
        return lambda: render_image(lambda ro, rd, vd: fwd(params, ro, rd, vd), H, W, K, c2w,
                                    chunk=CHUNK, device=dev)

    return step, state, batch, render


def run_unit(tmp_path, family, unit, dev="cpu"):
    """The unit's callable, warmed up once."""
    step, state, batch, render = tiny(tmp_path, family, dev)
    fn = (lambda: step(state, batch)) if unit == "train" else render()
    fn()
    return fn


def ranges(prof, prefix):
    return [e for e in prof.events() if e.name.startswith(prefix)]


@contextlib.contextmanager
def host_copies(monkeypatch):
    """Every call of ``torch.tensor``, ``torch.as_tensor`` and
    ``Tensor.cpu`` from a file of the port: (function, file, line)."""
    calls = []

    def recorder(what, orig):
        def call(*args, **kwargs):
            frame = sys._getframe(1)
            path = pathlib.Path(frame.f_code.co_filename).resolve()
            if PORT in path.parents:
                calls.append((what, path, frame.f_lineno))
            return orig(*args, **kwargs)
        return call

    with monkeypatch.context() as m:
        m.setattr(torch, "tensor", recorder("tensor", torch.tensor))
        m.setattr(torch, "as_tensor", recorder("as_tensor", torch.as_tensor))
        m.setattr(torch.Tensor, "cpu", recorder("cpu", torch.Tensor.cpu))
        yield calls


@pytest.mark.parametrize("recording", [False, True], ids=["no_profiler", "cpu_profiler"])
def test_span_opens_a_range_only_under_a_profiler(monkeypatch, recording):
    made = []
    real = profiling.record_function

    def record_function(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "record_function", record_function)
    recorder = profile(activities=[ProfilerActivity.CPU]) if recording else contextlib.nullcontext()
    with recorder as prof:
        with profiling.span("test/span"):
            torch.ones(4).sum()
    if recording:
        assert made == ["test/span"]
        assert len(ranges(prof, "test/span")) == 1
    else:
        assert made == []
        assert profiling.span("a") is profiling.span("b")  # one shared null context


def _march_forward_plain(density, mask, shift, interval, residuals=True):
    alpha = torch.where(mask, march.alpha_ops.raw2alpha(density, shift, interval), 0.0)
    t_excl = torch.cat([torch.ones_like(alpha[:, :1]), torch.cumprod(1 - alpha, -1)[:, :-1]], -1)
    w, ai = march.alpha_ops.alpha2weights(alpha)
    return w, ai, alpha, t_excl


@pytest.mark.parametrize("family", ["FourierGrid", "dcvgo"])
def test_backward_spans_lie_inside_the_steps_backward(tmp_path, monkeypatch, family):
    """The grids' gather backward and the march's (``FusedMarch``, its two
    launches replaced by their plain versions) under ``backward/*``, inside
    ``train_step/backward``; the gather's ``index_add_`` inside its span."""

    def fused(density, mask, shift, interval):
        if torch.is_grad_enabled() and density.requires_grad:
            return march.FusedMarch.apply(density, mask, float(shift), float(interval))
        return march.fused_alpha2weights_plain(density, mask, shift, interval)

    monkeypatch.setattr(common, "fused_alpha2weights", fused)
    monkeypatch.setattr(march, "march_forward", _march_forward_plain)
    monkeypatch.setattr(march, "march_backward", march.march_backward_plain)
    fn = run_unit(tmp_path, family, "train")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    (bwd,) = ranges(prof, "train_step/backward")
    gather, marches = ranges(prof, "backward/gather"), ranges(prof, "backward/march")
    assert len(gather) == 2 and len(marches) == 1  # density's and k0's gathers; one march
    for e in gather + marches:
        assert bwd.time_range.start <= e.time_range.start <= e.time_range.end \
            <= bwd.time_range.end
    adds = ranges(prof, "aten::index_add_")
    assert adds and all(any(g.time_range.start <= a.time_range.start <= g.time_range.end
                            for g in gather) for a in adds)


@pytest.mark.parametrize("unit", ["train", "render"])
@pytest.mark.parametrize("family", ["FourierGrid", "dcvgo"])
def test_a_sync_span_for_every_call_of_the_helpers(tmp_path, monkeypatch, family, unit):
    """A ``sync/h2d`` span for each copy, a ``sync/d2h`` for each read back.
    Warm, a step copies nothing and reuses its constants (FourierGrid 10,
    DCVGO 9, whatever the batch); a view copies K and c2w, reuses
    FourierGrid's 12 constants a chunk or DCVGO's 9, and reads its image;
    each DCVGO forward reads back its kept samples' count."""
    fn = run_unit(tmp_path, family, unit)
    with host_copies(monkeypatch) as calls, profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    helper = collections.Counter(what for what, path, _ in calls if path == HELPER)
    spans = collections.Counter(e.name for e in ranges(prof, "sync/"))
    assert set(spans) <= {"sync/h2d", "sync/d2h"}
    assert (spans["sync/h2d"], spans["sync/d2h"]) == (helper["as_tensor"], helper["cpu"])
    chunks = -(-H * W // CHUNK)
    per_chunk = {"FourierGrid": 12, "dcvgo": 9}[family]
    reused = ({"FourierGrid": 10, "dcvgo": 9}[family] if unit == "train"
              else chunks * per_chunk)
    assert spans["sync/h2d"] == (0 if unit == "train" else 2)
    assert spans["sync/d2h"] == (unit == "render") + forwards(family, unit)
    assert len(ranges(prof, "h2d/reused")) == reused


@pytest.mark.parametrize("unit", ["train", "render"])
@pytest.mark.parametrize("family", ["FourierGrid", "dcvgo"])
def test_only_the_helpers_copy_between_host_and_device(tmp_path, monkeypatch, family, unit):
    """During a step or a view no port module but ``device.py`` calls
    ``torch.tensor``, ``torch.as_tensor`` or ``Tensor.cpu``; warm, a step
    calls none of them, and a view copies K and c2w and reads its image;
    each DCVGO forward reads back its kept samples' count."""
    fn = run_unit(tmp_path, family, unit)
    with host_copies(monkeypatch) as calls:
        fn()
    outside = [(what, str(path.relative_to(PORT)), line) for what, path, line in calls
               if path != HELPER]
    assert outside == []
    want = collections.Counter({} if unit == "train" else {"as_tensor": 2, "cpu": 1})
    want["cpu"] += forwards(family, unit)
    assert collections.Counter(what for what, _, _ in calls) == want


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["FourierGrid", "dcvgo"])
def test_on_the_card_every_synchronisation_is_the_helpers(cuda, tmp_path, family):
    """With CUDA's synchronisation report on, a warm step and a warm view of
    each family synchronise only in ``device.py``, once a ``sync/*`` span:
    the step never, the view three times (K, c2w, the image), and DCVGO's
    once more a forward (its kept samples' count)."""
    fns = {unit: run_unit(tmp_path, family, unit, "cuda") for unit in ("train", "render")}
    for unit, fn in fns.items():
        torch.cuda.synchronize()
        try:
            with warnings.catch_warnings(record=True) as caught, \
                    profile(activities=[ProfilerActivity.CPU]) as prof:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                fn()
                torch.cuda.set_sync_debug_mode("default")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
        where = collections.Counter(f"{w.filename}:{w.lineno}: {str(w.message)[:80]}"
                                    for w in caught)
        assert all(pathlib.Path(w.filename).resolve() == HELPER for w in syncs), where
        want = (0 if unit == "train" else 3) + forwards(family, unit)
        assert len(syncs) == len(ranges(prof, "sync/")) == want, where


def test_trace_writes_the_train_steps_ranges(tmp_path):
    from unboundednerfpytorch_tpu_torch.data import synthetic
    from unboundednerfpytorch_tpu_torch.data.common import load_everything

    synthetic.write_llff_scene(str(tmp_path / "scene"), synthetic.orbit_scene(9, 12, 16, seed=5))
    cfg_file = tmp_path / "cfg.py"
    cfg_file.write_text(f"""
_base_ = {str(ROOT / 'configs' / 'nerf_unbounded' / 'bicycle_single.py')!r}
basedir = {str(tmp_path / 'logs')!r}
data = dict(datadir={str(tmp_path / 'scene')!r})
fine_train = dict(N_iters=3, N_rand=64, pg_scale=[])
fine_model_and_render = dict(num_voxels_density=12**3, num_voxels_base_density=12**3,
    num_voxels_rgb=12**3, num_voxels_base_rgb=12**3, sample_budget=0, fourier_freq_num=1)
""")
    cfg = load_config(str(cfg_file))
    data = load_everything(cfg)
    state = {}

    def callback(step, metrics):  # steps 2 and 3 traced
        if step == 1:
            state["trace"] = profiling.trace(str(tmp_path / "trace"), device="cpu")
            state["prof"] = state["trace"].__enter__()
        elif step == 3:
            state["trace"].__exit__(None, None, None)

    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiling.trace(str(tmp_path / "none")):
            pass
    loop.run_train(cfg, data, device="cpu", log_fn=lambda _: None, callback=callback)
    keys = {e.key for e in state["prof"].key_averages()}
    wanted = {"train_step/forward_loss", "train_step/backward", "train_step/tv",
              "train_step/adam"}
    assert wanted <= keys, sorted(keys)[:40]
    events = json.loads((tmp_path / "trace" / profiling.TRACE_FILE).read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert wanted <= names
    forward = [e for e in events["traceEvents"] if e.get("name") == "train_step/forward_loss"]
    assert len(forward) == 2  # one a traced step
