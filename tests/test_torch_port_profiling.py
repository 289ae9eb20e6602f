"""The port's tracing and timing (``utils/profiling.py``) against the JAX
package's on the CPU: ``StepTimer`` and ``RaysPerSecond`` give the same
summaries (every value equal) for the same clock readings, and ``trace``
writes a Chrome trace of a train step that holds its ``train_step/*``
ranges."""

import json
import pathlib

import numpy as np
import pytest

from unboundednerfpytorch_tpu.utils import profiling as jprof
from unboundednerfpytorch_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("warmup", [0, 2, 5])
def test_the_step_timer_summarises_as_jax(monkeypatch, warmup):
    rng = np.random.default_rng(warmup)
    readings = np.cumsum(rng.exponential(0.05, 40)).tolist()
    timers = []
    for mod in (jprof, profiling):
        clock = iter(readings)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        timer = mod.StepTimer(warmup=warmup)
        for _ in readings:
            timer.tick()
        timers.append(timer)
    want, got = (t.summary() for t in timers)
    assert got == want and got["n"] == len(readings) - 1 - warmup
    assert timers[1].times == timers[0].times
    assert profiling.StepTimer().summary() == jprof.StepTimer().summary() == {}


def test_rays_per_second_as_jax():
    meters = [jprof.RaysPerSecond(), profiling.RaysPerSecond()]
    assert [m.value for m in meters] == [0.0, 0.0]
    for n, s in ((4096, 0.25), (1000, 0.1), (7, 1e-3)):
        for m in meters:
            m.add(n, s)
    assert meters[1].value == meters[0].value
    assert (meters[1].rays, meters[1].seconds) == (meters[0].rays, meters[0].seconds)


def test_trace_writes_the_train_steps_ranges(tmp_path):
    from unboundednerfpytorch_tpu_torch.configs.loader import load_config
    from unboundednerfpytorch_tpu_torch.data import synthetic
    from unboundednerfpytorch_tpu_torch.data.common import load_everything
    from unboundednerfpytorch_tpu_torch.train import loop

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
    ranges = {"train_step/forward_loss", "train_step/backward", "train_step/tv",
              "train_step/adam"}
    assert ranges <= keys, sorted(keys)[:40]
    events = json.loads((tmp_path / "trace" / profiling.TRACE_FILE).read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert ranges <= names
    forward = [e for e in events["traceEvents"] if e.get("name") == "train_step/forward_loss"]
    assert len(forward) == 2  # one a traced step
