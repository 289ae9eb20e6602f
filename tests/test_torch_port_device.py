"""``device.py::constant``: host constants made into device tensors once, on
the CPU.

Equal values get one tensor, equal to ``torch.as_tensor``'s; values that
differ in a bit, in their own dtype, or in the dtype or device asked for get
their own, and a NaN finds its entry again. A miss opens ``sync/h2d`` and a
hit ``h2d/reused``, only under a profiler; the table keeps the most recently
used ``CONSTANTS_KEPT``. Two warm training steps of the tiny FourierGrid and
DCVGO of ``test_torch_port_profiling.py`` give, bit for bit, the loss,
gradients and parameters of the same steps with a fresh ``torch.as_tensor``
at every site, and leave every shared constant as it was made.
"""

import collections
import contextlib
import math
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from unboundednerfpytorch_tpu_torch import device as device_mod
from unboundednerfpytorch_tpu_torch.utils import profiling

from test_torch_port_profiling import tiny


@pytest.fixture
def table(monkeypatch):
    """An empty table for the test."""
    t = collections.OrderedDict()
    monkeypatch.setattr(device_mod, "_constants", t)
    return t


def test_equal_values_share_one_tensor_equal_to_as_tensor(table):
    for values, dtype in [((0.5, -1.25, 3.0), torch.float32), ([4, 5, 6], torch.int64),
                          (torch.Size([7, 8, 9]), torch.float32), ((1.5, 2.0), torch.bfloat16),
                          ([2, 3], None), ((0.1, 0.2), None)]:
        t = device_mod.constant(values, dtype, "cpu")
        assert device_mod.constant(tuple(values), dtype, torch.device("cpu")) is t
        want = torch.as_tensor(values, dtype=dtype, device="cpu")
        assert t.dtype == want.dtype and t.shape == want.shape
        assert torch.equal(t, want)
    assert len(table) == 6


@pytest.mark.parametrize("a, b, dtype", [
    ((0.0,), (-0.0,), torch.float32),  # equal, but not in their bits
    ([1], [1.0], None),  # int64 against the default float dtype
    ((1.0, 2.0), (1.0, 2.0, 0.0), torch.float32),
    ((1.0, 2.0), ((1.0, 2.0),), torch.float32),  # another shape
], ids=["signed_zero", "int_float", "length", "shape"])
def test_values_that_differ_get_their_own_entry(table, a, b, dtype):
    ta, tb = device_mod.constant(a, dtype, "cpu"), device_mod.constant(b, dtype, "cpu")
    assert ta is not tb and len(table) == 2
    assert torch.equal(ta, torch.as_tensor(a, dtype=dtype))
    assert torch.equal(tb, torch.as_tensor(b, dtype=dtype))
    if a == (0.0,):
        assert math.copysign(1, ta.item()) == 1 and math.copysign(1, tb.item()) == -1
    if a == [1]:
        assert ta.dtype == torch.int64 and tb.dtype == torch.get_default_dtype()


def test_dtypes_and_devices_get_their_own_entry(table):
    values = (1.0, 2.5)
    f32, f64 = (device_mod.constant(values, d, "cpu") for d in (torch.float32, torch.float64))
    meta = device_mod.constant(values, torch.float32, "meta")
    assert len({id(f32), id(f64), id(meta)}) == 3 and len(table) == 3
    assert (f32.dtype, f64.dtype, meta.device.type) == (torch.float32, torch.float64, "meta")
    assert device_mod.constant(values, torch.float64, "cpu") is f64
    assert device_mod.constant(values, torch.float32, "meta") is meta


def test_a_nan_finds_its_entry(table):
    t = device_mod.constant((float("nan"), 1.0), torch.float32, "cpu")
    assert device_mod.constant((float("nan"), 1.0), torch.float32, "cpu") is t
    assert len(table) == 1 and torch.isnan(t[0]) and t[1] == 1.0


@pytest.mark.parametrize("recording", [False, True], ids=["no_profiler", "cpu_profiler"])
def test_a_miss_waits_and_a_hit_is_reused_in_the_trace(table, monkeypatch, recording):
    made = []
    real = profiling.record_function

    def record_function(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "record_function", record_function)
    recorder = profile(activities=[ProfilerActivity.CPU]) if recording else contextlib.nullcontext()
    with recorder as prof:
        for _ in range(3):
            device_mod.constant((0.25, 0.5), torch.float32, "cpu")
    if recording:
        assert made == ["sync/h2d", "h2d/reused", "h2d/reused"]
        names = collections.Counter(e.name for e in prof.events()
                                    if e.name in ("sync/h2d", "h2d/reused"))
        assert names == {"sync/h2d": 1, "h2d/reused": 2}
    else:
        assert made == []


def test_the_table_keeps_the_most_recently_used(table, monkeypatch):
    monkeypatch.setattr(device_mod, "CONSTANTS_KEPT", 4)
    first = [device_mod.constant((float(i),), torch.float32, "cpu") for i in range(4)]
    assert device_mod.constant((0.0,), torch.float32, "cpu") is first[0]  # now the newest
    device_mod.constant((4.0,), torch.float32, "cpu")  # evicts 1.0, the least recent
    assert len(table) == 4
    assert device_mod.constant((0.0,), torch.float32, "cpu") is first[0]
    again = device_mod.constant((1.0,), torch.float32, "cpu")
    assert again is not first[1] and torch.equal(again, first[1])
    for i in range(100):
        device_mod.constant((float(i),), torch.float32, "cpu")
    assert len(table) == 4


def _steps(tmp_path, family, n, on_warm=lambda: None):
    """Loss, gradients and parameters after each of ``n`` steps of the tiny
    model; ``on_warm`` is called after the first."""
    step, state, batch, _ = tiny(tmp_path, family, "cpu")
    out = []
    for i in range(n):
        loss = step(state, batch)["loss"].clone()
        params = list(state.params.parameters())
        out.append((loss, [None if p.grad is None else p.grad.clone() for p in params],
                    [p.detach().clone() for p in params]))
        if i == 0:
            on_warm()
    return out


@pytest.mark.parametrize("family", ["FourierGrid", "dcvgo"])
def test_shared_constants_give_the_steps_of_fresh_copies_to_the_bit(tmp_path, monkeypatch,
                                                                    table, family):
    made = {}
    shared = _steps(tmp_path, family, 3, lambda: made.update(
        {k: (t, t.clone(), t._version) for k, t in table.items()}))
    assert made, "the steps made no constant"
    assert table.keys() == made.keys()
    for t, copy, version in made.values():
        assert t._version == version and torch.equal(t, copy), "a caller wrote into a constant"
    sites = [m for name, m in sys.modules.items()
             if name.startswith("unboundednerfpytorch_tpu_torch.")
             and getattr(m, "constant", None) is device_mod.constant]
    assert sites
    for m in sites:
        monkeypatch.setattr(m, "constant", lambda v, dtype, device:
                            torch.as_tensor(v, dtype=dtype, device=device))
    fresh = _steps(tmp_path, family, 3)
    for (l1, g1, p1), (l2, g2, p2) in zip(shared, fresh):
        assert torch.equal(l1, l2)
        assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(g1, g2))
        assert all(torch.equal(a, b) for a, b in zip(p1, p2))
