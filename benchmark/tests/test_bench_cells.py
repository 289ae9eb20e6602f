"""A dry run of every cell on the CPU at a tiny size: set-up, the window or
the traced window, the check against the plain reference, the result line;
and the faults and the control that the check must catch."""

from __future__ import annotations

import json

import pytest
from bench_tiny import CELLS, ROOT, run

from benchmark.core import check, spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(cell, trace):
    res = run(cell, trace=trace)
    assert list(res)[-1] == "checks"
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    c = spec.load(ROOT, cell)
    if trace:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "busy_s" in res["device"] and res["device"]["window_s"] > 0
        # no kernel ran on the CPU: the device's metrics are left out, not 0
        assert set(res["metrics"]) <= {m["name"] for m in c.per_layer}
    else:
        assert set(res["metrics"]) == {m["name"] for m in c.end_to_end}
        for m in c.end_to_end:
            assert res["metrics"][m["name"]]["unit"] == m["unit"]
            assert res["metrics"][m["name"]]["value"] > 0


@pytest.mark.parametrize("cell,fault", [
    ("bicycle_single.train", "state_unchanged"), ("bicycle_single.train", "half_batch"),
    ("bicycle_dcvgo.train", "state_unchanged"), ("bicycle_dcvgo.train", "half_batch"),
    ("bicycle_single.render", "answer_altered"), ("bicycle_dcvgo.render", "answer_altered"),
])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    res = run(cell, faults=[fault])
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_limit(cell):
    """The reference computed in bfloat16 in the program's place: at least
    one number passes its limit, while the program's own stay under."""
    res = run(cell, control=True)
    assert res["correct"], res["checks"]
    ok, checks = check.judge(res["control"], spec.load(ROOT, cell).limits)
    assert not ok, checks


def test_every_cell_has_its_limits_and_every_metric_its_reader():
    for w in BENCH["workloads"]:
        c = spec.load(ROOT, w["name"])
        assert set(c.limits) == set(c.kind.Unit.NUMBERS), w["name"]
    for m in BENCH["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists(), m["name"]


def test_a_leaf_that_moves_by_round_off_alone_is_left_out_of_the_change():
    ref = {"loss": [1.0], "grad": {"a": 1.0, "b": 2.0, "c": 1e-9},
           "change": {"a": 1.0, "b": 1.0, "c": 1e-6}}
    prog = {"loss": [1.0], "grad": dict(ref["grad"]), "change": {"a": 1.0, "b": 1.0, "c": 3e-6}}
    assert check.train_numbers(prog, ref)["change_gap"] == 0.0
    prog["change"]["a"] = 1.5
    assert check.train_numbers(prog, ref)["change_gap"] == pytest.approx(0.5)


def test_a_number_without_a_limit_or_not_finite_fails():
    assert check.judge({"x": 1e-9}, {}) == (False, {"x": {"value": 1e-9, "limit": None}})
    assert check.judge({"x": float("nan")}, {"x": 1.0})[0] is False
    assert check.judge({"x": 0.5}, {"x": 1.0})[0] is True
