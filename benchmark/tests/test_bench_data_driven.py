"""A kind of traffic, a model family, a configuration, a traffic mix, a
cell, a counter and a per-layer metric are added by new files and new
entries alone: in a copy of the benchmark, nothing that is there is edited,
and the new cell runs on the CPU with its new kind, family, counter and
metrics."""

from __future__ import annotations

import hashlib
import json
import shutil

from bench_tiny import ROOT, TINY, run

from benchmark.core import spec
from benchmark.reference import recipe

# a kind: the train kind's step, its rate counted in steps, a new end-to-end metric
KIND = '''"""A test's kind of traffic: the train kind, its rate in steps."""

import pathlib

from benchmark.core import spec

Base = spec.module(pathlib.Path(__file__).resolve().parents[2], "kinds", "train").Unit


class Unit(Base):
    def window(self, seconds):
        w = super().window(seconds)
        w["metrics"] = {"train_steps_per_s": (w["attempted"] / w["seconds"], "steps/s")}
        return w
'''
# a family: FourierGrid's reference and hooks, found under a name of its own
FAMILY = '''"""A test's family: FourierGrid's, from its file."""

import pathlib

from benchmark.core import spec

_base = spec.module(pathlib.Path(__file__).resolve().parents[2], "families", "fourier_grid")
globals().update({k: v for k, v in vars(_base).items() if not k.startswith("_")})
'''
# a counter: masked Adam's parameter bytes, read once, of each call in the traced window
SPY = '''"""A test's counter: the bytes of masked Adam's parameters at each call."""

TARGET = ("unboundednerfpytorch_tpu_torch.ops.cuda.adam", "masked_adam")


def wrap(orig, spies):
    def masked_adam(p, *args, **kwargs):
        spies.add("adam_params", (p.numel() * p.element_size(), 0.0))
        return orig(p, *args, **kwargs)

    return masked_adam
'''
METRIC = '''"""A test's metric: masked Adam's parameter GB a step."""


def read(ctx):
    work = ctx.totals["ops"].get("adam_params")
    return work[0] / ctx.units / 1e9 if work else None
'''


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_config_mix_and_metric_are_added_by_files_and_entries_alone(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "benchmark"

    (b / "kinds/steps.py").write_text(KIND)
    (b / "families/fourier_grid_again.py").write_text(FAMILY)
    (b / "spies/adam_params.py").write_text(SPY)
    (b / "metrics/adam_params.dummy.py").write_text(METRIC)
    # a configuration: bicycle_single at another step size, of the new family
    conf = json.loads((ROOT / "benchmark/configs/bicycle_single.json").read_text())
    conf["fine_model_and_render"]["stepsize"] = 0.7
    conf["family"] = "fourier_grid_again"
    (b / "configs/dummy.json").write_text(json.dumps(conf))
    bench["configs"].append({"name": "dummy", "source": "https://example.org/dummy",
                             "file": "benchmark/configs/dummy.json",
                             "reduced": ["data", "fine_model_and_render"],
                             "why": "a test's configuration"})
    # a traffic mix of the new kind with its own parameters
    (b / "traffic/dummy_mix.json").write_text(json.dumps(
        {"kind": "steps", "start_step": "last_pg_scale", "check_steps": 2,
         "trace_seconds": 0.2}))
    # the cell, its limits, its end-to-end metric and its per-layer metric
    cell = "dummy.dummy_mix"
    bench["workloads"].append({"name": cell, "config": "dummy", "traffic": "dummy_mix",
                               "chips": 1, "why": "a test's cell"})
    limits = json.loads((ROOT / "benchmark/limits/bicycle_single.train.json").read_text())
    (b / f"limits/{cell}.json").write_text(json.dumps(limits))
    bench["end_to_end"].append({"name": "train_steps_per_s", "unit": "steps/s",
                                "better": "higher", "bound": 0.2, "source": "host_clock",
                                "workloads": [cell]})
    bench["per_layer"].append({"name": "adam_params.dummy", "unit": "GB", "better": "lower",
                               "source": "program_counter", "layer": "device",
                               "moves": "train_steps_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(tmp_path)
    assert all(after[k] == v for k, v in before.items())  # nothing there was edited

    plain = run(cell, root=tmp_path)
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"train_steps_per_s", "setup_s"}
    traced = run(cell, root=tmp_path, trace=True)
    assert traced["correct"], traced["checks"]
    # every leaf once a step: the two grids and the MLP's six
    c = spec.load(tmp_path, cell)
    shape = c.family.recipe_fields(spec.merged(c.config, TINY["config"]))
    ws = recipe.world_size(0.2, shape["num_voxels"])
    grids = 2 * 7 * ws[0] * ws[1] * ws[2] * (1 + 12)  # 7 banks in bfloat16, density and k0
    mlp = 4 * sum(a * b + b for a, b in ((39, 128), (128, 128), (128, 3)))
    assert abs(traced["metrics"]["adam_params.dummy"]["value"] * 1e9 - (grids + mlp)) < 1
