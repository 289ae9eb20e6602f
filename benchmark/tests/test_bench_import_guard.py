"""No module that a cell's run loads is JAX, its libraries or the JAX
package, compared by whole top-level name."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
from bench_tiny import CELLS, ROOT

from benchmark.core import guard

SCRIPT = """
import json, sys
sys.path.insert(0, {tests!r})
import bench_tiny
bench_tiny.run({cell!r}, trace=False)
bench_tiny.run({cell!r}, trace=True)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax(cell, tmp_path):
    code = SCRIPT.format(tests=str(ROOT / "benchmark" / "tests"), cell=cell)
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "TMPDIR": str(tmp_path),
           "OMP_NUM_THREADS": "2"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "unboundednerfpytorch_tpu_torch" in tops  # the run did load the port
    assert not tops & guard.FORBIDDEN, sorted(tops & guard.FORBIDDEN)


def test_the_guard_compares_whole_top_level_names():
    assert guard.forbidden_modules(["unboundednerfpytorch_tpu_torch",
                                    "unboundednerfpytorch_tpu_torch.ops", "jaxtyping",
                                    "flaxen.x", "numpy"]) == []
    assert guard.forbidden_modules(["unboundednerfpytorch_tpu.models", "jax.numpy", "flax",
                                    "jaxlib.xla_client"]) == [
        "flax", "jax", "jaxlib", "unboundednerfpytorch_tpu"]


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch):
    """The runner refuses to return a result once a forbidden module is in
    the process, whatever loaded it."""
    import bench_tiny

    monkeypatch.setitem(sys.modules, "jaxlib", sys.modules["json"])
    with pytest.raises(guard.ForbiddenImport):
        bench_tiny.run("bicycle_single.train")


def test_without_a_gpu_the_command_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                          "bicycle_single.train", "--seed", str(2**31 + 7), "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                              "TMPDIR": str(tmp_path), "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
