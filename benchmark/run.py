"""Run one cell of the benchmark of ``unboundednerfpytorch_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU. The last line
of standard output is the result: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``, each number that decided ``correct`` beside its limit; those
numbers are also the last lines of standard error. It exits with 1, and
prints no result, without a GPU, with fewer GPUs than the cell asks for, or
if the process loaded JAX or the JAX package. ``--control 1`` also computes
the reference in bfloat16 and prints its numbers, and ``--fault`` breaks the
timed path (the readings that the limits are set between; neither is part of
a measured run).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = ROOT / "build" / "bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    # one process drives the card; its CPU work is the host's dispatch, so
    # few threads keep it from contending with itself
    os.environ.setdefault("OMP_NUM_THREADS", "2")


def _power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", action="append", default=[],
                   choices=("state_unchanged", "half_batch", "answer_altered"),
                   help="break the timed path so (the check of the limits; not a measured run)")
    args = p.parse_args(argv)
    _caches()
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.core import guard, runner, spec

    torch.set_num_threads(2)

    try:
        cell = spec.load(ROOT, args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"cannot read the cell: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"the cell needs {cell.chips} CUDA device(s); this machine shows "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    print(f"card and power limit: {_power_limit()}", file=sys.stderr)
    try:
        result = runner.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                            "cuda", faults=args.fault, control=bool(args.control),
                            log=lambda *a, **k: print(*a, **k))
    except guard.ForbiddenImport as e:
        print(str(e), file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
