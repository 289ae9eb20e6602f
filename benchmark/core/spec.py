"""What a cell is, read from ``BENCHMARK.json`` and the files it names.

A cell ``<config>.<mix>`` names a configuration (``configs`` entry: its
file holds the recipe as it runs, and its ``family`` key names
``benchmark/families/<family>.py``, the reference's model and the hooks
into the program's parameters) and a traffic mix
(``benchmark/traffic/<mix>.json``: the parameters that the generator of its
``kind``, ``benchmark/kinds/<kind>.py``, reads). Its limits for ``correct``
are ``benchmark/limits/<cell>.json``. Its end-to-end metrics are the
``end_to_end`` entries without a ``workloads`` key or listing it (an entry
``<measure>.<group>`` is the kind's ``<measure>`` in the cells it lists, so
that cells whose runs spread alike share a bound of their own); its
per-layer metrics the ``per_layer`` entries that list it, or, without the
key, that move one of its end-to-end metrics; each is read by
``benchmark/metrics/<name>.py``. The counters of the traced window are
``benchmark/spies/*.py``. A later kind, family, cell, mix, counter or metric
is new files and entries, found by these names.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re
import types


@dataclasses.dataclass
class Cell:
    root: pathlib.Path
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict
    kind: types.ModuleType  # benchmark/kinds/<traffic's kind>.py
    family: types.ModuleType  # benchmark/families/<config's family>.py

    def reader(self, metric: str):
        """The ``read(ctx)`` function of a per-layer metric's reader."""
        return module(self.root, "metrics", metric).read


_MODULES: dict = {}


def module(root, folder: str, name: str) -> types.ModuleType:
    """``benchmark/<folder>/<name>.py`` under ``root``, loaded by its path
    (once a path)."""
    path = (pathlib.Path(root) / "benchmark" / folder / f"{name}.py").resolve()
    if path not in _MODULES:
        if not path.is_file():
            raise KeyError(f"no file {path} for {folder} {name!r}")
        tag = f"_bench_{folder}_{len(_MODULES)}_" + re.sub(r"\W", "_", name)
        spec = importlib.util.spec_from_file_location(tag, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def _covers(entry: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves", entry["name"]) in e2e_names


def load(root, workload: str) -> Cell:
    root = pathlib.Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _covers(m, workload, names)]
    limits_path = root / "benchmark" / "limits" / f"{workload}.json"
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        root=root, name=workload, chips=int(w["chips"]), config_name=w["config"],
        config=config, traffic_name=w["traffic"], traffic=traffic,
        end_to_end=e2e, per_layer=per_layer,
        limits=json.loads(limits_path.read_text()) if limits_path.exists() else {},
        kind=module(root, "kinds", traffic["kind"]),
        family=module(root, "families", config["family"]))


def merged(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys put in, nested dicts merged."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out
