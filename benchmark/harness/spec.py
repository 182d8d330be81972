"""What `BENCHMARK.json` names, found by name under the benchmark's own
folder: a cell's configuration (`configs/<config>.json`), its traffic
(`traffic/<traffic>.json`) and its per-layer metrics' readers
(`metrics/<name>.py`).  A cell, a configuration, a traffic mix or a
metric that a later change adds is new files and new entries, read the
same way; nothing here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _read(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of `workloads`, with its configuration's entry and file,
    its traffic file and the metrics it reports."""

    def __init__(self, bench, name):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                             f"(there are {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = _read(os.path.join(ROOT, conf["file"]))
        self.traffic = _read(os.path.join(BENCH, "traffic",
                                          self.entry["traffic"] + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._has(m)]

    def _has(self, metric):
        return "workloads" not in metric or self.name in metric["workloads"]


def load(name):
    """The cell `name` of the repository's BENCHMARK.json."""
    return Cell(_read(os.path.join(ROOT, "BENCHMARK.json")), name)


def reader(metric):
    """The `read(ctx)` function of per-layer metric `metric`, from
    `metrics/<name>.py` (dots in the name are kept: the file is loaded by
    path)."""
    path = os.path.join(BENCH, "metrics", metric["name"] + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric["name"].replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def build_config(cls, values):
    """An instance of the config dataclass `cls` whose fields take
    `values` (a dict as `dataclasses.asdict` gives it; a nested dict fills
    a nested dataclass field the same way).  A key the class lacks
    raises: the file holds the configuration as it is run."""
    base = cls()
    kw = {}
    for key, val in values.items():
        if not hasattr(base, key):
            raise ValueError(f"{cls.__name__} has no field {key!r}")
        cur = getattr(base, key)
        if isinstance(val, dict) and dataclasses.is_dataclass(cur):
            kw[key] = build_config(type(cur), val)
        else:
            kw[key] = val
    return dataclasses.replace(base, **kw)
