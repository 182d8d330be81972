"""A cell, a configuration, a traffic mix and a per-layer metric added as
new files and new BENCHMARK.json entries run with no file that was there
edited: the harness finds each by name."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import tiny


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" in d:
                continue
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_cell_config_and_metric_are_new_files(tmp_path):
    shutil.copytree(tiny.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), tmp_path)
    before = _digests(tmp_path)
    b = tmp_path / "benchmark"

    (b / "configs" / "tiny-new.json").write_text(json.dumps(
        dict(name="tiny-new", config=tiny.config_values())))
    tr = json.loads((b / "traffic" / "fleet-b16.json").read_text())
    tr.update(lanes=2, scans=4, trace_steps=2)
    (b / "traffic" / "tiny-fleet.json").write_text(json.dumps(tr))
    (b / "limits" / "tiny-new-fleet.json").write_text(json.dumps(
        tiny.LIMITS))
    (b / "metrics" / "scans_seen.py").write_text(
        "def read(ctx):\n    return ctx.T\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(
        name="tiny-new", source="the port's tiny_config()",
        file="benchmark/configs/tiny-new.json", reduced=[], why="a test"))
    bench["workloads"].append(dict(
        name="tiny-new-fleet", config="tiny-new", traffic="tiny-fleet",
        chips=1, why="a test"))
    bench["per_layer"].append(dict(
        name="scans_seen", unit="scans", better="higher",
        source="program_counter", layer="step", moves="scans_per_s",
        workloads=["tiny-new-fleet"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = f"""
import sys, time, types, torch
sys.path[:0] = [{str(b)!r}, {tiny.ROOT!r}]
from harness import main, spec
cell = spec.load("tiny-new-fleet")
assert cell.traffic["scans"] == 4 and cell.chips == 1
assert [m["name"] for m in cell.per_layer][-1] == "scans_seen"
assert spec.reader(cell.per_layer[-1])(types.SimpleNamespace(T=4)) == 4
assert "scans_seen" not in [m["name"] for m in
                            spec.load("flagship-fleet-b16").per_layer]
r = main.run(cell, 7, 0.01, 0, torch.device("cpu"), time.perf_counter(),
             workers=1)
assert r["correct"] is True, r
print("ok")
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0 and p.stdout.strip().endswith("ok"), p.stderr
    # every file that was there, BENCHMARK.json aside, is as it was
    before.pop("BENCHMARK.json")
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
