"""The harness end to end at a tiny size on the CPU: a sound run comes
out correct, and a run whose timed path is broken underneath comes out
not correct, once for each fault the cells can have.  The look for a
card is skipped (the device is given); the rest of a run is as on the
card."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

import tiny
from harness import main, program

CPU = torch.device("cpu")


def _run(cell, seed=2 ** 31 + 5):
    return main.run(cell, seed, 0.01, 0, CPU, time.perf_counter(),
                    limits=tiny.LIMITS, workers=1)


@pytest.fixture(scope="module")
def fleet():
    return tiny.cell("fleet-b16", lanes=2, scans=5)


def test_sound_run_is_correct(fleet):
    r = _run(fleet)
    assert r["correct"] is True
    assert r["attempted"] >= 4 and r["failed"] == 0
    assert set(r["metrics"]) == {"scans_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert list(r)[-1] == "limits"
    assert set(r["limits"]) == set(tiny.LIMITS)
    assert main.forbidden_modules() == []


def _broken(monkeypatch, fault):
    """Break the program's entry underneath the harness."""
    real = program.Program.run

    def run(self, state, scans):
        if fault == "state unchanged":
            # every step starts from the state the job was given
            from reference.tree import tree_map

            T = scans.pts.shape[0]
            outs = [real(self, tree_map(torch.clone, state),
                         main._cut(scans, t, t + 1))[1] for t in range(T)]
            outs = type(outs[0])(*(torch.cat(x) for x in zip(*outs)))
            return state, outs
        final, outs = real(self, state, scans)
        if fault == "half the batch":
            # the second half of the lanes left out: their outputs are
            # the first half's
            B = outs.pose_p.shape[1]
            idx = torch.arange(B) % max(1, B // 2)
            outs = type(outs)(*(a[:, idx] for a in outs))
        elif fault == "answer altered":
            p = outs.pose_p.clone()
            p[-1, 0, 0] += 0.05
            outs = outs._replace(pose_p=p)
        return final, outs

    monkeypatch.setattr(program.Program, "run", run)


@pytest.mark.parametrize("fault", ["state unchanged", "half the batch",
                                   "answer altered"])
def test_broken_timed_path_is_not_correct(fleet, monkeypatch, fault):
    _broken(monkeypatch, fault)
    r = _run(fleet)
    assert r["correct"] is False
    assert any(x > lim for x, lim in r["limits"].values())


def test_one_sequence_run_is_correct():
    r = _run(tiny.cell("one-seq-t100", lanes=1, scans=5))
    assert r["correct"] is True and r["attempted"] >= 2


def test_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, os.path.join(tiny.BENCH, "run.py"), "--workload",
         "flagship-fleet-b16", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "needs 1 CUDA device" in p.stderr


def test_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path[:0] = [%r]\n"
            "import reference.pipeline, reference.config\n"
            "import reference.ops.assoc, reference.ops.eigh\n"
            "import reference.ops.map_insert, harness.compare\n"
            "import harness.traffic, harness.work\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % tiny.BENCH)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=tiny.BENCH)
    assert p.returncode == 0, p.stderr
    top = set(json.loads(p.stdout.strip().replace("'", '"')))
    assert not top & {"mmloam_tpu_torch", "mmloam_tpu", "jax", "jaxlib",
                      "flax"}
