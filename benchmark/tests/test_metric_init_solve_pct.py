"""The reader of `init_solve_pct`: nothing from a program without gate
counts (no `mmloam_tpu_torch.spans`, or a `spans` without
`gate_counts`) or before a lockstep graph has replayed; otherwise the
share of the lockstep replays that ran the init solve."""

import sys
import types

from harness import layers, spec

READ = spec.reader(dict(name="init_solve_pct"))
CTX = types.SimpleNamespace(capture_s=2.5, if_bodies=None, T=30)


def test_reads_nothing_without_spans(monkeypatch):
    import mmloam_tpu_torch

    monkeypatch.setitem(sys.modules, "mmloam_tpu_torch.spans", None)
    monkeypatch.delattr(mmloam_tpu_torch, "spans", raising=False)
    assert layers.spans_module() is None
    assert READ(CTX) is None


def test_reads_nothing_where_spans_keeps_no_gate_counts(monkeypatch):
    from mmloam_tpu_torch import spans

    monkeypatch.delattr(spans, "gate_counts")
    assert READ(CTX) is None


def test_reads_nothing_before_a_lockstep_graph_replayed(monkeypatch):
    from mmloam_tpu_torch import spans

    monkeypatch.setattr(spans, "_GATES", None)
    assert spans.gate_counts() is None
    assert READ(CTX) is None


def test_reads_the_share_of_replays_that_ran_the_solve(monkeypatch):
    from mmloam_tpu_torch import spans

    monkeypatch.setattr(spans, "_GATES", None)
    spans.count_gates(29, dict(init=8, init_solve=1))
    spans.count_gates(30, dict(init=9, init_solve=1))
    assert spans.gate_counts() == dict(scans=59, init=17, init_solve=2)
    assert READ(CTX) == 100.0 * 2 / 59
