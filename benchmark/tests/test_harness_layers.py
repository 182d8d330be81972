"""The readers of the program's set-up parts and the laying of a traced
call by layer (`harness/layers.py`), on made-up inputs.

* Every new reader gives nothing on a run of a program without spans
  (no `mmloam_tpu_torch.spans`), nothing where the program's last
  capture is not the warm-up's, and the part where it is.
* A traced call laid by layer: the layers' kernels and times sum to the
  call's, IF bodies expand by the call's predicates, an operation the
  profiler gives no correlation goes to the launch around it; a short or
  misordered replay, a missing predicate row or a program that laid no
  layers lays nothing.
"""

import sys
import types

import pytest

from harness import layers, spec

NEW = {"scan0_eager_s": "eager_s", "graph_census_s": "census_s",
       "graph_instantiate_s": "instantiate_s"}


def _ctx(capture_s=2.5):
    # what the run hands the readers, as `harness/main.py` builds it
    return types.SimpleNamespace(capture_s=capture_s, if_bodies=None, T=30)


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_reader_reads_nothing_without_spans(monkeypatch, name):
    import mmloam_tpu_torch

    read = spec.reader(dict(name=name))
    monkeypatch.setitem(sys.modules, "mmloam_tpu_torch.spans", None)
    monkeypatch.delattr(mmloam_tpu_torch, "spans", raising=False)
    assert layers.spans_module() is None
    assert read(_ctx()) is None
    monkeypatch.undo()

    from mmloam_tpu_torch import spans

    monkeypatch.setattr(spans, "_SETUP", None)
    assert read(_ctx()) is None                 # no capture yet
    parts = dict(eager_s=1.25, census_s=0.5, instantiate_s=0.75,
                 capture_s=2.5)
    monkeypatch.setattr(spans, "_SETUP", parts)
    assert read(_ctx(capture_s=3.0)) is None    # another capture's
    assert read(_ctx()) == parts[NEW[name]]


MS = 1_000_000
K2 = "void (anonymous namespace)::assoc_kernel<4, 8, true>(AssocArgs)"
K1 = "void (anonymous namespace)::map_insert_kernel<32>(float*)"

# top level: a front-end kernel, IF node 0 (an association kernel of
# ours, then a copy), a kernel outside every span, then K1
NODE_LAYERS = [
    [("kernel", "front_end", None), ("if", 0, None), ("kernel", None, None),
     ("kernel", "map_insert", "k1")],
    [("kernel", "association", "k2"), ("memcpy", "association", None)],
]


def _call(body_ran=(1, 0), drop=None, swap=False):
    """A traced call of two replays (correlations 7 and 9) between a
    copy in and a copy out: (ops, launches, history)."""
    ops = [(0, 1 * MS, "copy_kernel", True, 3)]
    t = 2 * MS
    for r, corr in enumerate((7, 9)):
        names = ["elementwise_kernel"]
        if body_ran[r]:
            names += [K2, "memcpy32_post"]
        names += ["reduce_kernel", K1]
        if swap:
            names[0], names[-1] = names[-1], names[0]
        for i, n in enumerate(names):
            if (r, i) == drop:
                continue
            # the body's copy comes without a correlation id
            c = 0 if n.startswith("memcpy") else corr
            ops.append((t, t + MS, n, not n.startswith("memcpy"), c))
            t += MS
        t += MS
    ops.append((t, t + 2 * MS, "Memcpy DtoD (Device -> Device)", False, 11))
    ops.append((t + 3 * MS, t + 4 * MS, "copy_kernel", True, 12))
    launches = [(10, 9), (5, 7)]
    return ops, launches, [[b] for b in body_ran]


def test_a_call_laid_by_layer_sums_to_its_kernels():
    ops, launches, hist = _call()
    got = layers.lay(ops, launches, NODE_LAYERS, hist)
    kernels = [o for o in ops if o[3]]
    assert sum(n for _, n in got.values()) == len(kernels) == 9
    assert sum(s for s, _ in got.values()) == pytest.approx(
        sum(o[1] - o[0] for o in kernels) / 1e9)
    assert got == {"front_end": [pytest.approx(0.002), 2],
                   "association": [pytest.approx(0.001), 1],
                   "step_rest": [pytest.approx(0.002), 2],
                   "map_insert": [pytest.approx(0.002), 2],
                   "replay_io": [pytest.approx(0.002), 2]}
    assert set(got) <= set(layers.leaves())


@pytest.mark.parametrize("change, why", [
    (dict(drop=(1, 0)), "2 operations traced, 3"),
    (dict(drop=(0, 2)), "4 operations traced, 5"),
    (dict(swap=True), "where the graph holds"),
])
def test_a_short_or_misordered_replay_lays_nothing(change, why):
    ops, launches, hist = _call(**change)
    with pytest.raises(layers.Unlaid, match=why):
        layers.lay(ops, launches, NODE_LAYERS, hist)


def test_no_layers_or_predicates_lay_nothing():
    ops, launches, hist = _call()
    with pytest.raises(layers.Unlaid, match="laid no layers"):
        layers.lay(ops, launches, None, hist)
    with pytest.raises(layers.Unlaid, match="2 graph launches traced, 1"):
        layers.lay(ops, launches, NODE_LAYERS, hist[:1])
    with pytest.raises(layers.Unlaid, match="no predicate"):
        layers.lay(ops, launches, NODE_LAYERS, None)


def test_idle_share_of_the_clocks():
    clocks = dict(replays=3, traced=False, host_s_per_scan=1e-3,
                  launch_s_per_scan=2e-4, graph_busy_s=0.09,
                  replay_span_s=0.1)
    assert layers.idle_pct(clocks) == pytest.approx(10.0)
    assert layers.idle_pct(dict(clocks, traced=True)) is None
    assert layers.idle_pct(None) is None
