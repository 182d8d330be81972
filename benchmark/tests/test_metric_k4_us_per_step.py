"""The reader of `k4_us_per_step`: nothing from a traced stretch without
K4's kernel (the program before it had one); otherwise its device time a
step, the two pieces weighed as the job's scans, where each piece shows
as many K4 kernels as the program counted for its call, and nothing where
one shows fewer or the program keeps no such count."""

import types

import pytest

from harness import layers, spec, trace

READ = spec.reader(dict(name="k4_us_per_step"))
MS = 1_000_000
K4 = ("void (anonymous namespace)::lm_damped_solve_kernel(float const*, "
      "float const*, float const*, float const*, float const*, float*, int)")
K3 = "void (anonymous namespace)::eigh_kernel(double const*)"


def _ctx(pre_dev, post_dev, share_pre=0.25):
    host = [(0, 100 * MS, trace.CALL)]
    pre = trace.Piece(1, 0.1, pre_dev, host)
    post = trace.Piece(4, 0.1, post_dev, host)
    return types.SimpleNamespace(
        pre=pre, post=post,
        weighted=lambda fn: trace.weighted(pre, post, share_pre, fn))


def _calls(monkeypatch, calls):
    spans = types.SimpleNamespace(call_launches=lambda: calls)
    monkeypatch.setattr(layers, "spans_module", lambda: spans)


PRE = [(1 * MS, 3 * MS, K4, True),
       (4 * MS, 5 * MS, "elementwise_kernel", True)]
POST = [(1 * MS, 2 * MS, K4, True), (3 * MS, 5 * MS, K4, True),
        (6 * MS, 9 * MS, K3, True)]
# the calls the program counted: an untraced one between the pieces
CALLS = [dict(scans=1, k1=0, k2=0, k3=0, k4=1),
         dict(scans=7, k1=0, k2=0, k3=5, k4=9),
         dict(scans=4, k1=0, k2=0, k3=1, k4=2)]


def test_reads_nothing_without_the_kernel(monkeypatch):
    _calls(monkeypatch, CALLS)
    torch_only = [(1 * MS, 3 * MS, "elementwise_kernel", True),
                  (4 * MS, 5 * MS, "eigh_kernel(double const*)", True),
                  (6 * MS, 7 * MS, "Memcpy DtoD (Device -> Device)", False)]
    assert READ(_ctx(torch_only, torch_only)) is None


def test_reads_the_kernel_time_a_step(monkeypatch):
    _calls(monkeypatch, CALLS)
    # 0.25 x 2 ms a step + 0.75 x 3 ms over 4 steps
    want = (0.25 * 2e-3 + 0.75 * 3e-3 / 4) * 1e6
    assert READ(_ctx(PRE, POST)) == pytest.approx(want)
    assert trace.ours(K4) is None       # outside the K1-K3 census


@pytest.mark.parametrize("case", ["dropped", "more", "uncounted",
                                  "no_count", "ambiguous"])
def test_reads_nothing_where_a_piece_is_not_the_count(monkeypatch, case):
    pre, post, calls = PRE, POST, CALLS
    if case == "dropped":               # the profiler lost a K4 record
        post = POST[1:]
    elif case == "more":
        pre = PRE + [(6 * MS, 7 * MS, K4, True)]
    elif case == "uncounted":           # no call of the piece's K1-K3
        calls = [dict(c, k3=c["k3"] + 1) for c in CALLS]
    elif case == "no_count":            # a program that keeps none
        calls = None
    elif case == "ambiguous":
        calls = CALLS + [dict(CALLS[-1], k4=3)]
    _calls(monkeypatch, calls)
    if case == "no_count":
        monkeypatch.setattr(layers, "spans_module",
                            lambda: types.SimpleNamespace())
    assert READ(_ctx(pre, post)) is None
