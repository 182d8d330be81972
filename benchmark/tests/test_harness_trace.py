"""The traced stretch's arithmetic on events made up here: the busy
union, the idle gaps and what the host was doing in them, the weighing
of the two pieces, and the kernels named as the port's."""

import pytest

from harness import trace


def _piece(steps=2):
    ms = 1_000_000
    dev = [(1 * ms, 3 * ms, "void assoc_kernel<5, 8, true>(AssocArgs)",
            True),
           (2 * ms, 4 * ms, "elementwise_kernel", True),
           (6 * ms, 7 * ms, "Memcpy DtoD (Device -> Device)", False),
           (8 * ms, 9 * ms, "eigh_kernel(double const*)", True)]
    host = [(0, 10 * ms, trace.CALL), (4 * ms, 6 * ms, "cudaGraphLaunch"),
            (0, 10 * ms, "aten::copy_")]
    return trace.Piece(steps, 0.01, dev, host)


def test_busy_is_the_union_and_gaps_name_the_host():
    p = _piece()
    assert p.span_s() == pytest.approx(0.010)
    assert p.busy_s() == pytest.approx(0.005)
    assert p.kernel_s() == pytest.approx(0.005)
    assert p.kernel_s("k2") == pytest.approx(0.002)
    assert dict(p.launches()) == {"k2": 1, "k3": 1}
    gaps = sorted(trace.gaps(p), reverse=True)
    assert [round(g, 6) for g, _ in gaps] == [0.002, 0.001, 0.001, 0.001]
    b = trace.breakdown([p])
    assert b["idle_gaps"][0] == ["cudaGraphLaunch", pytest.approx(0.002)]
    assert ["aten::copy_", pytest.approx(0.001)] in b["idle_gaps"]
    assert b["device_ops"][0][0] in ("void assoc_kernel<5, 8, true>"
                                     "(AssocArgs)", "elementwise_kernel")
    assert len(b["device_ops"]) == 4


def test_weighted_per_step():
    a, b = _piece(steps=1), _piece(steps=4)
    got = trace.weighted(a, b, 0.25, lambda p: p.busy_s())
    assert got == pytest.approx(0.25 * 0.005 + 0.75 * 0.005 / 4)


@pytest.mark.parametrize("name,key", [
    ("void map_insert_kernel<32>(float*)", "k1"),
    ("map_insert_groups", "k1"),
    ("_Z12assoc_kernelILi5ELi8ELb1EEvPK9AssocArgs", "k2"),
    ("eigh_kernel", "k3"), ("gemv2T_kernel", None)])
def test_ours(name, key):
    assert trace.ours(name) == key
