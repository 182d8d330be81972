"""Port voxel map and its insert kernel module against the JAX reference.

`map_insert.insert_batched_reference` (the plain version of the CUDA
kernel K1) is held against the Pallas kernel in interpret mode and against
`vmap(voxelmap.insert)` on the cases of tests/test_pallas_insert.py: meta
lanes exactly, sum lanes within 1e-5.  The port's scatter insert, dense
candidate blocks (bf16 equal) and tie-inclusive k-th smallest are compared
with JAX directly.  The CUDA kernel itself is compared with this plain
version on the card by tests/test_torch_cuda.py (and by chip_smoke.py).
"""

import numpy as np
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from mmloam_tpu.config import MapConfig  # noqa: E402
from mmloam_tpu.ops import pallas_insert  # noqa: E402
from mmloam_tpu.ops import voxelmap as jvm  # noqa: E402

from mmloam_tpu_torch import cuda_build  # noqa: E402
from mmloam_tpu_torch.ops import map_insert  # noqa: E402
from mmloam_tpu_torch.ops import voxelmap as tvm  # noqa: E402

MCFG = MapConfig(dim_x=16, dim_y=16, dim_z=8, voxel_size=0.4, count_cap=10.0)
SUM_ATOL = 1e-5


def _jax_vmap_insert(cells, pts, mask):
    return np.asarray(jax.vmap(lambda c, p, m: jvm.insert(
        jvm.VoxelMap(c), p, m, MCFG).cells)(
            jnp.asarray(cells), jnp.asarray(pts), jnp.asarray(mask)))


def _pallas(cells, pts, mask):
    return np.asarray(pallas_insert.insert_batched(
        jnp.asarray(cells), jnp.asarray(pts), jnp.asarray(mask), MCFG,
        interpret=True))


def _port(cells, pts, mask):
    c = torch.from_numpy(np.array(cells))
    map_insert.insert_batched_reference(c, torch.from_numpy(pts),
                                        torch.from_numpy(mask), MCFG)
    return c.numpy()


def _assert_maps(got, want):
    np.testing.assert_array_equal(got[..., 96:], want[..., 96:])
    np.testing.assert_allclose(got[..., :96], want[..., :96], atol=SUM_ATOL)


def _cases():
    rng = np.random.default_rng(0)
    B, N = 2, 128
    span = 8 * 0.4 * 0.45
    pts = rng.uniform(-span, span, (B, N, 3)).astype(np.float32)
    mask = rng.random((B, N)) > 0.15
    accumulate = [(pts, mask), ((pts * np.float32(0.98)), mask)]
    period = (np.array([MCFG.dim_x, MCFG.dim_y, MCFG.dim_z])
              * MCFG.voxel_size).astype(np.float32)
    p0 = np.tile(np.array([[0.5, 0.5, 0.5]], np.float32), (N, 1))[None]
    evict = [(p0, np.ones((1, N), bool)),
             (p0 + period[None, None, :], np.ones((1, N), bool))]
    return {"accumulate_and_cap": accumulate, "stale_epoch": evict}


@pytest.mark.parametrize("case", ["accumulate_and_cap", "stale_epoch"])
def test_insert_batched_reference_matches_pallas_and_xla(case):
    steps = _cases()[case]
    B = steps[0][0].shape[0]
    zero = np.zeros((B,) + tuple(jvm.empty_map(MCFG).cells.shape),
                    np.float32)
    c_pal, c_xla, c_port = zero, zero, zero
    for pts, mask in steps:
        c_pal = _pallas(c_pal, pts, mask)
        c_xla = _jax_vmap_insert(c_xla, pts, mask)
        c_port = _port(c_port, pts, mask)
    _assert_maps(c_port, c_pal)
    _assert_maps(c_port, c_xla)
    assert (c_port[..., 96:] > 0).any()
    if case == "stale_epoch":
        vm = tvm.VoxelMap(torch.from_numpy(c_port[0]))
        q = torch.from_numpy(steps[1][0][0, :1])
        _, _, d2 = tvm.query_knn(vm, q, torch.ones(1, dtype=torch.bool),
                                 MCFG)
        assert np.isfinite(d2[0, 0].item())


def test_scatter_insert_matches_jax():
    rng = np.random.default_rng(2)
    cj = jvm.empty_map(MCFG)
    ct = tvm.empty_map(MCFG)
    for k in range(3):
        pts = rng.uniform(-2.0, 2.0, (300, 3)).astype(np.float32)
        if k == 2:   # a torus period away: evicts
            pts[:50] += np.float32(16 * 0.4)
        mask = rng.random(300) > 0.1
        cj = jvm.insert(cj, jnp.asarray(pts), jnp.asarray(mask), MCFG)
        ct = tvm.insert(ct, torch.from_numpy(pts), torch.from_numpy(mask),
                        MCFG)
        _assert_maps(ct.cells.numpy(), np.asarray(cj.cells))
    guard_j = np.asarray(jvm.insert_guard(jnp.asarray(pts),
                                          jnp.asarray(pts[0]), MCFG))
    guard_t = tvm.insert_guard(torch.from_numpy(pts),
                               torch.from_numpy(pts[0]), MCFG).numpy()
    np.testing.assert_array_equal(guard_t, guard_j)


def _filled_map(rng):
    cj = jvm.empty_map(MCFG)
    pts = rng.uniform(-2.5, 2.5, (1500, 3)).astype(np.float32)
    cj = jvm.insert(cj, jnp.asarray(pts), jnp.ones(1500, bool), MCFG)
    return np.asarray(cj.cells)


@pytest.mark.parametrize("bf16", [True, False])
def test_dense_candidates_and_kth_smallest_match_jax(bf16):
    import dataclasses

    rng = np.random.default_rng(3)
    cfg = dataclasses.replace(MCFG, dense_bf16=bf16)
    cells = _filled_map(rng)
    q = rng.uniform(-2.5, 2.5, (200, 3)).astype(np.float32)
    mask = rng.random(200) > 0.1
    dj = jvm.query_candidates_dense(jvm.VoxelMap(jnp.asarray(cells)),
                                    jnp.asarray(q), jnp.asarray(mask), cfg)
    dt = tvm.query_candidates_dense(tvm.VoxelMap(torch.from_numpy(cells)),
                                    torch.from_numpy(q),
                                    torch.from_numpy(mask), cfg)
    for a, b in zip(dj, dt):
        a32 = np.asarray(a.astype(jnp.float32))
        b32 = b.to(torch.float32).numpy()
        if bf16:
            np.testing.assert_array_equal(b32, a32)
        else:
            np.testing.assert_allclose(b32, a32, atol=1e-6)
    d2 = dj[3]
    # ties: duplicate a row's values so the k-th smallest is tied
    kj = np.asarray(jvm.kth_smallest_dense(d2, 5).astype(jnp.float32))
    kt = tvm.kth_smallest_dense(dt[3], 5).to(torch.float32).numpy()
    np.testing.assert_array_equal(kt, kj)
    assert np.isfinite(kj).any() and np.isinf(kj).any()
    tied = np.full((4, 16), np.inf, np.float32)
    tied[:, :6] = [[1, 1, 2, 2, 2, 3]] * 4
    np.testing.assert_array_equal(
        tvm.kth_smallest_dense(torch.from_numpy(tied), 5).numpy(),
        np.asarray(jvm.kth_smallest_dense(jnp.asarray(tied), 5)))


def test_knn_and_cell_centroids_match_jax():
    rng = np.random.default_rng(4)
    cells = _filled_map(rng)
    q = rng.uniform(-2.5, 2.5, (100, 3)).astype(np.float32)
    mask = rng.random(100) > 0.1
    nj, vj, dj = jvm.query_knn(jvm.VoxelMap(jnp.asarray(cells)),
                               jnp.asarray(q), jnp.asarray(mask), MCFG)
    nt, vt, dt = tvm.query_knn(tvm.VoxelMap(torch.from_numpy(cells)),
                               torch.from_numpy(q), torch.from_numpy(mask),
                               MCFG)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    ok = np.asarray(vj)
    assert ok.any()
    np.testing.assert_allclose(nt.numpy()[ok], np.asarray(nj)[ok], atol=1e-5)
    np.testing.assert_allclose(dt.numpy()[ok], np.asarray(dj)[ok], atol=1e-5)
    cj, okj = jvm.cell_centroids(jvm.VoxelMap(jnp.asarray(cells)), MCFG)
    ct, okt = tvm.cell_centroids(tvm.VoxelMap(torch.from_numpy(cells)), MCFG)
    okj = np.asarray(okj)
    np.testing.assert_array_equal(okt.numpy(), okj)
    assert okj.sum() > 100
    np.testing.assert_allclose(ct.numpy()[okj], np.asarray(cj)[okj],
                               atol=1e-5)


def test_cpu_tensors_never_touch_the_cuda_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("CPU path reached the CUDA build")

    monkeypatch.setattr(cuda_build, "load", refuse)
    monkeypatch.setattr(cuda_build, "build", refuse)
    monkeypatch.setattr(cuda_build, "find_nvcc", refuse)
    before = map_insert.LAUNCHES
    pts, mask = _cases()["accumulate_and_cap"][0]
    cells = torch.zeros((2,) + tuple(tvm.empty_map(MCFG).cells.shape))
    out = map_insert.insert_batched(cells, torch.from_numpy(pts),
                                    torch.from_numpy(mask), MCFG)
    assert out is cells and (cells[..., 96:] > 0).any()
    assert map_insert.LAUNCHES == before


def test_wrapper_rejects_bad_inputs():
    pts, mask = _cases()["accumulate_and_cap"][0]
    upd = map_insert.aggregate_updates(torch.from_numpy(pts),
                                       torch.from_numpy(mask), MCFG)
    cells = torch.zeros((2,) + tuple(tvm.empty_map(MCFG).cells.shape))
    with pytest.raises(ValueError):
        map_insert.rmw(cells.double(), upd, 10.0)
    with pytest.raises(ValueError):
        map_insert.rmw(cells[:1], upd, 10.0)
    with pytest.raises(ValueError):
        map_insert.rmw(cells, upd._replace(nv=upd.nv.long()), 10.0)
