"""Every map option of the reference in the port's plain path, against the
JAX package: any superrow pack and stencil, and `dedup_gather`.

Geometries: packs (4,4,2), (2,2,2), (1,1,1) and (2,4,1), under the
default stencil (2,2,1) (windows of 8, 18, 75 and 18 superrows: 256, 144,
75 and 144 candidates a query) and under stencil (1,1,1) (8, 8, 27 and 12
superrows); pack (4,4,4) under stencil (2,2,1) (8 superrows of 64 cells:
512 candidates) and pack (4,4,2) under stencil (3,3,2) (27 superrows: 864
candidates, more than K2 holds in registers).  The maps are filled by the reference's scatter insert from
seeded raycast scans of the synthetic hall; the queries are seeded raycast
points, three of them masked and one NaN.

* `voxelmap.insert` and `map_insert.insert_batched_reference` (rows of 4
  cpr floats) against the reference's insert and its vmap: meta lanes
  exactly, sum lanes within SUM_ATOL (f32 scatter-adds in another order).
* `query_candidates_dense` (bf16 on and off), `kth_smallest_dense`,
  `query_knn` and `cell_centroids`: bit-equal.
* K2's candidate order, written out in Python as csrc/assoc.cu computes
  it (candidate c on lane c mod 32: window row c // cpr, sub-cell c % cpr,
  each by its "ij" meshgrid; a lane steps from c to c + 32 digit by digit
  in the pack's mixed radix), is `query_candidates`' order; and the
  host-side instance choice (`assoc.instance`, `assoc.plan`,
  `map_insert.instance`) gives every geometry a kernel instance.
* `factors.associate_lines` / `associate_planes` with the local rescue,
  fresh and from cached blocks, with f32 blocks: masks exactly; target
  points within ATOL and directions within DIR_ATOL up to sign
  (test_torch_assoc.py's bounds and reasons) wherever the fit's
  eigenvalue gap exceeds `assoc.GAP_MIN` of the largest eigenvalue (the
  card's rule: the eigenvector divides the moments' rounding by the gap;
  with capacity 1, dedup leaves plane fits of gap 0.007 whose normals
  differ by 1e-4 between the packages).  The bf16 rounding of the
  blocks is held bit-equal above, op by op; inside the jitted reference
  XLA contracts the f32 offset sums into FMAs before that rounding, so a
  candidate may differ by one bf16 ulp (2^-8 relative), which moved a
  plane normal by 1.3e-4 at pack (1,1,1).  The reference runs jitted,
  except at pack (1,1,1) with stencil (1,1,1): there XLA:CPU's jit of its
  `_neighbor_moments` (27 candidates a query) returns a wrong first
  moment's y entry on valid queries (off by up to 0.6 m, with n, t_k and
  the second moments right), and op by op the reference agrees with the
  port.
* `dedup_gather`: the counterparts of tests/test_voxelmap.py:142-180 (a
  capacity that holds every unique row changes nothing; an overflowing
  one drops candidates but never corrupts one), the port's dedup gather
  bit-equal to the reference's, the kernel's per-launch bound
  (`voxelmap.dedup_threshold`) giving the same rows, and the rescue with
  Mr < M, whose compacted query set and pad rows rank together, against
  the reference's factors.
(tests/test_torch_split.py holds one teacher-forced step at `tiny_config`
with `map` pack (2,2,2), `local_map` pack (1,1,1) and `dedup_gather` on
both.)
"""

import dataclasses
import functools

import numpy as np
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from mmloam_tpu.config import tiny_config as jax_tiny_config  # noqa: E402
from mmloam_tpu.data import synthetic as jsyn  # noqa: E402
from mmloam_tpu.estimator import factors as jfac  # noqa: E402
from mmloam_tpu.ops import voxelmap as jvx  # noqa: E402

from mmloam_tpu_torch.config import tiny_config  # noqa: E402
from mmloam_tpu_torch.estimator import factors as tfac  # noqa: E402
from mmloam_tpu_torch.ops import assoc, map_insert, voxelmap  # noqa: E402
from mmloam_tpu_torch.tree import tree_map  # noqa: E402

SUM_ATOL = 1e-5
ATOL = 1e-5
DIR_ATOL = 1e-4
CFG = tiny_config()
JCFG = jax_tiny_config()
K = CFG.map.knn
PACKS = ((4, 4, 2), (2, 2, 2), (1, 1, 1), (2, 4, 1))
STENCILS = ((2, 2, 1), (1, 1, 1))
GEOMS = [(p, s) for s in STENCILS for p in PACKS] + [
    ((4, 4, 4), (2, 2, 1)), ((4, 4, 2), (3, 3, 2))]
GEOM_IDS = ["pack{}{}{}-st{}{}{}".format(*p, *s) for p, s in GEOMS]
# windows (superrows) of GEOMS, from the reference's `_super_window`
WINDOW_ROWS = (8, 18, 75, 18, 8, 8, 27, 12, 8, 27)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _k1_instance(pack):
    """K1's instance at this pack: the default at 32 cells a row, the
    group one at 1, the warp-a-position one at any other width."""
    return {32: "default", 1: "groups"}.get(int(np.prod(pack)), "rows")


def _geom(mcfg, pack, stencil, **kw):
    return dataclasses.replace(
        mcfg, pack_x=pack[0], pack_y=pack[1], pack_z=pack[2],
        stencil_x=stencil[0], stencil_y=stencil[1], stencil_z=stencil[2],
        **kw)


def _cfgs(pack, stencil, local_pack=None, local_stencil=None, **kw):
    """(port cfg, reference cfg) with both maps at the geometry (the local
    map at its own, where given)."""
    lp, ls = local_pack or pack, local_stencil or stencil
    return tuple(c.replace(map=_geom(c.map, pack, stencil, **kw),
                           local_map=_geom(c.local_map, lp, ls, **kw))
                 for c in (CFG, JCFG))


def _rays(n, origin, rng, el=0.3):
    az = rng.uniform(-np.pi, np.pi, n)
    e = rng.uniform(-el, el, n)
    dirs = np.stack([np.cos(e) * np.cos(az), np.cos(e) * np.sin(az),
                     np.sin(e)], -1)
    o = np.asarray(origin, np.float64)
    r = jsyn.default_world().raycast(o, dirs)
    ok = np.isfinite(r)
    return (o + dirs * np.where(ok, r, 0.0)[:, None]).astype(np.float32), ok


def _scan_points(seed, n_scans=4):
    """Seeded noisy raycast scans of the hall from a short track."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_scans):
        pts, ok = _rays(2880, (0.4 * i, 0.2 * i, 0.1 * np.sin(i)), rng)
        pts = pts + rng.normal(scale=0.004, size=pts.shape).astype(
            np.float32)
        out.append((pts, ok))
    return out


@functools.lru_cache(maxsize=None)
def _scene(pack, stencil, local_pack=None, local_stencil=None):
    """Maps filled by the reference's insert at the geometry, and 256
    queries (3 masked, one NaN).  Returns (cfg, jcfg, cells, cells_l, pw,
    mask) as numpy."""
    cfg, jcfg = _cfgs(pack, stencil, local_pack, local_stencil)
    vm, vml = jvx.empty_map(jcfg.map), jvx.empty_map(jcfg.local_map)
    for pts, ok in _scan_points(0):
        vm = jvx.insert(vm, jnp.asarray(pts), jnp.asarray(ok), jcfg.map)
        vml = jvx.insert(vml, jnp.asarray(pts), jnp.asarray(ok),
                         jcfg.local_map)
    pw, mask = _rays(256, (0.9, 0.5, 0.05), np.random.default_rng(7))
    mask[:3] = False
    pw[1] = np.nan
    return cfg, jcfg, np.asarray(vm.cells), np.asarray(vml.cells), pw, mask


def _assert_cells(got, want):
    cpr = want.shape[-1] // 4
    np.testing.assert_array_equal(got[..., 3 * cpr:], want[..., 3 * cpr:])
    np.testing.assert_allclose(got[..., :3 * cpr], want[..., :3 * cpr],
                               atol=SUM_ATOL)


@pytest.mark.parametrize("pack,stencil", GEOMS, ids=GEOM_IDS)
def test_inserts_match_jax(pack, stencil):
    cfg, jcfg = _cfgs(pack, stencil)
    vm = voxelmap.empty_map(cfg.map, device="cpu")
    jm = jvx.empty_map(jcfg.map)
    assert tuple(vm.cells.shape) == tuple(jm.cells.shape)
    assert vm.cells.shape[1] == 4 * np.prod(pack)
    scans = _scan_points(1, n_scans=2)
    for pts, ok in scans:
        vm = voxelmap.insert(vm, torch.from_numpy(pts), torch.from_numpy(ok),
                             cfg.map)
        jm = jvx.insert(jm, jnp.asarray(pts), jnp.asarray(ok), jcfg.map)
    _assert_cells(_np(vm.cells), np.asarray(jm.cells))
    assert (_np(vm.count) > 1).any()
    # the batched insert's plain version, two lanes, two inserts each
    P = np.stack([p for p, _ in scans])[None].repeat(2, 0)
    P[1] *= np.float32(0.98)
    Mk = np.stack([m for _, m in scans])[None].repeat(2, 0)
    cells = torch.zeros((2,) + tuple(vm.cells.shape))
    jcells = jnp.zeros((2,) + tuple(jm.cells.shape))
    ins = jax.jit(jax.vmap(lambda c, p, m: jvx.insert(
        jvx.VoxelMap(c), p, m, jcfg.map).cells))
    for i in range(2):
        out = map_insert.insert_batched(cells, torch.from_numpy(P[:, i]),
                                        torch.from_numpy(Mk[:, i]), cfg.map)
        assert out is cells
        jcells = ins(jcells, jnp.asarray(P[:, i]), jnp.asarray(Mk[:, i]))
    _assert_cells(_np(cells), np.asarray(jcells))
    assert map_insert.instance(cfg.map) == _k1_instance(pack)


@pytest.mark.parametrize("pack,stencil", GEOMS, ids=GEOM_IDS)
def test_candidates_and_selection_match_jax(pack, stencil):
    cfg, jcfg, cells, _, pw, mask = _scene(pack, stencil)
    vm, jm = (voxelmap.VoxelMap(torch.from_numpy(cells)),
              jvx.VoxelMap(jnp.asarray(cells)))
    q, jq = torch.from_numpy(pw), jnp.asarray(pw)
    qm, jqm = torch.from_numpy(mask), jnp.asarray(mask)
    C = WINDOW_ROWS[GEOMS.index((pack, stencil))] * int(np.prod(pack))
    assert assoc.n_candidates(cfg.map) == C
    for bf16 in (True, False):
        mc = dataclasses.replace(cfg.map, dense_bf16=bf16)
        jmc = dataclasses.replace(jcfg.map, dense_bf16=bf16)
        got = voxelmap.query_candidates_dense(vm, q, qm, mc)
        want = jvx.query_candidates_dense(jm, jq, jqm, jmc)
        for a, b in zip(got, want):
            assert tuple(a.shape) == (256, C)
            np.testing.assert_array_equal(_np(a.float()),
                                          np.asarray(b.astype(jnp.float32)))
        np.testing.assert_array_equal(
            _np(voxelmap.kth_smallest_dense(got[3].float(), K)),
            np.asarray(jvx.kth_smallest_dense(want[3].astype(jnp.float32),
                                              K)))
    assert np.isfinite(_np(got[3])).any(axis=1).sum() > 100
    nb, valid, d2 = voxelmap.query_knn(vm, q, qm, cfg.map)
    jnb, jvalid, jd2 = jvx.query_knn(jm, jq, jqm, jcfg.map)
    np.testing.assert_array_equal(_np(valid), np.asarray(jvalid))
    np.testing.assert_array_equal(_np(d2), np.asarray(jd2))
    np.testing.assert_array_equal(_np(nb), np.asarray(jnb))
    cent, cval = voxelmap.cell_centroids(vm, cfg.map)
    jcent, jcval = jvx.cell_centroids(jm, jcfg.map)
    np.testing.assert_array_equal(_np(cval), np.asarray(jcval))
    np.testing.assert_array_equal(_np(cent)[_np(cval)],
                                  np.asarray(jcent)[np.asarray(jcval)])


def _walk(C, pack):
    """(row, sub-cell) of candidates 0..C-1 as a lane of csrc/assoc.cu's
    general instances reaches them: candidate c on lane c % 32, its first
    by division, each next (c + 32 = c + q32 cpr + r32) by adding r32's
    digits in the pack's mixed radix, the carry out of x to the row."""
    px, py, pz = pack
    cpr = px * py * pz
    q32, r32 = divmod(32, cpr)
    rd = (r32 // (py * pz), (r32 // pz) % py, r32 % pz)
    s = np.zeros(C, np.int64)
    sub = np.zeros((C, 3), np.int64)
    for lane in range(min(32, C)):
        r, j = divmod(lane, cpr)
        d = [j // (py * pz), (j // pz) % py, j % pz]
        for c in range(lane, C, 32):
            s[c], sub[c] = r, d
            carry = 0
            for ax, p in ((2, pz), (1, py), (0, px)):
                d[ax] += rd[ax] + carry
                carry = int(d[ax] >= p)
                d[ax] -= p * carry
            r += q32 + carry
    return s, sub


def _kernel_candidates(pw, mcfg):
    """Per candidate c of each query, the superrow coords, slot and
    sub-cell offsets as csrc/assoc.cu's general instances compute them:
    window row s (`_walk`) in meshgrid "ij" order over the window, its
    coords from the per-warp row table, sub-cell in meshgrid "ij" order
    over the pack."""
    px, py, pz = voxelmap._pack(mcfg)
    nbx, nby, nbz = voxelmap._super_window(mcfg)
    sd = voxelmap._sdims(mcfg)
    C = nbx * nby * nbz * px * py * pz
    v = np.floor(pw / np.float32(mcfg.voxel_size)).astype(np.int64)
    st = (mcfg.stencil_x, mcfg.stencil_y, mcfg.stencil_z)
    s0 = (v - np.asarray(st)) // np.asarray([px, py, pz])
    s, sub = _walk(C, (px, py, pz))
    o = np.stack([s // (nby * nbz), (s // nbz) % nby, s % nbz], -1)
    sv = s0[:, None, :] + o[None]
    mt = sv % np.asarray(sd)
    slot = (mt[..., 0] * sd[1] + mt[..., 1]) * sd[2] + mt[..., 2]
    return sv, slot, np.broadcast_to(sub, sv.shape)


@pytest.mark.parametrize("pack,stencil", GEOMS, ids=GEOM_IDS)
def test_kernel_candidate_order_is_the_reference_order(pack, stencil):
    cfg, _, _, _, pw, mask = _scene(pack, stencil)
    mcfg = cfg.map
    ok = np.isfinite(pw).all(axis=1)
    sv, slot, sub = _kernel_candidates(pw[ok], mcfg)
    addr = voxelmap.stencil_addresses(torch.from_numpy(pw[ok]), mcfg)
    cpr = voxelmap._cpr(mcfg)
    rep = lambda a: np.repeat(_np(a), cpr, axis=1)
    np.testing.assert_array_equal(sv, rep(addr.sv))
    np.testing.assert_array_equal(slot, rep(addr.slot))
    # sub-cells: the meshgrid "ij" of the pack, as query_candidates lays
    # out its (M, S, cpr) blocks
    gx, gy, gz = np.meshgrid(*(np.arange(p) for p in pack), indexing="ij")
    ref = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], -1)
    np.testing.assert_array_equal(sub[0], np.tile(ref, (sv.shape[1] // cpr,
                                                        1)))
    # the number of candidates picks the kernel instance
    per = -(-assoc.n_candidates(mcfg) // 32)
    inst = assoc.instance(mcfg)
    assert inst == ("default" if (pack, stencil) in (
        ((4, 4, 2), (2, 2, 1)), ((4, 4, 2), (1, 1, 1))) else
        "regs4" if per <= 4 else "regs8" if per <= 8 else
        "regs16" if per <= 16 else "staged")


@pytest.mark.parametrize("cached", [False, True])
def test_instance_choice(cached):
    """Every geometry of GEOMS has a K2 instance; the default map under
    dedup_gather keeps the default window's; the buffer each warp needs
    (a table of 8 words a window row, 16 B a candidate when staged) and
    the warps a block follow from the window alone; K1 runs any pack."""
    want = {((4, 4, 2), (2, 2, 1)): "default",
            ((2, 2, 2), (2, 2, 1)): "regs8", ((1, 1, 1), (2, 2, 1)): "regs4",
            ((2, 4, 1), (2, 2, 1)): "regs8", ((4, 4, 2), (1, 1, 1)): "default",
            ((2, 2, 2), (1, 1, 1)): "regs4", ((1, 1, 1), (1, 1, 1)): "regs4",
            ((2, 4, 1), (1, 1, 1)): "regs4", ((4, 4, 4), (2, 2, 1)): "regs16",
            ((4, 4, 2), (3, 3, 2)): "staged"}
    assert set(want) == set(GEOMS)
    for (pack, stencil), inst in want.items():
        mcfg = _cfgs(pack, stencil)[0].map
        name, wpb, words, scratch = assoc.plan(mcfg, cached)
        C, S = assoc.n_candidates(mcfg), assoc.window_rows(mcfg)
        if cached and C == 256:     # cached blocks of the default's width
            inst = "default"
        assert assoc.instance(mcfg, cached) == name == inst, (pack, stencil)
        table = 0 if cached or inst == "default" else 8 * S
        # bf16 dense blocks (tiny_config's) stage 8 B a candidate
        stage = 2 * 32 * -(-C // 32) if inst == "staged" else 0
        # 864 staged candidates and a table, 7.8 KB a warp: 7 blocks of 4
        # warps an SM keep more warps than 3 blocks of 8
        want_wpb = 4 if inst == "staged" and not cached else 8
        assert (words, wpb, scratch) == (table + stage, want_wpb, False)
        assert map_insert.instance(mcfg) == _k1_instance(pack)
        for cap in (1, 2):
            dd = dataclasses.replace(mcfg, dedup_gather=True,
                                     dedup_capacity=cap)
            assert assoc.plan(dd, cached) == (name, wpb, words, scratch)
    # f32 blocks stage 16 B a candidate: 864 take 14.7 KB a warp, 2 warps
    # a block; a window of 35 KB a warp also runs 2; one over a block's
    # shared memory puts the warps' buffers in device memory
    f32 = _cfgs((4, 4, 2), (3, 3, 2), dense_bf16=False)[0].map
    assert assoc.plan(f32) == ("staged", 2, 8 * 27 + 4 * 864, False)
    big = _cfgs((4, 4, 2), (5, 5, 3), dense_bf16=False)[0].map
    assert assoc.plan(big) == ("staged", 2, 8 * 64 + 4 * 2048, False)
    huge = _cfgs((1, 1, 1), (10, 10, 10))[0].map
    assert assoc.plan(huge)[1:] == (1, 8 * 9261 + 2 * 32 * 290, True)


@pytest.fixture(scope="module")
def jax_assoc():
    eye, zero = jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32)

    def lines(x6, p_l, mask, vm, vml, thres, cached, cfg):
        return jfac.associate_lines(x6, p_l, mask, vm, eye, zero, cfg, thres,
                                    vm_local=vml, cached=cached,
                                    with_blocks=True)

    def planes(x6, p_l, mask, vm, vml, thres, cached, cfg):
        pt, omega, valid, blk = jfac.associate_planes(
            x6, p_l, mask, vm, eye, zero, cfg, thres, 0.5, vm_local=vml,
            cached=cached, with_blocks=True)
        return (pt, omega, valid), blk

    return {(assoc.LINE, True): jax.jit(lines, static_argnames="cfg"),
            (assoc.PLANE, True): jax.jit(planes, static_argnames="cfg"),
            (assoc.LINE, False): lines, (assoc.PLANE, False): planes}


def _sign_close(got, want, atol):
    s = np.where(np.sum(got * want, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    np.testing.assert_allclose(got * s, want, atol=atol)


def _clear(mode, fits):
    """Queries whose serving fit (persistent map, else local map) has an
    eigenvalue gap above `assoc.GAP_MIN` of its largest eigenvalue (fits
    of one lane, with its lane axis)."""
    out = []
    for f in fits:
        ev = _np(f["evals"][0])
        gap = ev[:, 2] - ev[:, 1] if mode == assoc.LINE \
            else ev[:, 1] - ev[:, 0]
        out.append(gap > assoc.GAP_MIN * np.abs(ev).max(axis=1))
    return np.where(_np(fits[0]["valid"][0]), out[0], out[1])


def _assert_targets(mode, tt_, tj, least, clear):
    if mode == assoc.LINE:
        valid = _np(tt_.valid)
        np.testing.assert_array_equal(valid, np.asarray(tj.valid))
        assert valid.sum() > least, valid.sum()
        sel = valid & clear
        np.testing.assert_allclose(_np(tt_.c)[sel], np.asarray(tj.c)[sel],
                                   atol=ATOL)
        _sign_close(_np(tt_.u)[sel], np.asarray(tj.u)[sel], DIR_ATOL)
        return
    (pt, omega, valid), (pj, omega_j, valid_j) = tt_, tj
    valid = _np(valid)
    np.testing.assert_array_equal(valid, np.asarray(valid_j))
    assert valid.sum() > least, valid.sum()
    sel = valid & clear
    np.testing.assert_allclose(_np(pt.proj)[sel], np.asarray(pj.proj)[sel],
                               atol=ATOL)
    _sign_close(_np(omega)[sel], np.asarray(omega_j)[sel], DIR_ATOL)


def _associate_both(mode, scene, jax_assoc, rescue_frac, least, jit=True):
    """The port's and the reference's factors association with the local
    rescue, fresh then from the fresh call's cached blocks at a moved
    pose (the reference jitted, or op by op)."""
    cfg, jcfg, cells, cells_l, pw, mask = scene
    cfg = cfg.replace(solver=dataclasses.replace(
        cfg.solver, local_rescue_frac=rescue_frac))
    jcfg = jcfg.replace(solver=dataclasses.replace(
        jcfg.solver, local_rescue_frac=rescue_frac))
    p_l = np.where(np.isfinite(pw), pw, 0.0).astype(np.float32)
    thres = np.float32(1.0)
    # the port's association takes a lane axis: one lane here
    lane = lambda a: torch.from_numpy(a)[None]
    tvm, tvml = (voxelmap.VoxelMap(lane(c)) for c in (cells, cells_l))
    jvm, jvml = (jvx.VoxelMap(jnp.asarray(c)) for c in (cells, cells_l))

    def port(x6, cached):
        """The targets of the one lane, and the blocks with their lane
        axis (the cached entry's input)."""
        args = (lane(x6), lane(p_l), lane(mask), tvm, torch.eye(3),
                torch.zeros(3), cfg, torch.tensor([thres]))
        if mode == assoc.LINE:
            lt, blk = tfac.associate_lines(*args, vm_local=tvml,
                                           cached=cached, with_blocks=True)
            return tree_map(lambda a: a[0], lt), blk
        pt, omega, valid, blk = tfac.associate_planes(
            *args, 0.5, vm_local=tvml, cached=cached, with_blocks=True)
        return tree_map(lambda a: a[0], (pt, omega, valid)), blk

    blk_j = blk_t = None
    for x6 in (np.zeros(6, np.float32), np.full(6, 3e-3, np.float32)):
        tj, bj = jax_assoc[mode, jit](jnp.asarray(x6), jnp.asarray(p_l),
                                      jnp.asarray(mask), jvm, jvml, thres,
                                      blk_j, jcfg)
        tt_, bt = port(x6, blk_t)
        pw_t = tfac._world_points(lane(x6), lane(p_l), torch.eye(3),
                                  torch.zeros(3))
        sr = cfg.solver.plane_scatter_ratio if mode == assoc.PLANE else 0.0
        fits = assoc.rescue_stage_reference(
            tvm, tvml, pw_t, lane(mask), cfg.map, cfg.local_map,
            K, mode, torch.tensor([thres]), sr, blk_t,
            tfac._rescue_cap(pw.shape[0], rescue_frac))
        clear = _clear(mode, fits)
        assert clear[_np(tt_.valid if mode == assoc.LINE else tt_[2])].mean() \
            > 0.9
        _assert_targets(mode, tt_, tj, least, clear)
        if blk_j is None:
            blk_j, blk_t = bj, bt


@pytest.mark.parametrize("mode", [assoc.PLANE, assoc.LINE])
@pytest.mark.parametrize("pack,stencil", GEOMS, ids=GEOM_IDS)
def test_association_matches_jax(pack, stencil, mode, jax_assoc):
    """factors' association with the compacted local rescue (frac 0.5:
    Mr = 128 < M = 256), fresh and cached, f32 blocks."""
    least = 50 if mode == assoc.PLANE else 5
    cfg, jcfg, *rest = _scene(pack, stencil)
    f32 = lambda c: c.replace(
        map=dataclasses.replace(c.map, dense_bf16=False),
        local_map=dataclasses.replace(c.local_map, dense_bf16=False))
    _associate_both(mode, (f32(cfg), f32(jcfg), *rest), jax_assoc, 0.5,
                    least, jit=(pack, stencil) != ((1, 1, 1), (1, 1, 1)))


# --------------------------------------------------------------------------
# dedup_gather
# --------------------------------------------------------------------------

def _dense(vm, q, mask, mcfg):
    return [_np(a.float()) for a in voxelmap.query_candidates_dense(
        vm, torch.from_numpy(q), torch.from_numpy(mask), mcfg)]


def _jdense(cells, q, mask, jmcfg):
    return [np.asarray(a.astype(jnp.float32)) for a in
            jvx.query_candidates_dense(jvx.VoxelMap(jnp.asarray(cells)),
                                       jnp.asarray(q), jnp.asarray(mask),
                                       jmcfg)]


def _random_map(seed, span, n, mcfg):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-span, span, (n, 3)).astype(np.float32)
    vm = voxelmap.insert(voxelmap.empty_map(mcfg, device="cpu"),
                         torch.from_numpy(pts), torch.ones(n, dtype=bool),
                         mcfg)
    return vm, rng


def test_dedup_gather_equivalence():
    """A compact capacity that holds every unique superrow (clustered
    queries) changes no candidate, as in the reference."""
    mcfg = dataclasses.replace(CFG.map, dense_bf16=False)
    vm, rng = _random_map(3, 3.0, 800, mcfg)
    q = rng.uniform(-2, 2, (128, 3)).astype(np.float32)
    mask = np.ones(128, bool)
    on = dataclasses.replace(mcfg, dedup_gather=True, dedup_capacity=4)
    for a, b in zip(_dense(vm, q, mask, mcfg), _dense(vm, q, mask, on)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("capacity", [0, -1])
def test_dedup_capacity_below_one_raises(capacity):
    """A compact table of no rows is refused with ValueError by the plain
    gather, the plain association and the kernel's map check (whose bound
    would otherwise lie below every slot); capacity 1 runs."""
    mcfg = dataclasses.replace(CFG.map, dense_bf16=False)
    vm, rng = _random_map(3, 3.0, 200, mcfg)
    q = rng.uniform(-2, 2, (16, 3)).astype(np.float32)
    mask = np.ones(16, bool)
    bad = dataclasses.replace(mcfg, dedup_gather=True,
                              dedup_capacity=capacity)
    with pytest.raises(ValueError, match="dedup_capacity"):
        _dense(vm, q, mask, bad)
    with pytest.raises(ValueError, match="dedup_capacity"):
        assoc.associate_reference(vm, torch.from_numpy(q),
                                  torch.from_numpy(mask), bad, K,
                                  assoc.PLANE, CFG.solver.thres_dist)
    with pytest.raises(ValueError, match="dedup_capacity"):
        assoc._check_map(vm, bad, vm.cells.device)
    one = dataclasses.replace(bad, dedup_capacity=1)
    assoc._check_map(vm, one, vm.cells.device)
    assert np.isfinite(_dense(vm, q, mask, one)[3]).any()


@pytest.mark.parametrize("pack", [(4, 4, 2), (2, 2, 2)])
def test_dedup_gather_overflow_drops_never_corrupts(pack):
    """Capacity 1 on spread queries: overflowed rows drop their candidates
    (d2 = inf), and every candidate returned is the plain gather's, bit
    for bit; the port's dedup equals the reference's exactly."""
    mcfg = _geom(dataclasses.replace(CFG.map, dense_bf16=False), pack,
                 (2, 2, 1))
    vm, rng = _random_map(4, 17.0, 2000, mcfg)
    q = rng.uniform(-16, 16, (128, 3)).astype(np.float32)
    mask = np.ones(128, bool)
    on = dataclasses.replace(mcfg, dedup_gather=True, dedup_capacity=1)
    base = _dense(vm, q, mask, mcfg)
    dd = _dense(vm, q, mask, on)
    fin = np.isfinite(dd[3])
    assert fin.sum() > 0 and (np.isfinite(base[3]) & ~fin).sum() > 0
    for a, b in zip(base, dd):
        np.testing.assert_array_equal(a[fin], b[fin])
    jon = _geom(dataclasses.replace(JCFG.map, dense_bf16=False,
                                    dedup_gather=True, dedup_capacity=1),
                pack, (2, 2, 1))
    for a, b in zip(dd, _jdense(_np(vm.cells), q, mask, jon)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("capacity", [1, 2, 64])
def test_dedup_rows_and_kernel_bound_match_jax(capacity):
    """`_dedup_gather_rows` equals the reference's bit for bit, and the
    kernel's per-launch bound gives the same rows: a row is kept iff its
    slot is <= the bound, and a dropped row reads the bound's row."""
    cells = np.random.default_rng(0).normal(size=(300, 8)).astype(
        np.float32)
    slot = np.random.default_rng(1).integers(0, 300, (40, 6)).astype(
        np.int32)
    slot[:8] = slot[0]                    # clustered queries share rows
    rows, valid = voxelmap._dedup_gather_rows(torch.from_numpy(cells),
                                              torch.from_numpy(slot),
                                              capacity * 40)
    jrows, jvalid = jvx._dedup_gather_rows(jnp.asarray(cells),
                                           jnp.asarray(slot), capacity * 40)
    np.testing.assert_array_equal(_np(rows), np.asarray(jrows))
    np.testing.assert_array_equal(_np(valid), np.asarray(jvalid))
    thr = int(voxelmap.dedup_threshold(torch.from_numpy(slot),
                                       capacity * 40)[0])
    np.testing.assert_array_equal(_np(valid), slot <= thr)
    read = np.where(slot <= thr, slot, thr)
    np.testing.assert_array_equal(_np(rows), cells[read])
    assert (capacity * 40 < len(np.unique(slot))) == (~_np(valid)).any()


@pytest.mark.parametrize("mode", [assoc.PLANE, assoc.LINE])
def test_dedup_rescue_matches_jax(mode, jax_assoc):
    """dedup_gather on both maps (capacity 1, so rows overflow; f32
    blocks), the persistent map at pack (2,2,2) and the local map at
    (1,1,1): the
    compacted rescue (Mr = 128 < M = 256) ranks the first Mr flagged
    queries and the pad rows at the origin together, as the reference's
    factors do.  Against the reference's factors, and the plain rescue cut
    the kernel is held to (`run_rescue` on CPU tensors, from the flags'
    compacted set) equal to `associate_with_rescue_reference` bit for
    bit."""
    base = _scene((2, 2, 2), (2, 2, 1), (1, 1, 1), (2, 2, 1))
    on = dict(dedup_gather=True, dedup_capacity=1, dense_bf16=False)
    cfg, jcfg = (c.replace(map=dataclasses.replace(c.map, **on),
                           local_map=dataclasses.replace(c.local_map, **on))
                 for c in base[:2])
    scene = (cfg, jcfg) + base[2:]
    least = 20 if mode == assoc.PLANE else 5     # capacity 1 drops many
    _associate_both(mode, scene, jax_assoc, 0.5, least)

    _, _, cells, cells_l, pw, mask = scene
    # one lane, with its lane axis
    vm, vml = (voxelmap.VoxelMap(torch.from_numpy(c)[None])
               for c in (cells, cells_l))
    q = torch.from_numpy(np.where(np.isfinite(pw), pw, 0.0)
                         .astype(np.float32))[None]
    m = torch.from_numpy(mask)[None]
    sr = 0.01 if mode == assoc.PLANE else 0.0
    thres = torch.tensor([1.0])
    cap = tfac._rescue_cap(256, 0.5)
    args = (vm, vml, q, m, cfg.map, cfg.local_map, K, mode, thres, sr, cap)
    ref, _ = assoc.associate_with_rescue_reference(*args)
    got = assoc.run_rescue(*args)
    for name in assoc.Assoc._fields:
        torch.testing.assert_close(got[name], getattr(ref, name), rtol=0,
                                   atol=0, equal_nan=True)
    # rows did overflow in both maps
    for mc, vmi, pwq in ((cfg.map, vm, q),
                         (cfg.local_map, vml,
                          assoc._rescue_queries(q, got["need"], cap)[1])):
        keep = assoc.stage_reference(assoc.GATHER, vmi, pwq, m, mc, K, mode,
                                     thres)["keep"]
        assert not bool(keep.all())
