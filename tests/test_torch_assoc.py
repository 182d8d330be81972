"""The association kernel's plain version (ops/assoc.py, K2) against JAX.

Inputs are the fixture of tests/test_pallas_assoc.py: a tiny-config map
filled by the reference's scatter insert from four seeded raycast scans
of the synthetic hall (plus a local map from the same scans), and 256
seeded raycast queries, three of them masked and one NaN.

* Stencil addressing: `voxelmap.stencil_addresses` gives the archived
  kernel's slots (`prepare_queries`) exactly.
* Archived kernel, f32 mode: with `dense_bf16=False` the plain version is
  held against `pallas_assoc.assoc_batched(..., interpret=True)` at that
  test's own bounds (n exact, t_k rtol 1e-5, mu atol 1e-5, |vec . ref| >
  0.999 where the eigen gap is clear, valid agreement > 0.98): the
  archived kernel solves the eigenvalue angle by Newton steps instead of
  acos, so vectors and near-threshold gates may differ.
* Production path, bf16 blocks: `factors.associate_lines` /
  `associate_planes` against the reference's, fresh and from cached
  blocks, with the local rescue both compacted (`Mr < M`) and uncapped
  (`Mr >= M`).  Masks exactly; target points within ATOL = 1e-5 m (f32
  sums in another order, which XLA also contracts into FMAs); directions
  within DIR_ATOL = 1e-4, since the eigenvector column divides the moment
  rounding by the eigenvalue gap, and up to sign, which no residual sees.
  The same calls equal, bit for bit, the composition factors ran before
  the rescue was fused into `assoc.associate_with_rescue` (two
  `associate` calls, compaction, scatter).
* The rescue pair's plain form (`run_rescue` on CPU tensors: both maps
  over every query, merged by the flags' ranks as the kernel's two
  launches merge) equals `associate_with_rescue_reference` bit for bit,
  with a cap that binds and with every failure tried.
* The kernel's integer addressing (floor division and remainder from C's
  truncating / and %, the key clamp and packing), written out in Python,
  equals `voxelmap.stencil_addresses` at voxel and superrow boundaries, at
  negative coordinates and across the torus wrap.
* The dispatcher takes the plain version for CPU tensors and counts the
  call; each stage's plain cut agrees with the full plain version.
* The MOMENTS bound of `assoc.compare` (`assoc.moment_tols`) at windows of
  864 and 9,261 terms: f32 sums of the same terms in another order pass
  it, sums taken in bf16 fail it.
"""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from mmloam_tpu.config import tiny_config as jax_tiny_config  # noqa: E402
from mmloam_tpu.estimator import factors as jfac  # noqa: E402
from mmloam_tpu.ops import voxelmap as jvx  # noqa: E402

from mmloam_tpu_torch.config import tiny_config  # noqa: E402
from mmloam_tpu_torch.estimator import factors as tfac  # noqa: E402
from mmloam_tpu_torch.ops import assoc, voxelmap  # noqa: E402
from mmloam_tpu_torch.tree import tree_map  # noqa: E402

_TESTS = pathlib.Path(__file__).resolve().parent


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


pallas_assoc = _load("pallas_assoc_archive_t",
                     _TESTS.parent / "scripts" / "pallas_assoc.py")
fixture = _load("pallas_assoc_fixture_t", _TESTS / "test_pallas_assoc.py")

ATOL = 1e-5
DIR_ATOL = 1e-4
CFG = tiny_config()
JCFG = jax_tiny_config()
K = CFG.map.knn


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _maps(seed):
    """(persistent map cells, local map cells, world, rng) as numpy, both
    filled by the reference's insert from the fixture's scans."""
    cfg, vm, world, rng = fixture._build(seed=seed)
    rng_l = np.random.default_rng(seed)
    vml = jvx.empty_map(JCFG.local_map)
    az = np.linspace(-np.pi, np.pi, 720, endpoint=False)
    elevs = np.deg2rad([-15.0, -5.0, 5.0, 15.0])
    A, E = np.meshgrid(az, elevs)
    dirs = np.stack([np.cos(E) * np.cos(A), np.cos(E) * np.sin(A),
                     np.sin(E)], -1).reshape(-1, 3)
    for i in range(4):
        o = np.array([0.4 * i, 0.2 * i, 0.1 * np.sin(i)])
        r = world.raycast(o, dirs)
        ok = np.isfinite(r)
        r = r + rng_l.normal(scale=0.004, size=r.shape)
        pts = o + dirs * np.where(ok, r, 0.0)[:, None]
        vml = jvx.insert(vml, jnp.asarray(pts, jnp.float32), jnp.asarray(ok),
                         JCFG.local_map)
    return np.array(vm.cells), np.array(vml.cells), world, rng


def _queries(seed, origin):
    cells, cells_l, world, rng = _maps(seed)
    pw, mask = fixture._queries(world, rng, origin=origin)
    return cells, cells_l, np.array(pw), np.array(mask)


def test_stencil_addresses_match_prepare_queries():
    cells, _, pw, mask = _queries(0, (0.9, 0.5, 0.05))
    slot_j, meta_j = pallas_assoc.prepare_queries(jnp.asarray(pw),
                                                  jnp.asarray(mask), JCFG.map)
    addr = voxelmap.stencil_addresses(torch.from_numpy(pw), CFG.map)
    ok = np.isfinite(pw).all(axis=1)
    np.testing.assert_array_equal(_np(addr.slot)[ok], np.asarray(slot_j)[ok])
    keyq = np.asarray(meta_j)[..., 6]
    np.testing.assert_array_equal(_np(addr.key)[mask], keyq[mask])
    assert addr.slot.dtype == torch.int32 and addr.sv.shape == (256, 8, 3)


@pytest.mark.parametrize("mode", [assoc.PLANE, assoc.LINE])
def test_plain_f32_matches_archived_kernel(mode):
    seed, origin = ((0, (0.9, 0.5, 0.05)) if mode == assoc.PLANE
                    else (5, (0.3, -0.4, 0.0)))
    cells, _, pw, mask = _queries(seed, origin)
    sr = JCFG.solver.plane_scatter_ratio if mode == assoc.PLANE else 0.0
    mu_j, vec_j, valid_j, t_j, n_j = (np.asarray(a)[0] for a in
                                      pallas_assoc.assoc_batched(
        jnp.asarray(cells)[None], jnp.asarray(pw)[None],
        jnp.asarray(mask)[None], jnp.float32(1.0), JCFG.map, mode=mode, k=K,
        scatter_ratio=sr, interpret=True))

    mcfg = dataclasses.replace(CFG.map, dense_bf16=False)
    r, evals, _ = _plain_full(cells, pw, mask, mcfg, mode, 1.0, sr)
    n, t_k = _np(r.n), _np(r.t_k)
    have = (n >= K) & (t_k < 1.0) & mask
    assert have.sum() > 50, have.sum()
    np.testing.assert_array_equal(n[have], n_j[have])
    np.testing.assert_allclose(t_k[have], t_j[have], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(r.mu)[have], mu_j[have], atol=1e-5)
    ev = _np(evals)
    if mode == assoc.PLANE:
        clear = have & ((ev[:, 1] - ev[:, 0]) > 0.1 * ev[:, 2])
    else:
        clear = have & (ev[:, 2] > 3.0 * ev[:, 1])
    assert clear.sum() > 20, clear.sum()
    dots = np.abs(np.sum(_np(r.vec)[clear] * vec_j[clear], axis=-1))
    assert (dots > 0.999).all(), dots.min()
    agree = _np(r.valid)[have] == valid_j[have]
    assert agree.mean() > 0.98, agree.mean()


def _plain_full(cells, pw, mask, mcfg, mode, thres, sr):
    """The plain version through its pieces: (Assoc, evals, gates)."""
    pw_t, mask_t = torch.from_numpy(pw), torch.from_numpy(mask)
    vm = voxelmap.VoxelMap(torch.from_numpy(cells))
    t_k, n, s1, s2, blk, _ = assoc._neighbor_moments(vm, pw_t, mask_t, mcfg,
                                                     K)
    return assoc._fit(mode, pw_t, mask_t, t_k, n, s1, s2, blk,
                      torch.tensor(thres), K, sr)


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

    return {assoc.LINE: jax.jit(lines, static_argnames="cfg"),
            assoc.PLANE: jax.jit(planes, static_argnames="cfg")}


def _sign_close(got, want, atol):
    """Rows of unit vectors equal up to sign."""
    s = np.where(np.sum(got * want, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    np.testing.assert_allclose(got * s, want, atol=atol)


@pytest.mark.parametrize("rescue_frac", [0.5, 1.0])
@pytest.mark.parametrize("mode", [assoc.PLANE, assoc.LINE])
def test_production_association_matches_jax(mode, rescue_frac, jax_assoc):
    """Fresh and cached entries, compacted (frac 0.5 -> Mr = 128 < M = 256)
    and uncapped (frac 1.0 -> Mr = M) local rescue."""
    seed, origin = ((0, (0.9, 0.5, 0.05)) if mode == assoc.PLANE
                    else (5, (0.3, -0.4, 0.0)))
    cells, cells_l, pw, mask = _queries(seed, origin)
    assert CFG.map.dense_bf16
    cfg = CFG.replace(solver=dataclasses.replace(
        CFG.solver, local_rescue_frac=rescue_frac))
    jcfg = JCFG.replace(solver=dataclasses.replace(
        JCFG.solver, local_rescue_frac=rescue_frac))
    M = pw.shape[0]
    assert (tfac._rescue_cap(M, rescue_frac) < M) == (rescue_frac < 1.0)
    p_l = np.where(np.isfinite(pw), pw, 0.0).astype(np.float32)
    thres = np.float32(1.0)
    fj = jax_assoc[mode]
    # the port's association takes a lane axis: one lane here
    tvm = voxelmap.VoxelMap(torch.from_numpy(cells)[None])
    tvml = voxelmap.VoxelMap(torch.from_numpy(cells_l)[None])
    lane = lambda a: torch.from_numpy(a)[None]
    jvm, jvml = jvx.VoxelMap(jnp.asarray(cells)), jvx.VoxelMap(
        jnp.asarray(cells_l))

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

    x6 = np.zeros(6, np.float32)
    x6_moved = x6 + np.float32(3e-3)
    before = assoc.CALLS
    tj, blk_j = fj(jnp.asarray(x6), jnp.asarray(p_l), jnp.asarray(mask), jvm,
                   jvml, thres, None, jcfg)
    tt, blk_t = port(x6, None)
    assert assoc.CALLS == before + 1       # persistent + local tier, fused
    _assert_targets(mode, tt, tj)
    _assert_same_targets(mode, tt, _old_composition(
        mode, lane(x6), lane(p_l), lane(mask), tvm, tvml, cfg,
        torch.tensor([thres])))
    for name in ("dxd", "dyd", "dzd", "d2d"):
        a = _np(getattr(blk_t, name)[0].float())
        b = np.asarray(getattr(blk_j, name).astype(jnp.float32))
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=name)
        # one bf16 ulp (at most 2^-7 relative): XLA may contract the f32
        # sums into FMAs before the rounding (1e-6: f32 cancellation)
        np.testing.assert_allclose(a[fin], b[fin], rtol=2 ** -7, atol=1e-6,
                                   err_msg=name)
    tj2, _ = fj(jnp.asarray(x6_moved), jnp.asarray(p_l), jnp.asarray(mask),
                jvm, jvml, thres, blk_j, jcfg)
    tt2, _ = port(x6_moved, blk_t)
    _assert_targets(mode, tt2, tj2)
    _assert_same_targets(mode, tt2, _old_composition(
        mode, lane(x6_moved), lane(p_l), lane(mask), tvm, tvml, cfg,
        torch.tensor([thres]), blk_t))


def _old_composition(mode, x6, p_l, mask, vm, vml, cfg, thres, cached=None):
    """factors' association as it stood before the rescue was fused: two
    `associate` calls, the second on the compacted failures, merged after
    each map's post-processing.  Inputs of one lane, with its lane axis.
    Returns the lane's (proj, omega, valid) for the plane mode, (c, u,
    valid) for the line mode."""
    pw = tfac._world_points(x6, p_l, torch.eye(3), torch.zeros(3))
    M = pw.shape[-2]
    sr = cfg.solver.plane_scatter_ratio if mode == assoc.PLANE else 0.0

    def one(vmi, mcfg, pwq, maskq, cac=None):
        r, _ = assoc.associate(vmi, pwq, maskq, mcfg, K, mode, thres, sr,
                               cached=cac)
        if mode == assoc.LINE:
            return pwq + r.mu, r.vec, r.valid
        dist = -torch.sum(r.vec * r.mu, dim=-1)
        return pwq - dist[..., None] * r.vec, r.vec, r.valid

    p, v, valid = one(vm, cfg.map, pw, mask, cached)
    Mr = tfac._rescue_cap(M, cfg.solver.local_rescue_frac)
    if Mr >= M:
        p2, v2, valid2 = one(vml, cfg.local_map, pw, mask)
        use2 = (~valid & valid2)[..., None]
        return (torch.where(use2, p2, p)[0], torch.where(use2, v2, v)[0],
                (valid | valid2)[0])
    sel = assoc._compact_indices(mask & ~valid, Mr)
    p2, v2, valid2 = one(vml, cfg.local_map, assoc._take_fill(pw, sel),
                         sel < M)
    ok = torch.where(valid2, sel, torch.full_like(sel, M))
    return (assoc._set_drop(p, ok, p2)[0], assoc._set_drop(v, ok, v2)[0],
            assoc._set_drop(valid, ok, torch.ones_like(valid2))[0])


def _assert_same_targets(mode, tt, old):
    """The fused rescue's targets are the old composition's, bit for bit."""
    if mode == assoc.LINE:
        got = (tt.c, tt.u, tt.valid)
    else:
        pt, omega, valid = tt
        got = (pt.proj, omega, valid)
    for a, b in zip(got, old):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _assert_targets(mode, tt, tj):
    if mode == assoc.LINE:
        valid = _np(tt.valid)
        np.testing.assert_array_equal(valid, np.asarray(tj.valid))
        assert valid.sum() > 30, valid.sum()
        np.testing.assert_allclose(_np(tt.c)[valid], np.asarray(tj.c)[valid],
                                   atol=ATOL)
        _sign_close(_np(tt.u)[valid], np.asarray(tj.u)[valid], DIR_ATOL)
        return
    (pt, omega, valid), (pj, omega_j, valid_j) = tt, tj
    valid = _np(valid)
    np.testing.assert_array_equal(valid, np.asarray(valid_j))
    np.testing.assert_array_equal(_np(pt.valid), np.asarray(pj.valid))
    assert valid.sum() > 50, valid.sum()
    np.testing.assert_allclose(_np(pt.proj)[valid], np.asarray(pj.proj)[valid],
                               atol=ATOL)
    _sign_close(_np(omega)[valid], np.asarray(omega_j)[valid], DIR_ATOL)


@pytest.mark.parametrize("mode", [assoc.PLANE, assoc.LINE])
def test_stage_cuts_agree_with_plain_version(mode):
    """Every stage's plain cut is a cut of the same computation, and the
    dispatcher on CPU tensors is the plain version."""
    cells, _, pw, mask = _queries(0, (0.9, 0.5, 0.05))
    # one lane, with its lane axis
    vm = voxelmap.VoxelMap(torch.from_numpy(cells)[None])
    pw_t, mask_t = torch.from_numpy(pw)[None], torch.from_numpy(mask)[None]
    args = (vm, pw_t, mask_t, CFG.map, K, mode, torch.tensor([1.0]), 0.01)
    r, blocks = assoc.associate_reference(*args)
    calls = assoc.CALLS
    r2, blocks2 = assoc.associate(*args, want_blocks=True)
    assert assoc.CALLS == calls + 1
    for a, b in zip(r, r2):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(blocks.d2d, blocks2.d2d)
    assert assoc.associate(*args)[1] is None

    cuts = {s: assoc.run_stage(s, *args) for s in range(len(
        assoc.STAGE_NAMES))}
    slot = voxelmap.stencil_addresses(pw_t[0], CFG.map).slot.long()
    assert torch.equal(cuts[assoc.GATHER]["rows"][0], vm.cells[0][slot])
    for s in (assoc.SELECT, assoc.MOMENTS, assoc.OUT, assoc.NEED):
        torch.testing.assert_close(cuts[s]["t_k"], r.t_k, rtol=0, atol=0)
        torch.testing.assert_close(cuts[s]["n"], r.n, rtol=0, atol=0)
    torch.testing.assert_close(cuts[assoc.EIG]["vec"], r.vec, rtol=0, atol=0,
                               equal_nan=True)
    need = cuts[assoc.NEED]["need"]
    assert torch.equal(need, mask_t & ~r.valid)
    assert int(cuts[assoc.NEED]["need_count"]) == int(need.sum()) > 0
    for s, got in cuts.items():
        stats = assoc.compare(s, got, assoc.stage_reference(s, *args),
                              mask_t, mode)
        assert stats["max_abs_err"] == 0.0 and stats["near"] == 0
    with pytest.raises(AssertionError, match="valid differs"):
        bad = dict(cuts[assoc.OUT], valid=~cuts[assoc.OUT]["valid"])
        assoc.compare(assoc.OUT, bad, assoc.stage_reference(assoc.OUT, *args),
                      mask_t, mode)

    # cached entry: the blocks re-expressed at unmoved queries recompute
    # d2 from the rounded offsets, so t_k moves by at most one bf16 ulp
    rc, back = assoc.associate(*args, cached=blocks)
    assert back is blocks
    fin = torch.isfinite(r.t_k)
    assert torch.equal(torch.isfinite(rc.t_k), fin)
    torch.testing.assert_close(rc.t_k[fin], r.t_k[fin], rtol=2 ** -7, atol=0)


def test_near_threshold_flags_only_close_gates():
    q = torch.tensor([0.2, 0.2001, 0.3, 1e-5, 2e-5])
    thr = torch.tensor([0.2, 0.2, 0.2, 1e-5, 1e-5])
    near = assoc.near_threshold([(q, thr)], 1e-3)
    assert near.tolist() == [True, True, False, True, False]


@pytest.mark.parametrize("rescue_frac", [0.5, 1.0])
@pytest.mark.parametrize("mode", [assoc.PLANE, assoc.LINE])
def test_rescue_pair_plain_forms_agree(mode, rescue_frac):
    """`run_rescue`'s plain form (both maps over every query, merged by the
    flags' ranks, as the kernel's two launches merge) equals the
    compaction of `associate_with_rescue_reference`, bit for bit, and
    `compare_rescue` accepts it and refuses a wrong merge."""
    seed, origin = ((0, (0.9, 0.5, 0.05)) if mode == assoc.PLANE
                    else (5, (0.3, -0.4, 0.0)))
    cells, cells_l, pw, mask = _queries(seed, origin)
    M = pw.shape[0]
    # one lane, with its lane axis
    vm = voxelmap.VoxelMap(torch.from_numpy(cells)[None])
    vml = voxelmap.VoxelMap(torch.from_numpy(cells_l)[None])
    sr = CFG.solver.plane_scatter_ratio if mode == assoc.PLANE else 0.0
    args = (vm, vml, torch.from_numpy(pw)[None], torch.from_numpy(mask)[None],
            CFG.map, CFG.local_map, K, mode, torch.tensor([1.0]), sr)
    # a cap that binds (half the failures), or every failure tried
    n_fail = int(assoc.run_rescue(*args, M)["need"].sum())
    cap = n_fail // 2 if rescue_frac < 1.0 else M
    r, _ = assoc.associate_with_rescue_reference(*args, cap)
    got = assoc.run_rescue(*args, cap)
    for name in assoc.Assoc._fields:
        torch.testing.assert_close(got[name], getattr(r, name), rtol=0,
                                   atol=0, equal_nan=True, msg=name)
    assert n_fail > 20 and int(got["need"].sum()) == n_fail
    assert 0 < int(got["served"].sum()) < min(cap, n_fail)
    refs = assoc.rescue_stage_reference(*args)
    stats = assoc.compare_rescue(got, refs, args[3], mode, cap)
    assert stats["max_abs_err"] == 0.0 and stats["near"] == 0
    with pytest.raises(AssertionError, match="RESCUE"):
        assoc.compare_rescue(dict(got, served=got["need"]), refs, args[3],
                             mode, cap)


def _c_div(a, b):
    """C's integer `/` (truncates toward zero), as the kernel divides."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _kernel_addresses(q, cfg):
    """csrc/assoc.cu's stencil addressing of one query, line for line:
    voxel_index (floor of the correctly rounded f32 quotient), floor_div
    and floor_mod from C's truncating / and % (shift and mask for a
    power-of-two divisor), stencil_axis, the "ij" slot order and the key
    packing."""
    pow2 = lambda b: b > 0 and not b & (b - 1)

    def floor_div(a, b):
        if pow2(b):                  # arithmetic shift (Python's >> too)
            return a >> (b.bit_length() - 1)
        q = _c_div(a, b)
        return q - 1 if a - b * q != 0 and (a < 0) != (b < 0) else q

    def floor_mod(a, b):
        if pow2(b):                  # two's-complement mask (Python's too)
            return a & (b - 1)
        r = a - b * _c_div(a, b)
        return r + b if r != 0 and (r < 0) != (b < 0) else r

    voxel = np.float32(cfg.voxel_size)
    v = [int(np.floor(np.float32(c) / voxel)) for c in q]
    sd = voxelmap._sdims(cfg)
    axes = []
    for c, st, p, d in zip(v, (cfg.stencil_x, cfg.stencil_y, cfg.stencil_z),
                           voxelmap._pack(cfg), sd):
        s0 = floor_div(c - st, p)
        sv = [s0, s0 + 1]
        mt = [floor_mod(x, d) for x in sv]
        kq = [min(max(floor_div(x - m, d) + 16, 0), 31)
              for x, m in zip(sv, mt)]
        axes.append((sv, mt, kq))
    (svx, mx, kx), (svy, my, ky), (svz, mz, kz) = axes
    rows = [(s >> 2, (s >> 1) & 1, s & 1) for s in range(8)]
    sv = [[svx[i], svy[j], svz[k]] for i, j, k in rows]
    slot = [(mx[i] * sd[1] + my[j]) * sd[2] + mz[k] for i, j, k in rows]
    key = [float((kx[i] << 10) | (ky[j] << 5) | kz[k]) for i, j, k in rows]
    return v, sv, slot, key


def test_kernel_integer_addressing_matches_stencil_addresses():
    """The kernel's addressing formulas, written in Python with C's
    truncating division, give `voxelmap.stencil_addresses` exactly at
    voxel and superrow boundaries (and one f32 ulp either side), at
    negative coordinates, across the torus wrap and beyond the key clamp."""
    cfg = CFG.map
    vox = np.float32(cfg.voxel_size)
    period = np.float32(cfg.dim_x) * vox
    base = np.array([0.0, 1.0, 2.0, 3.0, 4.0, 7.0, 8.0, 17.0], np.float32)
    edges = np.concatenate([base * vox, -base * vox,
                            base * vox + period, base * vox - period,
                            base * vox - np.float32(17) * period,
                            base * vox + np.float32(16) * period])
    vals = np.concatenate([edges, np.nextafter(edges, np.float32(np.inf)),
                           np.nextafter(edges, np.float32(-np.inf)),
                           np.float32([-1e-7, 1e-7, -0.2, 0.2, -0.5, 613.0,
                                       -700.0, 700.0])])
    rng = np.random.default_rng(0)
    q = np.stack([vals, rng.permutation(vals), rng.permutation(vals)],
                 axis=1).astype(np.float32)
    addr = voxelmap.stencil_addresses(torch.from_numpy(q), cfg)
    want = [_kernel_addresses(row, cfg) for row in q]
    np.testing.assert_array_equal(_np(addr.v), [w[0] for w in want])
    np.testing.assert_array_equal(_np(addr.sv), [w[1] for w in want])
    np.testing.assert_array_equal(_np(addr.slot), [w[2] for w in want])
    np.testing.assert_array_equal(_np(addr.key), [w[3] for w in want])
    keys = _np(addr.key).astype(np.int64)
    assert ((keys >> 10) == 0).any() and ((keys >> 10) == 31).any()
    assert (q < 0).any() and (_np(addr.v) < 0).any()


@pytest.mark.parametrize("n", [864, 9261])
def test_moment_bound_passes_f32_orders_and_fails_bf16_sums(n):
    """Offsets of up to 2 m, as a window's candidates give them: the plain
    sums (torch.sum) against the same terms summed one after another in
    f32 (another order: within the bound) and in bf16 (outside it)."""
    M = 16
    rng = np.random.default_rng(n)
    o = torch.from_numpy(rng.uniform(-2.0, 2.0, (M, n, 3))
                         .astype(np.float32))
    t1 = o
    t2 = o[:, :, :, None] * o[:, :, None, :]
    ref = dict(t_k=torch.ones(M), n=torch.full((M,), float(n)),
               s1=t1.sum(dim=1), s2=t2.sum(dim=1))
    mask = torch.ones(M, dtype=torch.bool)

    def serial(dtype):
        a1 = torch.zeros((M, 3), dtype=dtype)
        a2 = torch.zeros((M, 3, 3), dtype=dtype)
        for i in range(n):
            a1 = a1 + t1[:, i].to(dtype)
            a2 = a2 + t2[:, i].to(dtype)
        return dict(ref, s1=a1.float(), s2=a2.float())

    stats = assoc.compare(assoc.MOMENTS, serial(torch.float32), ref, mask,
                          assoc.PLANE)
    assert 0.0 < stats["max_abs_err"]
    with pytest.raises(AssertionError, match="MOMENTS: s1 differs"):
        assoc.compare(assoc.MOMENTS, serial(torch.bfloat16), ref, mask,
                      assoc.PLANE)
    # the bf16 rounding of the f32 sums alone already leaves the bound
    # (at 9,261 terms s2's does; s1's stays within it)
    with pytest.raises(AssertionError, match="MOMENTS: s[12] differs"):
        assoc.compare(assoc.MOMENTS, dict(
            ref, s1=ref["s1"].bfloat16().float(),
            s2=ref["s2"].bfloat16().float()), ref, mask, assoc.PLANE)
