"""The port's CUDA kernels on the card (marked `cuda`; skip without one).

This file imports torch only, so it also runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

K1 (csrc/map_insert.cu) is held against its plain PyTorch version on CUDA
tensors: meta lanes exactly, sum lanes within `map_insert.sum_tolerance`
(the kernel sums each cell in sorted order, the plain version by an
associative scan).  K2 (csrc/assoc.cu) and each of its stages are held
against the same cut of the plain version (`assoc.compare` states the
bounds) on a small map of noisy planes and lines written by K1; the
addresses it computes are bit-equal to `voxelmap.stencil_addresses` on
voxel and superrow boundaries, at negative coordinates and across the
torus wrap; the fused local-map rescue agrees with both maps' plain
versions (`assoc.compare_rescue`) and is `associate_with_rescue`.  Under
`use_nonfeature` the non-feature association is one K2 launch with no
rescue, and the batched insert writes `vm_non` through K1 (five launches).
The rosbag decoder builds on the card's machine and decodes onto the card.
A CUDA tensor whose kernel library cannot be built raises; nothing falls
back to the plain version.  Every map option of the reference runs through
both kernels: K1 and K2 (every stage, fresh and cached) at superrow packs
(2,2,2), (1,1,1), (2,4,1) and (4,4,4) under stencils (2,2,1) and (1,1,1)
(K1 also at (1,2,2) and (4,2,2)),
windows whose candidates K2 stages in a per-warp buffer (864 candidates at
pack (4,4,2) with stencil (3,3,2); 2,048 in fewer warps a block; 9,261 in
device memory), and `dedup_gather` with a capacity that holds every row
and one that overflows, the rescue pair included; the default window under
dedup launches K2's default instance.  A split replay over the
card and the CPU runs two workers at once, each shard equal to its unsplit
replay, and the kernel counters hold the card's shard alone.  K3
(csrc/eigh.cu) is held against its plain version (`jacobi_reference`,
within n u ||A||; whether it is bit-equal is printed) and torch.linalg.eigh
(within 8 n u ||A||) at n = 2 to 32, at more matrices than the card has
SMs, and on stress matrices (0-9 sweeps); the replay's CUDA graph against the eager loop on
tests/test_torch_batch.py's diverging lanes (discrete outputs equal, poses
within 1e-5, the same launches), and two cached replays in a row with
other states.  The lockstep graph's init gates: on two hall lanes that
init together and on the diverging lanes, the graph agrees with the
eager loop, launches what it launches, and opens the bookkeeping's body
only while a lane is un-inited and the init solve's only on scans where a
lane attempts.  The one-sequence step's CUDA-graph IF nodes: a nested
program of branches against op by op (chip_smoke.py phase 1c), the
one-lane graph bit-equal to the lockstep graph at one lane and counting
the launches the one-lane loop issues, and a capture failure that raises
and caches nothing (in a process of its own).
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from mmloam_tpu_torch import cuda_build  # noqa: E402
from mmloam_tpu_torch.config import MapConfig  # noqa: E402
from mmloam_tpu_torch.ops import assoc, map_insert  # noqa: E402
from mmloam_tpu_torch.ops import voxelmap  # noqa: E402

MCFG = MapConfig(dim_x=16, dim_y=16, dim_z=8, voxel_size=0.4, count_cap=10.0)


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _steps(B, N, seed):
    rng = np.random.default_rng(seed)
    span = 8 * 0.4 * 0.45
    pts = rng.uniform(-span, span, (B, N, 3)).astype(np.float32)
    mask = rng.random((B, N)) > 0.15
    period = (np.array([MCFG.dim_x, MCFG.dim_y, MCFG.dim_z])
              * MCFG.voxel_size).astype(np.float32)
    return [(pts, mask), (pts * np.float32(0.98), mask),
            (pts + period, mask)]


def _assert_maps(ck, cp, loads):
    """Meta lanes exact, sum lanes within the stated bound (rows of any
    width)."""
    s3 = 3 * (ck.shape[-1] // 4)
    assert torch.equal(ck[..., s3:], cp[..., s3:])
    diff = (ck[..., :s3] - cp[..., :s3]).abs()
    assert bool((diff <= map_insert.sum_tolerance(cp[..., :s3], loads))
                .all()), float(diff.max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(1, 128), (3, 1000)])
def test_kernel_matches_plain_version_on_card(B, N):
    dev = _device()
    shape = (B,) + tuple(voxelmap.empty_map(MCFG).cells.shape)
    ck = torch.zeros(shape, device=dev)
    cp = torch.zeros(shape, device=dev)
    before = map_insert.LAUNCHES
    loads = []
    for pts, mask in _steps(B, N, seed=B):
        p = torch.from_numpy(pts).to(dev)
        m = torch.from_numpy(mask).to(dev)
        assert map_insert.insert_batched(ck, p, m, MCFG) is ck
        map_insert.insert_batched_reference(cp, p, m, MCFG)
        loads.append(map_insert.cell_load(p, m, MCFG))
    torch.cuda.synchronize()
    assert map_insert.LAUNCHES == before + 3
    _assert_maps(ck, cp, loads)
    assert bool((ck[..., 96:] > 0).any()) and max(loads) > 1


@pytest.mark.cuda
def test_cuda_tensor_without_kernel_raises(monkeypatch):
    dev = _device()

    def no_build(source):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cuda_build, "_LOADED", {})
    monkeypatch.setattr(cuda_build, "build", no_build)
    pts, mask = _steps(1, 64, seed=0)[0]
    cells = torch.zeros((1,) + tuple(voxelmap.empty_map(MCFG).cells.shape),
                        device=dev)
    with pytest.raises(RuntimeError, match="nvcc"):
        map_insert.insert_batched(cells, torch.from_numpy(pts).to(dev),
                                  torch.from_numpy(mask).to(dev), MCFG)
    assert not bool(cells.any())


@pytest.mark.cuda
def test_kernel_at_flagship_row_count():
    """One launch over the full 131,072-superrow persistent map."""
    dev = _device()
    from mmloam_tpu_torch.config import LIOConfig

    mcfg = dataclasses.replace(LIOConfig().map, count_cap=10.0)
    Cs = voxelmap.empty_map(mcfg).cells.shape[0]
    rng = np.random.default_rng(1)
    pts = torch.from_numpy(rng.uniform(-40, 40, (2, 2048, 3))
                           .astype(np.float32)).to(dev)
    mask = torch.ones((2, 2048), dtype=torch.bool, device=dev)
    ck = torch.zeros((2, Cs, 128), device=dev)
    cp = torch.zeros_like(ck)
    map_insert.insert_batched(ck, pts, mask, mcfg)
    map_insert.insert_batched_reference(cp, pts, mask, mcfg)
    torch.cuda.synchronize()
    _assert_maps(ck, cp, [map_insert.cell_load(pts, mask, mcfg)])


def _scene(dev, n_pts=4000, M=512, seed=3, mcfg=MCFG):
    """A map of two noisy planes and a line (K1 inserts) and M queries
    near them, 5 % masked: one lane, with its lane axis (K2's one input
    form)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-1.2, 1.2, (n_pts, 2))
    noise = rng.normal(0, 0.01, (n_pts, 3))
    floor = np.stack([u[:, 0], u[:, 1], np.full(n_pts, -0.5)], -1)
    wall = np.stack([np.full(n_pts, 1.1), u[:, 0], u[:, 1]], -1)
    line = np.stack([u[:, 0], np.full(n_pts, -0.9), np.full(n_pts, 0.7)], -1)
    pts = np.concatenate([floor, wall, line]) + np.concatenate([noise] * 3)
    cells = torch.zeros((1,) + tuple(voxelmap.empty_map(mcfg).cells.shape),
                        device=dev)
    p = torch.from_numpy(pts.astype(np.float32)).to(dev)[None]
    ones = torch.ones(p.shape[:2], dtype=torch.bool, device=dev)
    map_insert.insert_batched(cells, p, ones, mcfg)
    q = pts[rng.choice(len(pts), M)] + rng.normal(0, 0.05, (M, 3))
    mask = rng.random(M) > 0.05
    return (voxelmap.VoxelMap(cells),
            torch.from_numpy(q.astype(np.float32)).to(dev)[None],
            torch.from_numpy(mask).to(dev)[None])


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("mode", [assoc.PLANE, assoc.LINE])
def test_assoc_stages_match_plain_version_on_card(mode, bf16):
    dev = _device()
    vm, pw, mask = _scene(dev)
    mcfg = dataclasses.replace(MCFG, dense_bf16=bf16)
    thres = torch.tensor([1.0], device=dev)
    args = (vm, pw, mask, mcfg, 5, mode, thres, 0.01)
    _, blocks = assoc.associate_reference(*args)
    moved = pw + 0.02
    for cached, q in ((None, pw), (blocks, moved)):
        cargs = (vm, q) + args[2:]
        for stage in range(len(assoc.STAGE_NAMES)):
            if stage == assoc.GATHER and cached is not None:
                continue
            got = assoc.run_stage(stage, *cargs, cached=cached)
            ref = assoc.stage_reference(stage, *cargs, cached=cached)
            torch.cuda.synchronize()
            assoc.compare(stage, got, ref, mask, mode)
    r, _ = assoc.associate_reference(*args)
    assert int(r.valid.sum()) > 50


@pytest.mark.cuda
def test_assoc_launches_and_blocks_on_card():
    dev = _device()
    vm, pw, mask = _scene(dev)
    args = (vm, pw, mask, MCFG, 5, assoc.PLANE,
            torch.tensor([1.0], device=dev), 0.01)
    l0, c0 = assoc.LAUNCHES, assoc.CALLS
    r, blk = assoc.associate(*args, want_blocks=True)
    r_ref, blk_ref = assoc.associate_reference(*args)
    torch.cuda.synchronize()
    assert (assoc.LAUNCHES, assoc.CALLS) == (l0 + 1, c0 + 1)
    for name in ("dxd", "dyd", "dzd", "d2d"):
        assert torch.equal(getattr(blk, name), getattr(blk_ref, name)), name
    assert torch.equal(r.t_k, r_ref.t_k) and torch.equal(r.n, r_ref.n)
    r2, back = assoc.associate(*args, cached=blk)
    assert back is blk and assoc.LAUNCHES == l0 + 2


@pytest.mark.cuda
def test_assoc_cuda_tensor_without_kernel_raises(monkeypatch):
    dev = _device()

    def no_build(source):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cuda_build, "_LOADED", {})
    monkeypatch.setattr(cuda_build, "build", no_build)
    cells = torch.zeros((1,) + tuple(voxelmap.empty_map(MCFG).cells.shape),
                        device=dev)
    pw = torch.zeros((1, 8, 3), device=dev)
    mask = torch.ones((1, 8), dtype=torch.bool, device=dev)
    launches = assoc.LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc"):
        assoc.associate(voxelmap.VoxelMap(cells), pw, mask, MCFG, 5,
                        assoc.LINE, torch.tensor([1.0], device=dev))
    assert assoc.LAUNCHES == launches


def _boundary_queries(mcfg):
    """Queries on voxel and superrow boundaries and one f32 ulp either
    side, at negative coordinates and a torus period or more away."""
    vox = np.float32(mcfg.voxel_size)
    period = np.float32(mcfg.dim_x) * vox
    base = np.arange(0, 9, dtype=np.float32) * vox
    edges = np.concatenate([base, -base, base + period, base - period,
                            base - np.float32(17) * period])
    vals = np.concatenate([edges, np.nextafter(edges, np.float32(np.inf)),
                           np.nextafter(edges, np.float32(-np.inf))])
    rng = np.random.default_rng(5)
    return np.stack([vals, rng.permutation(vals), rng.permutation(vals)],
                    axis=1).astype(np.float32)


@pytest.mark.cuda
def test_assoc_addresses_bit_equal_on_card():
    """The addresses K2 computes (its GATHER stage) are
    `voxelmap.stencil_addresses`' bit for bit, and so are the rows."""
    dev = _device()
    vm, _, _ = _scene(dev)
    q = torch.from_numpy(_boundary_queries(MCFG)).to(dev)[None]
    mask = torch.ones(q.shape[:2], dtype=torch.bool, device=dev)
    args = (vm, q, mask, MCFG, 5, assoc.PLANE,
            torch.tensor([1.0], device=dev))
    got = assoc.run_stage(assoc.GATHER, *args)
    ref = assoc.stage_reference(assoc.GATHER, *args)
    torch.cuda.synchronize()
    assoc.compare(assoc.GATHER, got, ref, mask, assoc.PLANE)
    assert bool((got["v"] < 0).any())
    keys = got["key"].to(torch.int64)
    assert bool(((keys >> 10) != 16).any())


@pytest.mark.cuda
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("mode", [assoc.PLANE, assoc.LINE])
def test_fused_rescue_matches_plain_version_on_card(mode, full):
    """The NEED + RESCUE pair against both maps' plain versions, with a
    cap that binds and with every failure tried, fresh and cached; and
    `associate_with_rescue` returns the pair's merged records."""
    dev = _device()
    vm, pw, mask = _scene(dev)
    # the persistent map loses every third superrow, so many queries fail
    # there; the local map holds the same scene on a finer grid
    cells = vm.cells.clone()
    cells[:, ::3] = 0.0
    vm = voxelmap.VoxelMap(cells)
    lcfg = dataclasses.replace(MCFG, voxel_size=0.2)
    vml, _, _ = _scene(dev, mcfg=lcfg)
    thres = torch.tensor([1.0], device=dev)
    args = (vm, vml, pw, mask, MCFG, lcfg, 5, mode, thres, 0.01)
    n_fail = int(assoc.run_rescue(*args, pw.shape[1])["need"].sum())
    assert n_fail > 10
    cap = pw.shape[1] if full else n_fail // 2
    _, blocks = assoc.associate_reference(vm, pw, mask, MCFG, 5, mode, thres,
                                          0.01)
    for cached, q in ((None, pw), (blocks, pw + 0.02)):
        qargs = (vm, vml, q) + args[3:]
        got = assoc.run_rescue(*qargs, cap, cached)
        refs = assoc.rescue_stage_reference(*qargs, cached)
        torch.cuda.synchronize()
        st = assoc.compare_rescue(got, refs, mask, mode, cap)
        assert st["served"] > 0
        l0, r0, c0 = assoc.LAUNCHES, assoc.RESCUE_LAUNCHES, assoc.CALLS
        r, _ = assoc.associate_with_rescue(*qargs, cap, cached)
        assert (assoc.LAUNCHES, assoc.RESCUE_LAUNCHES, assoc.CALLS) == (
            l0 + 2, r0 + 1, c0 + 1)
        for name in assoc.Assoc._fields:
            assert torch.equal(getattr(r, name), got[name]), name


@pytest.mark.cuda
def test_nonfeature_association_launches_no_rescue_on_card():
    """The non-feature association (a plane fit against vm_non alone, zero
    tangent weight) is one K2 launch with no rescue, and agrees with the
    plain version (`assoc.compare`'s bounds)."""
    dev = _device()
    from mmloam_tpu_torch.config import LIOConfig
    from mmloam_tpu_torch.estimator import factors

    vm, pw, mask = _scene(dev)
    cfg = LIOConfig().replace(map=MCFG)
    x6 = torch.zeros((1, 6), device=dev)
    eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    thres = torch.tensor([1.0], device=dev)
    counts = lambda: (assoc.LAUNCHES, assoc.RESCUE_LAUNCHES, assoc.CALLS,
                      assoc.LOCAL_CALLS)
    c0 = counts()
    pt, omega, valid, _ = factors.associate_planes(
        x6, pw, mask, vm, eye, zero, cfg, thres, torch.zeros(1, device=dev),
        vm_local=None, with_blocks=True)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(c0, counts())) == (1, 0, 1, 0)
    # the same launch through the dispatcher, held against the plain cut
    sr = cfg.solver.plane_scatter_ratio
    r, _ = assoc.associate_with_rescue(vm, None, pw, mask, MCFG, None,
                                       MCFG.knn, assoc.PLANE, thres, sr,
                                       pw.shape[1])
    ref = assoc.stage_reference(assoc.OUT, vm, pw, mask, MCFG, MCFG.knn,
                                assoc.PLANE, thres, sr)
    torch.cuda.synchronize()
    assoc.compare(assoc.OUT, r._asdict(), ref, mask, assoc.PLANE)
    assert torch.equal(r.valid, valid) and torch.equal(r.vec, omega)
    assert int(valid.sum()) > 50
    # zero tangent weight: only the normal row of the sqrt-information
    assert float(pt.sqrt_info[:, :, 1:].abs().max()) == 0.0


@pytest.mark.cuda
def test_nonfeature_third_insert_on_card():
    """Under use_nonfeature the batched insert writes vm_non through K1:
    three persistent maps and two local ones, five launches, each against
    the plain version (meta exact, sums within the bound)."""
    dev = _device()
    from mmloam_tpu_torch import pipeline, replay
    from mmloam_tpu_torch.config import tiny_config

    cfg = tiny_config().replace(use_nonfeature=True)
    B = 2
    states = replay.stack_states([pipeline.init_state(cfg, device=dev)
                                  for _ in range(B)])
    rng = np.random.default_rng(7)
    sc = cfg.scan
    pts = lambda k: torch.from_numpy(rng.uniform(
        -6, 6, (B, k, 3)).astype(np.float32)).to(dev)
    msk = lambda k: torch.from_numpy(rng.random((B, k)) > 0.1).to(dev)
    ones = torch.ones(B, dtype=torch.bool, device=dev)
    pend = pipeline.PendingInsert(
        corner=pts(sc.max_corner), corner_mask=msk(sc.max_corner),
        surf=pts(sc.max_surf), surf_mask=msk(sc.max_surf),
        Rwl=torch.eye(3, device=dev).expand(B, 3, 3).contiguous(),
        p=torch.zeros((B, 3), device=dev), do_map=ones, do_map_local=ones,
        non=pts(sc.max_nonfeature), non_mask=msk(sc.max_nonfeature))
    plain = {f: getattr(states, f).cells.clone() for f in pipeline.MAP_FIELDS}
    before = map_insert.LAUNCHES
    pipeline.apply_inserts_batched(states, pend, cfg)
    torch.cuda.synchronize()
    assert map_insert.LAUNCHES == before + 5
    for field, pts_f, mcfg, gate_f in pipeline._insert_targets(cfg):
        wpts = getattr(pend, pts_f)
        ok = getattr(pend, pts_f + "_mask") & voxelmap.insert_guard(
            wpts, pend.p, mcfg)
        map_insert.insert_batched_reference(plain[field], wpts, ok, mcfg)
        _assert_maps(getattr(states, field).cells, plain[field],
                     [map_insert.cell_load(wpts, ok, mcfg)])
    assert bool((states.vm_non.cells[..., 96:] > 0).any())


@pytest.mark.cuda
def test_native_reader_and_decode_onto_card(tmp_path):
    """The rosbag decoder builds on the card's machine from
    native/src/rosbag_decode.cpp, and a synthetic bag decodes onto the
    card equal to the direct sequence (points exactly)."""
    dev = _device()
    from mmloam_tpu_torch import replay
    from mmloam_tpu_torch.config import tiny_config
    from mmloam_tpu_torch.data import decode, rosbag, synthetic, synthetic_bag

    cfg = tiny_config()
    scans, _, _ = replay.make_sequence(
        synthetic.default_world(), synthetic.Trajectory(speed=0.8), 0.0, 3,
        cfg, n_az=360, with_hori=True, hori_n_az=240, dtype=np.float32)
    path = tmp_path / "seq.bag"
    synthetic_bag.sequence_to_bag(scans, path, hori_offset=0.05)
    bag = rosbag.BagReader(path)
    assert bag.topics()["/velodyne_points"] == ("sensor_msgs/PointCloud2", 3)
    dec = decode.sequence_from_bag(bag, cfg, n_lines=16, max_pts=360,
                                   hori_topic="/livox/lidar",
                                   time_offset=0.05, device=dev)
    assert dec.pts.device.type == "cuda"
    assert torch.equal(dec.pts.cpu(), torch.from_numpy(scans.pts))
    assert torch.equal(dec.hori_n_valid.cpu(),
                       torch.from_numpy(scans.hori_n_valid))
    n_az = scans.hori_pts.shape[2]
    assert torch.equal(dec.hori_pts[:, :, :n_az].cpu(),
                       torch.from_numpy(scans.hori_pts))
    bag.close()


# --------------------------------------------------------------------------
# any pack and stencil, and dedup_gather
# --------------------------------------------------------------------------

PACKS = ((2, 2, 2), (1, 1, 1), (2, 4, 1), (4, 4, 4))
# K1 also at 4 and 16 cells a row
K1_PACKS = PACKS + ((1, 2, 2), (4, 2, 2))
STENCILS = ((2, 2, 1), (1, 1, 1))


def _geom(pack, stencil=(2, 2, 1), mcfg=MCFG, **kw):
    return dataclasses.replace(
        mcfg, pack_x=pack[0], pack_y=pack[1], pack_z=pack[2],
        stencil_x=stencil[0], stencil_y=stencil[1], stencil_z=stencil[2],
        **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("pack", K1_PACKS)
@pytest.mark.parametrize("which", ("chosen", "groups", "rows"))
def test_kernel_at_each_pack_on_card(pack, which):
    """K1 on rows of 4 cpr floats against the plain version: two inserts
    that accumulate and one a torus period away, through the instance
    `map_insert.instance` chooses and through each general instance."""
    dev = _device()
    mcfg = _geom(pack)
    shape = (3,) + tuple(voxelmap.empty_map(mcfg).cells.shape)
    assert shape[-1] == 4 * int(np.prod(pack))
    ck = torch.zeros(shape, device=dev)
    cp = torch.zeros(shape, device=dev)
    before = map_insert.LAUNCHES
    inst = map_insert.instance(mcfg) if which == "chosen" else which
    launched = map_insert.INSTANCE_LAUNCHES[inst]
    loads = []
    for pts, mask in _steps(3, 1000, seed=11):
        p = torch.from_numpy(pts).to(dev)
        m = torch.from_numpy(mask).to(dev)
        if which == "chosen":
            map_insert.insert_batched(ck, p, m, mcfg)
        else:
            map_insert.aggregate_rmw(
                ck, map_insert.sort_points(p, m, mcfg), mcfg, inst=inst)
        map_insert.insert_batched_reference(cp, p, m, mcfg)
        loads.append(map_insert.cell_load(p, m, mcfg))
    torch.cuda.synchronize()
    assert map_insert.LAUNCHES == before + 3
    assert map_insert.INSTANCE_LAUNCHES[inst] == launched + 3
    _assert_maps(ck, cp, loads)


def _check_k2(vm, pw, mask, mcfg, mode):
    """Every stage fresh and cached against the plain cuts; returns the
    rows the GATHER stage dropped."""
    thres = torch.tensor([1.0], device=pw.device)
    args = (vm, pw, mask, mcfg, 5, mode, thres, 0.01)
    _, blocks = assoc.associate_reference(*args)
    dropped = 0
    for cached, q in ((None, pw), (blocks, pw + 0.02)):
        cargs = (vm, q) + args[2:]
        for stage in range(len(assoc.STAGE_NAMES)):
            if stage == assoc.GATHER and cached is not None:
                continue
            got = assoc.run_stage(stage, *cargs, cached=cached)
            ref = assoc.stage_reference(stage, *cargs, cached=cached)
            torch.cuda.synchronize()
            st = assoc.compare(stage, got, ref, mask, mode)
            dropped += st.get("dropped", 0)
    # the entry's blocks are the plain version's, bit for bit
    _, blk = assoc.associate(*args, want_blocks=True)
    for name in ("dxd", "dyd", "dzd", "d2d"):
        assert torch.equal(getattr(blk, name), getattr(blocks, name)), name
    return dropped


@pytest.mark.cuda
@pytest.mark.parametrize("stencil", STENCILS)
@pytest.mark.parametrize("pack", PACKS)
def test_assoc_at_each_geometry_on_card(pack, stencil):
    """K2's general instances (candidate c on lane c mod 32) at the map's
    own window, both modes."""
    dev = _device()
    mcfg = _geom(pack, stencil)
    vm, pw, mask = _scene(dev, mcfg=mcfg)
    for mode in (assoc.PLANE, assoc.LINE):
        _check_k2(vm, pw, mask, mcfg, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [1, 4])
@pytest.mark.parametrize("pack", [(4, 4, 2), (2, 2, 2)])
def test_assoc_dedup_on_card(pack, capacity):
    """dedup_gather: capacity 4 holds every unique row, capacity 1 on
    spread queries overflows; the rows kept and dropped, and every stage,
    agree with the plain dedup gather."""
    dev = _device()
    # a map of 2,048 (pack 4,4,2) or 8,192 superrows: more than the 512
    # compact rows of capacity 1
    mcfg = _geom(pack, mcfg=dataclasses.replace(MCFG, dim_x=64, dim_y=64,
                                                dim_z=16),
                 dedup_gather=True, dedup_capacity=capacity)
    vm, pw, mask = _scene(dev, mcfg=mcfg)
    if capacity == 1:   # half the queries spread over the torus
        rng = np.random.default_rng(9)
        far = rng.uniform(-1, 1, (256, 3)) * np.array([12.0, 12.0, 3.0])
        pw = torch.cat([pw[:, :256], torch.from_numpy(far.astype(np.float32))
                        .to(dev)[None]], dim=1)
    dropped = _check_k2(vm, pw, mask, mcfg, assoc.PLANE)
    assert (dropped > 0) == (capacity == 1), dropped
    # the default window keeps its own instance under dedup
    inst = assoc.instance(mcfg)
    assert (inst == "default") == (pack == (4, 4, 2)), inst
    from torch.profiler import ProfilerActivity, profile

    before = dict(assoc.INSTANCE_LAUNCHES)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assoc.associate(vm, pw, mask, mcfg, 5, assoc.PLANE,
                        torch.tensor([1.0], device=dev), 0.01)
        torch.cuda.synchronize()
    assert assoc.INSTANCE_LAUNCHES[inst] == before[inst] + 1
    names = [e.key for e in prof.key_averages() if "assoc_kernel" in e.key]
    if names:       # the profiler on the card may drop our records
        want = ", 8, true>" if inst == "default" else ", 8, false>"
        assert all(want in n for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("full", [False, True])
def test_fused_rescue_with_dedup_on_card(full):
    """The rescue pair with dedup_gather on both maps, the local map at
    pack (1,1,1): its bound comes from the rescue's own query set (the
    NEED launch's first Mr flags and the pads when the cap binds), on the
    device between the two launches.  Capacity 8 on the local map: with
    the cap binding (Mr = 56 of 113 flags on this scene), two thirds of
    its 4,200 window rows overflow and some queries are still served."""
    dev = _device()
    mcfg = _geom((2, 2, 2), dedup_gather=True, dedup_capacity=1)
    vm, pw, mask = _scene(dev, mcfg=mcfg)
    cells = vm.cells.clone()
    cells[:, ::3] = 0.0
    vm = voxelmap.VoxelMap(cells)
    lcfg = _geom((1, 1, 1), voxel_size=0.2, dedup_gather=True,
                 dedup_capacity=8)
    vml, _, _ = _scene(dev, mcfg=lcfg)
    thres = torch.tensor([1.0], device=dev)
    args = (vm, vml, pw, mask, mcfg, lcfg, 5, assoc.PLANE, thres, 0.01)
    n_fail = int(assoc.run_rescue(*args, pw.shape[1])["need"].sum())
    cap = pw.shape[1] if full else n_fail // 2
    got = assoc.run_rescue(*args, cap)
    refs = assoc.rescue_stage_reference(*args, None, cap, got["need"])
    torch.cuda.synchronize()
    st = assoc.compare_rescue(got, refs, mask, assoc.PLANE, cap)
    assert st["served"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("pack,stencil,M,bf16,where", [
    ((4, 4, 2), (3, 3, 2), 512, True, "shared"),
    ((4, 4, 2), (3, 3, 2), 512, False, "shared"),
    ((4, 4, 2), (5, 5, 3), 256, True, "shared"),
    ((1, 1, 1), (10, 10, 10), 64, True, "device")])
def test_assoc_staged_windows_on_card(pack, stencil, M, bf16, where):
    """Windows of more candidates than registers hold run the staged
    instance against the plain version, every stage fresh and cached: 864
    candidates (staged as bf16 with bf16 blocks, else as f32), 2,048 (18
    KB a warp), and 9,261 whose buffers go to device memory."""
    dev = _device()
    mcfg = _geom(pack, stencil, dense_bf16=bf16)
    inst, wpb, words, scratch = assoc.plan(mcfg)
    assert inst == "staged" and scratch == (where == "device")
    vm, pw, mask = _scene(dev, M=M, mcfg=mcfg)
    before = assoc.INSTANCE_LAUNCHES["staged"]
    for mode in (assoc.PLANE, assoc.LINE):
        _check_k2(vm, pw, mask, mcfg, mode)
    assert assoc.INSTANCE_LAUNCHES["staged"] > before


@pytest.mark.cuda
def test_split_over_card_and_cpu_replays_at_once_on_card(monkeypatch):
    """`replay_batch` over the mesh [card, CPU]: two workers replay at
    once (each shard waits at a barrier the other must reach), the card's
    shard through K1 and K2, the CPU's through the plain versions (its
    tensors lie on the CPU).  Each shard equals the unsplit replay of its
    lanes on its own device bit for bit, outputs and final state, and the
    kernel counters hold the card's shard alone: K1 and K2 launched as in
    the unsplit card replay of those lanes."""
    import threading

    from mmloam_tpu_torch import checkpoint, pipeline, replay
    from mmloam_tpu_torch.config import tiny_config
    from mmloam_tpu_torch.data import synthetic
    from mmloam_tpu_torch.tree import tree_map

    dev, cpu = _device(), torch.device("cpu")
    cfg, B, T = tiny_config(), 4, 3
    seqs = [replay.make_sequence(
        synthetic.default_world(),
        synthetic.Trajectory(speed=0.6 + 0.05 * b, yaw_rate=0.15 + 0.03 * b,
                             z_amp=0.1),
        0.0, T, cfg, n_az=360, seed=b, dtype=np.float32)[0]
        for b in range(B)]
    stacked = replay.stack_sequences(seqs)

    def states(n, d):
        return replay.stack_states([pipeline.init_state(cfg, device=d)
                                    for _ in range(n)])

    def lanes(lo, hi, d):
        return pipeline.scan_from_numpy(
            tree_map(lambda a: a[:, lo:hi], stacked), d)

    k1, k2 = map_insert.LAUNCHES, assoc.LAUNCHES
    st_card, ref_card = replay.replay_batch(states(2, dev), lanes(0, 2, dev),
                                            cfg)
    torch.cuda.synchronize()
    k1_ref, k2_ref = map_insert.LAUNCHES - k1, assoc.LAUNCHES - k2
    st_cpu, ref_cpu = replay.replay_batch(states(2, cpu), lanes(2, 4, cpu),
                                          cfg)
    assert k1_ref == 4 * T and k2_ref > 0

    barrier = threading.Barrier(2, timeout=300)
    lockstep = replay._replay_lockstep

    def meet_then_replay(*args):
        barrier.wait()
        return lockstep(*args)

    monkeypatch.setattr(replay, "_replay_lockstep", meet_then_replay)
    k1, k2 = map_insert.LAUNCHES, assoc.LAUNCHES
    shards, outs = replay.replay_batch(states(B, cpu), lanes(0, B, cpu), cfg,
                                       mesh=[dev, cpu])
    torch.cuda.synchronize()
    assert (map_insert.LAUNCHES - k1, assoc.LAUNCHES - k2) == (k1_ref,
                                                                k2_ref)
    assert not barrier.broken
    assert shards[0].x.device.type == "cuda" and shards[1].x.device == cpu
    for name in outs._fields:
        got = getattr(outs, name)
        assert got.device.type == "cuda", name
        for part, want in ((got[:, :2], getattr(ref_card, name)),
                           (got[:, 2:], getattr(ref_cpu, name))):
            torch.testing.assert_close(part, want.to(dev), rtol=0, atol=0,
                                       equal_nan=True, msg=name)
    for got, want in ((shards[0], st_card), (shards[1], st_cpu)):
        la, lb = (checkpoint._leaves_with_keys(t) for t in (got, want))
        for (ka, a), (kb, b) in zip(la, lb):
            assert ka == kb
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                       msg=ka)


# --------------------------------------------------------------------------
# K2 with a lane axis: one launch serves a batch's lanes
# --------------------------------------------------------------------------

LANE_GEOMS = {
    "default": {},
    "dedup default": dict(dedup_gather=True, dedup_capacity=2),
    "regs4": dict(pack=(1, 1, 1)),
    "regs8": dict(pack=(2, 2, 2), stencil=(2, 2, 1)),
    "regs16": dict(pack=(4, 4, 4)),
    "staged": dict(pack=(4, 4, 2), stencil=(3, 3, 2)),
}


def _lane_geom(name):
    kw = dict(LANE_GEOMS[name])
    pack, stencil = kw.pop("pack", None), kw.pop("stencil", (1, 1, 1))
    mcfg = MCFG if pack is None else _geom(pack, stencil)
    return dataclasses.replace(mcfg, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [assoc.PLANE, assoc.LINE])
@pytest.mark.parametrize("geom", list(LANE_GEOMS))
def test_assoc_lane_axis_on_card(geom, mode):
    """Three lanes (their own maps, queries and distance gates) in one K2
    launch a stage, at every instance: each stage, fresh and cached,
    against the plain version with the same lane axis (`assoc.compare`'s
    bounds) and bit for bit against one launch a lane alone; the rescue
    pair likewise (`assoc.compare_rescue`), with its cap binding."""
    dev = _device()
    mcfg = _lane_geom(geom)
    inst = {"dedup default": "default"}.get(geom, geom)
    assert assoc.instance(mcfg) == inst
    B, k = 3, 5
    scenes = [_scene(dev, seed=11 + b, mcfg=mcfg) for b in range(B)]
    locs = [_scene(dev, n_pts=1500, seed=21 + b, mcfg=mcfg)[0]
            for b in range(B)]
    vm = voxelmap.VoxelMap(torch.cat([s[0].cells for s in scenes]))
    vml = voxelmap.VoxelMap(torch.cat([m.cells for m in locs]))
    pw = torch.cat([s[1] for s in scenes])
    mask = torch.cat([s[2] for s in scenes])
    thres = torch.tensor([1.0, 25.0, 0.05], device=dev)
    sr = 0.01 if mode == assoc.PLANE else 0.0
    _, blocks = assoc.associate_reference(vm, pw, mask, mcfg, k, mode, thres,
                                          sr)
    moved = pw + 3e-3
    for stage in range(len(assoc.STAGE_NAMES)):
        for cached, q in ((None, pw), (blocks, moved)):
            if stage == assoc.GATHER and cached is not None:
                continue
            before = assoc.INSTANCE_LAUNCHES[inst]
            got = assoc.run_stage(stage, vm, q, mask, mcfg, k, mode, thres,
                                  sr, cached)
            assert assoc.INSTANCE_LAUNCHES[inst] == before + 1
            ref = assoc.stage_reference(stage, vm, q, mask, mcfg, k, mode,
                                        thres, sr, cached)
            torch.cuda.synchronize()
            assoc.compare(stage, got, ref, mask, mode)
            for b in range(B):
                lane = slice(b, b + 1)
                c1 = None if cached is None else assoc.StackBlocks(
                    *(a[lane] for a in cached))
                one = assoc.run_stage(stage,
                                      voxelmap.VoxelMap(vm.cells[lane]),
                                      q[lane], mask[lane], mcfg, k, mode,
                                      thres[lane], sr, c1)
                for name, v in one.items():
                    assert torch.equal(got[name][lane], v), (
                        assoc.STAGE_NAMES[stage], name, b)
    M = pw.shape[1]
    for cap in (64, M):
        before = assoc.LAUNCHES
        got = assoc.run_rescue(vm, vml, pw, mask, mcfg, mcfg, k, mode, thres,
                               sr, cap)
        assert assoc.LAUNCHES == before + 2
        refs = assoc.rescue_stage_reference(vm, vml, pw, mask, mcfg, mcfg, k,
                                            mode, thres, sr, None, cap,
                                            got["need"])
        torch.cuda.synchronize()
        assoc.compare_rescue(got, refs, mask, mode, cap)
        for b in range(B):
            lane = slice(b, b + 1)
            one = assoc.run_rescue(voxelmap.VoxelMap(vm.cells[lane]),
                                   voxelmap.VoxelMap(vml.cells[lane]),
                                   pw[lane], mask[lane], mcfg, mcfg, k, mode,
                                   thres[lane], sr, cap)
            for name, v in one.items():
                assert torch.equal(got[name][lane], v), ("rescue", cap, name,
                                                         b)
        if cap < M:
            assert bool((got["need"].sum(dim=1) > cap).any()), "cap binds"


# --------------------------------------------------------------------------
# K3 (csrc/eigh.cu) and the lockstep scan as a CUDA graph
# --------------------------------------------------------------------------

def _eigh_inputs(n, B, seed):
    """B symmetric n x n matrices: PSD at condition numbers up to 1e7,
    indefinite ones, and a rank-deficient one."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(B):
        Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        if b % 3 == 0:
            ev = np.logspace(0, 7 * b / max(B - 1, 1), n)
        elif b % 3 == 1:
            ev = rng.normal(size=n)
        else:
            ev = np.concatenate([np.zeros(n // 3), rng.uniform(1, 5,
                                                               n - n // 3)])
        out.append((Q * ev) @ Q.T)
    A = np.stack(out)
    return (0.5 * (A + np.swapaxes(A, -1, -2))).astype(np.float32)


def _eigh_stress(n, B, seed):
    """B symmetric n x n matrices of chip_smoke.eigh_stress's kinds: PSD
    at condition numbers up to 1e7, clustered and repeated spectra,
    rank-deficient ones, indefinite ones over nine decades; lane 1 is
    diagonal (no sweep)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(B):
        Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        kind = b % 5
        if kind == 0:
            ev = np.logspace(0, 7 * b / (B - 1), n)
        elif kind == 1:
            ev = 1.0 + 1e-6 * rng.normal(size=n)
        elif kind == 2:
            ev = np.repeat([1.0, 2.0, 3.0], n // 3 + 1)[:n]
        elif kind == 3:
            ev = np.concatenate([np.zeros(n // 3),
                                 rng.uniform(1, 10, n - n // 3)])
        else:
            ev = rng.normal(size=n) * 10.0 ** rng.uniform(-3, 6)
        out.append(np.diag(ev) if b == 1 else (Q * ev) @ Q.T)
    A = np.stack(out)
    return (0.5 * (A + np.swapaxes(A, -1, -2))).astype(np.float32)


def _eigh_close(w, V, w_ref, V_ref, c):
    """Eigenvalues within c n u ||A|| of the reference's, eigenvectors up
    to sign within that over the gap where the gap is 1e-3 ||A|| or more
    (u = 2^-24)."""
    n = w.shape[-1]
    for b in range(w.shape[0]):
        nrm = max(float(w_ref[b].abs().max()), 1e-30)
        tol = c * n * 2.0 ** -24 * nrm
        assert float((w[b] - w_ref[b]).abs().max()) <= tol, b
        for k in range(n):
            others = torch.cat([w_ref[b, :k], w_ref[b, k + 1:]])
            gap = float((others - w_ref[b, k]).abs().min()) if n > 1 \
                else float("inf")
            if gap < 1e-3 * nrm:
                continue
            v, r = V[b][:, k], V_ref[b][:, k]
            sign = 1.0 if float(v @ r) >= 0.0 else -1.0
            assert float((sign * v - r).abs().max()) <= tol / gap, (b, k)


@pytest.mark.cuda
@pytest.mark.parametrize("n,B,stress", [
    pytest.param(n, B, False, id=f"{n}-{B}") for n, B in (
        (15, 4), (15, 16), (2, 3), (3, 5), (16, 7), (31, 3), (32, 9),
        (15, 200))] + [pytest.param(15, 64, True, id="15-64-stress")])
def test_eigh_kernel_matches_plain_versions_on_card(n, B, stress):
    """K3 against `jacobi_reference` on the card (the same rotations:
    eigenvalues within n u ||A||, vectors up to sign; it prints whether
    they are bit-equal: the two sum off(A) in other orders, so they may
    stop a sweep apart) and against torch.linalg.eigh (an f32 solver: 8 n
    u ||A||); a non-finite lane gives NaN and leaves the others as they
    are alone; one launch, one block a matrix (B=200 is more than the
    card's SMs)."""
    from mmloam_tpu_torch.ops import eigh

    dev = _device()
    make = _eigh_stress if stress else _eigh_inputs
    A = torch.from_numpy(make(n, B, seed=n + B)).to(dev)
    n0 = eigh.LAUNCHES
    w, V = eigh.eigh(A)
    torch.cuda.synchronize()
    assert eigh.LAUNCHES - n0 == 1
    assert w.dtype == V.dtype == torch.float32 and w.is_cuda
    wr, Vr, info = eigh.jacobi_reference(A, info=True)
    sweeps = info["sweeps"]
    print(f"K3 n={n} B={B}: sweeps {int(sweeps.min())}-"
          f"{int(sweeps.max())}, bit-equal to jacobi_reference: "
          f"{torch.equal(w, wr) and torch.equal(V, Vr)}")
    if stress:
        assert int(sweeps.min()) == 0 and int(sweeps.max()) >= 5
    _eigh_close(w, V, wr, Vr, 1.0)
    wl, Vl = torch.linalg.eigh(A)
    _eigh_close(w, V, wl, Vl, 8.0)
    assert bool((w[:, 1:] >= w[:, :-1]).all())
    bad = A.clone()
    bad[B // 2, n - 1, 0] = float("nan")
    wb, Vb = eigh.eigh(bad)
    assert bool(torch.isnan(wb[B // 2]).all() and torch.isnan(Vb[B // 2])
                .all())
    keep = [b for b in range(B) if b != B // 2]
    assert torch.equal(wb[keep], w[keep]) and torch.equal(Vb[keep], V[keep])


def _graph_lanes(dev):
    """tests/test_torch_batch.py's diverging B=3 lanes (tiny_config; one
    initializes late, one starts mid-sequence), on the card."""
    import test_torch_batch as tb

    from mmloam_tpu_torch import replay
    from mmloam_tpu_torch.tree import tree_map

    states, scans = tb._lanes()
    to = lambda t: tree_map(lambda a: a.to(dev), t)
    return tb.CFG, (lambda: to(replay.stack_states(tb._fresh(states)))), \
        to(replay.stack_sequences(scans))


def _counts():
    from mmloam_tpu_torch.ops import eigh

    return (map_insert.LAUNCHES, assoc.LAUNCHES, assoc.CALLS, eigh.LAUNCHES)


def _same_run(got, want, what):
    """Discrete outputs equal, poses within 1e-5 (chip_smoke's
    LANES_POSE_ATOL: cuBLAS may pick other algorithms on the capture
    stream)."""
    for f in ("inited", "fail", "degenerate", "n_corner", "n_surf",
              "n_assoc_line", "n_assoc_plane", "fast_rotation",
              "hori_merged"):
        assert torch.equal(getattr(got, f), getattr(want, f)), (what, f)
    for f in ("pose_p", "pose_q"):
        err = float((getattr(got, f) - getattr(want, f)).abs().max())
        assert err <= 1e-5, (what, f, err)


@pytest.mark.cuda
def test_solve_lu_captures_over_16_matrices_on_card():
    """The gravity refinement's (B, 18, 18) solve at B = 64 captures in a
    CUDA graph (torch alone would take MAGMA there, which waits on the
    host) and its replay equals the solve op by op, bit for bit."""
    from mmloam_tpu_torch.ops import preintegration

    dev = _device()
    g = torch.Generator().manual_seed(5)
    A = torch.randn(64, 18, 18, generator=g).to(dev) + 4 * torch.eye(
        18, device=dev)
    rhs = torch.randn(64, 18, 1, generator=g).to(dev)
    want = preintegration.solve_lu(A, rhs)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(dev)
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        got = preintegration.solve_lu(A, rhs)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_graph_replay_matches_eager_loop_on_card():
    """`replay_batch` on the card captures the lockstep scan and replays
    it; it agrees with the eager loop on the diverging lanes, issues the
    same kernel launches (the counters tick per replay), and leaves the
    caller's states as they were."""
    from mmloam_tpu_torch import replay
    from mmloam_tpu_torch.tree import tree_map

    dev = _device()
    replay.clear_graphs()
    cfg, states, scans = _graph_lanes(dev)
    T = scans.pts.shape[0]
    c0 = _counts()
    _, eager = replay._replay_eager(states(), scans, cfg)
    torch.cuda.synchronize()
    c1 = _counts()
    given = states()
    before = tree_map(torch.clone, given)
    final, graph = replay.replay_batch(given, scans, cfg)
    torch.cuda.synchronize()
    c2 = _counts()
    assert len(replay._GRAPHS) == 1
    _same_run(graph, eager, "graph vs eager")
    assert tuple(b - a for a, b in zip(c0, c1)) == \
        tuple(b - a for a, b in zip(c1, c2))
    assert c2[0] - c1[0] == 4 * T and c2[3] - c1[3] == 2 * T
    for a, b in zip(replay._leaves(given), replay._leaves(before)):
        assert torch.equal(a, b)
    cache = {a.untyped_storage().data_ptr()
             for r in replay._GRAPHS.values() for a in replay._leaves(r.state)}
    assert not any(a.untyped_storage().data_ptr() in cache
                   for a in replay._leaves(final))
    replay.clear_graphs()


@pytest.mark.cuda
def test_cached_graph_replays_other_states_on_card():
    """Two cached replays in a row with other states (the lanes in two
    other orders): each agrees with the eager loop on its own states, and
    the first call's returned state is untouched by the later ones."""
    from mmloam_tpu_torch import replay
    from mmloam_tpu_torch.tree import tree_map

    dev = _device()
    replay.clear_graphs()
    cfg, states, scans = _graph_lanes(dev)
    first, _ = replay.replay_batch(states(), scans, cfg)
    kept = tree_map(torch.clone, first)
    for perm in ([2, 0, 1], [1, 2, 0]):
        sts = tree_map(lambda a: a[perm].contiguous(), states())
        scs = tree_map(lambda a: a[:, perm].contiguous(), scans)
        _, want = replay._replay_eager(tree_map(torch.clone, sts), scs, cfg)
        _, got = replay.replay_batch(sts, scs, cfg)
        torch.cuda.synchronize()
        assert len(replay._GRAPHS) == 1
        _same_run(got, want, f"cached graph vs eager, lanes {perm}")
    for a, b in zip(replay._leaves(first), replay._leaves(kept)):
        assert torch.equal(a, b)
    replay.clear_graphs()


@pytest.mark.cuda
def test_new_key_replaces_the_cached_graph_on_card():
    """A call with other shapes (two lanes of the three) replaces the
    cached graph and frees it: one graph a device.  The new graph agrees
    with the eager loop."""
    import gc
    import weakref

    from mmloam_tpu_torch import replay
    from mmloam_tpu_torch.tree import tree_map

    dev = _device()
    replay.clear_graphs()
    cfg, states, scans = _graph_lanes(dev)
    replay.replay_batch(states(), scans, cfg)
    (first,) = replay._GRAPHS.values()
    gone, first = weakref.ref(first), None
    sts = tree_map(lambda a: a[:2].contiguous(), states())
    scs = tree_map(lambda a: a[:, :2].contiguous(), scans)
    _, want = replay._replay_eager(tree_map(torch.clone, sts), scs, cfg)
    _, got = replay.replay_batch(sts, scs, cfg)
    torch.cuda.synchronize()
    gc.collect()
    assert len(replay._GRAPHS) == 1 and gone() is None
    _same_run(got, want, "the new key's graph vs eager")
    replay.clear_graphs()


@pytest.mark.cuda
def test_if_nodes_nest_capture_and_replay_on_card():
    """chip_smoke.py phase 1c: a program of one-lane branches (two-way
    and identity conds, a loop nested in a cond, a cuBLAS product and a
    sort inside bodies) captured once as nested CUDA-graph IF nodes and
    replayed at every combination of its predicates, bit-equal to the same
    calls op by op, each node's flag its predicate there."""
    import chip_smoke

    res = chip_smoke.check_if_nodes(_device())
    assert res["if_nodes"] == 8 and res["cases"] == 12


def _hall_lanes(dev, T=14):
    """Two hall lanes from fresh states (lane 1's points moved 1 cm), on
    the card: (cfg, fresh states, scans (T, 2, ...))."""
    from mmloam_tpu_torch import replay

    cfg, scans, init = _one_lane_hall(dev, T)
    seqs = [scans, scans._replace(pts=scans.pts + 0.01)]
    return cfg, (lambda: replay.stack_states([init(), init()])), \
        replay.stack_sequences(seqs)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", ["hall", "diverging"])
def test_lockstep_graph_gates_init_on_card(lanes, monkeypatch):
    """`replay_batch` over lanes that cross init: a cached call agrees
    with the eager loop (`_same_run`) and launches K1, K2 and K3 as often;
    its flag history opens the bookkeeping's body ("init") on the scans
    before which some lane is un-inited, and the init solve's
    ("init_solve") only on those where some lane attempts (at scans 8,
    11, ... from a fresh state); `spans.gate_counts()` adds the call's
    replays and the bodies' runs."""
    from mmloam_tpu_torch import pipeline, replay, spans

    dev = _device()
    replay.clear_graphs()
    cfg, states, scans = (_hall_lanes if lanes == "hall"
                          else _graph_lanes)(dev)
    T = scans.pts.shape[0]
    attempts = []
    attempt = pipeline._try_init

    def spied(s, c, a):
        attempts.append(bool(a.any()))
        return attempt(s, c, a)

    with monkeypatch.context() as mp:
        mp.setattr(pipeline, "_try_init", spied)
        c0 = _counts()
        _, eager = replay._replay_eager(states(), scans, cfg)
        torch.cuda.synchronize()
        c1 = _counts()
    assert len(attempts) == T
    replay.replay_batch(states(), scans, cfg)      # scan 0 eager, capture
    (runner,) = replay._GRAPHS.values()
    assert runner.gates == dict(init=0, init_solve=1)
    assert len(runner.bodies) == 4
    g0 = spans.gate_counts()
    c2 = _counts()
    _, graph = replay.replay_batch(states(), scans, cfg)
    torch.cuda.synchronize()
    c3 = _counts()
    g1 = spans.gate_counts()
    _same_run(graph, eager, "gated graph vs eager")
    assert tuple(b - a for a, b in zip(c0, c1)) == \
        tuple(b - a for a, b in zip(c2, c3))
    before = torch.cat([states().inited[None], eager.inited[:-1]]).cpu()
    book = (~before).any(dim=1)
    solve = book & torch.tensor(attempts)
    hist = runner.flag_history.cpu().bool()
    assert torch.equal(hist[:, 0], book)
    assert torch.equal(hist[:, 1], solve)
    assert solve.any()
    assert {k: g1[k] - g0[k] for k in g1} == dict(
        scans=T, init=int(book.sum()), init_solve=int(solve.sum()))
    if lanes == "hall":
        # both lanes inited within the call: the bookkeeping stops
        assert not book[-1]
        assert all((t - 8) % 3 == 0 for t in
                   solve.nonzero().flatten().tolist())
    replay.clear_graphs()


def _one_lane_hall(dev, T=14):
    from mmloam_tpu_torch import pipeline, replay
    from mmloam_tpu_torch.config import tiny_config
    from mmloam_tpu_torch.data import synthetic

    cfg = tiny_config()
    scans = replay.make_sequence(
        synthetic.default_world(), synthetic.Trajectory(speed=0.8, z_amp=0.15),
        0.0, T, cfg, n_az=360, dtype=np.float32, range_noise=0.003, seed=1,
        device=dev)[0]
    return cfg, scans, lambda: pipeline.init_state(cfg, device=dev)


@pytest.mark.cuda
def test_one_lane_graph_is_the_lockstep_graph_on_card():
    """`replay.replay` captures the one-lane step with IF nodes (its own
    cache key beside the lockstep graph's) and replays it: bit-equal to
    `replay_batch` at one lane in every output and the final state, maps
    included; a cached replay counts the launches the one-lane loop op by
    op issues on the same inputs, from the bodies that ran."""
    from mmloam_tpu_torch import pipeline, replay
    from mmloam_tpu_torch.ops import eigh
    from mmloam_tpu_torch.tree import tree_map

    dev = _device()
    replay.clear_graphs()
    cfg, scans, init = _one_lane_hall(dev)
    final, outs = replay.replay(init(), scans, cfg)
    (runner,) = replay._GRAPHS.values()
    assert runner.key[1] is True and len(runner.bodies) > 0
    lane = tree_map(lambda a: a[:, None], scans)
    lfinal, louts = replay.replay_batch(pipeline._lane(init()), lane, cfg)
    (lrunner,) = replay._GRAPHS.values()
    assert lrunner.key[1] is False and len(lrunner.bodies) == 4
    assert lrunner.gates == dict(init=0, init_solve=1)
    for f in outs._fields:
        assert torch.equal(getattr(outs, f), getattr(louts, f)[:, 0]), f
    for a, b in zip(replay._leaves(final),
                    replay._leaves(pipeline._unlane(lfinal))):
        assert torch.equal(a, b)
    replay.clear_graphs()
    replay.replay(init(), scans, cfg)            # capture
    c0 = _counts() + (assoc.RESCUE_LAUNCHES,)
    again, outs2 = replay.replay(init(), scans, cfg)
    torch.cuda.synchronize()
    c1 = _counts() + (assoc.RESCUE_LAUNCHES,)
    replay._replay_eager(pipeline._lane(init()), lane, cfg, one=True)
    torch.cuda.synchronize()
    c2 = _counts() + (assoc.RESCUE_LAUNCHES,)
    d = tuple(b - a for a, b in zip(c0, c1))
    assert d == tuple(b - a for a, b in zip(c1, c2))
    # the cached replay's K2 launches: a call's own and its rescue's
    assert d[1] == d[2] + d[4] and d[4] == d[2] > 0
    T = scans.pts.shape[0]
    assert c1[0] - c0[0] == 4 * T and c1[3] - c0[3] == 2 * (T - 1)
    for f in outs._fields:
        assert torch.equal(getattr(outs, f), getattr(outs2, f)), f
    assert eigh.LAUNCHES > 0
    replay.clear_graphs()


def _capture_failure_then_recovery(monkeypatch, one):
    """An op that reads the device on the host during the capture (in
    the LM: inside an IF node's body on the one-lane path, on the capture
    stream itself on the lockstep path) fails it: the replay raises and
    names the op, and no graph is cached (nothing falls back to another
    path).  The process stays fit for more: the same scans then capture
    and replay, agreeing with the loop op by op, and every graph and
    memory pool is torn down (`replay._end_routing`, `replay._abandon`;
    before them the first teardown after a failed capture aborted or hung
    the process)."""
    import gc

    from mmloam_tpu_torch import pipeline, replay
    from mmloam_tpu_torch.config import tiny_config
    from mmloam_tpu_torch.data import synthetic
    from mmloam_tpu_torch.estimator import solver

    dev = _device()
    cfg = tiny_config()
    scans = replay.make_sequence(
        synthetic.default_world(),
        synthetic.Trajectory(speed=0.8, z_amp=0.15), 0.0, 3, cfg, n_az=360,
        dtype=np.float32, device=dev)[0]
    lane = type(scans)(*(None if a is None else a[:, None] for a in scans))
    init = lambda: pipeline._lane(pipeline.init_state(cfg, device=dev))

    def run():
        if one:
            return replay.replay(pipeline.init_state(cfg, device=dev), scans,
                                 cfg)[1]
        outs = replay.replay_batch(init(), lane, cfg)[1]
        return type(outs)(*(a[:, 0] for a in outs))

    damped = solver._damped_solve

    def reads_the_device(*a, **k):
        dx = damped(*a, **k)
        if torch.cuda.is_current_stream_capturing():
            float(dx.sum())
        return dx

    replay.clear_graphs()
    monkeypatch.setattr(solver, "_damped_solve", reads_the_device)
    with pytest.raises(RuntimeError) as err:
        run()
    what = "one-lane" if one else "lockstep"
    assert f"the {what} scan did not capture at estimator/solver.py" \
        in str(err.value).splitlines()[0], str(err.value)
    assert not replay._GRAPHS
    assert torch.cuda.current_stream(dev) == torch.cuda.default_stream(dev)
    err = None
    gc.collect()                # the failed capture's pools go here
    pool = torch.cuda.MemPool()     # a pool's teardown checks the routing
    del pool
    gc.collect()

    monkeypatch.setattr(solver, "_damped_solve", damped)
    outs = run()
    _, eager = replay._replay_eager(init(), lane, cfg, one=one)
    torch.cuda.synchronize()
    for f in outs._fields:
        tol = 1e-5 if getattr(outs, f).is_floating_point() else 0
        torch.testing.assert_close(getattr(outs, f),
                                   getattr(eager, f)[:, 0], rtol=tol,
                                   atol=tol, msg=f)
    replay.clear_graphs()
    gc.collect()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_one_lane_capture_failure_raises_on_card(monkeypatch):
    _capture_failure_then_recovery(monkeypatch, one=True)


@pytest.mark.cuda
def test_lockstep_capture_failure_raises_on_card(monkeypatch):
    _capture_failure_then_recovery(monkeypatch, one=False)
