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
(2,2,2), (1,1,1) and (2,4,1) under stencils (2,2,1) and (1,1,1), and
`dedup_gather` with a capacity that holds every row and one that
overflows, the rescue pair included; a window beyond K2's instances
raises NotImplementedError and launches nothing.  A split replay over the
card and the CPU runs two workers at once, each shard equal to its unsplit
replay, and the kernel counters hold the card's shard alone.
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
    near them, 5 % masked."""
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
    return (voxelmap.VoxelMap(cells[0]),
            torch.from_numpy(q.astype(np.float32)).to(dev),
            torch.from_numpy(mask).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("mode", [assoc.PLANE, assoc.LINE])
def test_assoc_stages_match_plain_version_on_card(mode, bf16):
    dev = _device()
    vm, pw, mask = _scene(dev)
    mcfg = dataclasses.replace(MCFG, dense_bf16=bf16)
    thres = torch.tensor(1.0, device=dev)
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
    args = (vm, pw, mask, MCFG, 5, assoc.PLANE, 1.0, 0.01)
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
    cells = torch.zeros(tuple(voxelmap.empty_map(MCFG).cells.shape),
                        device=dev)
    pw = torch.zeros((8, 3), device=dev)
    mask = torch.ones((8,), dtype=torch.bool, device=dev)
    launches = assoc.LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc"):
        assoc.associate(voxelmap.VoxelMap(cells), pw, mask, MCFG, 5,
                        assoc.LINE, 1.0)
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
    q = torch.from_numpy(_boundary_queries(MCFG)).to(dev)
    mask = torch.ones(q.shape[0], dtype=torch.bool, device=dev)
    args = (vm, q, mask, MCFG, 5, assoc.PLANE, 1.0)
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
    cells[::3] = 0.0
    vm = voxelmap.VoxelMap(cells)
    lcfg = dataclasses.replace(MCFG, voxel_size=0.2)
    vml, _, _ = _scene(dev, mcfg=lcfg)
    thres = torch.tensor(1.0, device=dev)
    args = (vm, vml, pw, mask, MCFG, lcfg, 5, mode, thres, 0.01)
    n_fail = int(assoc.run_rescue(*args, pw.shape[0])["need"].sum())
    assert n_fail > 10
    cap = pw.shape[0] if full else n_fail // 2
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
    x6 = torch.zeros(6, device=dev)
    eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    thres = torch.tensor(1.0, device=dev)
    counts = lambda: (assoc.LAUNCHES, assoc.RESCUE_LAUNCHES, assoc.CALLS,
                      assoc.LOCAL_CALLS)
    c0 = counts()
    pt, omega, valid, _ = factors.associate_planes(
        x6, pw, mask, vm, eye, zero, cfg, thres, torch.zeros((), device=dev),
        vm_local=None, with_blocks=True)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(c0, counts())) == (1, 0, 1, 0)
    # the same launch through the dispatcher, held against the plain cut
    sr = cfg.solver.plane_scatter_ratio
    r, _ = assoc.associate_with_rescue(vm, None, pw, mask, MCFG, None,
                                       MCFG.knn, assoc.PLANE, thres, sr,
                                       pw.shape[0])
    ref = assoc.stage_reference(assoc.OUT, vm, pw, mask, MCFG, MCFG.knn,
                                assoc.PLANE, thres, sr)
    torch.cuda.synchronize()
    assoc.compare(assoc.OUT, r._asdict(), ref, mask, assoc.PLANE)
    assert torch.equal(r.valid, valid) and torch.equal(r.vec, omega)
    assert int(valid.sum()) > 50
    # zero tangent weight: only the normal row of the sqrt-information
    assert float(pt.sqrt_info[:, 1:].abs().max()) == 0.0


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

PACKS = ((2, 2, 2), (1, 1, 1), (2, 4, 1))
STENCILS = ((2, 2, 1), (1, 1, 1))


def _geom(pack, stencil=(2, 2, 1), mcfg=MCFG, **kw):
    return dataclasses.replace(
        mcfg, pack_x=pack[0], pack_y=pack[1], pack_z=pack[2],
        stencil_x=stencil[0], stencil_y=stencil[1], stencil_z=stencil[2],
        **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("pack", PACKS)
def test_kernel_at_each_pack_on_card(pack):
    """K1 on rows of 4 cpr floats against the plain version: two inserts
    that accumulate and one a torus period away."""
    dev = _device()
    mcfg = _geom(pack)
    shape = (3,) + tuple(voxelmap.empty_map(mcfg).cells.shape)
    assert shape[-1] == 4 * int(np.prod(pack))
    ck = torch.zeros(shape, device=dev)
    cp = torch.zeros(shape, device=dev)
    before = map_insert.LAUNCHES
    loads = []
    for pts, mask in _steps(3, 1000, seed=11):
        p = torch.from_numpy(pts).to(dev)
        m = torch.from_numpy(mask).to(dev)
        map_insert.insert_batched(ck, p, m, mcfg)
        map_insert.insert_batched_reference(cp, p, m, mcfg)
        loads.append(map_insert.cell_load(p, m, mcfg))
    torch.cuda.synchronize()
    assert map_insert.LAUNCHES == before + 3
    _assert_maps(ck, cp, loads)


def _check_k2(vm, pw, mask, mcfg, mode):
    """Every stage fresh and cached against the plain cuts; returns the
    rows the GATHER stage dropped."""
    thres = torch.tensor(1.0, device=pw.device)
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
        pw = torch.cat([pw[:256], torch.from_numpy(far.astype(np.float32))
                        .to(dev)])
    dropped = _check_k2(vm, pw, mask, mcfg, assoc.PLANE)
    assert (dropped > 0) == (capacity == 1), dropped


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
    cells[::3] = 0.0
    vm = voxelmap.VoxelMap(cells)
    lcfg = _geom((1, 1, 1), voxel_size=0.2, dedup_gather=True,
                 dedup_capacity=8)
    vml, _, _ = _scene(dev, mcfg=lcfg)
    thres = torch.tensor(1.0, device=dev)
    args = (vm, vml, pw, mask, mcfg, lcfg, 5, assoc.PLANE, thres, 0.01)
    n_fail = int(assoc.run_rescue(*args, pw.shape[0])["need"].sum())
    cap = pw.shape[0] if full else n_fail // 2
    got = assoc.run_rescue(*args, cap)
    refs = assoc.rescue_stage_reference(*args, None, cap, got["need"])
    torch.cuda.synchronize()
    st = assoc.compare_rescue(got, refs, mask, assoc.PLANE, cap)
    assert st["served"] > 0


@pytest.mark.cuda
def test_assoc_geometry_beyond_instances_raises_on_card():
    dev = _device()
    mcfg = _geom((4, 4, 2), (3, 3, 2), dim_z=8)
    assert not assoc.kernel_supports(mcfg)
    cells = torch.zeros(tuple(voxelmap.empty_map(mcfg).cells.shape),
                        device=dev)
    pw = torch.zeros((8, 3), device=dev)
    mask = torch.ones((8,), dtype=torch.bool, device=dev)
    launches = assoc.LAUNCHES
    with pytest.raises(NotImplementedError, match="512 candidates"):
        assoc.associate(voxelmap.VoxelMap(cells), pw, mask, mcfg, 5,
                        assoc.PLANE, 1.0)
    assert assoc.LAUNCHES == launches


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
