"""The port's CUDA kernels on the card (marked `cuda`; skip without one).

This file imports torch only, so it also runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

K1 (csrc/map_insert.cu) is held against its plain PyTorch version on CUDA
tensors: the kernel is built with -fmad=false, so the maps are bit-equal.
A CUDA tensor whose kernel library cannot be built raises; nothing falls
back to the plain version.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from mmloam_tpu_torch import cuda_build  # noqa: E402
from mmloam_tpu_torch.config import MapConfig  # noqa: E402
from mmloam_tpu_torch.ops import map_insert  # noqa: E402
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


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(1, 128), (3, 1000)])
def test_kernel_matches_plain_version_on_card(B, N):
    dev = _device()
    shape = (B,) + tuple(voxelmap.empty_map(MCFG).cells.shape)
    ck = torch.zeros(shape, device=dev)
    cp = torch.zeros(shape, device=dev)
    before = map_insert.LAUNCHES
    for pts, mask in _steps(B, N, seed=B):
        p = torch.from_numpy(pts).to(dev)
        m = torch.from_numpy(mask).to(dev)
        assert map_insert.insert_batched(ck, p, m, MCFG) is ck
        map_insert.insert_batched_reference(cp, p, m, MCFG)
    torch.cuda.synchronize()
    assert map_insert.LAUNCHES == before + 3
    assert torch.equal(ck, cp)
    assert bool((ck[..., 96:] > 0).any())


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
    assert torch.equal(ck, cp)
