"""The yardstick of the kernels' rooflines: published peaks of the card
and the work a kernel's call needs, counted from its shapes.

Frozen copies of `chip_smoke.bound_ms` and `chip_smoke.k2_work`'s
formulas.  A K2 call's shapes come from the reference's own association
calls for the same scans (`reference.ops.assoc.RECORD`), so the count
reads the same whatever implements K2.  The superrows a fresh launch
gathers depend on each query's position, which the captured graph
hides; they are left out, and so is the rescue launch, whose queries
are those the first launch failed.  The count is a floor, and the share
never reads above what the kernel achieves.
"""

from __future__ import annotations

import math

# One NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet): the HBM
# rate and the float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# bytes of the association's result per query: mu and vec (6 f32), t_k
# and n (2 f32) and the valid flag
K2_RESULT_BYTES = 33
K2_OPS_PER_CANDIDATE = 30     # offsets, d2, selection compares, moments


def least_s(nbytes, ops):
    """The least time the card could take: the larger of bytes over the
    memory rate and float32 operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS)


def _candidates(mcfg):
    from reference.ops import voxelmap

    return math.prod(voxelmap._super_window(mcfg)) * voxelmap._cpr(mcfg)


def k2_launch(B, M, mcfg, cached, want_blocks):
    """(bytes, ops) of one K2 launch over B lanes of M queries: queries,
    mask and each lane's gate read once, the result written once, the
    cached blocks and their queries read, or the blocks written when
    asked; about 30 float32 operations a candidate."""
    C = _candidates(mcfg)
    blk = 4 * B * M * C * (2 if mcfg.dense_bf16 else 4)
    nbytes = B * M * (12 + 1) + 4 * B + B * M * K2_RESULT_BYTES
    if cached:
        nbytes += B * M * 12 + blk
    elif want_blocks:
        nbytes += blk
    return nbytes, B * M * C * K2_OPS_PER_CANDIDATE


def k2_call_least_s(call):
    """The least time of one association call as the reference noted it:
    (B, M, mcfg, lcfg, rescue_cap, cached, want_blocks), its first launch
    (the rescue's queries are data the graph hides)."""
    B, M, mcfg, _, _, cached, want = call
    return least_s(*k2_launch(B, M, mcfg, cached, want))


def k2_least_s(calls_by_scan, scans):
    """The least time of K2 over the given scan indices."""
    return sum(k2_call_least_s(c) for t in scans for c in calls_by_scan[t])
