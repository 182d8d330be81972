"""The benchmark's plain reference: a frozen copy of the port's eager
replay (`mmloam_tpu_torch` as of its first benchmark), with the plain
versions of its three kernels in their place (map insert: the segment
sums and row update of `ops/map_insert.py`; association: the dense
candidate blocks of `ops/assoc.py`; the marginalization's eigen-solver:
`torch.linalg.eigh` in float64).  It imports nothing of the port, of the
JAX package or of JAX, and runs op by op: the lockstep step for a batch
(`pipeline.step_core_batch`), the one-lane step for one sequence
(`pipeline.step_core_one`).  `harness/compare.py` drives it.
"""
