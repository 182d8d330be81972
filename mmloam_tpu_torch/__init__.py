"""mmloam_tpu_torch — the PyTorch/CUDA port of the mmloam_tpu LIO engine.

The JAX package `mmloam_tpu` is the reference; this package mirrors its
layout and function names module for module (`lie`, `ops/*`,
`estimator/*`, `pipeline`, `replay`) so each function's counterpart is easy
to find, and is held against it on identical inputs by the
`tests/test_torch_*.py` suite.  It imports `torch` and never `jax`.

Containers are NamedTuples with the reference's field names and order;
`tree.tree_map` walks them.  `pipeline.step_core_batch` is the reference's
`vmap` of the step: one step over the lanes of a batch, every per-lane
branch a select, with no host read of the device; `pipeline.step` and
`step_core` are it at one lane.  `replay.replay_batch` runs B sequences in
lockstep: one batched step per scan (the association kernel
`csrc/assoc.cu` launched once for all lanes) and one batched map insert
per map through the hand-written CUDA kernel `csrc/map_insert.cu`
(`ops/map_insert.py`); with `mesh=[device, ...]` it splits the batch over
devices, whole sequences to a device.
"""

__version__ = "0.1.0"

import torch as _torch

# f32 rules pinned by the reference (mmloam_tpu/__init__.py sets
# jax_default_matmul_precision="highest"): the engine's matmuls are tiny
# normal-equation blocks, and TF32's ~3 decimal digits measurably degrade
# trajectory accuracy.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
