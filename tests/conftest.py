"""Test harness config.

Tests run on a virtual 8-device CPU mesh so that multi-chip sharding paths
(`jax.sharding.Mesh` + `shard_map`) are exercised without TPU hardware, per
SURVEY.md §4.  Must run before any `import jax`.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
# XLA:CPU's parallel LLVM codegen intermittently segfaults this container's
# toolchain on large programs (observed ~40 tests into a full-suite run);
# serialize it — compile time barely changes, crashes stop.
if "xla_cpu_parallel_codegen_split_count" not in flags:
    flags = (flags + " --xla_cpu_parallel_codegen_split_count=1").strip()
os.environ["XLA_FLAGS"] = flags

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# The env var alone is not enough on machines where an experimental TPU
# plugin registers itself; the config update reliably pins the CPU backend.
jax.config.update("jax_platforms", "cpu")

# x64 for math-substrate tests against scipy ground truth; engine code paths
# construct f32 arrays explicitly so f32 behavior is still exercised.
jax.config.update("jax_enable_x64", True)



import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """XLA:CPU in this container segfaults inside backend_compile after ~40
    accumulated program compilations in one process (reproducible at the
    same point across runs, flags made no difference).  Dropping the live
    executables between test modules keeps the compiler below the cliff."""
    yield
    import jax

    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: tests over ~60 s each (flagship configs, "
        "end-to-end replays); full suite ~65 min, -m 'not slow' ~10 min")
    config.addinivalue_line(
        "markers", "smoke: <2 min tier, one fast test per layer "
        "(pytest -m smoke)")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the port's hand-written "
        "kernels); skips without one")
