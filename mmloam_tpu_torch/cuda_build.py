"""Build-at-first-use for the port's hand-written CUDA kernels.

Each kernel is a `csrc/*.cu` file with a plain C entry point, compiled by
`nvcc` for `sm_90a` into a shared library under `mmloam_tpu_torch/_build/`
and loaded with `ctypes`.  The library name carries a hash of the source
and the flags, so an edited source rebuilds and a stale library is never
loaded.  Nothing here runs at import time: `ctypes` is imported and `nvcc`
looked up only when a CUDA tensor first needs a kernel.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LOADED = {}


def find_nvcc():
    """Path of nvcc: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    path = shutil.which("nvcc")
    if path:
        return path
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def library_path(source: str) -> str:
    """Build-output path for `csrc/<source>`, keyed by content and flags."""
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def build(source: str) -> str:
    """Compile `csrc/<source>` unless its hashed library exists; returns
    the library path.  Raises with nvcc's output when the build fails."""
    out = library_path(source)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)      # atomic: concurrent builders never see halves
    return out


def load(source: str):
    """ctypes handle of the built `csrc/<source>` (built on first use)."""
    if source not in _LOADED:
        import ctypes

        _LOADED[source] = ctypes.CDLL(build(source))
    return _LOADED[source]
