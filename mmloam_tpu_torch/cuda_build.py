"""Build-at-first-use for the port's native libraries.

Each kernel is a `csrc/*.cu` file with a plain C entry point, compiled by
`nvcc` for `sm_90a` into a shared library under `mmloam_tpu_torch/_build/`
and loaded with `ctypes`.  The rosbag decoder (`native/src/
rosbag_decode.cpp`, host C++) is built the same way by the host compiler
(`build_host`).  A library's name carries a hash of its source and flags,
so an edited source rebuilds and a stale library is never loaded.  Nothing
here runs at import time: `ctypes` is imported and a compiler looked up
only when a library is first needed.
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
# the flags of native/CMakeLists.txt (whose own build writes into the JAX
# package, so the port never runs it)
HOST_FLAGS = ("-O2", "-Wall", "-std=c++17", "-shared", "-fPIC")
HOST_LIBS = ("-ldl",)

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


def find_cxx():
    """The host C++ compiler: $CXX, else g++ or c++ on PATH."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C++ compiler found (set CXX): the rosbag "
                       "decoder is built from native/src at first use")


def _hashed_path(src_path, flags):
    with open(src_path, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    stem = os.path.splitext(os.path.basename(src_path))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def library_path(source: str) -> str:
    """Build-output path for `csrc/<source>`, keyed by content and flags."""
    return _hashed_path(os.path.join(CSRC, source), NVCC_FLAGS)


def _compile(src_path, out, cmd_head, tail=()):
    """Run `cmd_head -o <tmp> src tail` and move the result to `out`
    unless it exists; raises with the compiler's output on failure."""
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [*cmd_head, "-o", tmp, src_path, *tail]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed "
                           f"({proc.returncode}) on {src_path}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)      # atomic: concurrent builders never see halves
    return out


def build(source: str) -> str:
    """Compile `csrc/<source>` unless its hashed library exists; returns
    the library path.  Raises with nvcc's output when the build fails."""
    return _compile(os.path.join(CSRC, source), library_path(source),
                    [find_nvcc(), *NVCC_FLAGS])


def build_host(src_path: str) -> str:
    """Compile the host C++ file `src_path` into a hashed shared library
    under `_build/` (flags HOST_FLAGS, linked with HOST_LIBS) unless it
    exists; returns the library path."""
    flags = HOST_FLAGS + HOST_LIBS
    return _compile(src_path, _hashed_path(src_path, flags),
                    [find_cxx(), *HOST_FLAGS], HOST_LIBS)


def load(source: str, bind=None):
    """ctypes handle of the built `csrc/<source>` (built on first use).
    `bind(lib)`, when given, runs once as the library loads: it sets the
    entry points' argtypes, so a launch does not set them again."""
    if source not in _LOADED:
        import ctypes

        lib = ctypes.CDLL(build(source))
        if bind is not None:
            bind(lib)
        _LOADED[source] = lib
    return _LOADED[source]
