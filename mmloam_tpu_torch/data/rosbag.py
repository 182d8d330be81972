"""ctypes interface to the native rosbag decoder (port of
mmloam_tpu/data/rosbag.py).

The decoder is `native/src/rosbag_decode.cpp`, built for the port at first
use by the host C++ compiler (`cuda_build.build_host`: the flags of
`native/CMakeLists.txt`, output `mmloam_tpu_torch/_build/
librosbag_decode_<hash>.so`).  The CMake build is not used: it writes its
library into the JAX package.  The library depends only on libc and
`dlopen` (lz4 and bz2 are opened at run time), so it builds wherever a C++
compiler is.  `BagReader` returns numpy arrays; `decode` turns them into
the port's tensors.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "src", "rosbag_decode.cpp")

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .. import cuda_build

        lib = ctypes.CDLL(cuda_build.build_host(SOURCE))
        lib.mm_bag_open.restype = ctypes.c_void_p
        lib.mm_bag_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                    ctypes.c_int]
        lib.mm_bag_close.argtypes = [ctypes.c_void_p]
        lib.mm_bag_topic_count.argtypes = [ctypes.c_void_p]
        lib.mm_bag_topic_info.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_long)]
        lib.mm_bag_message_count.restype = ctypes.c_long
        lib.mm_bag_message_count.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.mm_bag_message_stamp.restype = ctypes.c_double
        lib.mm_bag_message_stamp.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                             ctypes.c_long]
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
        lib.mm_bag_read_imu.restype = ctypes.c_long
        lib.mm_bag_read_imu.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        f64p, f64p, f64p, ctypes.c_long]
        lib.mm_bag_pc2_points.restype = ctypes.c_long
        lib.mm_bag_pc2_points.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_double), f32p, f32p, i32p, f32p,
            ctypes.c_long]
        lib.mm_bag_livox_points.restype = ctypes.c_long
        lib.mm_bag_livox_points.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_double), f32p, f32p, i32p, f32p,
            ctypes.c_long]
        _LIB = lib
    return _LIB


class BagReader:
    """Decoded view of one rosbag file."""

    def __init__(self, path: str):
        lib = _lib()
        err = ctypes.create_string_buffer(256)
        self._h = lib.mm_bag_open(str(path).encode(), err, 256)
        if not self._h:
            raise IOError(f"bag open failed: {err.value.decode()}")
        self._lib = lib

    def close(self):
        if self._h:
            self._lib.mm_bag_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def topics(self):
        out = {}
        n = self._lib.mm_bag_topic_count(self._h)
        for i in range(n):
            name = ctypes.create_string_buffer(256)
            typ = ctypes.create_string_buffer(256)
            cnt = ctypes.c_long()
            if self._lib.mm_bag_topic_info(self._h, i, name, 256, typ, 256,
                                           ctypes.byref(cnt)) == 0:
                out[name.value.decode()] = (typ.value.decode(), cnt.value)
        return out

    def message_count(self, topic: str) -> int:
        return self._lib.mm_bag_message_count(self._h, topic.encode())

    def message_stamp(self, topic: str, idx: int) -> float:
        return self._lib.mm_bag_message_stamp(self._h, topic.encode(), idx)

    def read_imu(self, topic: str):
        """-> (t (M,), gyr (M,3), acc (M,3)) float64."""
        cap = self.message_count(topic)
        t = np.zeros(max(cap, 1), np.float64)
        gyr = np.zeros((max(cap, 1), 3), np.float64)
        acc = np.zeros((max(cap, 1), 3), np.float64)
        n = self._lib.mm_bag_read_imu(self._h, topic.encode(), t, gyr, acc,
                                      cap)
        if n < 0:
            raise IOError("imu decode failed")
        return t[:n], gyr[:n], acc[:n]

    def read_pointcloud2(self, topic: str, idx: int):
        """-> dict(stamp, xyz (N,3) f32, intensity, ring i32, time_rel)."""
        stamp = ctypes.c_double()
        empty32 = np.zeros(1, np.float32)
        n = self._lib.mm_bag_pc2_points(
            self._h, topic.encode(), idx, ctypes.byref(stamp),
            np.zeros((1, 3), np.float32), empty32,
            np.zeros(1, np.int32), empty32, 0)
        if n < 0:
            raise IOError("pc2 decode failed")
        xyz = np.zeros((n, 3), np.float32)
        inten = np.zeros(n, np.float32)
        ring = np.zeros(n, np.int32)
        rel = np.zeros(n, np.float32)
        r = self._lib.mm_bag_pc2_points(self._h, topic.encode(), idx,
                                        ctypes.byref(stamp), xyz, inten,
                                        ring, rel, n)
        if r != n:
            raise IOError("pc2 decode failed (size changed)")
        return dict(stamp=stamp.value, xyz=xyz, intensity=inten, ring=ring,
                    time_rel=rel)

    def read_livox(self, topic: str, idx: int):
        """-> dict(timebase, xyz (N,3), reflect, line i32, offset_s)."""
        tb = ctypes.c_double()
        empty32 = np.zeros(1, np.float32)
        n = self._lib.mm_bag_livox_points(
            self._h, topic.encode(), idx, ctypes.byref(tb),
            np.zeros((1, 3), np.float32), empty32,
            np.zeros(1, np.int32), empty32, 0)
        if n < 0:
            raise IOError("livox decode failed")
        xyz = np.zeros((n, 3), np.float32)
        refl = np.zeros(n, np.float32)
        line = np.zeros(n, np.int32)
        off = np.zeros(n, np.float32)
        r = self._lib.mm_bag_livox_points(self._h, topic.encode(), idx,
                                          ctypes.byref(tb), xyz, refl, line,
                                          off, n)
        if r != n:
            raise IOError("livox decode failed (size changed)")
        return dict(timebase=tb.value, xyz=xyz, reflect=refl, line=line,
                    offset_s=off)
