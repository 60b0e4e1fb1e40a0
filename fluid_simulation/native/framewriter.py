"""Python binding for the native async frame writer (framewriter.cpp)."""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np

from fluid_simulation.native import load_library


class NativeFrameWriter:
    """Background-thread frame streamer. ``append`` takes one array (or None)
    per file opened, in order; None skips that file for the frame."""

    def __init__(self, paths: Sequence[str], max_queued: int = 8):
        self._lib = load_library()
        self._lib.fstpu_fw_open.restype = ctypes.c_void_p
        self._lib.fstpu_fw_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_long]
        self._lib.fstpu_fw_append.restype = ctypes.c_int
        self._lib.fstpu_fw_append.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_long)]
        self._lib.fstpu_fw_close.restype = None
        self._lib.fstpu_fw_close.argtypes = [ctypes.c_void_p]
        self._n = len(paths)
        arr = (ctypes.c_char_p * self._n)(
            *[p.encode() for p in paths])
        self._h = self._lib.fstpu_fw_open(arr, self._n, max_queued)
        if not self._h:
            raise OSError(f"could not open output files: {list(paths)}")

    def append(self, arrays: List[Optional[np.ndarray]]):
        if len(arrays) != self._n:
            raise ValueError(f"expected {self._n} arrays, got {len(arrays)}")
        bufs = []
        ptrs = (ctypes.c_char_p * self._n)()
        sizes = (ctypes.c_long * self._n)()
        for i, a in enumerate(arrays):
            if a is None:
                ptrs[i], sizes[i] = None, 0
                continue
            b = np.ascontiguousarray(a, dtype=np.float32)
            bufs.append(b)  # keep alive until the C side copies
            ptrs[i] = ctypes.cast(
                b.ctypes.data_as(ctypes.c_void_p), ctypes.c_char_p)
            sizes[i] = b.nbytes
        rc = self._lib.fstpu_fw_append(self._h, ptrs, sizes)
        if rc != 0:
            raise OSError("native frame append failed")

    def close(self):
        if self._h:
            self._lib.fstpu_fw_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
