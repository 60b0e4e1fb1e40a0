"""Python binding for the native voxelizer (geometry.cpp)."""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from fluid_simulation.native import load_library


def voxelize_ray_parity(tris: np.ndarray, obj_center: np.ndarray,
                        padded_lo: np.ndarray, padded_hi: np.ndarray,
                        scale: float, W: int, H: int, D: int,
                        translate: Tuple[float, float, float],
                        seed: int = 0,
                        fine_divisor: float = 200.0) -> np.ndarray:
    """Bit-identical to scene.voxelize.voxelize_ray_parity, computed by the
    OpenMP engine. Returns the padded (D+2, H+2, W+2) obstacle mask."""
    lib = load_library()
    fn = lib.fstpu_voxelize_ray_parity
    fn.restype = ctypes.c_long
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_double,
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_double), ctypes.c_uint64,
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_float),
    ]

    tris_f = np.ascontiguousarray(tris, dtype=np.float32)
    lo = np.ascontiguousarray(padded_lo, dtype=np.float64)
    hi = np.ascontiguousarray(padded_hi, dtype=np.float64)
    ctr = np.ascontiguousarray(obj_center, dtype=np.float64)
    tr = np.ascontiguousarray(translate, dtype=np.float64)
    out = np.zeros((D + 2, H + 2, W + 2), dtype=np.float32)

    def p(arr, typ):
        return arr.ctypes.data_as(ctypes.POINTER(typ))

    fn(p(tris_f, ctypes.c_float), len(tris_f),
       p(lo, ctypes.c_double), p(hi, ctypes.c_double),
       p(ctr, ctypes.c_double), float(scale),
       W, H, D, p(tr, ctypes.c_double), int(seed) & (2 ** 64 - 1),
       float(fine_divisor), p(out, ctypes.c_float))
    return out
