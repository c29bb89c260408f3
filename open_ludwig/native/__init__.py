"""ctypes bindings for the native preprocessing kernels, with auto-build.

The library is compiled on first use (g++ -O3 -shared); if no toolchain is
available the callers fall back to the vectorized numpy implementations in
domain/voxelize.py and domain/bouzidi.py.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger("open_ludwig")

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "preprocess.cpp")
_LIB = os.path.join(_DIR, "libpreprocess.so")

_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.isfile(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
        try:
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-o", _LIB, _SRC],
                check=True, capture_output=True, timeout=120,
            )
        except Exception as e:  # no toolchain / build failure -> numpy fallback
            log.info("[native] build failed (%s); using numpy preprocessing", e)
            return None
    try:
        lib = ctypes.CDLL(_LIB)
        lib.voxelize_sat.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.bouzidi_raycast.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
    except OSError as e:
        log.info("[native] load failed (%s); using numpy preprocessing", e)
    return _lib


def available() -> bool:
    return _load() is not None


def voxelize_sat(verts: np.ndarray, dx: float, dims) -> Optional[np.ndarray]:
    """Native SAT shell voxelization; returns None if the library is absent."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(verts, np.float64)
    out = np.zeros(int(np.prod(dims)), np.uint8)
    lib.voxelize_sat(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(len(v)), ctypes.c_double(dx),
        ctypes.c_int64(dims[0]), ctypes.c_int64(dims[1]), ctypes.c_int64(dims[2]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out.reshape(dims).astype(bool)


def bouzidi_raycast(
    verts: np.ndarray, dx: float, dims
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native Bouzidi q computation: returns dense (X, Y, Z, 27) float32 q and
    int32 nearest-triangle maps, or None without the library."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(verts, np.float64)
    n = int(np.prod(dims))
    q = np.zeros(n * 27, np.float32)
    tri = np.full(n * 27, -1, np.int32)
    lib.bouzidi_raycast(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(len(v)), ctypes.c_double(dx),
        ctypes.c_int64(dims[0]), ctypes.c_int64(dims[1]), ctypes.c_int64(dims[2]),
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        tri.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return (
        q.reshape(tuple(dims) + (27,)),
        tri.reshape(tuple(dims) + (27,)),
    )
