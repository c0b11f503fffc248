"""ctypes binding for the native C++ SAH BVH builder (native/bvh_builder.cpp).

Builds the shared library (untracked, native/libbvh.so) from native/Makefile
on first use if a compiler is available; otherwise callers fall back to the
numpy builder in ops/bvh.py.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libbvh.so"
_lib = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        # build under a private name and rename into place, so processes
        # building at once never load a half-written library
        tmp = _NATIVE_DIR / f".libbvh.{os.getpid()}.so"
        try:
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR), f"OUT={tmp.name}"],
                check=True, capture_output=True,
            )
            os.replace(tmp, _LIB_PATH)
        except (OSError, subprocess.CalledProcessError):
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    lib.bvh_sah_build_flat.restype = ctypes.c_int
    lib.bvh_sah_build_flat.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def sah_build_flat(bmin: np.ndarray, bmax: np.ndarray):
    """→ dict(bmin, bmax, hit, miss, first, count, order) flat arrays, or
    None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(bmin)
    cap = max(4 * n, 8)
    bmin = np.ascontiguousarray(bmin, np.float32)
    bmax = np.ascontiguousarray(bmax, np.float32)
    out_bmin = np.empty((cap, 3), np.float32)
    out_bmax = np.empty((cap, 3), np.float32)
    out_hit = np.empty((cap,), np.int32)
    out_miss = np.empty((cap,), np.int32)
    out_first = np.empty((cap,), np.int32)
    out_count = np.empty((cap,), np.int32)
    out_order = np.empty((max(n, 1),), np.int32)

    def fp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    m = lib.bvh_sah_build_flat(
        fp(bmin), fp(bmax), n, fp(out_bmin), fp(out_bmax), ip(out_hit),
        ip(out_miss), ip(out_first), ip(out_count), ip(out_order), cap,
    )
    if m < 0:
        return None
    return dict(
        bmin=out_bmin[:m].copy(), bmax=out_bmax[:m].copy(), hit=out_hit[:m].copy(),
        miss=out_miss[:m].copy(), first=out_first[:m].copy(),
        count=out_count[:m].copy(), order=out_order[:n].copy(),
    )
