"""ctypes binding to the native C++ kernels (native/chambolle.cc).

Builds libsemiblind_native.so on first use if a toolchain is present
(the library is not tracked by git);
`available()` gates every test/caller so environments without g++ fall back
to the pure-JAX paths.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libsemiblind_native.so")

__all__ = ["available", "chambolle_prox_native", "tv_norm_native"]


def _load() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is not None:
        return _LIB
    if not os.path.exists(_LIB_PATH):
        # build under a private name, then rename: concurrent importers
        # (test workers) never load a half-written library
        tmp = f"{os.path.basename(_LIB_PATH)}.tmp.{os.getpid()}"
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, f"LIB={tmp}"],
                check=True,
                capture_output=True,
                timeout=120,
            )
            os.replace(os.path.join(_NATIVE_DIR, tmp), _LIB_PATH)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.tv_norm_f64.restype = ctypes.c_double
    lib.tv_norm_f64.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
    ]
    lib.chambolle_prox_f64.restype = ctypes.c_int64
    lib.chambolle_prox_f64.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_double, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
    ]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def tv_norm_native(x: np.ndarray) -> float:
    lib = _load()
    assert lib is not None, "native library unavailable"
    x = np.ascontiguousarray(x, np.float64)
    return lib.tv_norm_f64(_ptr(x), x.shape[0], x.shape[1])


def chambolle_prox_native(
    g: np.ndarray,
    lam: float,
    max_iter: int,
    tau: float = 0.249,
    tol: float = 1e-3,
    duals: Optional[Tuple[np.ndarray, np.ndarray]] = None,
):
    """Native Chambolle prox; returns (f, px, py, iters, err)."""
    lib = _load()
    assert lib is not None, "native library unavailable"
    g = np.ascontiguousarray(g, np.float64)
    m, n = g.shape
    if duals is None:
        px = np.zeros((m, n))
        py = np.zeros((m, n))
    else:
        px = np.ascontiguousarray(duals[0], np.float64).copy()
        py = np.ascontiguousarray(duals[1], np.float64).copy()
    f = np.empty((m, n))
    err = ctypes.c_double(0.0)
    iters = lib.chambolle_prox_f64(
        _ptr(g), lam, max_iter, tau, tol, _ptr(px), _ptr(py), _ptr(f),
        m, n, ctypes.byref(err),
    )
    return f, px, py, int(iters), float(err.value)
