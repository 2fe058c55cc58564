"""ctypes bindings of the port's native mesh IO and scene preprocessing
(`diffcloth_native.cpp`).

Counterpart of `diffcloth_tpu/native/fastobj.py`, with the same API:
`load_obj` / `save_obj` (as geometry/objio.py's), `extract_bending_pairs`
and `conn_table` (as geometry/builder.py's `extract_bending_pairs` and
`adjacency_exclusion`).  The library is built and loaded at the first
call, not at import.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from diffcloth_tpu_torch import native

_F64P = ctypes.POINTER(ctypes.c_double)
_I32P = ctypes.POINTER(ctypes.c_int32)
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(native.ensure_built())
        lib.dc_load_obj.restype = ctypes.c_int
        lib.dc_load_obj.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(_F64P),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(_I32P),
            ctypes.POINTER(ctypes.c_int64)]
        lib.dc_save_obj.restype = ctypes.c_int
        lib.dc_save_obj.argtypes = [ctypes.c_char_p, _F64P, ctypes.c_int64,
                                    _I32P, ctypes.c_int64]
        lib.dc_extract_bending_pairs.restype = ctypes.c_int
        lib.dc_extract_bending_pairs.argtypes = [
            _I32P, ctypes.c_int64, ctypes.POINTER(_I32P),
            ctypes.POINTER(ctypes.c_int64)]
        lib.dc_conn_table.restype = ctypes.c_int
        lib.dc_conn_table.argtypes = [_I32P, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_uint8)]
        lib.dc_free.restype = None
        lib.dc_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def _take(lib, ptr, count, dtype) -> np.ndarray:
    """Copy `count` elements out of a buffer the library allocated, and
    free it."""
    try:
        return (np.ctypeslib.as_array(ptr, shape=(count,)).astype(dtype)
                if count else np.zeros(0, dtype))
    finally:
        lib.dc_free(ctypes.cast(ptr, ctypes.c_void_p))


def _tris(tris: np.ndarray, n=None) -> np.ndarray:
    t = np.ascontiguousarray(tris, np.int32).reshape(-1, 3)
    if t.size and (t.min() < 0 or (n is not None and t.max() >= n)):
        raise ValueError(f"triangle indices outside [0, {n})")
    return t


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Vertices (V, 3) float64 and triangles (T, 3) int32 of an OBJ file
    ('v x y z', 'f a b c [d]', 1-based with optional /vt/vn suffixes;
    quads fan-triangulated)."""
    lib = _load()
    vp, tp = _F64P(), _I32P()
    nv, nt = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.dc_load_obj(path.encode(), ctypes.byref(vp), ctypes.byref(nv),
                         ctypes.byref(tp), ctypes.byref(nt))
    if rc != 0:
        raise IOError(f"dc_load_obj({path}) failed rc={rc}")
    verts = _take(lib, vp, 3 * nv.value, np.float64).reshape(-1, 3)
    tris = _take(lib, tp, 3 * nt.value, np.int32).reshape(-1, 3)
    return verts, tris


def save_obj(path: str, verts: np.ndarray, tris: np.ndarray) -> None:
    """Write an OBJ frame (8 decimals, as objio.save_obj)."""
    lib = _load()
    v = np.ascontiguousarray(verts, np.float64).reshape(-1, 3)
    t = _tris(tris, v.shape[0])
    rc = lib.dc_save_obj(path.encode(), v.ctypes.data_as(_F64P), v.shape[0],
                         t.ctypes.data_as(_I32P), t.shape[0])
    if rc != 0:
        raise IOError(f"dc_save_obj({path}) failed rc={rc}")


def extract_bending_pairs(tris: np.ndarray) -> np.ndarray:
    """(B, 4) [vmin, vmax, other0, other1] per interior edge, in sorted
    (vmin, vmax) order; ValueError for a non-manifold edge."""
    lib = _load()
    t = _tris(tris)
    qp, nq = _I32P(), ctypes.c_int64()
    rc = lib.dc_extract_bending_pairs(t.ctypes.data_as(_I32P), t.shape[0],
                                      ctypes.byref(qp), ctypes.byref(nq))
    if rc != 0:
        raise ValueError(f"non-manifold mesh (rc={rc})")
    return _take(lib, qp, 4 * nq.value, np.int32).reshape(-1, 4)


def conn_table(tris: np.ndarray, n: int) -> np.ndarray:
    """(n, n) bool: the diagonal and every pair sharing a triangle."""
    lib = _load()
    t = _tris(tris, n)
    table = np.zeros((n, n), np.uint8)
    rc = lib.dc_conn_table(t.ctypes.data_as(_I32P), t.shape[0], n,
                           table.ctypes.data_as(
                               ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise RuntimeError(f"dc_conn_table failed rc={rc}")
    return table.astype(bool)
