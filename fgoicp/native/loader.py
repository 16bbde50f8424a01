"""ctypes bindings for the native loader (fgoicp/native/src/loader.cc).

Import side effects are deliberately safe: if g++ or the build fails, the
module still imports and every function returns None so io/loader.py
falls back to pure Python.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from . import build as _build

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = _build.ensure_built(quiet=True)
    if path is None or not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.fgoicp_load_txt.restype = ctypes.POINTER(ctypes.c_float)
        lib.fgoicp_load_txt.argtypes = [ctypes.c_char_p,
                                        ctypes.POINTER(ctypes.c_int64)]
        lib.fgoicp_free.restype = None
        lib.fgoicp_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.fgoicp_load_ply.restype = ctypes.POINTER(ctypes.c_float)
        lib.fgoicp_load_ply.argtypes = [ctypes.c_char_p,
                                        ctypes.POINTER(ctypes.c_int64)]
        lib.fgoicp_native_abi.restype = ctypes.c_int32
        if lib.fgoicp_native_abi() != 2:
            return None
        _lib = lib
        return lib
    except OSError:
        return None


def _call(fn_name: str, path: str):
    lib = _load()
    if lib is None:
        return None
    n = ctypes.c_int64(0)
    ptr = getattr(lib, fn_name)(path.encode(), ctypes.byref(n))
    if not ptr:
        return None
    try:
        flat = np.ctypeslib.as_array(ptr, shape=(n.value * 3,))
        return np.array(flat, dtype=np.float32).reshape(n.value, 3)
    finally:
        lib.fgoicp_free(ptr)


def load_txt(path: str):
    """Parse a first-line-count TXT cloud natively; None on any failure."""
    return _call("fgoicp_load_txt", path)


def load_ply(path: str):
    """Parse an ascii/binary_le PLY natively; None on unsupported variants
    (big-endian, list vertex props) — callers fall back to Python."""
    return _call("fgoicp_load_ply", path)
