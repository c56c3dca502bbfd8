"""ctypes loader for the native CA parser (io/_native/pdbparse.cpp).

The port's copy of the JAX package's loader. The library is built on first
use by utils.nativebuild (g++, host-tuned, content-keyed, atomic publish)
into the package's `_build/`. When g++ is missing or the build fails,
`available()` is False and io.pdb.read_ca uses its numpy path, which is the
specification this parser follows. This is host code: the fallback is the
JAX package's behaviour, not a device fallback. The C call releases the
GIL, so createdb's parser thread pool scales across cores.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading

import numpy as np

logger = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native",
                    "pdbparse.cpp")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        from ..utils.nativebuild import load_native_lib

        try:
            lib = load_native_lib(_SRC, "pdbparse")
        except (RuntimeError, OSError) as e:
            logger.warning("native CA parser unavailable, using numpy: %s",
                           str(e)[:300])
            _build_failed = True
            return None
        lib.parse_ca.restype = ctypes.c_int
        lib.parse_ca.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char,
            ctypes.POINTER(ctypes.c_float), ctypes.c_char_p, ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def parse_ca_bytes(raw: bytes, chain: str):
    """CA records of `chain` from PDB file bytes -> (coords f32 [N,3], seq)
    or None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    # every CA record occupies a >= 55-byte line (54 cols + newline)
    cap = max(4, len(raw) // 55 + 1)
    coords = np.empty((cap, 3), np.float32)
    seq = ctypes.create_string_buffer(cap)
    n = lib.parse_ca(
        raw, len(raw), chain.encode("ascii"),
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), seq, cap)
    if n > cap:  # cannot happen with the line-length bound
        return None
    return coords[:n].copy(), seq.raw[:n].decode("ascii")
