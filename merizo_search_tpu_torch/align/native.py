"""ctypes bindings for the native C++ TM-align (align/_native/tmalign.cpp).

The reference invokes its bundled TM-align binary as a subprocess per
query-hit pair, round-tripping PDBs through /tmp (programs/Foldclass/
utils.py:75-109). Here the aligner is an in-process shared library with a
std::thread batch entry point: no fork+exec, no file I/O, one call per
rescoring batch. The port keeps its own copy of the source and builds it
with g++ into the package's `_build/` directory on first use.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading

import numpy as np

from .seqid import seq_identity_count

logger = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "_native", "tmalign.cpp")

_lock = threading.Lock()
_lib = None


def load():
    """The loaded library, built on first use; raises if g++ fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from ..utils.nativebuild import load_native_lib

        lib = load_native_lib(_SRC, "tmalign")
        lib.tmalign_batch.restype = ctypes.c_int
        lib.tmalign_batch.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int)]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads (the failure is logged)."""
    try:
        load()
    except Exception as e:  # noqa: BLE001  (g++ missing or failing)
        logger.warning("native TM-align unavailable: %s", e)
        return False
    return True


def _pack(structs) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    coords = [np.ascontiguousarray(s["coords"], np.float32) for s in structs]
    lens = np.asarray([c.shape[0] for c in coords], np.int32)
    offs = np.zeros(len(coords), np.int32)
    if len(coords) > 1:
        offs[1:] = np.cumsum(lens[:-1])
    flat = (np.concatenate(coords, axis=0) if coords
            else np.zeros((0, 3), np.float32))
    return np.ascontiguousarray(flat), offs, lens


def tmalign_pairs_native(pairs: list[tuple], fast: bool = False,
                         nthreads: int = 0) -> list[dict]:
    """Align (query, target) dict pairs with the C++ library.

    Returns one {len_ali, rmsd, seq_id, qtm, ttm} dict per pair (the schema
    of the reference's parsed TM-align output, Foldclass/utils.py:112-158).
    """
    lib = load()
    n = len(pairs)
    if n == 0:
        return []
    xq, qoff, qlen = _pack([p[0] for p in pairs])
    xt, toff, tlen = _pack([p[1] for p in pairs])
    out = np.zeros(4 * n, np.float64)
    ali = np.full(int(qlen.sum()), -1, np.int32)

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    dp = ctypes.POINTER(ctypes.c_double)
    rc = lib.tmalign_batch(
        xq.ctypes.data_as(fp), qoff.ctypes.data_as(ip), qlen.ctypes.data_as(ip),
        xt.ctypes.data_as(fp), toff.ctypes.data_as(ip), tlen.ctypes.data_as(ip),
        n, int(fast), int(nthreads),
        out.ctypes.data_as(dp), ali.ctypes.data_as(ip))
    if rc != 0:
        raise RuntimeError(f"tmalign_batch returned {rc}")

    results = []
    for i, (q, t) in enumerate(pairs):
        qtm, ttm, rmsd, len_ali = out[4 * i:4 * i + 4]
        a = ali[qoff[i]:qoff[i] + qlen[i]]
        n_id = seq_identity_count(q.get("seq", ""), t.get("seq", ""), a)
        la = int(len_ali)
        results.append({
            "len_ali": la,
            "rmsd": float(rmsd),
            "seq_id": (n_id / la) if la else 0.0,
            "qtm": float(qtm),
            "ttm": float(ttm),
        })
    return results
