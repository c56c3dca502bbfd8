"""Build and load the scan kernels (csrc/*.cu) with nvcc and ctypes.

Each `.cu` file is compiled to an object by its own `nvcc` process, all
started together, for `sm_90a`; the objects are linked into one shared
library with plain `extern "C"` launchers that return a `cudaError_t`.
ctypes loads it with `c_void_p` for every pointer and the stream. The
library is cached in the package's `_build/` directory under a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
at once. No PyTorch headers are compiled: a build takes seconds.

Imported only by the kernel wrappers when they are handed a CUDA tensor,
so the CPU tests never look for nvcc.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from ..utils.nativebuild import BUILD_DIR, content_tag, run_compiler, temp_path

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_seconds = 0.0   # wall time of the nvcc build in this process (0 if cached)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin, "
                       "default /usr/local/cuda/bin); the CUDA kernels cannot "
                       "be built")


def _compile(sources: list[str], out: str) -> None:
    """`nvcc -c` every source, all started together, then link one shared
    library. The ptxas report (registers, shared memory, spills) goes to
    `_build/nvcc.log`. Temporary objects live in `_build/` and are removed."""
    nvcc = _nvcc()
    objs = {src: temp_path(".o") for src in sources}
    tmp = temp_path(".so")
    try:
        with ThreadPoolExecutor(len(sources)) as pool:
            logs = list(pool.map(
                lambda src: run_compiler([nvcc, *NVCC_FLAGS, "-c", "-o", objs[src], src]),
                sources))
        with open(os.path.join(BUILD_DIR, "nvcc.log"), "w") as fh:
            fh.write("\n".join(f"== {os.path.basename(src)}\n{log}"
                               for src, log in zip(sources, logs)))
        run_compiler([nvcc, "-shared", "-o", tmp, *objs.values()], 300)
        os.replace(tmp, out)
    finally:
        for path in (tmp, *objs.values()):
            if os.path.exists(path):
                os.unlink(path)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use. Raises when nvcc is
    missing or a source does not compile."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
        headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
        tag = content_tag(sources + headers, NVCC_FLAGS)
        path = os.path.join(BUILD_DIR, f"libmst_kernels-{tag}.so")
        if not os.path.exists(path):
            t0 = time.perf_counter()
            _compile(sources, path)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(path)
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mst_blockmax_scan.restype = ci
        lib.mst_blockmax_scan.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, ci, ll,
                                          ci, ci, vp]
        lib.mst_gather_block_scores.restype = ci
        lib.mst_gather_block_scores.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp,
                                                vp, ci, ci, ci, ll, vp]
        lib.mst_by_block_ws.restype = ll
        lib.mst_by_block_ws.argtypes = [ci, ll, vp]
        lib.mst_invert_blocks.restype = ci
        lib.mst_invert_blocks.argtypes = [vp, vp, ci, ci, ci, vp]
        lib.mst_gather_by_block.restype = ci
        lib.mst_gather_by_block.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci,
                                            ci, ci, ll, vp]
        lib.mst_bm_gather.restype = ci
        lib.mst_bm_gather.argtypes = [ci, vp, vp, vp, vp, ci, ci, ll, ci, ci, vp,
                                      vp, vp, vp, ci, ci, vp]
        lib.mst_bm_gather_prep.restype = ci
        lib.mst_bm_gather_prep.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
        lib.mst_bm_gather_layout.restype = ci
        lib.mst_bm_gather_layout.argtypes = [ci, ci, vp]
        lib.mst_mini_scan.restype = ci
        lib.mst_mini_scan.argtypes = [ci, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                                      ci, vp]
        lib.mst_stream_probe.restype = ci
        lib.mst_stream_probe.argtypes = [vp, vp, vp, ci, ll, ci, vp]
        lib.mst_slab_scan.restype = ci
        lib.mst_slab_scan.argtypes = [ci, ci, vp, vp, vp, vp, vp, ci, ci, ll, ci, ci,
                                      vp]
        lib.mst_gather_variant.restype = ci
        lib.mst_gather_variant.argtypes = [ci, ci, vp, vp, ci, vp, vp, vp, ci, ci, ci, vp]
        lib.mst_walk_layout.restype = ci
        lib.mst_walk_layout.argtypes = [ci, ci, vp]
        lib.mst_gather_layout.restype = ci
        lib.mst_gather_layout.argtypes = [ci, vp]
        _lib = lib
        return _lib


def ptr(t, name: str, dtype, shape=None, device=None) -> int | None:
    """Validate a kernel argument and return its device pointer (None for a
    missing optional argument). Kernels take contiguous, 16-byte aligned
    CUDA tensors of one dtype and shape; anything else raises here."""
    if t is None:
        return None
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name} must be on {device or 'a CUDA device'}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return t.data_ptr()


ERR_TMAP = 100_000   # launcher codes past this: ERR_TMAP + cuTensorMapEncodeTiled's CUresult


def check_launch(rc: int, name: str) -> None:
    """Raise for a launcher's nonzero return: a cudaError_t, or a failed
    encode of the DB's TMA tensor map (csrc/scan_common.cuh db_tensor_map)."""
    if rc >= ERR_TMAP:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed with CUresult {rc - ERR_TMAP}")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
