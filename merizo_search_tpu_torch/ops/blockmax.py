"""Phase A of the fused scan: per-128-row block maxima of the scores.

`blockmax_scan` launches the CUDA kernel in csrc/blockmax.cu for CUDA
tensors and runs `blockmax_plain`, the plain PyTorch version of the same
contract, for CPU tensors. The kernel replaces the Pallas `_bm_kernel` of
the JAX package; its header says what bounds it on the H100.
`phase_a_geometry` sizes its launch: the query tile to the batch and a
persistent grid of one CTA an SM, each walking a contiguous range of
blocks; `walk_layout` reads the kernel's shared-memory layout.

Contract (both versions), for q [Q, 128] and db [Npad, 128] of one dtype
(bf16 or int8 for the kernel; the plain version also takes f32), Npad a
multiple of 128, rows >= n_valid padding:
  BM[q, b] = max over block b's rows of score(q, row), float32 [Q, Npad/128]
- int8: the int32 block max times the block's scale (`scales` [Npad], from
  `quantize_blocks`: uniform within each block);
- with `tl` [Npad] (= tlen * mincov) and `qcap` [Q] (= qlen), rows with
  !(tl <= qcap) are masked: -inf, or the int sentinel -(2^31 - 1) for int8
  (as in the JAX kernel, so BM matches it exactly); NaN scores never win;
- blocks starting at or past n_valid are NEG_CAP, all others are clamped to
  NEG_CAP from below (BM is finite). The one block that straddles n_valid
  may carry an inflated max; fused_topk compensates.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from .topk import BLOCK

LAUNCHES = profiling.declare("blockmax.launches")   # kernel launches (plain runs not counted)

NEG_CAP = -3.4e38
INT_MASKED = -(2 ** 31) + 1
_DTYPE_CODE = {torch.bfloat16: 0, torch.int8: 1}


def _validate(q, db, tl, qcap, scales):
    if q.dim() != 2 or db.dim() != 2 or q.shape[1] != 128 or db.shape[1] != 128:
        raise ValueError(f"q and db must be [*, 128], got {tuple(q.shape)}, {tuple(db.shape)}")
    if db.shape[0] % BLOCK:
        raise ValueError(f"db rows must be a multiple of {BLOCK}, got {db.shape[0]}")
    if q.dtype != db.dtype:
        raise TypeError(f"q and db dtypes differ: {q.dtype} vs {db.dtype}")
    if (tl is None) != (qcap is None):
        raise ValueError("tl and qcap are given together or not at all")
    if (db.dtype == torch.int8) != (scales is not None):
        raise ValueError("scales are required for int8 and only for int8")


def blockmax_plain(q, db, n_valid: int, tl=None, qcap=None, scales=None):
    """Plain PyTorch phase A. Scores are computed in float64 (exact for
    int8) and rounded to float32."""
    _validate(q, db, tl, qcap, scales)
    qn, nb = q.shape[0], db.shape[0] // BLOCK
    s = q.to(torch.float64) @ db.to(torch.float64).T
    masked = None if tl is None else ~(tl[None, :] <= qcap[:, None])
    if db.dtype == torch.int8:
        if masked is not None:
            s = s.masked_fill(masked, INT_MASKED)
        m = (s.view(qn, nb, BLOCK).amax(dim=2).to(torch.float32)
             * scales.view(nb, BLOCK)[:, 0])
    else:
        s = s.to(torch.float32)
        s = s.masked_fill(torch.isnan(s), float("-inf"))
        if masked is not None:
            s = s.masked_fill(masked, float("-inf"))
        m = s.view(qn, nb, BLOCK).amax(dim=2)
    valid = torch.arange(nb, device=q.device) * BLOCK < n_valid
    return torch.where(valid[None, :], torch.clamp(m, min=NEG_CAP), NEG_CAP)


TILE_WIDTHS = (32, 64, 128, 256)   # query tile widths N the kernels are built for


def walk_layout(dtype, n: int) -> dict:
    """Phase A's shared-memory layout for tile width n, read from the built
    library (csrc/blockmax.cuh `WalkSmem`): the ring's stage count and slot
    bytes, byte offsets of the query tile, the slots' tl values, the tile's
    qcap values, the epilogue buffer and the barriers (the slots start at
    0), the layout's bytes, and what a launch asks for (plus 1024 bytes of
    alignment slack). Builds the library: needs nvcc."""
    import ctypes

    from . import _build

    out = (ctypes.c_int * 9)()
    _build.check_launch(_build.library().mst_walk_layout(_DTYPE_CODE[dtype], n, out),
                        "walk_layout")
    return dict(zip(("stages", "slot_bytes", "qt", "tl", "qcap", "red", "bar", "bytes",
                     "launch"), out))


def tile_width(nq: int) -> int:
    """Phase A's query tile width N (32, 64, 128 or 256): the least that
    holds the batch, at most 256 queries a tile, so a small batch
    multiplies no query columns of zeros beyond the next power of two."""
    return next(n for n in TILE_WIDTHS if n >= min(nq, 256))


def phase_a_geometry(nq: int, nb: int, sms: int) -> tuple[int, int]:
    """(N, blocks_per_cta) of a phase-A launch: query tiles of N =
    tile_width(nq) queries and a persistent grid of about one CTA an SM
    (the CTA's ring and query tile take most of an SM's shared memory),
    each walking a contiguous range of blocks_per_cta blocks, so each CTA
    stages its query tile once. More query tiles than SMs take one chunk
    each, in waves."""
    n = tile_width(nq)
    qtiles = max(1, -(-nq // n))
    chunks = max(1, min(nb, sms // qtiles))
    return n, max(1, -(-nb // chunks))


def launch_geometry(q, nb: int) -> tuple[int, int]:
    """phase_a_geometry for a CUDA tensor q's batch and card."""
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return phase_a_geometry(q.shape[0], nb, sms)


def blockmax_scan(q, db, n_valid: int, tl=None, qcap=None, scales=None):
    """Phase A: BM [Q, Npad/128] float32 (module docstring). CUDA tensors
    launch the kernel (or raise); CPU tensors run the plain version."""
    _validate(q, db, tl, qcap, scales)
    if q.device.type == "cpu":
        with profiling.phase("scan.phase_a", q.device):
            return blockmax_plain(q, db, n_valid, tl, qcap, scales)
    from . import _build

    nq, npad = q.shape[0], db.shape[0]
    nb = npad // BLOCK
    if db.dtype not in _DTYPE_CODE:
        raise TypeError(f"blockmax kernel takes bf16 or int8, got {db.dtype}")
    dev = q.device
    args = [_build.ptr(q, "q", db.dtype, device=dev),
            _build.ptr(db, "db", db.dtype, device=dev),
            _build.ptr(tl, "tl", torch.float32, (npad,), dev),
            _build.ptr(qcap, "qcap", torch.float32, (nq,), dev),
            _build.ptr(scales, "scales", torch.float32, (npad,), dev)]
    out = torch.empty((nq, nb), dtype=torch.float32, device=dev)
    if nq == 0 or nb == 0:
        return out
    geometry = launch_geometry(q, nb)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the launch and its smem attribute on q's card. Phase A's device span
    # opens at the launch: the card has no work queued before it, so the
    # host's work above would count as device time
    with torch.cuda.device(dev), profiling.phase("scan.phase_a", dev):
        rc = _build.library().mst_blockmax_scan(
            _DTYPE_CODE[db.dtype], *args, out.data_ptr(), nq, nb, int(n_valid),
            *geometry, stream)
    _build.check_launch(rc, "blockmax_scan")
    profiling.count(LAUNCHES)
    return out
