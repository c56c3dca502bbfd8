"""Phase A of the fused scan: per-128-row block maxima of the scores.

`blockmax_scan` launches the CUDA kernel in csrc/blockmax.cu for CUDA
tensors and runs `blockmax_plain`, the plain PyTorch version of the same
contract, for CPU tensors. The kernel replaces the Pallas `_bm_kernel` of
the JAX package; its header says what bounds it on the H100.
`phase_a_geometry` sizes its launch: the query tile to the batch and a
grid resident at once, each CTA walking a contiguous range of blocks.

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

from .topk import BLOCK

NEG_CAP = -3.4e38
INT_MASKED = -(2 ** 31) + 1
_DTYPE_CODE = {torch.bfloat16: 0, torch.int8: 1}

launches = 0   # kernel launches since the last reset (plain runs not counted)


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


QUERY_GROUP = 32                                  # queries a warp holds (blockmax.cuh QG)
CTAS_PER_SM = {torch.bfloat16: 2, torch.int8: 3}  # Traits::CTAS, csrc/scan_common.cuh


def query_groups(nq: int) -> int:
    """Query groups of 32 in a CTA's query tile (1, 2, 4 or 8): the fewest
    that hold the batch, at most 256 queries a tile, so a small batch
    multiplies no query columns of zeros beyond its last n-tile of 8."""
    return next(g for g in (1, 2, 4, 8) if QUERY_GROUP * g >= min(nq, 256))


def phase_a_geometry(nq: int, nb: int, sms: int, ctas_per_sm: int) -> tuple[int, int]:
    """(qgroups, blocks_per_cta) of a phase-A launch: query tiles of
    32 * qgroups queries, and about sms * ctas_per_sm CTAs in all (a grid
    that is resident at once), each walking a contiguous range of
    blocks_per_cta blocks, so each CTA loads its query fragments once."""
    qg = query_groups(nq)
    qtiles = -(-nq // (QUERY_GROUP * qg))
    chunks = max(1, min(nb, sms * ctas_per_sm // qtiles))
    return qg, -(-nb // chunks)


def launch_geometry(q, nb: int) -> tuple[int, int]:
    """phase_a_geometry for a CUDA tensor q's batch and card."""
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return phase_a_geometry(q.shape[0], nb, sms, CTAS_PER_SM[q.dtype])


def blockmax_scan(q, db, n_valid: int, tl=None, qcap=None, scales=None):
    """Phase A: BM [Q, Npad/128] float32 (module docstring). CUDA tensors
    launch the kernel (or raise); CPU tensors run the plain version."""
    global launches
    _validate(q, db, tl, qcap, scales)
    if q.device.type == "cpu":
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
    if nq == 0:
        return out
    rc = _build.library().mst_blockmax_scan(
        _DTYPE_CODE[db.dtype], *args, out.data_ptr(), nq, nb, int(n_valid),
        *launch_geometry(q, nb), torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "blockmax_scan")
    launches += 1
    return out
