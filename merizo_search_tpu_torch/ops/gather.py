"""Phase C of the fused scan: rescore the rows of the selected blocks.

`gather_block_scores` launches the CUDA kernel in csrc/gather.cu for CUDA
tensors and runs `gather_plain`, the plain PyTorch version of the same
contract, for CPU tensors. The kernel replaces both Pallas phase-C kernels
of the JAX package (the one in `gather_block_scores_dma`, with the caller's
per-selected-block scales, and the one in `gather_block_scores`, with
per-row scales in the kernel) through one scale mode argument.

Contract (both versions): q [Q, 128], db [Npad, 128] of one dtype (bf16,
int8, or f32: the IVF rerank's sidecar, scored by an FFMA body on the CUDA
cores since tensor cores would round f32 to TF32), bidx
[Q, KB] int32 block ids (-1 = padding). Returns float32 [Q, KB*128] with
out[q, c*128 + r] = score(q, row) for row = bidx[q, c]*128 + r, times
  - nothing (no scales),
  - scale_sel[q, c] (the production int8 mode: per-selected-block scales),
  - or scales[row] (per-row mode);
and the finite sentinel NEG_CAP where bidx is -1, row >= n_valid, the
length channel masks the row (!(tl[row] <= qcap[q])) or the score is NaN.
"""

from __future__ import annotations

import torch

from .blockmax import NEG_CAP, _DTYPE_CODE
from .topk import BLOCK

_GATHER_CODE = {**_DTYPE_CODE, torch.float32: 2}

launches = 0   # kernel launches since the last reset (plain runs not counted)
launches_f32 = 0   # of which in the f32 mode (the IVF rerank)


def _validate(q, db, bidx, tl, qcap, scale_sel, scales):
    if q.dim() != 2 or db.dim() != 2 or q.shape[1] != 128 or db.shape[1] != 128:
        raise ValueError(f"q and db must be [*, 128], got {tuple(q.shape)}, {tuple(db.shape)}")
    if db.shape[0] % BLOCK:
        raise ValueError(f"db rows must be a multiple of {BLOCK}, got {db.shape[0]}")
    if q.dtype != db.dtype:
        raise TypeError(f"q and db dtypes differ: {q.dtype} vs {db.dtype}")
    if bidx.dim() != 2 or bidx.shape[0] != q.shape[0]:
        raise ValueError(f"bidx must be [Q, KB], got {tuple(bidx.shape)}")
    if (tl is None) != (qcap is None):
        raise ValueError("tl and qcap are given together or not at all")
    if scale_sel is not None and scales is not None:
        raise ValueError("give scale_sel or scales, not both")


def gather_plain(q, db, bidx, n_valid: int, tl=None, qcap=None,
                 scale_sel=None, scales=None):
    """Plain PyTorch phase C. Scores are computed in float64 (exact for
    int8) and rounded to float32; queries go 16 at a time to bound the
    gathered [16, KB, 128, 128] float64 block."""
    _validate(q, db, bidx, tl, qcap, scale_sel, scales)
    qn, kb = bidx.shape
    rows = (bidx.clamp(min=0).long()[:, :, None] * BLOCK
            + torch.arange(BLOCK, device=q.device))             # [Q, KB, 128]
    keep = (bidx >= 0)[:, :, None] & (rows < n_valid)
    if tl is not None:
        keep &= tl[rows] <= qcap[:, None, None]
    out = torch.empty((qn, kb, BLOCK), dtype=torch.float32, device=q.device)
    for q0 in range(0, qn, 16):
        x = db[rows[q0:q0 + 16]].to(torch.float64)            # [16, KB, 128, D]
        s = torch.einsum("qd,qkrd->qkr", q[q0:q0 + 16].to(torch.float64), x)
        out[q0:q0 + 16] = s.to(torch.float32)
    if scale_sel is not None:
        out = out * scale_sel[:, :, None]
    if scales is not None:
        out = out * scales[rows]
    out = torch.where(keep & (out == out), out, NEG_CAP)
    return out.reshape(qn, kb * BLOCK)


def gather_block_scores(q, db, bidx, n_valid: int, tl=None, qcap=None,
                        scale_sel=None, scales=None):
    """Phase C: [Q, KB*128] float32 (module docstring). CUDA tensors launch
    the kernel (or raise); CPU tensors run the plain version."""
    global launches, launches_f32
    _validate(q, db, bidx, tl, qcap, scale_sel, scales)
    if q.device.type == "cpu":
        return gather_plain(q, db, bidx, n_valid, tl, qcap, scale_sel, scales)
    from . import _build

    nq, kb = bidx.shape
    npad = db.shape[0]
    if db.dtype not in _GATHER_CODE:
        raise TypeError(f"gather kernel takes bf16, int8 or f32, got {db.dtype}")
    dev = q.device
    args = [_build.ptr(q, "q", db.dtype, device=dev),
            _build.ptr(db, "db", db.dtype, device=dev),
            _build.ptr(tl, "tl", torch.float32, (npad,), dev),
            _build.ptr(qcap, "qcap", torch.float32, (nq,), dev),
            _build.ptr(bidx, "bidx", torch.int32, (nq, kb), dev),
            _build.ptr(scale_sel, "scale_sel", torch.float32, (nq, kb), dev),
            _build.ptr(scales, "scales", torch.float32, (npad,), dev)]
    out = torch.empty((nq, kb * BLOCK), dtype=torch.float32, device=dev)
    if nq == 0 or kb == 0:
        return out
    rc = _build.library().mst_gather_block_scores(
        _GATHER_CODE[db.dtype], *args, out.data_ptr(), nq, kb, int(n_valid),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "gather_block_scores")
    launches += 1
    launches_f32 += db.dtype == torch.float32
    return out
