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

`gather_block_scores_by_block` is a second launch of the same contract,
for the IVF, whose probed blocks are shared by many queries: it inverts
bidx into a CSR from each distinct block to its (query, column) slots
(`invert_blocks`; `invert_plain` is its plain version) and scores each
distinct block once against all of them (csrc/gather.cuh). Its output
equals `gather_block_scores`'s bit for bit; CPU tensors run `gather_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import profiling
from .blockmax import NEG_CAP, _DTYPE_CODE
from .topk import BLOCK

_GATHER_CODE = {**_DTYPE_CODE, torch.float32: 2}

RES = 8   # residue classes of a query index: its N slot in a tensor-core n-tile

LAUNCHES = profiling.declare("gather.launches")   # kernel launches (plain runs not counted)
LAUNCHES_F32 = profiling.declare("gather.launches_f32")   # of which in the f32 mode (the IVF rerank)
LAUNCHES_BY_BLOCK = profiling.declare("gather.launches_by_block")   # block-major launches
LAUNCHES_BY_BLOCK_F32 = profiling.declare("gather.launches_by_block_f32")   # of which f32


def gather_layout(dtype) -> dict:
    """The shared-memory layout of the bf16/int8 per-query kernel's CTA (one
    selected column), read from the built library (csrc/gather.cuh
    `GatherSmem`): byte offsets of the query's 8-row B tile, the block's tl
    values and its barrier (the block's slot starts at 0), the layout's
    bytes, and what a launch asks for (plus 1024 bytes of alignment
    slack). Builds the library: needs nvcc."""
    from . import _build

    out = (ctypes.c_int * 5)()
    _build.check_launch(_build.library().mst_gather_layout(_DTYPE_CODE[dtype], out),
                        "gather_layout")
    return dict(zip(("bt", "tl", "bar", "bytes", "launch"), out))


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


def _kernel_args(q, db, bidx, tl, qcap, scale_sel, scales):
    """Both launches' pointer arguments (q, db, tl, qcap, bidx, scale_sel,
    scales), validated for the card."""
    from . import _build

    nq, kb = bidx.shape
    npad = db.shape[0]
    if db.dtype not in _GATHER_CODE:
        raise TypeError(f"gather kernel takes bf16, int8 or f32, got {db.dtype}")
    dev = q.device
    return [_build.ptr(q, "q", db.dtype, device=dev),
            _build.ptr(db, "db", db.dtype, device=dev),
            _build.ptr(tl, "tl", torch.float32, (npad,), dev),
            _build.ptr(qcap, "qcap", torch.float32, (nq,), dev),
            _build.ptr(bidx, "bidx", torch.int32, (nq, kb), dev),
            _build.ptr(scale_sel, "scale_sel", torch.float32, (nq, kb), dev),
            _build.ptr(scales, "scales", torch.float32, (npad,), dev)]


def gather_block_scores(q, db, bidx, n_valid: int, tl=None, qcap=None,
                        scale_sel=None, scales=None):
    """Phase C: [Q, KB*128] float32 (module docstring). CUDA tensors launch
    the kernel (or raise); CPU tensors run the plain version."""
    _validate(q, db, bidx, tl, qcap, scale_sel, scales)
    if q.device.type == "cpu":
        return gather_plain(q, db, bidx, n_valid, tl, qcap, scale_sel, scales)
    from . import _build

    args = _kernel_args(q, db, bidx, tl, qcap, scale_sel, scales)
    nq, kb = bidx.shape
    out = torch.empty((nq, kb * BLOCK), dtype=torch.float32, device=q.device)
    if nq == 0 or kb == 0:
        return out
    with torch.cuda.device(q.device):  # the launch and its smem attribute: q's card
        rc = _build.library().mst_gather_block_scores(
            _GATHER_CODE[db.dtype], *args, out.data_ptr(), nq, kb, db.shape[0] // BLOCK,
            int(n_valid),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch(rc, "gather_block_scores")
    profiling.count(LAUNCHES)
    if db.dtype == torch.float32:
        profiling.count(LAUNCHES_F32)
    return out


def invert_plain(bidx, nb: int):
    """The block-major launch's inversion, plain: bidx [Q, KB] over nb
    blocks -> (blocks [D] int64, the distinct selected ids ascending;
    offsets [D, 9] int64, block blocks[d]'s entries of residue r at
    slots[offsets[d, r]:offsets[d, r + 1]]; slots [M] int64, flat entries
    q*KB + c ascending within each (block, residue); pad [P] int64, the
    entries that are padding: bidx < 0 or >= nb). The residue of entry
    q*KB + c is q % 8, the query's N slot in phase A's n-tiles."""
    qn, kb = bidx.shape
    ent = torch.arange(qn * kb, device=bidx.device)
    flat = bidx.reshape(-1).long()
    bucket = torch.where((flat >= 0) & (flat < nb), flat, nb)
    key = bucket * RES + (ent // kb) % RES
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=(nb + 1) * RES)
    off = torch.zeros((nb + 1) * RES + 1, dtype=torch.int64, device=bidx.device)
    off[1:] = torch.cumsum(counts, 0)
    blocks = torch.nonzero(counts[:nb * RES].view(nb, RES).sum(1)).flatten()
    offsets = off[blocks[:, None] * RES + torch.arange(RES + 1, device=off.device)]
    nvalid = int(off[nb * RES])
    return blocks, offsets, order[:nvalid], torch.sort(order[nvalid:]).values


def _segments(lst, starts, ends):
    """The values lst[starts[s]:ends[s]] of every segment s, each segment
    sorted, concatenated in segment order; and the segments' lengths."""
    lens = ends - starts
    sid = torch.repeat_interleave(torch.arange(len(lens), device=lst.device), lens)
    first = torch.cumsum(lens, 0) - lens
    vals = lst[starts[sid] + torch.arange(len(sid), device=lst.device) - first[sid]]
    return vals[torch.argsort(sid * max(len(lst), 1) + vals)], lens


def invert_blocks(bidx, nb: int):
    """The inversion as the block-major launch builds it: CPU tensors run
    `invert_plain`; on the card the kernels' CSR (csrc/gather.cu, a counting
    sort by atomics, its lists in no particular order) is read back in
    invert_plain's form: blocks ascending, each list sorted. A test and
    diagnostic entry: it syncs with the host."""
    if bidx.dim() != 2:
        raise ValueError(f"bidx must be [Q, KB], got {tuple(bidx.shape)}")
    if bidx.device.type == "cpu":
        return invert_plain(bidx, nb)
    from . import _build

    nq, kb = bidx.shape
    m = nq * kb
    lib = _build.library()
    sec = (ctypes.c_longlong * 5)()    # cnt, hdr, off, dist, list
    ws = torch.empty(lib.mst_by_block_ws(nb, m, sec), dtype=torch.int32, device=bidx.device)
    with torch.cuda.device(bidx.device):
        rc = lib.mst_invert_blocks(_build.ptr(bidx, "bidx", torch.int32, (nq, kb)),
                                   ws.data_ptr(), nq, kb, nb,
                                   torch.cuda.current_stream(bidx.device).cuda_stream)
    _build.check_launch(rc, "invert_blocks")
    ws = ws.long()
    off = ws[sec[2]:sec[2] + (nb + 1) * (RES + 1)].view(nb + 1, RES + 1)
    blocks = torch.sort(ws[sec[3]:sec[3] + int(ws[sec[1]])]).values
    lst = ws[sec[4]:sec[4] + m]
    slots, lens = _segments(lst, off[blocks, :RES].reshape(-1), off[blocks, 1:].reshape(-1))
    cum = torch.zeros(len(lens) + 1, dtype=torch.int64, device=ws.device)
    cum[1:] = torch.cumsum(lens, 0)
    offsets = cum[torch.arange(len(blocks), device=ws.device)[:, None] * RES
                  + torch.arange(RES + 1, device=ws.device)]
    pad, _ = _segments(lst, off[nb, :1], off[nb, RES:])
    return blocks, offsets, slots, pad


def gather_block_scores_by_block(q, db, bidx, n_valid: int, tl=None, qcap=None,
                                 scale_sel=None, scales=None, out=None):
    """Phase C, block-major: `gather_block_scores`'s contract and output, bit
    for bit, with each distinct selected block read once a call (the IVF's
    probe gather and rerank). `out`: an optional float32 [Q, KB*128] on q's
    device to write into. CUDA tensors launch the kernels (or raise); CPU
    tensors run the plain version."""
    _validate(q, db, bidx, tl, qcap, scale_sel, scales)
    nq, kb = bidx.shape
    if out is not None and (out.dtype != torch.float32 or out.device != q.device
                            or tuple(out.shape) != (nq, kb * BLOCK)):
        raise ValueError(f"out must be float32 {(nq, kb * BLOCK)} on {q.device}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    if q.device.type == "cpu":
        res = gather_plain(q, db, bidx, n_valid, tl, qcap, scale_sel, scales)
        return res if out is None else out.copy_(res)
    from . import _build

    args = _kernel_args(q, db, bidx, tl, qcap, scale_sel, scales)
    if out is None:
        out = torch.empty((nq, kb * BLOCK), dtype=torch.float32, device=q.device)
    optr = _build.ptr(out, "out", torch.float32)
    if nq == 0 or kb == 0:
        return out
    if nq * kb >= 2 ** 31:
        raise ValueError(f"bidx has {nq * kb} entries; the inversion takes fewer than 2^31")
    lib = _build.library()
    nb = db.shape[0] // BLOCK
    ws = torch.empty(lib.mst_by_block_ws(nb, nq * kb, None), dtype=torch.int32,
                     device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.mst_gather_by_block(
            _GATHER_CODE[db.dtype], *args, optr, ws.data_ptr(), nq, kb, nb, int(n_valid),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch(rc, "gather_block_scores_by_block")
    profiling.count(LAUNCHES_BY_BLOCK)
    if db.dtype == torch.float32:
        profiling.count(LAUNCHES_BY_BLOCK_F32)
    return out
