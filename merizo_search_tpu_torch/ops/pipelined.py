"""The two-batch pipelined exact scan: phase A of this batch and phase C of
the previous batch in one kernel launch.

`blockmax_scan_gather` launches the CUDA kernel in csrc/bm_gather.cu for
CUDA tensors and runs `blockmax_scan_gather_plain`, built from the plain
versions of phases A and C, for CPU tensors. The kernel replaces the Pallas
`_bm_gather_kernel` of the JAX package; its header says what bounds it on
the H100: one pass over the DB, phase A's walk, that also scores the
previous batch's selected blocks on the ring slots that hold them, after
`invert_previous` has inverted that selection block-major. `fused_topk_step`
drives it with the JAX `fused_topk_step` contract. The engine does not use
it: it is the measured experiment of overlapping phase C with the next
batch's phase A (PERF.md).

Contract of `blockmax_scan_gather`, for q [Q, 128] this batch, pv_q
[Qp, 128] and pv_bidx [Qp, KB] int32 the previous batch's queries and
selected blocks (-1 = padding), db [Npad, 128] bf16 or int8, no length
channel:
- BM [Q, Npad/128] float32, as `blockmax_scan` without tl/qcap;
- prev [Qp, KB*128] float32, as `gather_block_scores` without tl/qcap:
  int8 scores times pv_scale_sel [Qp, KB] (the previous batch's
  per-selected-block scales, which `fused_topk_step` carries), or raw
  integers where pv_scale_sel is None (as the JAX `blockmax_scan_gather`
  returns them).
"""

from __future__ import annotations

import torch

from ..utils import profiling
from .blockmax import _DTYPE_CODE, blockmax_plain, launch_geometry
from .fused_scan import final_topk
from .gather import gather_plain
from .select import phase_b
from .topk import BLOCK

LAUNCHES = profiling.declare("pipelined.launches")   # kernel launches (plain runs not counted)
INVERSIONS = profiling.declare("pipelined.inversions")   # invert_previous calls (a memset and four kernels each)

PLAIN_CHUNK = 1 << 20   # DB rows per phase-A piece of the plain version


def _validate(q, db, pv_q, pv_bidx, scales, pv_scale_sel):
    for name, t in (("q", q), ("pv_q", pv_q)):
        if t.dim() != 2 or t.shape[1] != 128:
            raise ValueError(f"{name} must be [*, 128], got {tuple(t.shape)}")
        if t.dtype != db.dtype:
            raise TypeError(f"{name} and db dtypes differ: {t.dtype} vs {db.dtype}")
    if db.dim() != 2 or db.shape[1] != 128 or db.shape[0] % BLOCK:
        raise ValueError(f"db must be [Npad, 128] with Npad % {BLOCK} == 0, "
                         f"got {tuple(db.shape)}")
    if pv_bidx.dim() != 2 or pv_bidx.shape[0] != pv_q.shape[0]:
        raise ValueError(f"pv_bidx must be [Qp, KB], got {tuple(pv_bidx.shape)}")
    if (db.dtype == torch.int8) != (scales is not None):
        raise ValueError("scales are required for int8 and only for int8")
    if pv_scale_sel is not None and (scales is None or pv_scale_sel.shape != pv_bidx.shape):
        raise ValueError("pv_scale_sel is int8's, shaped as pv_bidx")


def blockmax_scan_gather_plain(q, db, n_valid: int, pv_q, pv_bidx, scales=None,
                               pv_scale_sel=None):
    """Plain PyTorch version: (BM, prev) from `blockmax_plain` (over DB
    pieces of PLAIN_CHUNK rows, to bound its float64 score matrix) and
    `gather_plain`."""
    _validate(q, db, pv_q, pv_bidx, scales, pv_scale_sel)
    bms = []
    for r0 in range(0, db.shape[0], PLAIN_CHUNK):
        sc = None if scales is None else scales[r0:r0 + PLAIN_CHUNK]
        bms.append(blockmax_plain(q, db[r0:r0 + PLAIN_CHUNK], n_valid - r0, scales=sc))
    bm = torch.cat(bms, dim=1)
    return bm, gather_plain(pv_q, db, pv_bidx, n_valid, scale_sel=pv_scale_sel)


def bm_gather_layout(dtype, n: int) -> dict:
    """The kernel's shared-memory layout for tile width n, read from the
    built library (csrc/bm_gather.cu `BmGatherSmem`): byte offsets of the
    consumers' B tiles, their pass entries and the ring's offset windows
    (phase A's `WalkSmem` comes first), the layout's bytes, and what a
    launch asks for (plus 1024 bytes of alignment slack). Builds the
    library: needs nvcc."""
    import ctypes

    from . import _build

    out = (ctypes.c_int * 5)()
    _build.check_launch(_build.library().mst_bm_gather_layout(_DTYPE_CODE[dtype], n, out),
                        "bm_gather_layout")
    return dict(zip(("bt", "meta", "win", "bytes", "launch"), out))


def invert_previous(pv_q, pv_bidx, nb: int, pv_scale_sel=None):
    """The previous selection as the kernel reads it, built on the card
    (csrc/bm_gather.cu `mst_bm_gather_prep`): ws, the block-major inversion
    of pv_bidx over nb blocks (csrc/gather.cu's CSR, int32); lq [M, 128],
    the rows of pv_q in the CSR's list order; lss [M] float32, pv_scale_sel
    in that order (None without). CUDA tensors, M = Qp*KB > 0; launches on
    the current stream, no sync."""
    from . import _build

    nqp, kb = pv_bidx.shape
    m, dev = nqp * kb, pv_q.device
    if not 0 < m < 2 ** 31:
        raise ValueError(f"the inversion takes 0 < Qp*KB < 2^31 entries, got {m}")
    args = [_build.ptr(pv_q, "pv_q", pv_q.dtype, device=dev),
            _build.ptr(pv_bidx, "pv_bidx", torch.int32, (nqp, kb), dev),
            _build.ptr(pv_scale_sel, "pv_scale_sel", torch.float32, (nqp, kb), dev)]
    lib = _build.library()
    ws = torch.empty(lib.mst_by_block_ws(nb, m, None), dtype=torch.int32, device=dev)
    lq = torch.empty((m, 128), dtype=pv_q.dtype, device=dev)
    lss = None if pv_scale_sel is None else torch.empty(m, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.mst_bm_gather_prep(_DTYPE_CODE[pv_q.dtype], *args, ws.data_ptr(),
                                    lq.data_ptr(), None if lss is None else lss.data_ptr(),
                                    nqp, kb, nb, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "invert_previous")
    profiling.count(INVERSIONS)
    return ws, lq, lss


def blockmax_scan_gather(q, db, n_valid: int, pv_q, pv_bidx, scales=None,
                         pv_scale_sel=None):
    """(BM [Q, Npad/128], prev [Qp, KB*128]) float32 (module docstring).
    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    version."""
    _validate(q, db, pv_q, pv_bidx, scales, pv_scale_sel)
    if q.device.type == "cpu":
        return blockmax_scan_gather_plain(q, db, n_valid, pv_q, pv_bidx, scales,
                                          pv_scale_sel)
    from . import _build

    if db.dtype not in _DTYPE_CODE:
        raise TypeError(f"bm_gather kernel takes bf16 or int8, got {db.dtype}")
    nq, npad = q.shape[0], db.shape[0]
    nqp, kb = pv_bidx.shape
    nb = npad // BLOCK
    dev = q.device
    args = [_build.ptr(q, "q", db.dtype, device=dev),
            _build.ptr(db, "db", db.dtype, device=dev),
            _build.ptr(scales, "scales", torch.float32, (npad,), dev)]
    _build.ptr(pv_q, "pv_q", db.dtype, device=dev)
    bm = torch.empty((nq, nb), dtype=torch.float32, device=dev)
    prev = torch.empty((nqp, kb * BLOCK), dtype=torch.float32, device=dev)
    if nq == 0 and (nqp == 0 or kb == 0):
        return bm, prev
    ws = lq = lss = None
    if nqp * kb:
        ws, lq, lss = invert_previous(pv_q, pv_bidx, nb, pv_scale_sel)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):       # the launch and its smem attribute: q's card
        rc = _build.library().mst_bm_gather(
            _DTYPE_CODE[db.dtype], *args, bm.data_ptr(), nq, nb, int(n_valid),
            *launch_geometry(q, nb), ptr(ws), ptr(lq), ptr(lss), prev.data_ptr(), nqp, kb,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "blockmax_scan_gather")
    profiling.count(LAUNCHES)
    return bm, prev


def fused_topk_step(q, db, n_valid: int, k: int, carry, scales=None):
    """One step of the two-batch pipelined exact scan.

    Runs this batch's phase A and the previous batch's phase C in one
    launch, then this batch's phase B and the previous batch's final top-k.
    carry is None on the first call, whose results are all -inf / -1 (there
    is no previous batch); after that, the carry the previous call returned.
    The batch size stays constant; there is no length filter (fused_topk
    serves mincov scans). Call once more with any batch to drain the last
    results.

    Returns ((v [Q, k] float32, idx [Q, k] int64) of the PREVIOUS batch,
    new carry {"q", "bidx", "scale_sel"}). Per batch the results equal
    fused_topk's bit for bit: the same kernel arithmetic and the same
    selection.
    """
    if carry is None:
        kb0 = min(k + 1, db.shape[0] // BLOCK) + 1
        carry = {"q": torch.zeros_like(q),
                 "bidx": torch.full((q.shape[0], kb0), -1, dtype=torch.int32,
                                    device=q.device),
                 "scale_sel": None if scales is None else torch.ones(
                     (q.shape[0], kb0), dtype=torch.float32, device=q.device)}
    if carry["q"].shape != q.shape:
        raise ValueError(f"batch size must stay constant: {tuple(carry['q'].shape)} "
                         f"then {tuple(q.shape)}")
    bm, prev = blockmax_scan_gather(q, db, n_valid, carry["q"], carry["bidx"], scales,
                                    carry["scale_sel"])
    bidx, scale_sel = phase_b(bm, n_valid, k, scales)
    v, idx = final_topk(prev, carry["bidx"], k)
    new_carry = {"q": q, "bidx": bidx, "scale_sel": scale_sel}
    return (v, idx), new_carry
