"""Exact top-k inner-product search by block-max cover (phases A, B, C).

The orchestration of the JAX package's `fused_topk`:

Phase A (CUDA kernel, ops/blockmax.py): one pass over the DB that writes
    only the per-128-row block maxima BM [Q, NB].
Phase B (plain torch): the top-(k+1) blocks of each query by BM, plus the
    block that straddles n_valid. Cover argument: if a true top-k row's
    block were not among the top-k blocks by max, then >= k blocks would
    each hold a larger row. The straddling block may carry a max inflated
    by padding rows, which can displace at most one true block, so phase B
    takes k+1 blocks and force-includes the straddling one (as -1 in its
    top-(k+1) slot when already selected, so no row is reported twice).
Phase C (CUDA kernel, ops/gather.py): rescore every row of the selected
    blocks with exact masking, then the final top-k.

Phases A and C compute a row's score through one device routine, so the
cover is exact: results are the exact top-k of the stored-precision scores
(for int8, of the quantised scores). CPU tensors run the kernels' plain
versions, which compute the same contract.
"""

from __future__ import annotations

import torch

from .blockmax import blockmax_scan
from .gather import gather_block_scores
from .topk import BLOCK


def select_blocks(bm, n_valid: int, k: int):
    """Phase B: bidx [Q, KB] int32 with KB = min(k+1, NB) + 1, -1 where the
    straddling block was already selected."""
    qn, nb = bm.shape
    straddle = min(n_valid // BLOCK, nb - 1)
    _, top = torch.topk(bm, min(k + 1, nb), dim=1)
    top = torch.where(top == straddle, -1, top)
    bidx = torch.cat([top, top.new_full((qn, 1), straddle)], dim=1)
    return bidx.to(torch.int32).contiguous()


def fused_topk(q, db, n_valid: int, k: int, tlen=None, qlen=None,
               mincov: float = 0.0, use_len: bool = False, scales=None):
    """Exact top-k inner-product search with the fused scan.

    q [Q, 128] and db [Npad, 128] bf16 or int8 (Npad % 128 == 0, rows >=
    n_valid are padding); tlen [Npad] / qlen [Q] float32 target and query
    lengths for the mincov channel (use_len=True); scales [Npad] float32
    block-uniform dequantisation scales for an int8 DB (`quantize_blocks`).
    Returns (scores [Q, k] float32, indices [Q, k] int64), descending;
    masked or padded entries carry -inf / -1.
    """
    tl = qcap = None
    if use_len:
        # tl = tlen*mincov and qcap = qlen, so the kernels' tl <= qcap is the
        # reference's qlen >= tlen*mincov bit for bit (dividing qlen by
        # mincov instead disagrees at f32 coverage boundaries)
        cov = torch.tensor(mincov, dtype=torch.float32, device=q.device)
        tl = (tlen.to(torch.float32) * cov).contiguous()
        qcap = qlen.to(torch.float32).contiguous()

    bm = blockmax_scan(q, db, n_valid, tl, qcap, scales)
    bidx = select_blocks(bm, n_valid, k)
    scale_sel = None if scales is None else selected_scales(scales, bidx)
    scores = gather_block_scores(q, db, bidx, n_valid, tl, qcap,
                                 scale_sel=scale_sel)
    return final_topk(scores, bidx, k)


def selected_scales(scales, bidx):
    """scale_sel [Q, KB] float32: the block scale of each selected block
    (from the block-uniform per-row `scales`), 1.0 in padding columns."""
    block_scale = scales.view(-1, BLOCK)[:, 0]
    return torch.where(bidx >= 0, block_scale[bidx.clamp(min=0).long()],
                       1.0).contiguous()


def cover_check(bm, scores, bidx, n_valid: int) -> tuple[int, int]:
    """The invariant the cover argument rests on, counted: for each selected
    column whose block lies wholly below n_valid, the max over the block's
    128 phase-C scores (NEG_CAP where masked; int8 with the block scale
    applied, as `scale_sel` does) equals BM[q, b] exactly. Columns where
    phase C keeps no row carry each phase's own sentinel (int8 phase A: the
    masked integer times the scale) and are not compared. Returns
    (columns compared, columns that differ)."""
    qn, kb = bidx.shape
    b = bidx.long()
    cmax = scores.view(qn, kb, BLOCK).amax(dim=2)
    cmp = (b >= 0) & ((b + 1) * BLOCK <= n_valid) & (cmax > -3.0e38)
    differ = cmp & (cmax != torch.gather(bm, 1, b.clamp(min=0)))
    return int(cmp.sum()), int(differ.sum())


def final_topk(scores, bidx, k: int):
    """The top-k rows of phase C's scores [Q, KB*128] over the blocks bidx
    [Q, KB]: (v [Q, k] float32, idx [Q, k] int64), -inf / -1 where fewer
    than k rows are found (NEG_CAP sentinels do not count)."""
    qn = scores.shape[0]
    kk = min(k, scores.shape[1])
    v, sel = torch.topk(scores, kk, dim=1)
    idx = torch.gather(bidx.long(), 1, sel // BLOCK) * BLOCK + sel % BLOCK
    found = v > -3.0e38
    v = torch.where(found, v, float("-inf"))
    idx = torch.where(found, idx, -1)
    if kk < k:
        v = torch.cat([v, v.new_full((qn, k - kk), float("-inf"))], dim=1)
        idx = torch.cat([idx, idx.new_full((qn, k - kk), -1)], dim=1)
    return v, idx
