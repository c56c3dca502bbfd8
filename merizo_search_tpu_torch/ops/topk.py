"""Plain exact top-k scan and the int8 quantisers.

`topk_scan` is the exact inner-product top-k as one matmul, a mask and
`torch.topk` per DB chunk: the oracle the fused scan is held against and the
engine's f32 path (the JAX package likewise leaves f32 to XLA). Length
masking follows the reference (dbsearch.py:76: keep a target iff
len(query) >= len(target) * mincov), with -inf scores for masked entries.

`quantize_rows` / `quantize_blocks` are numpy copies of the JAX package's
quantisers, so DBs and queries quantise to the same bytes in both packages.
`merge_partials` merges the stream mode's per-superblock top-k;
`query_operands` puts a query batch on the device as the scans take it.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 128  # rows per selection block of the fused scan (= int8 scale block)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=eps)


def topk_scan(q: torch.Tensor, db: torch.Tensor, n_valid: int, k: int,
              tlen: torch.Tensor | None = None, qlen: torch.Tensor | None = None,
              mincov: float = 0.0, chunk: int = 1 << 20):
    """Exact top-k inner-product search, scored in float32.

    q [Q, D], db [Npad, D] (rows >= n_valid are padding), tlen [Npad] and
    qlen [Q] f32 for the mincov filter (both or neither). Returns
    (scores [Q, k] f32, indices [Q, k] int64), descending; masked or padded
    entries carry -inf / -1.
    """
    qf = q.to(torch.float32)
    qn = q.shape[0]
    vals = torch.full((qn, 0), float("-inf"), device=q.device)
    idxs = torch.zeros((qn, 0), dtype=torch.int64, device=q.device)
    if tlen is not None:
        # a CPU 0-dim tensor: a CUDA op reads it as a kernel argument, so
        # no host-to-device copy (and no hidden sync) per call
        cov = torch.tensor(mincov, dtype=torch.float32)
    for c0 in range(0, db.shape[0], chunk):
        blk = db[c0:c0 + chunk].to(torch.float32)
        s = qf @ blk.T
        gi = torch.arange(c0, c0 + blk.shape[0], device=q.device)
        s = torch.where(gi[None, :] < n_valid, s, float("-inf"))
        if tlen is not None:
            tl = tlen[c0:c0 + chunk] * cov
            s = torch.where(qlen[:, None] >= tl[None, :], s, float("-inf"))
        av = torch.cat([vals, s], dim=1)
        ai = torch.cat([idxs, gi[None, :].expand(qn, -1)], dim=1)
        vals, sel = torch.topk(av, min(k, av.shape[1]), dim=1)
        idxs = torch.gather(ai, 1, sel)
    if vals.shape[1] < k:
        pad = k - vals.shape[1]
        vals = torch.cat([vals, vals.new_full((qn, pad), float("-inf"))], dim=1)
        idxs = torch.cat([idxs, idxs.new_full((qn, pad), -1)], dim=1)
    idxs = torch.where(torch.isfinite(vals), idxs, -1)
    return vals, idxs


def merge_partials(vals: torch.Tensor, idxs: torch.Tensor, k: int):
    """Merge per-superblock partial top-k results: vals / idxs [P, Q, k']
    -> (scores [Q, k], indices [Q, k]), one `torch.topk` over [Q, P*k']
    and a gather."""
    p, qn, kk = vals.shape
    av = vals.permute(1, 0, 2).reshape(qn, p * kk)
    ai = idxs.permute(1, 0, 2).reshape(qn, p * kk)
    v, sel = torch.topk(av, min(k, p * kk), dim=1)
    return v, torch.gather(ai, 1, sel)


def quantize_rows(x: np.ndarray):
    """Symmetric per-row int8 quantisation (the query side).

    Returns (q int8 [N,D], scales f32 [N]) with x ~ q * scales[:,None]."""
    x = np.asarray(x, np.float32)
    a = np.max(np.abs(x), axis=1)
    s = np.where(a > 0, a / 127.0, 1.0).astype(np.float32)
    qv = np.clip(np.rint(x / s[:, None]), -127, 127).astype(np.int8)
    return qv, s


def query_operands(q: np.ndarray, dtype: torch.dtype, device):
    """Unit queries [Q, D] f32 on `device` in the scan's storage dtype,
    and for int8 their per-row scales: (q, scales or None)."""
    if dtype == torch.int8:
        q8, qs = quantize_rows(q)
        return torch.from_numpy(q8).to(device), torch.from_numpy(qs).to(device)
    return torch.from_numpy(q).to(device).to(dtype), None


def quantize_blocks(x: np.ndarray, block: int = BLOCK):
    """Symmetric int8 quantisation with one shared scale per `block`
    consecutive rows — the DB-side format of the fused int8 scan.

    With a block-uniform scale the int32 block max commutes with
    dequantisation, so phase A reduces raw int32 scores and scales only the
    block maxima. Per-row scales (`quantize_rows`) would silently corrupt
    the block selection. Returns (q int8 [N,D], scales f32 [N]) with scales
    constant within each block; a ragged tail shares one scale."""
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    nfull = (n // block) * block
    a = (np.abs(x[:nfull]).reshape(-1, block * x.shape[1]).max(axis=1)
         if nfull else np.zeros((0,), np.float32))
    if n != nfull:  # ragged tail shares one scale
        a = np.concatenate([a, [np.max(np.abs(x[nfull:]), initial=0.0)]])
    sb = np.where(a > 0, a / 127.0, 1.0).astype(np.float32)
    s = np.repeat(sb, block)[:n]
    qv = np.clip(np.rint(x / s[:, None]), -127, 127).astype(np.int8)
    return qv, s
