"""Plain exact top-k scans, the references of the port's scans.

- `int8_topk`: inner products of int8 queries with int8 DB rows, each
  dequantised by the query's row scale and the DB row's block scale,
  exact (integer dot products, then float64), top-k by value.
- `bf16_topk`: inner products of bf16-rounded unit queries with bf16 DB
  rows, in float64, rows whose length fails the coverage test masked.

Both scan the rows in chunks and merge, so that they fit beside the DB on
the card. `normalize_rows` and `quantize_rows` restate the formulas the
search applies to its inputs (unit rows in float32, symmetric int8 with
one scale a row), so the reference derives the same operands itself.
"""

from __future__ import annotations

import numpy as np
import torch

NEG = float("-inf")


def normalize_rows(x: np.ndarray) -> np.ndarray:
    """Unit rows, float32: x / max(|x|, 1e-12)."""
    x = np.asarray(x, np.float32)
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return (x / np.maximum(n, 1e-12)).astype(np.float32)


def quantize_rows(x: np.ndarray, levels: int = 127):
    """Symmetric per-row quantisation to [-levels, levels]: (q int8, scales f32)."""
    x = np.asarray(x, np.float32)
    a = np.max(np.abs(x), axis=1)
    s = np.where(a > 0, a / np.float32(levels), 1.0).astype(np.float32)
    q = np.clip(np.rint(x / s[:, None]), -levels, levels).astype(np.int8)
    return q, s


def _merge(vals, ids, v, i, k):
    av, ai = torch.cat([vals, v], 1), torch.cat([ids, i], 1)
    top, sel = torch.topk(av, min(k, av.shape[1]), dim=1)
    return top, torch.gather(ai, 1, sel)


def _finish(vals, ids, k):
    if vals.shape[1] < k:
        pad = k - vals.shape[1]
        vals = torch.cat([vals, vals.new_full((vals.shape[0], pad), NEG)], 1)
        ids = torch.cat([ids, ids.new_full((ids.shape[0], pad), -1)], 1)
    ids = torch.where(torch.isfinite(vals), ids, -1)
    return vals.cpu().numpy(), ids.cpu().numpy()


def int8_rows(rows8: torch.Tensor, levels: int) -> tuple[torch.Tensor, float]:
    """DB rows as float32 integers on [-levels, levels], and the factor that
    multiplies their block scale: the rows themselves at 127 levels, else
    requantised from int8 (the lower-precision control)."""
    r = rows8.to(torch.float32)
    if levels == 127:
        return r, 1.0
    return torch.clamp(torch.round(r * (levels / 127.0)), -levels, levels), 127.0 / levels


@torch.no_grad()
def int8_topk(q8: np.ndarray, qs: np.ndarray, rows8: torch.Tensor, bscale: torch.Tensor,
              n_valid: int, k: int, levels: int = 127, chunk: int = 1 << 20):
    """Exact top-k of q8 [S, 128] int8 (row scales qs [S]) against rows8
    [>= n_valid, 128] int8 with per-row block-uniform scales bscale, over
    rows [0, n_valid). Products are summed as float32 integers (exact:
    every partial sum is below 2^24) and dequantised in float64. Returns
    (scores [S, k] float64, ids [S, k] int64), descending,
    -inf / -1 past the valid rows. levels < 127 computes the same at that
    many levels, queries and rows alike (the control)."""
    dev = rows8.device
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("exact integer sums need torch.backends.cuda.matmul.allow_tf32 off")
    qf = torch.from_numpy(q8).to(dev, torch.float32)
    qsc = torch.from_numpy(qs).to(dev, torch.float64)
    vals = torch.full((qf.shape[0], 0), NEG, dtype=torch.float64, device=dev)
    ids = torch.zeros((qf.shape[0], 0), dtype=torch.int64, device=dev)
    for c0 in range(0, n_valid, chunk):
        c1 = min(c0 + chunk, n_valid)
        r, f = int8_rows(rows8[c0:c1], levels)
        s = (qf @ r.T).to(torch.float64) * (bscale[c0:c1].to(torch.float64) * f)[None, :]
        s = s * qsc[:, None]
        v, i = torch.topk(s, min(k, c1 - c0), dim=1)
        vals, ids = _merge(vals, ids, v, i + c0, k)
    return _finish(vals, ids, k)


@torch.no_grad()
def int8_scores_of(q8: np.ndarray, qs: np.ndarray, rows8: torch.Tensor, bscale: torch.Tensor,
                   n_valid: int, ids: np.ndarray) -> np.ndarray:
    """The exact dequantised score [S, k] float64 of each given id, -inf
    where an id lies outside [0, n_valid)."""
    dev = rows8.device
    local = torch.from_numpy(np.asarray(ids, np.int64)).to(dev)
    ok = (local >= 0) & (local < n_valid)
    li = torch.where(ok, local, 0)
    r = rows8[li].to(torch.float32)                                   # [S, k, 128]
    qf = torch.from_numpy(q8).to(dev, torch.float32)
    dot = torch.einsum("sd,skd->sk", qf, r).to(torch.float64)
    s = dot * bscale[li].to(torch.float64) * torch.from_numpy(qs).to(dev, torch.float64)[:, None]
    return torch.where(ok, s, NEG).cpu().numpy()


def bf16_ambiguity(q: np.ndarray, tol: float) -> np.ndarray:
    """[S, D] float64: for each component of the unit queries q (float32)
    that lies within `tol` of the midpoint between two bf16 values, the
    distance between those two values; 0 elsewhere. Such a component's
    bf16 rounding is not determined by the float32 value to within `tol`
    (the reference's own float32 uncertainty): a program whose float32
    query differs from the reference's by less than `tol` may round it
    either way."""
    qt = torch.from_numpy(np.asarray(q, np.float32))
    b = qt.to(torch.bfloat16)
    bits = b.view(torch.int16)
    toward = torch.sign(qt - b.to(torch.float32)) * torch.sign(b.to(torch.float32))
    alt = torch.where(toward >= 0, bits + 1, bits - 1).view(torch.bfloat16).to(torch.float64)
    bd = b.to(torch.float64)
    mid = 0.5 * (bd + alt)
    amb = ((qt.to(torch.float64) - mid).abs() <= tol) & (bd != 0)
    return torch.where(amb, (alt - bd).abs(), 0.0).numpy()


def bf16_slack(amb: np.ndarray, rows_bf16: torch.Tensor, ids: np.ndarray) -> np.ndarray:
    """How far the ambiguous roundings (bf16_ambiguity, [S, D]) can move the
    score of each given id's row: sum_j amb_j |r_j|, [S, k] (0 for id -1)."""
    dev = rows_bf16.device
    ids = np.asarray(ids, np.int64)
    li = torch.from_numpy(np.clip(ids, 0, rows_bf16.shape[0] - 1)).to(dev)
    r = rows_bf16[li].to(torch.float64).abs()
    s = torch.einsum("sd,skd->sk", torch.from_numpy(amb).to(dev), r).cpu().numpy()
    return np.where(ids >= 0, s, 0.0)


def coverage_mask(qlen, tlen, mincov: float):
    """Keep a target iff qlen >= tlen * mincov, in float32 (dbsearch.py:76)."""
    tl = tlen.to(torch.float32) * torch.tensor(mincov, dtype=torch.float32)
    return qlen.to(torch.float32)[:, None] >= tl[None, :].to(qlen.device)


@torch.no_grad()
def bf16_topk(q: np.ndarray, rows_bf16: torch.Tensor, tlen: torch.Tensor, qlen: np.ndarray,
              mincov: float, k: int, chunk: int = 1 << 18):
    """Exact top-k of unit queries q [S, 128] float32, rounded to bf16,
    against bf16 rows [N, 128] (already unit rows rounded), in float64,
    with the coverage mask. Returns (scores [S, k] float64, ids [S, k])."""
    dev = rows_bf16.device
    qb = torch.from_numpy(q).to(dev).to(torch.bfloat16).to(torch.float64)
    ql = torch.from_numpy(np.asarray(qlen, np.float32)).to(dev)
    vals = torch.full((qb.shape[0], 0), NEG, dtype=torch.float64, device=dev)
    ids = torch.zeros((qb.shape[0], 0), dtype=torch.int64, device=dev)
    n = rows_bf16.shape[0]
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        s = qb @ rows_bf16[c0:c1].to(torch.float64).T
        s = torch.where(coverage_mask(ql, tlen[c0:c1], mincov), s, NEG)
        v, i = torch.topk(s, min(k, c1 - c0), dim=1)
        vals, ids = _merge(vals, ids, v, i + c0, k)
    return _finish(vals, ids, k)


@torch.no_grad()
def bf16_scores_of(q: np.ndarray, rows_bf16: torch.Tensor, tlen: torch.Tensor,
                   qlen: np.ndarray, mincov: float, ids: np.ndarray) -> np.ndarray:
    """The masked bf16 score [S, k] float64 of each given id (-inf where the
    id is out of range or fails the coverage test)."""
    dev = rows_bf16.device
    n = rows_bf16.shape[0]
    li = torch.from_numpy(np.asarray(ids, np.int64)).to(dev)
    ok = (li >= 0) & (li < n)
    li = torch.where(ok, li, 0)
    qb = torch.from_numpy(q).to(dev).to(torch.bfloat16).to(torch.float64)
    s = torch.einsum("sd,skd->sk", qb, rows_bf16[li].to(torch.float64))
    tl = tlen[li].to(torch.float32) * torch.tensor(mincov, dtype=torch.float32)
    keep = torch.from_numpy(np.asarray(qlen, np.float32)).to(dev)[:, None] >= tl
    return torch.where(ok & keep, s, NEG).cpu().numpy()
