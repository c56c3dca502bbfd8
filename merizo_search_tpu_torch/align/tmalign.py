"""TM-align-style structural alignment, batched on the device (PyTorch).

The port of the JAX package's batched aligner. A rescoring batch is grouped
into static length buckets, and every pair of a bucket aligns at once:

- initial alignments by exhaustive gapless threading (every offset, batched
  Kabsch + TM-score), by Needleman-Wunsch over the CA-geometry
  secondary-structure match matrix (TM-align's get_initial_ss), and by the
  superposition of the best gapless fragment pair (get_initial_local);
- iterative refinement alternating a TM-score-optimal superposition search
  over the current alignment with NW dynamic programming (free end gaps) on
  the 1/(1+d^2/d0^2) similarity matrix, as a bank of six chains per pair
  (each init x gap penalty in {-0.6, 0}) that keeps the best basin;
- the DP runs as an anti-diagonal wavefront: 2L steps of [rows, L+1] tensor
  operations and a 2L-step traceback, over every (pair, chain) row of the
  bucket chunk at once.

Where the JAX package vmaps, the port batches explicitly: pairs, refine
chains and superposition seeds are tensor dimensions, the per-row lengths nx
and ny and the DP gap are [rows] tensors, and `lax.map`'s chunks are kept
(16 fragment combos, 64 threading offsets a step). Nothing inside the
loops reads a device value on the host: everything data-dependent goes
through `torch.where`, so the device runs the loops without a sync.

Scores follow TM-score conventions: d0(L) = 1.24 (L-15)^(1/3) - 1.8, at
least 0.5; qtm normalises by the query's length, ttm by the target's. The
cube root is a float64 `pow` with the exponent float32(1/3), rounded to
float32: it equals XLA's float32 `cbrt` for every integer length 0-2099
but 1577, where it is one ulp away.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..device import resolve_device
from .kabsch import kabsch, transform
from .seqid import seq_identity_count

logger = logging.getLogger(__name__)

GAP = -0.6
NEG = -1e4
_THIRD = float(np.float32(1.0 / 3.0))
# jnp.linspace(0, 1, 16) in float32, bit for bit (torch.linspace differs in
# the last ulp of 6 of its 16 values, which moves the fragment start grid)
_LIN16 = np.arange(16, dtype=np.float32) * np.float32(1.0 / 15.0)


def tm_d0(ln) -> torch.Tensor:
    """TM-score normalisation distance of length(s) `ln` (float32)."""
    ln = torch.as_tensor(ln, dtype=torch.float32)
    c = torch.pow(torch.clamp(ln - 15.0, min=1e-3).double(), _THIRD).float()
    d0 = 1.24 * c - 1.8
    return torch.where(ln <= 21, 0.5, torch.clamp(d0, min=0.5))


def _d0_search(d0: torch.Tensor) -> torch.Tensor:
    return torch.clamp(d0, 4.5, 8.0)


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances of broadcast point sets [..., 3], summed x, y, z in
    that order."""
    d = a[..., 0] - b[..., 0]
    d2 = d * d
    d = a[..., 1] - b[..., 1]
    d2 += d * d
    d = a[..., 2] - b[..., 2]
    d2 += d * d
    return d2


# ---------------------------------------------------------------------------
# Needleman-Wunsch on anti-diagonals

def _dp_align(S: torch.Tensor, nx: torch.Tensor, ny: torch.Tensor,
              gap=GAP) -> torch.Tensor:
    """Semi-global NW (free end gaps) over S [R, L, L], one alignment per row
    r; cells outside [0, nx[r]) x [0, ny[r]) carry NEG. nx, ny: [R] int64;
    gap: a float or an [R] float32 tensor, on S's device. Returns ali [R, L]
    int64 (y index per x position, -1 for unaligned).

    H[r, k, i] holds H(i, k - i) for the diagonal k = i + j. It starts as
    the similarity that cell adds on a diagonal move (S skewed), and step k
    overwrites its own diagonal with the DP values, so each anti-diagonal of
    S is read once and no second [R, 2L+1, L+1] buffer is needed. Each
    row's maxima and pointers equal JAX's bit for bit: the same float32
    sums, the same comparisons in the same order. Cells off the DP matrix
    (i or j past L) hold values that no valid cell reads.

    The pointer of a cell is stored as the step back to its predecessor in
    the flattened H (0 on the boundary, where the traceback stops), so a
    traceback step is one gather and one subtraction.
    """
    R, L = S.shape[0], S.shape[-1]
    Lp, K = L + 1, 2 * L + 1
    dev = S.device
    i_idx = torch.arange(Lp, device=dev)
    k_idx = torch.arange(K, device=dev)
    src = ((i_idx - 1).clamp(0, L - 1)[None, :] * L
           + (k_idx[:, None] - i_idx[None, :] - 1).clamp(0, L - 1))
    H = torch.index_select(S.reshape(R, L * L), 1, src.reshape(-1)).view(R, K, Lp)
    # column i = 0: the boundary (free end gaps) on the diagonals k <= L
    H[:, :, 0] = torch.where(k_idx <= L, 0.0, NEG * 2)
    ptr = torch.zeros((R, K, Lp), dtype=torch.int16, device=dev)
    step_diag, step_up, step_left = 2 * Lp + 1, Lp + 1, Lp
    d_diag = torch.full((), step_diag, dtype=torch.int16, device=dev)
    d_up = torch.full((), step_up, dtype=torch.int16, device=dev)
    d_left = torch.full((), step_left, dtype=torch.int16, device=dev)
    if isinstance(gap, torch.Tensor):
        gap_col = gap.to(torch.float32).reshape(-1, 1)
    else:
        gap_col = torch.full((1, 1), gap, dtype=torch.float32, device=dev)
    h_before = torch.full((R, Lp), NEG * 2, device=dev)       # the diagonal k = -1

    for k in range(1, K):
        h1 = H[:, k - 1]
        h2 = H[:, k - 2] if k >= 2 else h_before
        g = h1 + gap_col                     # up at i + 1, left at i
        cur = H[:, k, 1:]
        diag = h2[:, :-1] + cur
        torch.maximum(diag, torch.maximum(g[:, :-1], g[:, 1:]), out=cur)
        torch.where(cur == diag, d_diag, torch.where(cur == g[:, :-1], d_up, d_left),
                    out=ptr[:, k, 1:])
        if k <= L:                           # the boundary cell (i, j) = (k, 0)
            H[:, k, k].fill_(0.0)
    # the boundary cells (k, 0) stop the traceback
    ptr.view(R, K * Lp).index_fill_(1, torch.arange(1, L + 1, device=dev) * (Lp + 1), 0)

    # best end on row i = nx (any j <= ny) or column j = ny (any i <= nx)
    base = torch.arange(R, device=dev)[:, None] * (K * Lp)
    rng = i_idx[None, :]
    nxc, nyc = nx[:, None], ny[:, None]
    Hf = H.view(-1)
    row_vals = torch.where(rng <= nyc, Hf[base + (nxc + rng) * Lp + nxc], NEG * 2)
    col_vals = torch.where(rng <= nxc, Hf[base + (rng + nyc) * Lp + rng], NEG * 2)
    jr = row_vals.argmax(1)
    ic = col_vals.argmax(1)
    use_row = row_vals.amax(1) >= col_vals.amax(1)
    i0 = torch.where(use_row, nx, ic)
    j0 = torch.where(use_row, jr, ny)

    # traceback: 2L steps, each a gather of the pointer and a step back
    idx = base[:, 0] + (i0 + j0) * Lp + i0
    pf = ptr.view(-1)
    trail = torch.empty((2 * L, R), dtype=torch.int16, device=dev)
    for s in range(2 * L):
        torch.index_select(pf, 0, idx, out=trail[s])
        idx.sub_(trail[s])
    t = trail.long()
    take = t == step_diag
    di = (take | (t == step_up)).long()
    dj = (take | (t == step_left)).long()
    i_at = i0[None, :] - (torch.cumsum(di, 0) - di)
    j_at = j0[None, :] - (torch.cumsum(dj, 0) - dj)
    ali = torch.full((R, L + 1), -1, dtype=torch.int64, device=dev)
    ali.scatter_(1, torch.where(take, i_at - 1, L).T, (j_at - 1).T)
    return ali[:, :L]


# ---------------------------------------------------------------------------
# TM-score superposition search

def _seed_masks(w: torch.Tensor) -> torch.Tensor:
    """Sub-fragments of the aligned set by aligned rank: full, first half,
    second half, middle half (the static-shape stand-in for TM-score's
    L_init schedule). w [..., L] -> [..., 4, L]."""
    rank = torch.cumsum(w, -1) - 1
    n = w.sum(-1, keepdim=True)
    half = n / 2.0
    quarter = n / 4.0
    seeds = torch.stack([
        w,
        w * (rank < half),
        w * (rank >= half),
        w * ((rank >= quarter) & (rank < 3 * quarter)),
    ], -2)
    # a seed with < 3 points falls back to the full set
    ok = seeds.sum(-1, keepdim=True) >= 3
    return torch.where(ok, seeds, w[..., None, :])


def _tm_iterate(x, yj, w, seed, d0, d0s, lnorm, n_iter):
    """Iterative superposition refinement from each seed mask.

    x, yj [N, 1, L, 3]; w [N, 1, L]; seed [N, S, L]; d0, d0s, lnorm [N, 1].
    Returns (best_score [N, S], best_R [N, S, 3, 3], best_t [N, S, 3])."""
    N, S = seed.shape[0], seed.shape[1]
    dev = seed.device
    dd = (d0 * d0)[..., None]
    cuts = [(c * c)[..., None] for c in (d0s, d0s + 1.0, d0s + 2.5)]
    sel = seed
    best_score = torch.full((N, S), -1.0, device=dev)
    best_r = torch.eye(3, device=dev).expand(N, S, 3, 3)
    best_t = torch.zeros((N, S, 3), device=dev)
    for _ in range(n_iter):
        r, t = kabsch(x, yj, sel)
        d2 = _sq_dist(transform(r, t, x), yj)
        score = (w / (1.0 + d2 / dd)).sum(-1) / lnorm
        better = score > best_score
        best_score = torch.where(better, score, best_score)
        best_r = torch.where(better[..., None, None], r, best_r)
        best_t = torch.where(better[..., None], t, best_t)
        # next selection: aligned pairs within d0_search; widen until >= 4
        s1, s2, s3 = (w * (d2 < c) for c in cuts)
        sel = torch.where(s1.sum(-1, keepdim=True) >= 4, s1,
                          torch.where(s2.sum(-1, keepdim=True) >= 4, s2,
                                      torch.where(s3.sum(-1, keepdim=True) >= 4, s3, w)))
    return best_score, best_r, best_t


def tm_score_search(x, y, ali, d0, lnorm, n_iter: int = 8):
    """Best TM-score superposition of each row's alignment.

    x, y [N, L, 3]; ali [N, L] (y index or -1); d0, lnorm [N].
    Returns (score [N], R [N, 3, 3], t [N, 3])."""
    N, L = ali.shape
    rows = torch.arange(N, device=ali.device)
    w = (ali >= 0).float()
    yj = y[rows[:, None], ali.clamp(0, L - 1)]
    seeds = _seed_masks(w)
    scores, rs, ts = _tm_iterate(x[:, None], yj[:, None], w[:, None], seeds,
                                 d0[:, None], _d0_search(d0)[:, None], lnorm[:, None],
                                 n_iter)
    b = scores.argmax(1)
    return scores[rows, b], rs[rows, b], ts[rows, b]


# ---------------------------------------------------------------------------
# initial alignment: secondary structure

def _assign_ss(c: torch.Tensor, nres: torch.Tensor) -> torch.Tensor:
    """CA-geometry secondary structure (TM-align's make_sec; the native
    backend's assign_ss rules): window distances around residue i decide
    helix (1), strand (2), turn (3), else coil (0). Positions outside
    [2, nres-3) are coil. c [P, L, 3], nres [P] -> [P, L] int8."""
    L = c.shape[1]
    i = torch.arange(L, device=c.device)

    def d(a, b):
        return torch.sqrt(_sq_dist(c[:, (i + a).clamp(0, L - 1)],
                                   c[:, (i + b).clamp(0, L - 1)]))

    d13, d14, d15 = d(-2, 0), d(-2, 1), d(-2, 2)
    d24, d25, d35 = d(-1, 1), d(-1, 2), d(0, 2)
    helix = (((d15 - 6.37).abs() < 2.1) & ((d14 - 5.18).abs() < 2.1) &
             ((d25 - 5.18).abs() < 2.1) & ((d13 - 5.45).abs() < 2.1) &
             ((d24 - 5.45).abs() < 2.1) & ((d35 - 5.45).abs() < 2.1))
    strand = (((d15 - 13.0).abs() < 1.42) & ((d14 - 10.4).abs() < 1.42) &
              ((d25 - 10.4).abs() < 1.42) & ((d13 - 6.1).abs() < 1.42) &
              ((d24 - 6.1).abs() < 1.42) & ((d35 - 6.1).abs() < 1.42))
    code = torch.where(helix, 1, torch.where(strand, 2, torch.where(d15 < 8.0, 3, 0)))
    valid = (i[None, :] >= 2) & (i[None, :] + 2 < nres[:, None])
    return torch.where(valid, code, 0).to(torch.int8)


def _pair_mask(xm, ym):
    return (xm[:, :, None] > 0) & (ym[:, None, :] > 0)


def _ss_init(x, y, xm, ym, nx, ny):
    """Initial alignment by NW over the secondary-structure match matrix
    (match 1.0, mismatch 0.0, gap -1.0): the init that rescues pairs whose
    best superposition shares no long gapless diagonal (TM-align's
    get_initial_ss)."""
    ssx = _assign_ss(x, nx)
    ssy = _assign_ss(y, ny)
    S = (ssx[:, :, None] == ssy[:, None, :]).float()
    S = S.masked_fill_(~_pair_mask(xm, ym), NEG)
    return _dp_align(S, nx, ny, gap=-1.0)


def _similarity(xt, y, xm, ym, d0):
    """S [P, L, L] = 1/(1 + d^2/d0^2) of the superposed x against y, NEG off
    the chains."""
    d2 = _sq_dist(xt[:, :, None, :], y[:, None, :, :])
    S = 1.0 / (1.0 + d2 / (d0 * d0)[:, None, None])
    return S.masked_fill_(~_pair_mask(xm, ym), NEG)


# ---------------------------------------------------------------------------
# initial alignment: local fragment superposition

def _fragment_init(x, y, xm, ym, nx, ny, d0):
    """Superpose the best gapless fragment pair (16x16 start grid, window
    min(lmin/2, 20)) scored against half-sampled targets, then NW on the
    distance matrix under that frame: TM-align's get_initial_local analogue
    (the shape of the native backend's init_fragment). Rescues pairs whose
    only common core is one compact motif. The 256 combos of a pair run 16
    at a time (JAX's lax.map chunk), over every pair of the batch."""
    P, L = x.shape[0], x.shape[1]
    dev = x.device
    FL = 20
    rows = torch.arange(P, device=dev)
    fl = torch.clamp(torch.minimum(nx, ny) // 2, 5, FL)
    k = torch.arange(FL, device=dev)
    wk = (k[None, :] < fl[:, None]).float()
    lin = torch.from_numpy(_LIN16).to(dev)
    sx = (lin[None, :] * torch.clamp(nx - fl, min=0)[:, None].float()).to(torch.int64)
    sy = (lin[None, :] * torch.clamp(ny - fl, min=0)[:, None].float()).to(torch.int64)
    yh = y[:, ::2]                    # half-sampled coarse score targets
    yh_valid = torch.arange(yh.shape[1], device=dev)[None, :] * 2 < ny[:, None]
    xrow = torch.arange(L, device=dev)[None, :] < nx[:, None]
    dd = (d0 * d0)[:, None, None]

    scs, rs, ts = [], [], []
    yj = y[rows[:, None, None], (sy[:, :, None] + k).clamp(0, L - 1)]        # [P, 16, FL, 3]
    wy = (sy[:, :, None] + k < ny[:, None, None])
    for a in range(16):               # combos (sx[a], sy[0..15])
        ix = sx[:, a, None] + k                                              # [P, FL]
        xi = x[rows[:, None], ix.clamp(0, L - 1)][:, None]                   # [P, 1, FL, 3]
        w = wk[:, None, :] * (ix < nx[:, None])[:, None, :] * wy
        r, t = kabsch(xi, yj, torch.clamp(w, min=1e-6))
        d2 = _sq_dist(transform(r, t, x[:, None])[:, :, :, None, :], yh[:, None, None, :, :])
        bd = torch.where(yh_valid[:, None, None, :], d2, 1e18).amin(-1)
        scs.append(torch.where(xrow[:, None, :], 1.0 / (1.0 + bd / dd), 0.0).sum(-1))
        rs.append(r)
        ts.append(t)
    bi = torch.cat(scs, 1).argmax(1)
    r_b = torch.cat(rs, 1)[rows, bi]
    t_b = torch.cat(ts, 1)[rows, bi]
    S = _similarity(transform(r_b, t_b, x), y, xm, ym, d0)
    return _dp_align(S, nx, ny)


# ---------------------------------------------------------------------------
# initial alignment: gapless threading

def _threading_init(x, y, nx, ny, d0, lnorm, stride: int = 1):
    """Best gapless offset alignment (TM-align's get_initial analogue), 64
    offsets a step over every pair of the batch."""
    P, L = x.shape[0], x.shape[1]
    dev = x.device
    rows = torch.arange(P, device=dev)
    offsets = torch.arange(-(L - 5), L - 4, stride, device=dev)
    idx = torch.arange(L, device=dev)
    nxc, nyc = nx[:, None, None], ny[:, None, None]
    dd = (d0 * d0)[:, None, None]

    def alis(o):                       # o [C] or [P, C] -> [P, C, L]
        j = idx + o[..., None]
        return torch.where((j >= 0) & (j < nyc) & (idx < nxc), j, -1)

    scores = []
    for c0 in range(0, len(offsets), 64):
        ali = alis(offsets[c0:c0 + 64])
        w = (ali >= 0).float()
        yj = y[rows[:, None, None], ali.clamp(0, L - 1)]
        enough = w.sum(-1) >= 5
        r, t = kabsch(x[:, None], yj, torch.clamp(w, min=1e-6))
        d2 = _sq_dist(transform(r, t, x[:, None]), yj)
        score = (w / (1.0 + d2 / dd)).sum(-1) / lnorm[:, None]
        scores.append(torch.where(enough, score, -1.0))
    b = torch.cat(scores, 1).argmax(1)
    return alis(offsets[b][:, None])[:, 0]


# ---------------------------------------------------------------------------
# full pairwise alignment

N_CHAINS = 6


def _tmalign_batch(x, xm, y, ym, n_refine: int, n_tm_iter: int) -> dict:
    """Batched TM-align on the tensors' device. x/y [P, L, 3], xm/ym [P, L]
    masks. Returns a dict of [P] tensors qtm, ttm, rmsd, len_ali, and ali
    [P, L].

    The six refine chains of every pair are rows of one batch (row
    p * 6 + c), so each refine step runs one tm_score_search and one DP
    over all of them."""
    P, L = x.shape[0], x.shape[1]
    dev = x.device
    rows = torch.arange(P, device=dev)
    nx = xm.sum(1).long()
    ny = ym.sum(1).long()
    lmin = torch.minimum(nx, ny).float()
    d0_min = tm_d0(lmin)

    # independent refine basins, like the native backend's init list x gap
    # schedule: gapless threading finds the best shared diagonal; the
    # SS-match NW rescues pairs whose superposition has no long gapless
    # diagonal; fragment superposition rescues single-motif cores; the
    # zero-gap chains grow alignments that the open-penalty chains fragment
    thr = _threading_init(x, y, nx, ny, d0_min, lmin)
    ssa = _ss_init(x, y, xm, ym, nx, ny)
    frg = _fragment_init(x, y, xm, ym, nx, ny, d0_min)
    ali = torch.stack([thr, ssa, frg, thr, ssa, frg], 1).reshape(P * N_CHAINS, L)
    x6, y6, xm6, ym6, nx6, ny6, d0_6, lmin6 = (
        v.repeat_interleave(N_CHAINS, 0) for v in (x, y, xm, ym, nx, ny, d0_min, lmin))
    gaps = torch.where(torch.arange(P * N_CHAINS, device=dev) % N_CHAINS < 3, GAP, 0.0)

    best_score = torch.full((P * N_CHAINS,), -1.0, device=dev)
    best_ali = ali
    for _ in range(n_refine):
        score, r, t = tm_score_search(x6, y6, ali, d0_6, lmin6, n_tm_iter)
        better = score > best_score
        best_score = torch.where(better, score, best_score)
        best_ali = torch.where(better[:, None], ali, best_ali)
        S = _similarity(transform(r, t, x6), y6, xm6, ym6, d0_6)
        ali = _dp_align(S, nx6, ny6, gaps)
    # evaluate the last alignment too
    score_last, _, _ = tm_score_search(x6, y6, ali, d0_6, lmin6, n_tm_iter)
    best_ali = torch.where((score_last > best_score)[:, None], ali, best_ali)
    chain_score = torch.maximum(score_last, best_score).view(P, N_CHAINS)
    best = best_ali.view(P, N_CHAINS, L)[rows, chain_score.argmax(1)]

    # qtm and ttm: one search over both normalisations
    tm, _, _ = tm_score_search(torch.cat([x, x]), torch.cat([y, y]), torch.cat([best, best]),
                               torch.cat([tm_d0(nx), tm_d0(ny)]),
                               torch.cat([nx, ny]).float(), n_tm_iter)
    w = (best >= 0).float()
    yj = y[rows[:, None], best.clamp(0, L - 1)]
    r2, t2 = kabsch(x, yj, w)
    d2 = _sq_dist(transform(r2, t2, x), yj)
    rmsd = torch.sqrt((d2 * w).sum(-1) / torch.clamp(w.sum(-1), min=1.0))
    return {"qtm": tm[:P], "ttm": tm[P:], "rmsd": rmsd, "len_ali": w.sum(-1).long(),
            "ali": best}


# ---------------------------------------------------------------------------
# host-facing API

_BUCKETS = (64, 128, 256, 384, 512, 768, 1024, 1536, 2048)

# chains longer than the largest bucket are truncated by this backend; the
# dispatcher (align/__init__.py rescore_pairs) routes such pairs to the
# full-length native backend when it is available
MAX_BUCKET = _BUCKETS[-1]


def _bucket(n):
    for b in _BUCKETS:
        if n <= b:
            return b
    return _BUCKETS[-1]


def _dispatch_cap(b: int) -> int:
    """Pairs per bucket chunk: the JAX package's cap of ~2 GB of [b, b] f32
    S matrices for six chains (21 pairs at b = 2048), kept so that chunks,
    and so results, match it. The port's DP holds more per pair (H and the
    pointers, [2b+1, b+1] each per chain)."""
    return max(1, (1 << 31) // (24 * b * b))


def tmalign_pairs(pairs: list[tuple], fast: bool = False,
                  device: str | torch.device = "cuda") -> list[dict]:
    """Align a list of (query, target) pairs on `device`, where each element
    is a dict with 'coords' [N, 3] float and 'seq' str.

    Returns one dict per pair with keys matching the reference's parsed
    TM-align output: len_ali, rmsd, seq_id, qtm, ttm.
    """
    dev = resolve_device(device)
    n_refine, n_tm_iter = (4, 4) if fast else (10, 8)
    results = [None] * len(pairs)
    groups: dict[int, list[int]] = {}
    for i, (q, t) in enumerate(pairs):
        b = _bucket(max(len(q["coords"]), len(t["coords"])))
        groups.setdefault(b, []).append(i)

    with torch.no_grad():
        for b, all_idxs in sorted(groups.items()):
            cap = _dispatch_cap(b)
            for c0 in range(0, len(all_idxs), cap):
                _align_bucket(pairs, all_idxs[c0:c0 + cap], b, n_refine, n_tm_iter,
                              results, dev)
    return results


def _align_bucket(pairs, idxs, b, n_refine, n_tm_iter, results, dev):
    """Align one bucket-shaped chunk of pairs; writes into results[i]."""
    B = len(idxs)
    x = np.zeros((B, b, 3), np.float32)
    y = np.zeros((B, b, 3), np.float32)
    xm = np.zeros((B, b), np.float32)
    ym = np.zeros((B, b), np.float32)
    for k, i in enumerate(idxs):
        q, t = pairs[i]
        nq, nt = min(len(q["coords"]), b), min(len(t["coords"]), b)
        x[k, :nq] = q["coords"][:nq]
        y[k, :nt] = t["coords"][:nt]
        xm[k, :nq] = 1
        ym[k, :nt] = 1
    out = _tmalign_batch(*(torch.from_numpy(a).to(dev) for a in (x, xm, y, ym)),
                         n_refine, n_tm_iter)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    for k, i in enumerate(idxs):
        q, t = pairs[i]
        n_id = seq_identity_count(q["seq"][:b], t["seq"], out["ali"][k])
        la = int(out["len_ali"][k])
        # structures longer than the bucket are aligned over their first b
        # residues; renormalise the TM-scores by the TRUE chain lengths so
        # truncation can only underestimate (the in-batch score normalises
        # by the truncated length; the native backend aligns full-length)
        qv, tv = float(out["qtm"][k]), float(out["ttm"][k])
        if len(q["coords"]) > b:
            qv *= b / len(q["coords"])
            logger.warning(
                "TM-align device backend truncated a %d-residue query to "
                "%d; qtm renormalised by the full length (conservative)",
                len(q["coords"]), b)
        if len(t["coords"]) > b:
            tv *= b / len(t["coords"])
        results[i] = {
            "len_ali": la,
            "rmsd": float(out["rmsd"][k]),
            "seq_id": (n_id / la) if la else 0.0,
            "qtm": qv,
            "ttm": tv,
        }


def run_tmalign_pair(query: dict, target: dict, fast: bool = False,
                     device: str | torch.device = "cuda") -> dict:
    """Single-pair convenience wrapper (drop-in for the reference's
    run_tmalign subprocess call)."""
    return tmalign_pairs([(query, target)], fast=fast, device=device)[0]
