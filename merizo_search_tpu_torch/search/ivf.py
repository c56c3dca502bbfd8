"""IVF (inverted-file) index: sublinear approximate search over a DB.

The port's twin of the JAX package's IVF. The flat scan reads every DB
byte per query batch; the IVF touches only `nprobe/nlist` of it:

- **Build** (device + host): cosine k-means centroids over a training
  sample (Lloyd iterations as f32 matmuls on the device, TF32 off), then a
  *balanced* assignment that gives every cluster exactly C = Npad/nlist
  slots (rows go to their best cluster in affinity order; full clusters
  spill to the next choice), and the spare slots of the `expand` slack
  filled with duplicates of the highest-affinity rows held elsewhere. The
  DB is permuted so each cluster is a contiguous block-aligned slab. The
  balancing is the JAX package's numpy, so one seed gives one layout.
- **Query** (device): one small matmul scores the centroids, the
  top-nprobe clusters of each query become 128-row block ids, and phase C
  of the fused scan rescores exactly those blocks, through its
  block-major launch (ops/gather.py `gather_block_scores_by_block`: on the
  card each probed block is read once a batch, however many queries probe
  it); `torch.topk` takes the exact top-k of everything probed.
  `rerank_hi` rescores the top-(k+1) probed blocks again from an f32
  sidecar (phase C's f32 mode, block-major too).
- **Disk** (host): `write_disk_ivf` persists the permuted layout as
  sidecars for the engine's stream IVF, which stages only the probed
  clusters. The files are byte for byte the JAX package's: a sidecar set
  or an `.ivf{nlist}.npz` cache written by either package opens in the
  other. bf16 sidecars are read and written as 16-bit words.
- **Mesh** (devices): `mesh_ivf_search` shards the permuted layout by
  whole clusters over a list of devices (`resident_layout(rows=...)`);
  each device probes the same clusters, reads the ones it holds, and the
  partial top-k are merged on the first device.

Exactness: results are the exact top-k of the probed clusters in the
storage dtype (with rerank, of the rescored blocks in f32); nprobe = nlist
recovers the flat scan exactly.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops.gather import gather_block_scores_by_block
from ..ops.topk import BLOCK, merge_partials, quantize_blocks

logger = logging.getLogger(__name__)

# preference depth for multi-assignment duplicates (build_ivf expand > 0):
# a row lives in its primary cluster plus at most DUP_PREF duplicate slots,
# so a deduplicating search pulls (DUP_PREF + 1) * k candidates to guarantee
# k unique ids even if every copy of every winner was probed
DUP_PREF = 4
NEG_CAP_FLOOR = -3.0e38   # phase C's NEG_CAP sentinel lies below this


def _seg_chunk_rows(nlist: int) -> int:
    """Sub-chunk row count keeping a [cs, nlist] f32 block at ~64 MB."""
    return max(256, min(8192, ((1 << 24) // max(nlist, 1)) // 256 * 256))


def _lloyd(x: torch.Tensor, cent: torch.Tensor, iters: int) -> torch.Tensor:
    """Lloyd iterations on unit vectors (cosine k-means), f32 on x's device.

    Row-chunked as in the JAX package: each [cs, nlist] score block and its
    one-hot stay bounded; the per-cluster sums are one-hot matmuls (a fixed
    order, unlike index_add_'s atomics on the card)."""
    n = x.shape[0]
    nlist = cent.shape[0]
    cs = _seg_chunk_rows(nlist)
    ids = torch.arange(nlist, device=x.device)
    for _ in range(iters):
        sums = torch.zeros_like(cent)
        counts = torch.zeros(nlist, dtype=x.dtype, device=x.device)
        for c0 in range(0, n, cs):
            xb = x[c0:c0 + cs]
            a = torch.argmax(xb @ cent.T, dim=1)
            oh = (a[:, None] == ids[None, :]).to(x.dtype)
            sums += oh.T @ xb
            counts += oh.sum(dim=0)
        counts = counts[:, None]
        new = torch.where(counts > 0, sums / counts.clamp(min=1), cent)
        cent = new / torch.linalg.norm(new, dim=1, keepdim=True).clamp(min=1e-9)
    return cent


def _score_prefs(emb, cent: np.ndarray, npref: int, device):
    """Chunked top-npref (ids, scores) of every row of emb (array or
    memmap) against `cent`, scored on the device."""
    n = emb.shape[0]
    pref = np.empty((n, npref), np.int32)
    pscore = np.empty((n, npref), np.float32)
    dcent = torch.from_numpy(np.ascontiguousarray(cent, np.float32)).to(device)
    chunk = 1 << 18
    for c0 in range(0, n, chunk):
        sl = slice(c0, min(n, c0 + chunk))
        rows = torch.from_numpy(np.array(emb[sl], np.float32)).to(device)
        ts, top = torch.topk(rows @ dcent.T, npref, dim=1)
        pref[sl] = top.cpu().numpy()
        pscore[sl] = ts.cpu().numpy()
    return pref, pscore


def refine_centroids(emb, assign: np.ndarray, nlist: int, device="cuda") -> np.ndarray:
    """Centroids recomputed from the rows each cluster ACTUALLY holds.

    The balanced assignment moves boundary rows away from their argmax
    cluster, so the Lloyd centroids no longer describe cluster contents;
    the normalised mean of each cluster's members re-aligns the probe
    ranking with the layout. The JAX package's sort + prefix-sum segment
    reduction in float64 (O(N*D) adds), run on `device` a chunk of rows at
    a time."""
    dev = resolve_device(device)
    n, d = emb.shape
    sums = torch.zeros((nlist, d), dtype=torch.float64, device=dev)
    counts = torch.zeros(nlist, dtype=torch.int64, device=dev)
    chunk = 1 << 18
    for c0 in range(0, n, chunk):
        sl = slice(c0, min(n, c0 + chunk))
        rows = torch.from_numpy(np.array(emb[sl], np.float32)).to(dev)
        a = torch.from_numpy(np.asarray(assign[sl], np.int64)).to(dev)
        cnt = torch.bincount(a, minlength=nlist)
        order = torch.sort(a, stable=True).indices
        cum = torch.zeros((len(order) + 1, d), dtype=torch.float64, device=dev)
        torch.cumsum(rows[order].to(torch.float64), dim=0, out=cum[1:])
        ends = torch.cumsum(cnt, dim=0)
        sums += cum[ends] - cum[ends - cnt]
        counts += cnt
    out = (sums / counts.clamp(min=1)[:, None]).to(torch.float32).cpu().numpy()
    out /= np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-9)
    return out.astype(np.float32)


def build_ivf(emb: np.ndarray, nlist: int, iters: int = 10,
              train_sample: int = 1 << 18, seed: int = 0,
              multiple_of: int = 1, expand: float = 0.25,
              refine: bool = True, device="cuda", timings: dict | None = None) -> dict:
    """Build a balanced IVF over normalised embeddings [N, D] (array or
    memmap). The JAX package's build_ivf, with its defaults; the k-means
    and the preference scoring run on `device`.

    multiple_of: force nlist to a multiple (shard boundaries on cluster
    boundaries). expand: fractional slack per cluster, filled with
    DUPLICATES of the highest-affinity rows held elsewhere, so a probe of
    cluster c also sees the boundary rows that spilled out of c (search
    must then dedup by original id: the dict's "dup" flag). refine:
    re-estimate the centroids from the clusters' members after balancing.
    timings: if given, filled with the seconds of each step (lloyd, prefs,
    balance, refine, duplicates).

    Returns {"centroids" [nlist,D] f32, "perm" [Npad] i64 (permuted row ->
    original row, -1 for padding), "cluster_rows" C, "nlist", "expand",
    "dup" bool}.
    """
    dev = resolve_device(device)
    t = {} if timings is None else timings
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        now = time.perf_counter()
        t[name] = t.get(name, 0.0) + now - t0
        t0 = now

    n, d = emb.shape
    rng = np.random.default_rng(seed)
    # clamp nlist: need >= nlist training rows to seed centroids, and more
    # clusters than ~N/BLOCK just pads every cluster to one near-empty block
    cap = max(1, min(min(train_sample, n), -(-n // BLOCK)))
    if nlist > cap:
        logger.warning("IVF nlist %d too large for %d rows; using %d", nlist, n, cap)
        nlist = cap
    if multiple_of > 1:
        nlist = max(multiple_of, (nlist // multiple_of) * multiple_of)
    c_rows = -(-int(n * (1.0 + max(expand, 0.0))) // nlist)
    c_rows = -(-c_rows // BLOCK) * BLOCK
    npad = c_rows * nlist

    sample = np.asarray(emb[rng.choice(n, size=min(train_sample, n), replace=False)],
                        np.float32)
    cent0 = sample[rng.choice(len(sample), size=nlist, replace=False)]
    cent0 = cent0 / np.maximum(np.linalg.norm(cent0, axis=1, keepdims=True), 1e-9)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # exact f32 scores
    try:
        cent = _lloyd(torch.from_numpy(sample).to(dev),
                      torch.from_numpy(np.ascontiguousarray(cent0, np.float32)).to(dev),
                      iters).cpu().numpy()
        lap("lloyd")
        npref = min(8, nlist)
        pref, pscore = _score_prefs(emb, cent, npref, dev)
        lap("prefs")
        assign = _balance(pref, pscore, nlist, c_rows)
        lap("balance")
        if refine and nlist > 1:
            cent = refine_centroids(emb, assign, nlist, dev)
        lap("refine")
        dup_rows, dup_cluster = _duplicates(emb, cent, assign, nlist, c_rows, expand, dev)
        lap("duplicates")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32

    # permuted layout: rows of cluster c at [c*c_rows, (c+1)*c_rows)
    perm = np.full(npad, -1, np.int64)
    mem_cluster = np.concatenate([assign, dup_cluster])
    mem_row = np.concatenate([np.arange(n, dtype=np.int64), dup_rows])
    order2 = np.argsort(mem_cluster, kind="stable")
    sa = mem_cluster[order2]
    first = np.searchsorted(sa, np.arange(nlist), side="left")
    ordinal = np.arange(len(sa)) - first[sa]
    perm[sa * c_rows + ordinal] = mem_row[order2]
    lap("balance")
    logger.info("IVF built: %d clusters x %d rows (%d duplicates, %d padding rows)",
                nlist, c_rows, len(dup_rows), npad - n - len(dup_rows))
    return {"centroids": np.asarray(cent, np.float32), "perm": perm,
            "cluster_rows": c_rows, "nlist": nlist,
            "expand": float(max(expand, 0.0)), "dup": bool(len(dup_rows))}


def _balance(pref: np.ndarray, pscore: np.ndarray, nlist: int, c_rows: int) -> np.ndarray:
    """Balanced primary assignment [N] i64: vectorised overflow-spill
    passes (everyone takes their current preference, each over-full
    cluster keeps its c_rows highest-affinity rows and spills the rest to
    their next preference), then capacity enforcement and a back-fill of
    the rows that exhausted their preferences."""
    n, npref = pref.shape
    rows = np.arange(n)
    rank = np.zeros(n, np.int32)
    for _ in range(npref):
        active = rank < npref
        assign = np.where(active, pref[rows, np.minimum(rank, npref - 1)], -1)
        sc = np.where(active, pscore[rows, np.minimum(rank, npref - 1)], 0.0)
        key = np.lexsort((-sc, assign))
        sa = assign[key]
        first = np.searchsorted(sa, np.arange(nlist), side="left")
        ordinal = np.arange(n) - first[np.clip(sa, 0, nlist - 1)]
        over = key[(sa >= 0) & (ordinal >= c_rows)]
        if len(over) == 0:
            break
        rank[over] += 1
    assign = np.where(rank < npref, pref[rows, np.minimum(rank, npref - 1)],
                      -1).astype(np.int64)
    # residual overflow from the last pass is demoted to -1 (keeping each
    # cluster's highest-affinity rows)...
    sc = np.where(rank < npref, pscore[rows, np.minimum(rank, npref - 1)], 0.0)
    key = np.lexsort((-sc, assign))
    sa = assign[key]
    first = np.searchsorted(sa, np.arange(nlist), side="left")
    ordinal = np.arange(n) - first[np.clip(sa, 0, nlist - 1)]
    assign[key[(sa >= 0) & (ordinal >= c_rows)]] = -1
    # ...and back-fills clusters with spare capacity
    left = np.nonzero(assign < 0)[0]
    if len(left):
        fill = np.bincount(assign[assign >= 0], minlength=nlist)
        room = np.repeat(np.arange(nlist), np.maximum(c_rows - fill, 0))
        assign[left] = room[:len(left)]
        logger.info("IVF: %d rows overflowed their %d preferred clusters", len(left), npref)
    return assign


def _duplicates(emb, cent, assign, nlist: int, c_rows: int, expand: float, dev):
    """Multi-assignment: each cluster's spare slots take DUPLICATES of the
    highest-affinity rows assigned elsewhere, re-scored against the
    (refined) centroids. Returns (rows [M] i64, clusters [M] i64)."""
    spare = c_rows - np.bincount(assign, minlength=nlist)
    if not (expand > 0 and nlist > 1 and spare.sum() > 0):
        return np.zeros((0,), np.int64), np.zeros((0,), np.int64)
    n = len(assign)
    pref2, ps2 = _score_prefs(emb, cent, min(DUP_PREF, nlist), dev)
    cand = pref2 != assign[:, None].astype(np.int32)
    cc = pref2[cand].astype(np.int64)
    cs = ps2[cand]
    cr = np.broadcast_to(np.arange(n)[:, None], pref2.shape)[cand].astype(np.int64)
    order = np.lexsort((-cs, cc))
    scc = cc[order]
    first = np.searchsorted(scc, np.arange(nlist), side="left")
    ordinal = np.arange(len(scc)) - first[scc]
    keep = ordinal < spare[scc]
    logger.info("IVF: %d duplicate rows fill the %.0f%% expansion slack",
                int(keep.sum()), 100 * expand)
    return cr[order][keep], scc[keep]


def permute_rows(emb, perm_slice: np.ndarray, dtype=np.float32) -> np.ndarray:
    """Materialise one cluster-contiguous slab (padding rows are zero).
    emb may be a memmap: rows are fancy-indexed, so host RAM holds only the
    requested slab."""
    out = np.zeros((len(perm_slice), emb.shape[1]), dtype)
    valid = perm_slice >= 0
    out[valid] = emb[perm_slice[valid]].astype(dtype)
    return out


def permute_db(emb: np.ndarray, ivf: dict, dtype=np.float32) -> np.ndarray:
    """Materialise the full cluster-contiguous DB (tests/small DBs)."""
    return permute_rows(emb, ivf["perm"], dtype)


# -- query --------------------------------------------------------------------

def _probe_blocks(q: torch.Tensor, centroids: torch.Tensor, nprobe: int, bpc: int,
                  nlist_local: int | None = None, me: int | None = None):
    """Top-nprobe clusters per query -> [Q, nprobe*bpc] int32 block ids of
    the permuted layout (bpc blocks a cluster), -1 = skip. The centroids
    are scored in f32 from q as given (the engine passes the storage-dtype
    query, as the JAX engine does).

    With nlist_local/me set, cluster ids are remapped to mesh shard me's
    local cluster range and the probes of other shards' clusters become -1
    (phase C's padding): every shard computes the same global probe set and
    reads only the probed clusters it holds."""
    cs = q.to(torch.float32) @ centroids.T                      # [Q, nlist]
    probe = torch.topk(cs, nprobe, dim=1).indices               # [Q, nprobe]
    if nlist_local is not None:
        lp = probe - me * nlist_local
        probe = torch.where((lp >= 0) & (lp < nlist_local), lp, -1)
    bidx = torch.where(probe[:, :, None] >= 0,
                       probe[:, :, None] * bpc + torch.arange(bpc, device=q.device), -1)
    return bidx.reshape(q.shape[0], nprobe * bpc).to(torch.int32).contiguous()


def _dedup_topk(v: torch.Tensor, idx: torch.Tensor, k: int):
    """Exact top-k by score among UNIQUE original row ids.

    v [Q, M] f32 (any order), idx [Q, M] original ids (-1 invalid, with -inf
    scores). Copies of a multi-assigned row score identically; this keeps
    one copy per id. The (id asc, score desc) order takes two stable sorts
    (score first, then id), so each id's best copy comes first in its
    group; one adjacent compare kills the rest, and a stable sort by score
    ranks what is left. Always returns exactly k columns (-inf / -1
    padding)."""
    qn, m = v.shape
    idx = idx.to(torch.int64)
    o1 = torch.sort(v, dim=1, descending=True, stable=True).indices
    sv, si = torch.gather(v, 1, o1), torch.gather(idx, 1, o1)
    o2 = torch.sort(si, dim=1, stable=True).indices
    sv, si = torch.gather(sv, 1, o2), torch.gather(si, 1, o2)
    first = torch.ones_like(si, dtype=torch.bool)
    first[:, 1:] = si[:, 1:] != si[:, :-1]
    sv = torch.where(first, sv, float("-inf"))
    if m < k:
        sv = torch.cat([sv, sv.new_full((qn, k - m), float("-inf"))], dim=1)
        si = torch.cat([si, si.new_full((qn, k - m), -1)], dim=1)
    o3 = torch.sort(sv, dim=1, descending=True, stable=True).indices[:, :k]
    out_v = torch.gather(sv, 1, o3)
    out_i = torch.where(torch.isfinite(out_v), torch.gather(si, 1, o3), -1)
    return out_v, out_i


def _rerank_blocks(q_hi, db_hi, scores, bidx, tl, qcap, k: int):
    """Exact re-rank: the top-(k+1) scanned blocks (by block max of the
    scan's scores [Q, KB*128]) rescored from the f32 sidecar db_hi
    [Npad, D] against the f32 queries, under the scan's own masks (tl /
    qcap: padding rows and the mincov filter), through phase C's f32 mode
    (block-major).
    Returns (scores2 [Q, KS*128], bidx2 [Q, KS]) with KS = min(k+1, KB)."""
    qn, kb = bidx.shape
    blkmax = scores.view(qn, kb, BLOCK).amax(dim=2)
    cols = torch.topk(blkmax, min(k + 1, kb), dim=1).indices
    bidx2 = torch.gather(bidx, 1, cols).contiguous()
    s2 = gather_block_scores_by_block(q_hi, db_hi, bidx2, db_hi.shape[0], tl, qcap)
    return s2, bidx2


def _probe_and_select(q, db_perm, perm, bidx, k: int, tlen, qlen, mincov: float,
                      use_len: bool, scales=None, dedup: bool = False,
                      rerank_hi=None, q_hi=None):
    """Gather the probed blocks; exact top-k of the probed candidates.

    scales: [Npad] f32 block-uniform scales when db_perm is int8 (over the
    PERMUTED layout); q must then be int8 too, and the caller applies the
    per-query scale to the values. Phase C takes the scales in its
    per-row mode (block-uniform, so each score gets its block's scale by
    the same f32 multiply as the per-selected-block mode). Padding rows
    (perm == -1) are excluded through phase C's length mask: their length
    is +inf, which no finite qcap admits. rerank_hi / q_hi: see
    _rerank_blocks. Returns (scores [Q, k] f32, ORIGINAL ids [Q, k] int64,
    -1 misses)."""
    qn = q.shape[0]
    npad = db_perm.shape[0]
    pad_inf = torch.where(perm >= 0, 0.0, float("inf")).to(torch.float32)
    if use_len:
        # a CPU 0-dim tensor: no host-to-device copy, so no hidden sync
        cov = torch.tensor(mincov, dtype=torch.float32)
        tl = (tlen * cov + pad_inf).contiguous()
        qcap = qlen.to(torch.float32).contiguous()
    else:
        tl = pad_inf.contiguous()
        qcap = torch.full((qn,), 3e38, dtype=torch.float32, device=q.device)
    scores = gather_block_scores_by_block(q, db_perm, bidx, npad, tl, qcap, scales=scales)
    if rerank_hi is not None:
        scores, bidx = _rerank_blocks(q_hi, rerank_hi, scores, bidx, tl, qcap, k)
    kb = bidx.shape[1]
    ridx = (bidx.to(torch.int64)[:, :, None] * BLOCK
            + torch.arange(BLOCK, device=q.device)).reshape(qn, kb * BLOCK)
    # with duplicates in the layout, pull (DUP_PREF + 1) * k candidates so
    # the post-dedup top-k is still k deep even when every copy of every
    # winner was probed (copies score identically)
    ksel = (DUP_PREF + 1) * k if dedup else k
    kk = min(ksel, scores.shape[1])
    v, sel = torch.topk(scores, kk, dim=1)
    if kk < ksel:
        v = torch.cat([v, v.new_full((qn, ksel - kk), float("-inf"))], dim=1)
        sel = torch.cat([sel, sel.new_zeros((qn, ksel - kk))], dim=1)
    v = torch.where(v <= NEG_CAP_FLOOR, float("-inf"), v)
    pidx = torch.gather(ridx, 1, sel)                         # permuted rows
    idx = perm[pidx.clamp(0, len(perm) - 1)]
    idx = torch.where(torch.isfinite(v) & (pidx >= 0), idx, -1)
    if dedup:
        v, idx = _dedup_topk(v, idx, k)
    return v, idx


def ivf_search(q, db_perm, centroids, perm, k: int, nprobe: int, tlen=None,
               qlen=None, mincov: float = 0.0, use_len: bool = False, scales=None,
               q8=None, dedup: bool = False, rerank_hi=None, q_hi=None):
    """Approximate top-k: probe nprobe clusters, exact top-k of the probed.

    q [Q,D] f32/bf16 (drives the centroid probe; the scan's query unless q8
    is given), db_perm [Npad,D] cluster-contiguous in the storage dtype,
    centroids [nlist,D] f32, perm [Npad] int64, tlen [Npad] f32 target
    lengths in PERMUTED order (mincov filter, use_len=True). int8 DBs: pass
    scales (block-uniform over the permuted layout) AND q8 (quantize_rows
    int8 queries); the values then need the caller's per-query rescale
    (not with rerank_hi: rescored values are already f32). dedup=True is
    REQUIRED for layouts built with expand > 0 (the build's "dup" flag).
    rerank_hi: optional f32 [Npad, D] sidecar in the same permuted layout,
    rescoring the top-(k+1) blocks against q_hi (the caller's f32 queries;
    defaults to q upcast). All tensors on one device.
    Returns (scores [Q,k] f32, ORIGINAL indices [Q,k] int64, -1 for misses).
    """
    nlist = centroids.shape[0]
    c_rows = db_perm.shape[0] // nlist
    bidx = _probe_blocks(q, centroids, nprobe, c_rows // BLOCK)
    if rerank_hi is not None and q_hi is None:
        q_hi = q.to(torch.float32)
    return _probe_and_select(q8 if q8 is not None else q, db_perm, perm, bidx, k,
                             tlen, qlen, mincov, use_len, scales=scales, dedup=dedup,
                             rerank_hi=rerank_hi,
                             q_hi=None if q_hi is None else q_hi.to(torch.float32).contiguous())


def resident_layout(emb, ivf: dict, dtype: torch.dtype, device, lengths=None,
                    rerank: bool = False, slab: int = 1 << 18, rows=None) -> dict:
    """The permuted layout on `device` as device-mode IVF search reads it:
    "db" [Npad, D] in the storage dtype (int8 with block scales, "scales",
    over the permuted layout), "tlen" the permuted target lengths (padding
    rows 1e9; None without `lengths`), "hi" the f32 sidecar (rerank only),
    and the centroids, perm and dup flag. Slabs of `slab` permuted rows (a
    multiple of 128, so int8 blocks stay whole) are gathered from the
    (memmap) embeddings one at a time. rows=(lo, hi): only the permuted
    rows [lo, hi) (a mesh shard: lo and hi on cluster boundaries), with
    the whole centroids."""
    lo0, hi0 = rows or (0, len(ivf["perm"]))
    perm = ivf["perm"][lo0:hi0]
    npad, dim = len(perm), emb.shape[1]
    quant = dtype == torch.int8
    db = torch.zeros((npad, dim), dtype=dtype, device=device)
    scales = torch.ones(npad, dtype=torch.float32, device=device) if quant else None
    hi = torch.zeros((npad, dim), dtype=torch.float32, device=device) if rerank else None
    for lo in range(0, npad, slab):
        part = permute_rows(emb, perm[lo:lo + slab], np.float32)
        if quant:
            qv, s = quantize_blocks(part)
            db[lo:lo + slab] = torch.from_numpy(qv).to(device)
            scales[lo:lo + slab] = torch.from_numpy(s).to(device)
        else:
            db[lo:lo + slab] = torch.from_numpy(part).to(device).to(dtype)
        if hi is not None:
            hi[lo:lo + slab] = torch.from_numpy(part).to(device)
    tlen = None
    if lengths is not None:
        lp = np.full(npad, 1e9, np.float32)
        lp[perm >= 0] = np.asarray(lengths, np.float32)[perm[perm >= 0]]
        tlen = torch.from_numpy(lp).to(device)
    return {"db": db, "scales": scales, "hi": hi, "tlen": tlen,
            "centroids": torch.from_numpy(
                np.ascontiguousarray(ivf["centroids"], np.float32)).to(device),
            "perm": torch.from_numpy(np.asarray(perm, np.int64)).to(device),
            "dup": bool(ivf["dup"])}


def mesh_ivf_search(shards, q, k: int, nprobe: int, qlen=None, mincov: float = 0.0,
                    use_len: bool = False, q8=None, rerank: bool = False, q_hi=None):
    """The IVF sharded over a mesh: the counterpart of the JAX package's
    `build_mesh_ivf_search`. shards: resident_layouts of equal row ranges
    of one layout, in order, one a device (rows=: nlist/ndev whole
    clusters each, the whole centroids on every device). q, q8, q_hi and
    qlen as for ivf_search, on the first shard's device; each shard gets
    its own copy. Every shard computes the global probe set from the
    centroids, gathers only the probed clusters it holds (_probe_blocks'
    remap) and takes its exact top-k of them (rerank: from its own f32
    sidecar, before the merge); the partials are copied to the first
    device and merged (merge_partials; a layout with duplicates dedups
    across shards, since a row and its copy may lie on two devices).
    Equal to ivf_search on the whole layout with the same centroids and
    perm. Returns (scores [Q, k], ORIGINAL ids [Q, k]) on the first
    shard's device."""
    nd = len(shards)
    nlist = shards[0]["centroids"].shape[0]
    if nlist % nd:
        raise ValueError(f"{nlist} clusters do not shard over {nd} devices")
    nlist_local = nlist // nd
    dev0 = shards[0]["db"].device
    dedup = shards[0]["dup"]
    if rerank and q_hi is None:
        q_hi = q.to(torch.float32)
    parts_v, parts_i = [], []
    for me, lay in enumerate(shards):
        dev = lay["db"].device

        def on(t):
            return None if t is None else t.to(dev, non_blocking=True)

        bpc = lay["db"].shape[0] // nlist_local // BLOCK
        qd = on(q)
        bidx = _probe_blocks(qd, lay["centroids"], nprobe, bpc, nlist_local, me)
        v, idx = _probe_and_select(on(q8) if q8 is not None else qd, lay["db"], lay["perm"],
                                   bidx, k, lay["tlen"], on(qlen), mincov, use_len,
                                   scales=lay["scales"], dedup=dedup,
                                   rerank_hi=lay["hi"] if rerank else None,
                                   q_hi=on(q_hi.to(torch.float32).contiguous())
                                   if rerank else None)
        parts_v.append(v)
        parts_i.append(idx)
    pv = [v.to(dev0, non_blocking=True) for v in parts_v]
    pi = [i.to(dev0, non_blocking=True) for i in parts_i]
    if dedup:
        return _dedup_topk(torch.cat(pv, dim=1), torch.cat(pi, dim=1), k)
    return merge_partials(torch.stack(pv), torch.stack(pi), k)


def search_resident(lay, qf, query, k: int, nprobe: int, qlen=None,
                    mincov: float = 0.0, use_len: bool = False, rerank: bool = False):
    """ivf_search on a resident_layout, or mesh_ivf_search on a list of
    shard layouts: qf [Q, D] the f32 unit queries, query =
    ops.topk.query_operands(...) (the scan's query, int8 scales), both on
    the (first) layout's device. The centroid probe scores the scan's
    query (bf16: rounded, as the JAX engine passes it to ivf_search; int8:
    the f32 query, as the JAX engine keeps it); with a mesh too, so a mesh
    returns what one device does. int8 values are rescaled per query,
    except with rerank (the layout's "hi" sidecar), whose values are exact
    f32 already."""
    qd, qs = query
    first = lay[0] if isinstance(lay, list) else lay
    quant = first["scales"] is not None
    nprobe = min(nprobe, first["centroids"].shape[0])
    kw = dict(qlen=qlen, mincov=mincov, use_len=use_len, q8=qd if quant else None,
              q_hi=qf if rerank else None)
    if isinstance(lay, list):
        vals, idxs = mesh_ivf_search(lay, qf if quant else qd, k, nprobe, rerank=rerank, **kw)
    else:
        vals, idxs = ivf_search(qf if quant else qd, lay["db"], lay["centroids"], lay["perm"],
                                k, nprobe, tlen=lay["tlen"], scales=lay["scales"],
                                dedup=lay["dup"], rerank_hi=lay["hi"] if rerank else None,
                                **kw)
    if quant and not rerank:
        vals = vals * qs[:, None]
    return vals, idxs


# -- disk-streaming IVF -------------------------------------------------------
# For DBs over the device budget: the cluster-contiguous permuted layout
# persisted once, and per query batch only the union of probed clusters
# staged to the card and flat-scanned (search/engine.py stream IVF).

_DISK_DTYPES = {"int8": np.int8, "f32": np.float32, "bf16": np.uint16}


def _bf16_words(x: np.ndarray) -> np.ndarray:
    """f32 -> bfloat16 (round to nearest even) as uint16 words, the bytes
    an ml_dtypes bfloat16 array holds."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def write_disk_ivf(emb, lengths: np.ndarray, nlist: int, path_prefix: str,
                   precision: str = "int8", iters: int = 10,
                   train_sample: int = 1 << 18, seed: int = 0,
                   fingerprint=None, expand: float = 0.25, device="cuda") -> dict:
    """Build an IVF and persist the cluster-contiguous layout as sidecars.

    emb: [N, D] NORMALISED embeddings (array or memmap: rows are read in
    bounded slabs). Writes next to `path_prefix` (the JAX package's files):
      .npz     centroids [nlist,D] f32, cluster_rows, precision, npad, dim,
               dup, fingerprint
      .perm    int64 [Npad] (permuted row -> original, -1 padding)
      .emb     [Npad, D] in `precision` (int8 block-quantised; bf16 words)
      .scales  f32 [Npad] (int8 only; block-uniform per 128 rows)
      .len     f32 [Npad] permuted lengths, +inf on padding rows
    Every file is written under a tmp name and renamed into place, the
    .npz last: readers gate on it, so a killed or concurrent build never
    leaves a readable torn set. Returns load_disk_ivf(path_prefix)."""
    ivf = build_ivf(emb, nlist, iters=iters, train_sample=train_sample, seed=seed,
                    expand=expand, device=device)
    perm, c_rows = ivf["perm"], ivf["cluster_rows"]
    npad, dim = len(perm), emb.shape[1]
    tmp = f".tmp{os.getpid()}"
    mm = np.memmap(path_prefix + ".emb" + tmp, dtype=_DISK_DTYPES[precision], mode="w+",
                   shape=(npad, dim))
    sc = (np.memmap(path_prefix + ".scales" + tmp, np.float32, "w+", shape=(npad,))
          if precision == "int8" else None)
    ch = (1 << 18) // BLOCK * BLOCK  # BLOCK-aligned: scale blocks never straddle a slab
    for lo in range(0, npad, ch):
        hi = min(lo + ch, npad)
        slab = permute_rows(emb, perm[lo:hi], np.float32)
        if precision == "int8":
            mm[lo:hi], sc[lo:hi] = quantize_blocks(slab)
        elif precision == "bf16":
            mm[lo:hi] = _bf16_words(slab)
        else:
            mm[lo:hi] = slab
    mm.flush()
    if sc is not None:
        sc.flush()
    pm = np.memmap(path_prefix + ".perm" + tmp, np.int64, "w+", shape=(npad,))
    pm[:] = perm
    pm.flush()
    lp = np.memmap(path_prefix + ".len" + tmp, np.float32, "w+", shape=(npad,))
    lp[:] = np.inf
    valid = perm >= 0
    lp[valid] = np.asarray(lengths, np.float32)[perm[valid]]
    lp.flush()
    del mm, sc, pm, lp  # close the maps before renaming their files
    for name in [".emb", ".perm", ".len"] + ([".scales"] if precision == "int8" else []):
        os.replace(path_prefix + name + tmp, path_prefix + name)
    with open(path_prefix + ".npz" + tmp, "wb") as fh:   # a file object: no suffix added
        np.savez(fh, centroids=ivf["centroids"], cluster_rows=c_rows,
                 precision=precision, npad=npad, dim=dim, dup=ivf["dup"],
                 fingerprint=np.asarray(fingerprint if fingerprint is not None else [],
                                        np.int64))
    os.replace(path_prefix + ".npz" + tmp, path_prefix + ".npz")
    logger.info("disk IVF written: %d clusters x %d rows (%s) at %s",
                ivf["nlist"], c_rows, precision, path_prefix)
    return load_disk_ivf(path_prefix)


def load_disk_ivf(path_prefix: str) -> dict:
    """Open a write_disk_ivf sidecar set; arrays are read-only memmaps (a
    bf16 set's rows as uint16 words)."""
    z = np.load(path_prefix + ".npz")
    precision = str(z["precision"])
    npad, dim = int(z["npad"]), int(z["dim"])
    return {
        "fingerprint": z["fingerprint"] if "fingerprint" in z else None,
        "dup": bool(z["dup"]) if "dup" in z else False,
        "centroids": z["centroids"],
        "cluster_rows": int(z["cluster_rows"]),
        "nlist": int(z["centroids"].shape[0]),
        "precision": precision,
        "emb": np.memmap(path_prefix + ".emb", _DISK_DTYPES[precision], "r",
                         shape=(npad, dim)),
        "scales": (np.memmap(path_prefix + ".scales", np.float32, "r", shape=(npad,))
                   if precision == "int8" else None),
        "perm": np.memmap(path_prefix + ".perm", np.int64, "r", shape=(npad,)),
        "lengths": np.memmap(path_prefix + ".len", np.float32, "r", shape=(npad,)),
    }


def cluster_runs(cluster_ids: np.ndarray) -> list[tuple[int, int]]:
    """Coalesce sorted unique cluster ids into [start, stop) runs so staging
    reads the fewest contiguous disk ranges."""
    if len(cluster_ids) == 0:
        return []
    breaks = np.nonzero(np.diff(cluster_ids) != 1)[0]
    starts = np.concatenate([[0], breaks + 1])
    stops = np.concatenate([breaks, [len(cluster_ids) - 1]])
    return [(int(cluster_ids[a]), int(cluster_ids[b]) + 1) for a, b in zip(starts, stops)]
