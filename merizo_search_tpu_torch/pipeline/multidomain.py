"""Multi-domain (full-length chain) search.

Reference: programs/Foldclass/dbsearch_fulllength.py:183-574. Per-domain hits
are grouped by query chain; each hit's database neighbourhood is expanded to
recover all domains of the hit chain (relying on the DB being ordered by
chain, :354-404); every query-domain x candidate-domain pair is TM-aligned;
and valid assignments of query domains onto hit-chain domains are enumerated
and classified into match categories 0-3.

The reference fills the TM-score matrix with a multiprocessing.Pool of
TM-align subprocesses (:55-92); here the whole matrix is one batched call
of the native C++ TM-align (`align.rescore_pairs`). The port's twin of the
JAX package's module, over the port's aligner and Foldclass embedder.
"""

from __future__ import annotations

import heapq
import logging
import os
import re
from itertools import product

import numpy as np

from ..align import rescore_pairs
from ..db.codecs import FlatDB
from ..io.pdb import read_ca
from ..utils.names import strip_struct_ext
from .embed import embed_structures, load_foldclass_params

logger = logging.getLogger(__name__)

FIELD_SET_SEP = ","
FIELD_SEP = ":"


def domid2chainid(x: str) -> str:
    """'cath-dompdb/2pi4A04.pdb' -> '2pi4A'; 'AF-..._TED02.pdb' -> 'AF-...'
    (parity: dbsearch_fulllength.py:36-39)."""
    base = strip_struct_ext(os.path.basename(x))
    return re.sub(r"[0-9]{2}$", "", base).rstrip("_").removesuffix("_TED")


def _expand_chain_neighbourhood(db: FlatDB, anchor_index: int, anchor_chain: str):
    """All db indices of the anchor's chain (walk left/right while the chain
    id matches; parity :354-404). Returns sorted indices incl. anchor iff the
    chain is multi-domain, else []."""
    idxs = []
    i = anchor_index - 1
    while i >= 0 and domid2chainid(db.name(i)) == anchor_chain:
        idxs.append(i)
        i -= 1
    i = anchor_index + 1
    while i < db.size and domid2chainid(db.name(i)) == anchor_chain:
        idxs.append(i)
        i += 1
    if idxs:
        idxs.append(anchor_index)
        idxs.sort()
    return idxs


# Assignment-path enumeration bound. The reference enumerates the raw
# cartesian product of per-query-domain hit columns
# (dbsearch_fulllength.py:95-180) — exponential in the domain count with a
# dense hit matrix. Above this many raw paths the enumeration switches to a
# score-ranked beam (kept paths maximise the sum of kept pair scores), which
# bounds both time and output size; a warning notes the truncation.
MAX_ASSIGNMENT_PATHS = int(os.environ.get("MERIZO_MDA_MAX_PATHS", "100000"))


def _beam_paths(hd_indices: list[list[int]], mtx: np.ndarray, beam: int):
    """Top-`beam` injective assignment paths by total pair score.

    Delegates to the exact best-first enumeration (`_exact_top_paths`):
    unlike a greedy level-by-level beam, the returned paths are provably
    the global top-`beam`, so capping dense matrices changes only *how
    many* assignments are reported, never which ones rank first."""
    return _exact_top_paths(hd_indices, mtx, beam)


def _exact_top_paths(hd_indices: list[list[int]], mtx: np.ndarray, beam: int):
    """EXACT top-`beam` injective assignment paths by total pair score.

    Lazy best-first search over partial assignments (one query domain per
    tree level), ordered by f = g + h where g is the prefix score and
    h[d] = sum over rows >= d of each row's best column score — an
    optimistic (admissible) bound on any completion, since it ignores the
    injectivity constraint. With an admissible bound, complete paths pop
    off the frontier in exact descending true-score order, so the first
    `beam` pops are the global top-`beam` assignments — the same ones the
    exhaustive cartesian enumeration (reference dbsearch_fulllength.py:
    95-180) would have ranked first (pinned by
    tests/test_multidomain.py::test_beam_keeps_exhaustive_ranking).

    A push cap bounds memory on adversarial near-tie matrices; past it the
    frontier stops growing and remaining pops drain existing entries
    (still injective, best-effort ranked, warned). Entries with equal f
    tie-break on the path tuple, keeping the order deterministic."""
    nqd = len(hd_indices)
    h = [0.0] * (nqd + 1)
    for i in range(nqd - 1, -1, -1):
        h[i] = h[i + 1] + max((float(mtx[i, j]) for j in hd_indices[i]),
                              default=0.0)
    frontier: list[tuple[float, tuple[int, ...]]] = [(-h[0], ())]
    out: list[list[int]] = []
    pushes, push_cap = 0, max(64 * beam, 2_000_000)
    capped = False
    while frontier and len(out) < beam:
        nf, path = heapq.heappop(frontier)
        depth = len(path)
        if depth == nqd:
            out.append(list(path))
            continue
        if pushes >= push_cap:
            if not capped:
                logger.warning(
                    "assignment-path search frontier hit the %d-push cap; "
                    "remaining paths are best-effort ranked", push_cap)
                capped = True
            continue
        g = -nf - h[depth]
        used = set(path)
        for j in hd_indices[depth]:
            if j not in used:
                g2 = g + float(mtx[depth, j])
                heapq.heappush(frontier, (-(g2 + h[depth + 1]), path + (j,)))
                pushes += 1
    return out


def _submatrix_to_hits(mtx: np.ndarray, qc: str, hc: str, qds: list[str], hds: list[dict]):
    """Enumerate valid query->hit domain assignments for one hit chain
    (parity: tmalign_submatrix_to_hits :95-180).

    match categories: 0 bag-of-domains; 1 ordered with gaps; 2 ordered,
    end gaps only; 3 exact MDA match.

    The raw product is capped at MAX_ASSIGNMENT_PATHS: denser matrices fall
    back to a score-ranked beam (see _beam_paths) instead of the reference's
    unbounded cartesian enumeration."""
    result = []
    nqd, nhd = mtx.shape
    if np.where(~mtx.any(axis=1))[0].size > 0:
        return result
    if np.where(mtx.any(axis=0))[0].size < nqd:
        return result

    nz_rows, nz_cols = np.nonzero(mtx)
    hd_indices = [[] for _ in range(nqd)]
    for i, j in zip(nz_rows, nz_cols):
        hd_indices[i].append(int(j))

    npaths = 1
    for cols in hd_indices:
        npaths *= len(cols)
    if npaths > MAX_ASSIGNMENT_PATHS:
        logger.warning(
            "Query chain %s vs hit chain %s: %d raw assignment paths exceed "
            "the %d cap; keeping the %d best-scoring assignments "
            "(MERIZO_MDA_MAX_PATHS raises the cap).",
            qc, hc, npaths, MAX_ASSIGNMENT_PATHS, MAX_ASSIGNMENT_PATHS)
        paths = _beam_paths(hd_indices, mtx, MAX_ASSIGNMENT_PATHS)
    else:
        paths = product(*hd_indices)

    for path in paths:
        path = list(path)
        if len(set(path)) != nqd:
            continue
        match_cat = 0
        if sorted(path) == path:
            if nqd == nhd:
                match_cat = 3
            elif np.all(np.diff(path) == 1):
                match_cat = 2
            else:
                match_cat = 1
        match_info, match_meta = [], []
        for qdi in range(nqd):
            hit = hds[path[qdi]]
            match_info.append(FIELD_SEP.join([qds[qdi], hit["hd"], str(mtx[qdi, path[qdi]])]))
            match_meta.append(hit["hm"])
        result.append((qc, nqd, hc, nhd, match_cat,
                       FIELD_SET_SEP.join(match_info),
                       "[" + FIELD_SET_SEP.join(match_meta) + "]"))
    return result


def _embscore_matrix(q_structs: list[dict], db_idxs: list[int],
                     db: FlatDB, model) -> np.ndarray:
    """Query-domain x candidate-domain cosine-similarity matrix.

    Queries are embedded once (batched Foldclass forward on the model's
    device); candidate embeddings are read straight from the database rows,
    so no candidate is ever re-embedded or aligned."""
    q_emb = embed_structures(model, [np.asarray(q["coords"], np.float32)
                                      for q in q_structs])
    q_emb /= np.maximum(np.linalg.norm(q_emb, axis=1, keepdims=True), 1e-12)
    t_emb = np.asarray(db.embeddings()[np.asarray(db_idxs)], np.float32)
    t_emb /= np.maximum(np.linalg.norm(t_emb, axis=1, keepdims=True), 1e-12)
    return q_emb @ t_emb.T


def multi_domain_search(queries, search_results, db_name: str,
                        fastmode: bool = False, mintm: float = 0.5,
                        inputs_from_easy_search: bool = False,
                        mode: str = "exhaustive_tmalign",
                        pdb_chain: str | None = None,
                        tmalign_backend: str = "auto", threads: int = 0,
                        weights: str | None = None, model=None,
                        device: str = "cuda"):
    """Full-length multi-domain architecture matching.

    queries: list of PDB paths (search mode) or of per-domain dicts from the
    segment stage (easy-search). Returns list of result tuples or None.
    tmalign_backend: "auto", "native" (the C++ TM-align) or "tpu" (the
    device aligner on `device`, pairs near `mintm` re-checked natively).
    model: a loaded
    FoldClassNet for embscore mode (else loaded from `weights`, None: the
    default weights, onto `device`).

    mode:
    - "exhaustive_tmalign": pair scores are TM-scores (batched aligner);
      parity with the reference's only working mode.
    - "embscore": pair scores are embedding cosine similarities — the mode
      the reference declares but leaves unimplemented
      (dbsearch_fulllength.py:558-571 returns an error). Candidate-domain
      embeddings come straight off the database (no re-embedding, no
      alignment), so chain-level MDA matching costs one query-embed plus a
      few dot products — the scalable path at TED scale. Pair threshold is
      `mintm` applied to cosine (same 0..1 range, default 0.5).
    """
    if mode not in ("exhaustive_tmalign", "embscore"):
        raise ValueError(f"Unrecognised multi-domain search mode: {mode}")
    nq = len(queries)
    if nq == 1:
        logger.warning("Cannot execute multi-domain search with only one query domain.")
        return None

    if not inputs_from_easy_search:
        from .dbsearch import _chains_for

        chains = _chains_for(queries, pdb_chain)
        queries = [read_ca(q, chains[i]) for i, q in enumerate(queries)]

    logger.info("Start multi-domain search...")
    qd_info = {}
    dom_names = []
    for q in queries:
        name = strip_struct_ext(os.path.basename(q["name"]))
        qd_info[name] = q
        dom_names.append(name)

    if inputs_from_easy_search:
        dom2chain = {d: re.sub(r"_merizo_[0-9]*$", "", d) for d in dom_names}
    else:
        dom2chain = {d: "A" for d in dom_names}

    # group hits per query chain
    hit_index: dict[str, dict[str, list[dict]]] = {}
    for hitdict in search_results:
        for hit in hitdict.values():
            qd = hit["query"]
            qc = dom2chain.get(qd)
            if qc is None:
                continue
            hd = hit["target"]
            hit_index.setdefault(qc, {}).setdefault(qd, []).append(
                {"hc": domid2chainid(hd), "hd": hd, "hi": int(hit["dbindex"])})
    # ensure every domain of a chain is present even if it had no hits
    for qd, qc in dom2chain.items():
        if qc in hit_index:
            hit_index[qc].setdefault(qd, [])

    db = FlatDB.open(db_name)
    final_results = []
    if mode == "embscore" and model is None:
        model = load_foldclass_params(weights, device)  # one load for all chains

    for qc in list(hit_index):
        if len(hit_index[qc]) < 2:
            logger.info("Query chain %s: fewer than two detected domains, skipping.", qc)
            continue
        nqd = len(hit_index[qc])
        to_extract: set[int] = set()
        for qd, hits in hit_index[qc].items():
            for hit in hits:
                idxs = _expand_chain_neighbourhood(db, hit["hi"], hit["hc"])
                if len(idxs) >= nqd:
                    to_extract.update(idxs)
        if not to_extract:
            logger.info("Query chain %s: no candidate multi-domain chains in db "
                        "(try increasing -k).", qc)
            continue

        extract = sorted(to_extract)
        entries = []
        for i in extract:
            name, coords, seq = db.entry(i)
            entries.append({
                "hd": strip_struct_ext(os.path.basename(name)),
                "coords": coords, "seq": seq, "hi": i, "hm": db.metadata(i),
            })

        qds = list(hit_index[qc].keys())
        q_structs = [qd_info[qd] for qd in qds]
        if mode == "embscore":
            logger.info("Query chain %s: embedding-score %d x %d domain pairs...",
                        qc, len(qds), len(entries))
            mtx = _embscore_matrix(q_structs, [e["hi"] for e in entries],
                                   db, model)
        else:
            logger.info("Query chain %s: TM-align %d x %d domain pairs (batched)...",
                        qc, len(qds), len(entries))
            pairs = [(q, {"coords": e["coords"], "seq": e["seq"]})
                     for q in q_structs for e in entries]
            tms = rescore_pairs(pairs, fast=fastmode, backend=tmalign_backend,
                                nthreads=max(threads, 0), decision_tm=mintm,
                                device=device)
            mtx = np.asarray([max(t["qtm"], t["ttm"]) for t in tms]).reshape(
                len(qds), len(entries))
        mtx[mtx < mintm] = 0.0

        hc_per_hd = np.asarray([domid2chainid(e["hd"]) for e in entries])
        for hc in np.unique(hc_per_hd):
            cols = np.where(hc_per_hd == hc)[0]
            sub = _submatrix_to_hits(
                mtx[:, cols], qc=qc, hc=hc, qds=qds,
                hds=[{"hd": entries[c]["hd"], "hc": hc,
                      "hi": entries[c]["hi"], "hm": entries[c]["hm"]} for c in cols])
            final_results.extend(sub)
        logger.info("Finished multi-domain search for query chain %s.", qc)
    return final_results
