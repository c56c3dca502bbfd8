"""Host-side domain-id post-processing heuristics (numpy/scipy).

These are the sequential cleanup passes the reference runs between and
after the network forward (programs/Merizo/model/utils/utils.py): O(N) list
walks with data-dependent control flow, which stay on the host. Where the
reference's implementation has observable quirks they are kept bit for bit,
because downstream choppings (and hence hit sets) depend on them. The
port's copy of the JAX package's module.
"""

from __future__ import annotations

import re

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components


def get_ids(dom_ids: np.ndarray):
    """Unique non-zero ids and their count (utils.py:49-63)."""
    ids = np.unique(dom_ids[dom_ids != 0])
    return ids, len(ids)


def instance_matrix(labels: np.ndarray) -> np.ndarray:
    """Domain co-membership map: 1 where labels_i == labels_j != 0.

    The reference computes this by mapping labels to primes and testing
    whether sqrt(p_i * p_j) is an integer (utils.py:142-165) — which is true
    exactly when the labels are equal; background (label 0 -> prime 2) pairs
    are then zeroed. The direct equality form is identical.
    """
    lab = np.asarray(labels)
    eq = (lab[:, None] == lab[None, :]) & (lab[:, None] != 0)
    return eq.astype(np.float32)


def separate_components(domain_map: np.ndarray, dmap: np.ndarray,
                        dom_ids: np.ndarray, distance: float = 8.0) -> np.ndarray:
    """Split domains whose segments are further than `distance` Å apart.

    Parity: utils.py:276-316 — intersect the domain-map graph with the
    <=distance contact graph, drop isolated nodes (background), and relabel
    connected components 1..K in order of first node appearance. networkx is
    replaced by scipy.sparse.csgraph (the reference's networkx path is ~100x
    slower at N=2000).
    """
    adj = (domain_map > 0) & (dmap <= distance)
    # background rows have no edges at all (incl. no self-loop) -> isolated
    keep = adj.any(axis=1)
    labels_new = np.zeros(len(dom_ids), dtype=np.int64)
    if not keep.any():
        return labels_new
    sub = adj[np.ix_(keep, keep)]
    n_comp, comp = connected_components(csr_matrix(sub), directed=False)
    # renumber components by first occurrence (networkx yields components in
    # node order; scipy's labels already increase with first occurrence, but
    # renumber defensively)
    order = {}
    out_sub = np.zeros(len(comp), dtype=np.int64)
    for i, c in enumerate(comp):
        if c not in order:
            order[c] = len(order) + 1
        out_sub[i] = order[c]
    labels_new[keep] = out_sub
    return labels_new


def clean_domains(dom_ids: np.ndarray, min_num: int) -> np.ndarray:
    """Absorb too-small domains into the preceding one by left-propagation.

    Parity: utils.py:168-181 (in-place forward fill over removed ids).
    """
    out = np.asarray(dom_ids).copy()
    nz = out[out != 0]
    if len(nz) == 0:
        return out
    vals, counts = np.unique(nz, return_counts=True)
    remove = set(vals[counts < min_num].tolist())
    for i in range(1, len(out)):
        if out[i] in remove:
            out[i] = out[i - 1]
    return out


def segment_lengths(dom_ids: np.ndarray) -> np.ndarray:
    """Per-position length of the containing constant run.

    Parity with the reference's loop (utils.py:205-227) INCLUDING its
    off-by-one quirk: the counter is reset to 0 (not 1) at run boundaries, so
    every run after the first reports length-1; runs also bleed one position
    at boundaries ([_idx:idx+1] uses the stale idx). Downstream thresholds
    (clean_singletons) were tuned against this behaviour.
    """
    n = len(dom_ids)
    counts = np.ones(n, dtype=np.int64)
    counter = 0
    _idx = idx = 0
    for i in range(n):
        if i == 0:
            counter = 1
            _idx = idx = 0
        elif dom_ids[i] == dom_ids[i - 1]:
            counter += 1
            idx = i
        else:
            counts[_idx:idx + 1] = counter
            counter = 0
            _idx = i
        if i == n - 1:
            counts[_idx:idx + 1] = counter
    return counts


def _assimilate_terminal(dom_ids: np.ndarray, counts: np.ndarray,
                         threshold: int, termini: str) -> np.ndarray:
    """Parity: utils.py:184-202."""
    ids = dom_ids.copy()
    cts = counts
    if termini == "C":
        ids = ids[::-1].copy()
        cts = cts[::-1]
    i = 0
    next_id = ids[0]
    for i in range(len(ids)):
        if cts[i] >= threshold or ids[i] == 0:
            next_id = ids[min(i + 1, len(ids) - 1)]
            break
    ids[:i + 1] = next_id
    if termini == "C":
        return ids[::-1].copy()
    return ids


def clean_singletons(dom_ids: np.ndarray, threshold: int) -> np.ndarray:
    """Re-assign short segments: terminal stretches assimilate into the
    adjacent domain; internal fragments are split at their median between the
    neighbouring domains.

    Parity: utils.py:230-273 (including the always-true `len(...) != 0` guard
    — the body always runs).
    """
    out = np.asarray(dom_ids).copy()
    counts = segment_lengths(out)
    out = _assimilate_terminal(out, counts, threshold, "N")
    out = _assimilate_terminal(out, counts, threshold, "C")

    short = counts < threshold
    non_terminal = np.where(~short)[0]
    if len(non_terminal) == 0:
        return out
    short = short.copy()
    short[:non_terminal[0]] = False
    short[non_terminal[-1]:] = False

    idxs = np.nonzero(short)[0]
    if len(idxs) == 0:
        return out
    # group consecutive indices into stretches
    splits = np.where(np.diff(idxs) != 1)[0] + 1
    for stretch in np.split(idxs, splits):
        start, end = int(stretch[0]), int(stretch[-1])
        mid = int(np.median(stretch))
        out[start:mid + 1] = out[start - 1]
        out[mid:end + 1] = out[min(end + 1, len(out) - 1)]
    return out


def remap_ids(dom_ids: np.ndarray) -> np.ndarray:
    """Renumber non-zero ids 1..K in order of first occurrence (utils.py:66-86)."""
    out = np.zeros_like(dom_ids)
    mapping = {}
    for i, v in enumerate(dom_ids):
        if v != 0:
            if v not in mapping:
                mapping[v] = len(mapping) + 1
            out[i] = mapping[v]
    return out


def shuffle_ids(dom_ids: np.ndarray, rng=None) -> np.ndarray:
    """Randomly permute domain ids (utils.py:89-107)."""
    rng = rng or np.random.default_rng()
    ids, _ = get_ids(dom_ids)
    perm = rng.permutation(len(ids)) + 1
    out = np.zeros_like(dom_ids)
    for u, d in zip(ids, perm):
        out[dom_ids == u] = d
    return out


def _natsort_key(s: str):
    return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", s)]


def format_dom_str(dom_ids: np.ndarray, ri: np.ndarray) -> str:
    """Chopping string: domains ','-separated (naturally sorted), segments
    '_'-separated, ranges 'a-b' (utils.py:511-541)."""
    dom_strs = []
    for d in np.unique(dom_ids[dom_ids != 0]):
        resi = ri[dom_ids == d].astype(np.int64)
        parts = []
        run_start = prev = int(resi[0])
        for v in resi[1:].tolist() + [None]:
            if v is not None and v == prev + 1:
                prev = v
                continue
            parts.append(f"{run_start}-{prev}" if prev > run_start else str(run_start))
            if v is not None:
                run_start = prev = v
        dom_strs.append("_".join(parts))
    return ",".join(sorted(dom_strs, key=_natsort_key))
