"""Segmentation accuracy evaluation against reference ground-truth datasets.

The reference ships CATH/AFDB/ECOD domain-boundary CSVs
(programs/Merizo/datasets/merizo_domains/, format documented in that
directory's README) but no harness that consumes them — they were used
offline for the paper's evaluation. This module wires them up: it parses the
ground-truth chopping format, parses predicted choppings (`_segment.tsv`
column or raw chopping strings), and scores predictions with

- **domain-count accuracy**: predicted == true number of (unmasked) domains;
- **NDO-style overlap score**: residue overlap under the optimal one-to-one
  matching of predicted to true domains (Hungarian assignment), normalised
  by the residue count covered by either chopping. 1.0 = identical chopping.
- **boundary F1**: domain boundary positions matched within +-`tol` residues.

Ground-truth format (datasets README): domains '|'-delimited, discontinuous
segments '_'-delimited, ranges 'start-end', each domain suffixed ':T_S'
labels; label ':999_999' marks holding-pen domains to ignore.
Predicted chopping format (format_dom_str, reference
model/utils/utils.py:511-541): domains ','-delimited, segments '_'-delimited.

The PyTorch package keeps its own copy of the JAX package's module (numpy
and scipy only), so the port needs nothing of the JAX package.
"""

from __future__ import annotations

import csv
import logging

import numpy as np

logger = logging.getLogger(__name__)

MASK_LABEL = "999_999"


def parse_gt_chopping(col7: str) -> list[set[int]]:
    """'100-129_168-292:40_1078|1-99:40_1078' -> [set of residue ids per
    domain], holding-pen (999_999) domains dropped."""
    domains = []
    for dom in col7.split("|"):
        if not dom.strip():
            continue
        rng, _, label = dom.partition(":")
        if label.strip() == MASK_LABEL:
            continue
        res: set[int] = set()
        for seg in rng.split("_"):
            if not seg.strip():
                continue
            a, _, b = seg.partition("-")
            lo, hi = int(a), int(b or a)
            res.update(range(lo, hi + 1))
        if res:
            domains.append(res)
    return domains


def parse_pred_chopping(dom_str: str) -> list[set[int]]:
    """'1001-1023_1039-1073,1024-1038' -> [set of residue ids per domain]
    (format_dom_str output; 'na' / '' -> no domains)."""
    if not dom_str or dom_str in ("na", "NA", "-"):
        return []
    out = []
    for dom in dom_str.split(","):
        res: set[int] = set()
        for seg in dom.split("_"):
            if not seg.strip():
                continue
            a, _, b = seg.partition("-")
            lo, hi = int(a), int(b or a)
            res.update(range(lo, hi + 1))
        if res:
            out.append(res)
    return out


def load_gt_csv(path: str) -> dict[str, list[set[int]]]:
    """CATH-X.csv / AFDB-X.csv -> {pdb_chain_id: [domain residue sets]}."""
    gt = {}
    with open(path) as fh:
        for row in csv.reader(fh):
            if len(row) < 7:
                continue
            gt[row[1].strip()] = parse_gt_chopping(row[6])
    return gt


def load_segment_tsv(path: str, chopping_col: int | None = None
                     ) -> dict[str, str]:
    """_segment.tsv -> {name: chopping string}. The chopping column is
    auto-detected as the last column unless given (write_segment_results
    layout: name, length, nres_domain, nres_non_domain, num_domains, conf,
    time, chopping)."""
    preds = {}
    with open(path) as fh:
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2 or parts[0] in ("name", "filename"):
                continue
            col = chopping_col if chopping_col is not None else len(parts) - 1
            preds[parts[0]] = parts[col]
    return preds


def _boundaries(domains: list[set[int]]) -> set[int]:
    """Segment start/end residues of every domain (internal chopping points)."""
    b = set()
    for res in domains:
        rs = sorted(res)
        b.add(rs[0])
        b.add(rs[-1])
        for i in range(len(rs) - 1):  # discontinuity edges
            if rs[i + 1] != rs[i] + 1:
                b.add(rs[i])
                b.add(rs[i + 1])
    return b


def score_chopping(pred: list[set[int]], true: list[set[int]], tol: int = 8):
    """Score one chain. Returns dict with ndo_overlap, count_match,
    boundary_f1."""
    if not true and not pred:
        return {"ndo_overlap": 1.0, "count_match": True, "boundary_f1": 1.0}
    if not true or not pred:
        return {"ndo_overlap": 0.0, "count_match": len(pred) == len(true),
                "boundary_f1": 0.0}

    # optimal 1:1 domain matching by residue overlap
    ov = np.zeros((len(pred), len(true)))
    for i, p in enumerate(pred):
        for j, t in enumerate(true):
            ov[i, j] = len(p & t)
    try:
        from scipy.optimize import linear_sum_assignment

        ri, ci = linear_sum_assignment(-ov)
        matched = ov[ri, ci].sum()
    except ImportError:  # pragma: no cover - greedy fallback
        # greedy over all (pred, true) pairs by descending overlap: each
        # domain used at most once (not optimal, but never drops a pred
        # whose best column was taken — it falls through to its next pair)
        matched, used_p, used_t = 0.0, set(), set()
        order = np.dstack(np.unravel_index(np.argsort(-ov, axis=None),
                                           ov.shape))[0]
        for i, j in order:
            if i not in used_p and j not in used_t and ov[i, j] > 0:
                matched += ov[i, j]
                used_p.add(int(i))
                used_t.add(int(j))
    union = len(set().union(*pred) | set().union(*true))
    ndo = matched / max(union, 1)

    bp, bt = _boundaries(pred), _boundaries(true)
    tp = sum(1 for b in bp if any(abs(b - x) <= tol for x in bt))
    prec = tp / max(len(bp), 1)
    rec = sum(1 for b in bt if any(abs(b - x) <= tol for x in bp)) / max(len(bt), 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-12)
    return {"ndo_overlap": float(ndo), "count_match": len(pred) == len(true),
            "boundary_f1": float(f1)}


def evaluate(gt: dict[str, list[set[int]]], preds: dict[str, str],
             tol: int = 8) -> dict:
    """Aggregate scores over all chains present in both gt and preds."""
    rows = []
    for name, dom_str in preds.items():
        key = name if name in gt else name.split(".")[0]
        if key not in gt:
            continue
        s = score_chopping(parse_pred_chopping(dom_str), gt[key], tol=tol)
        s["name"] = key
        rows.append(s)
    if not rows:
        return {"n": 0}
    return {
        "n": len(rows),
        "ndo_overlap_mean": float(np.mean([r["ndo_overlap"] for r in rows])),
        "count_accuracy": float(np.mean([r["count_match"] for r in rows])),
        "boundary_f1_mean": float(np.mean([r["boundary_f1"] for r in rows])),
        "per_chain": rows,
    }
