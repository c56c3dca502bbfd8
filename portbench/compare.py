"""The numbers that decide `correct`: gaps between the program's answers and
the plain reference's, each read as the widest over the sampled queries."""

from __future__ import annotations

import numpy as np


def _widest(d: np.ndarray) -> float:
    d = np.where(np.isnan(d), np.inf, d)
    return float(d.max(initial=0.0))


def rank_gap(vals: np.ndarray, ref_vals: np.ndarray, slack=0.0) -> float:
    """max |vals - ref_vals| rank by rank ([S, k], both descending), less
    each query's `slack` ([S], how far the reference allows its scores to
    move) and not below 0; -inf against -inf reads 0, -inf against a score
    reads inf."""
    a, b = np.asarray(vals, np.float64), np.asarray(ref_vals, np.float64)
    both = np.isneginf(a) & np.isneginf(b)
    d = np.abs(a - b) - np.reshape(np.asarray(slack, np.float64), (-1, 1))
    return _widest(np.where(both, 0.0, np.maximum(d, 0.0)))


def id_gap(vals: np.ndarray, ids: np.ndarray, exact: np.ndarray, slack=0.0) -> float:
    """max |returned score - the reference's score of the returned id| over
    the returned entries (id >= 0), less that entry's `slack` and not below
    0: inf for an id the reference masks or that a query gets twice."""
    ids = np.asarray(ids)
    real = ids >= 0
    for row, ok in zip(ids, real):
        r = row[ok]
        if len(np.unique(r)) != len(r):
            return float("inf")
    d = np.abs(np.asarray(vals, np.float64) - np.asarray(exact, np.float64)) - slack
    return _widest(np.where(real, np.maximum(d, 0.0), 0.0))


def hit_lists(vals: np.ndarray, floor: float, k: int) -> np.ndarray:
    """Each row's scores at or above `floor`, descending, padded to k with
    `floor`: hit lists filtered by a score threshold, compared rank by rank
    (a hit just under the threshold on one side reads its distance to it)."""
    out = np.full((len(vals), k), floor, np.float64)
    for r, row in enumerate(np.asarray(vals, np.float64)):
        h = np.sort(row[row >= floor])[::-1][:k]
        out[r, :len(h)] = h
    return out
