"""Vectorised sequence-identity count over an alignment map.

The reference derives seq_id from TM-align's stdout (the ':' / '.' midline,
programs/Foldclass/utils.py:112-158). Both in-tree aligners instead return an
explicit per-residue alignment map (ali[i] = aligned target index or -1);
this helper counts identical aligned residues in one NumPy pass instead of a
per-residue Python loop.
"""

from __future__ import annotations

import numpy as np


def seq_identity_count(qseq: str, tseq: str, ali: np.ndarray) -> int:
    """Number of aligned positions (ali[i] >= 0) where qseq[i] == tseq[ali[i]]."""
    nq = min(len(qseq), len(ali))
    if nq == 0 or not tseq:
        return 0
    a = np.asarray(ali[:nq], dtype=np.int64)
    qa = np.frombuffer(qseq[:nq].encode("ascii", "replace"), np.uint8)
    ta = np.frombuffer(tseq.encode("ascii", "replace"), np.uint8)
    valid = (a >= 0) & (a < ta.size)
    j = np.where(valid, a, 0)
    return int(np.count_nonzero(valid & (qa == ta[j])))
