"""Structural alignment for rescoring: the native C++ TM-align only.

The batched device aligner of the JAX package is a later slice of the port
(ROADMAP.md, queue 1). Until then `rescore_pairs` has one backend, and a
failed g++ build raises instead of falling back.
"""

from __future__ import annotations


def rescore_pairs(pairs: list[tuple], fast: bool = False,
                  nthreads: int = 0) -> list[dict]:
    """TM-align (query, target) coord/seq dict pairs with the native library.

    Returns one {len_ali, rmsd, seq_id, qtm, ttm} dict per pair.
    """
    from .native import tmalign_pairs_native

    return tmalign_pairs_native(pairs, fast=fast, nthreads=nthreads)
