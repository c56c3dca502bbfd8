"""Structural alignment backends.

Two interchangeable TM-align implementations rescore search hits:

- "native": the in-process C++ library (align/_native/tmalign.cpp) with a
  std::thread batch API, built with g++ on first use. Sequential per pair,
  best alignment quality.
- "tpu": the batched device aligner (align/tmalign.py, plain PyTorch): every
  pair of a length bucket aligns in one batch on the device the caller
  names (CLI: -d). The name is the JAX package's, kept for its flags.

"auto" prefers native and uses the device aligner only if the g++ build
fails.
"""

from __future__ import annotations

#: half-width of the decision band around a TM threshold inside which the
#: batched device aligner's result is re-checked with the native aligner.
#: The device aligner drifts from native by ~0.01 in the decision region
#: (|tm - 0.5| small) and ~0.03 on unrelated pairs, so a 0.02 band covers
#: every observed near-threshold disagreement.
NEAR_THRESHOLD_BAND = 0.02


def rescore_pairs(pairs: list[tuple], fast: bool = False,
                  backend: str = "auto", nthreads: int = 0,
                  decision_tm: float | None = None, device="cuda") -> list[dict]:
    """TM-align (query, target) coord/seq dict pairs.

    Returns one {len_ali, rmsd, seq_id, qtm, ttm} dict per pair (the schema
    of the reference's parsed TM-align output, Foldclass/utils.py:112-158).

    backend: "auto", "native" or "tpu" (the device aligner, on `device`).
    decision_tm: the TM threshold the caller will gate hits on (mintm).
    When the device aligner produced a pair's score and max(qtm, ttm) lands
    within NEAR_THRESHOLD_BAND of this threshold, the pair is re-aligned
    with the native backend (when buildable) before the result is returned,
    so the device aligner's drift cannot flip hits at the significance gate.
    Chains longer than MAX_BUCKET go to the native backend too.
    """
    if backend not in ("auto", "native", "tpu"):
        raise ValueError(f"unknown tmalign backend {backend!r}")
    from . import native

    if backend in ("auto", "native"):
        if native.available():
            return native.tmalign_pairs_native(pairs, fast=fast, nthreads=nthreads)
        if backend == "native":
            raise RuntimeError("native tmalign backend unavailable (g++ build failed?)")
    from .tmalign import MAX_BUCKET, tmalign_pairs

    # the device aligner pads pairs into static length buckets; chains past
    # the largest bucket would be truncated (with a conservative
    # renormalisation), so those pairs go to the full-length native backend
    # when it can be built
    long_idx = [i for i, (q, t) in enumerate(pairs)
                if len(q["coords"]) > MAX_BUCKET or len(t["coords"]) > MAX_BUCKET]
    if long_idx and native.available():
        long_set = set(long_idx)
        short_idx = [i for i in range(len(pairs)) if i not in long_set]
        results: list[dict | None] = [None] * len(pairs)
        long_res = native.tmalign_pairs_native([pairs[i] for i in long_idx], fast=fast,
                                               nthreads=nthreads)
        for i, r in zip(long_idx, long_res):
            results[i] = r
        if short_idx:
            short = [pairs[i] for i in short_idx]
            short_res = _recheck_near_threshold(
                short, tmalign_pairs(short, fast=fast, device=device), decision_tm,
                fast, nthreads)
            for i, r in zip(short_idx, short_res):
                results[i] = r
        return results
    results = tmalign_pairs(pairs, fast=fast, device=device)
    return _recheck_near_threshold(pairs, results, decision_tm, fast, nthreads)


def _recheck_near_threshold(pairs, results, decision_tm, fast, nthreads):
    """Re-align device-scored pairs whose max TM sits in the decision band
    with the native backend (no-op when decision_tm is None or the native
    library cannot be built)."""
    if decision_tm is None or not pairs:
        return results
    near = [i for i, r in enumerate(results)
            if abs(max(r["qtm"], r["ttm"]) - decision_tm) <= NEAR_THRESHOLD_BAND]
    if not near:
        return results
    from . import native

    if not native.available():
        return results
    redo = native.tmalign_pairs_native([pairs[i] for i in near], fast=fast,
                                       nthreads=nthreads)
    out = list(results)
    for i, r in zip(near, redo):
        out[i] = r
    return out
