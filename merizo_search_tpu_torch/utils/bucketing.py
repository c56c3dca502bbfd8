"""Length bucketing for batched embedding.

Variable-length structures are padded up to a small set of buckets and
masked, so one batch holds structures of similar length and the padded pair
work stays bounded. The buckets are those of the JAX package, so both
packages batch a query set the same way.
"""

from __future__ import annotations

import numpy as np

# Powers-of-two-ish (multiples of 64). The embedder truncates
# at the reference's 2000-residue cap (makedb.py:68-69); segmentation runs
# full length, so buckets extend to 3072 — above AFDB's 2700-residue chain
# cap — beyond which the N^2 pair tensors (c_z=32 -> ~1.2 GB at 3072) stop
# fitting comfortably and the segmenter reports a clear per-structure error
# instead of bucketing (see segment/pipeline.py).
DEFAULT_BUCKETS = (64, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 3072)


def bucket_for(n: int, buckets=DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def pad_coords(coords: np.ndarray, bucket: int):
    """Pad [N,3] float32 coords to [bucket,3]; returns (padded, mask)."""
    n = min(len(coords), bucket)
    out = np.zeros((bucket, 3), dtype=np.float32)
    out[:n] = coords[:n]
    mask = np.zeros(bucket, dtype=np.float32)
    mask[:n] = 1.0
    return out, mask


def group_by_bucket(lengths, buckets=DEFAULT_BUCKETS) -> dict[int, list[int]]:
    """Group item indices by their length bucket."""
    groups: dict[int, list[int]] = {}
    for i, n in enumerate(lengths):
        groups.setdefault(bucket_for(int(n), buckets), []).append(i)
    return groups
