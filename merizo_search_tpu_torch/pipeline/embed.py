"""Batched Foldclass embedding of variable-length structures.

The reference embeds one structure per forward pass (makedb.py:75-79,
dbsearch.py:97-98). Here structures are grouped into length buckets and run
as masked batches, with the JAX package's bucketing and its merge of small
query sets into one padded batch. The JAX package also pads each batch to a
power of two rows so that its jit compiles few shapes; eager PyTorch
compiles nothing, so the port runs each batch at its own size.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models import foldclass as fc
from ..utils.bucketing import pad_coords, group_by_bucket

MAX_RES = 2000  # reference truncation at db build (makedb.py:68-69)


def load_foldclass_params(weights_path: str | None = None,
                          device: str | torch.device = "cuda") -> fc.FoldClassNet:
    """The Foldclass network on `device`, in eval mode: reference weights
    from a `.pt` state dict, or, when no checkpoint is given, the JAX
    package's default random weights (`fc.default_state_dict`; the
    reference's trained FINAL_foldclass_model.pt is not in this mirror)."""
    dev = resolve_device(device)
    if weights_path:
        sd = torch.load(weights_path, map_location="cpu")
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
    else:
        sd = fc.default_state_dict()
    model = fc.FoldClassNet()
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    return model.to(dev).eval()


def _batch_budget(bucket: int) -> int:
    """Structures per batch for a given bucket length: bound total pair work
    (B * N^2) at ~8M pairs per forward pass."""
    return max(1, (1 << 23) // (bucket * bucket))


@torch.no_grad()
def embed_structures(model: fc.FoldClassNet, coords_list: list[np.ndarray],
                     batch_budget=None) -> np.ndarray:
    """Embed a list of [N_i, 3] float32 CA coordinate arrays -> [n, 128].

    Runs on the device the model's parameters live on. Structures longer
    than MAX_RES are truncated (parity: makedb.py:68).
    """
    dev = next(model.parameters()).device
    n = len(coords_list)
    out = np.zeros((n, fc.EMBED_DIM), dtype=np.float32)
    lengths = [min(len(c), MAX_RES) for c in coords_list]
    groups = group_by_bucket(lengths)

    # Small query sets (a handful of structures spanning 2-4 length buckets)
    # cost one forward pass per bucket; collapse the buckets into one padded
    # batch whenever the padded pair work still fits one batch budget. Big
    # sweeps keep exact bucketing, where the N^2 padding blowup would
    # dominate. Masked padding leaves every embedding unchanged.
    if len(groups) > 1:
        maxb = max(groups)
        if n * maxb * maxb <= (1 << 23):
            groups = {maxb: sorted(i for idxs in groups.values() for i in idxs)}

    for bucket, idxs in sorted(groups.items()):
        bsz = batch_budget(bucket) if batch_budget else _batch_budget(bucket)
        for i0 in range(0, len(idxs), bsz):
            sel = idxs[i0:i0 + bsz]
            batch = np.zeros((len(sel), bucket, 3), np.float32)
            mask = np.zeros((len(sel), bucket), np.float32)
            for bi, si in enumerate(sel):
                batch[bi], mask[bi] = pad_coords(coords_list[si][:MAX_RES], bucket)
            emb = model(torch.from_numpy(batch).to(dev),
                        torch.from_numpy(mask).to(dev)).cpu().numpy()
            out[sel] = emb
    return out
