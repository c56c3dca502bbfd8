"""Batched Foldclass embedding of variable-length structures.

The reference embeds one structure per forward pass (makedb.py:75-79,
dbsearch.py:97-98). Here structures are grouped into length buckets and run
as masked batches, with the JAX package's bucketing and its merge of small
query sets into one padded batch. The JAX package also pads each batch to a
power of two rows so that its jit compiles few shapes; eager PyTorch
compiles nothing, so the port runs each batch at its own size.

With a mesh (device.py) the embedding is data parallel, as the JAX
package's sharded batch axis: each batch holds the one-device budget times
the devices, is padded with masked rows to a multiple of them, and each
device embeds its slice on its own copy of the network (`replicas`); the
slices' outputs come back in order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device, resolve_mesh
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


def replicas(model: fc.FoldClassNet, mesh) -> list[fc.FoldClassNet]:
    """The network on each device of `mesh`: the model itself on its own
    device, elsewhere a copy, made at the first call for that device and
    kept on the model (`model.mesh_replicas`), so a DB build copies the
    weights once, not once a chunk. For inference: a copy does not follow
    a later change of the model's weights."""
    own = next(model.parameters()).device
    mesh = resolve_mesh(mesh)
    cache = model.__dict__.setdefault("mesh_replicas", {})
    for dev in mesh:
        if dev != own and dev not in cache:
            net = fc.FoldClassNet()
            net.load_state_dict(model.state_dict())
            cache[dev] = net.to(dev).eval()
    return [model if dev == own else cache[dev] for dev in mesh]


def _batch_budget(bucket: int) -> int:
    """Structures per batch for a given bucket length: bound total pair work
    (B * N^2) at ~8M pairs per forward pass."""
    return max(1, (1 << 23) // (bucket * bucket))


@torch.no_grad()
def embed_structures(model: fc.FoldClassNet, coords_list: list[np.ndarray],
                     batch_budget=None, mesh=None) -> np.ndarray:
    """Embed a list of [N_i, 3] float32 CA coordinate arrays -> [n, 128].

    Runs on the device the model's parameters live on, or data parallel
    over the devices of `mesh` (module docstring). Structures longer than
    MAX_RES are truncated (parity: makedb.py:68).
    """
    nets = [model] if mesh is None else replicas(model, mesh)
    ndev = len(nets)
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
        bsz = batch_budget(bucket) if batch_budget else _batch_budget(bucket) * ndev
        bsz = -(-bsz // ndev) * ndev
        for i0 in range(0, len(idxs), bsz):
            sel = idxs[i0:i0 + bsz]
            per = -(-len(sel) // ndev)          # rows a device; padding rows masked
            batch = np.zeros((per * ndev, bucket, 3), np.float32)
            mask = np.zeros((per * ndev, bucket), np.float32)
            for bi, si in enumerate(sel):
                batch[bi], mask[bi] = pad_coords(coords_list[si][:MAX_RES], bucket)
            # every device's forward is issued before the first copy back
            embs = [net(torch.from_numpy(batch[j * per:(j + 1) * per]).to(dev),
                        torch.from_numpy(mask[j * per:(j + 1) * per]).to(dev))
                    for j, (net, dev) in enumerate(
                        (net, next(net.parameters()).device) for net in nets)]
            out[sel] = torch.cat([e.cpu() for e in embs]).numpy()[:len(sel)]
    return out
