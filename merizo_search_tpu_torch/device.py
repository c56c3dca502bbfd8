"""Device resolution for the port's entry points, and the mesh.

A mesh is a tuple of `torch.device`s driven by one process, the
counterpart of the JAX package's one-axis `Mesh` over `jax.devices()`: a
sharded search puts each shard's tensors on its device, issues each
shard's launches on that device's current stream (launches are
asynchronous, so shards on distinct cards overlap), copies each shard's
partial top-k to the first device and merges there. No process group,
launcher or rendezvous is involved, as none is in the JAX mesh.
"""

from __future__ import annotations

import logging
from collections.abc import Sequence

import torch

logger = logging.getLogger(__name__)

Mesh = tuple[torch.device, ...]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return the torch.device an entry point runs on.

    Only "cuda" (optionally "cuda:N") and "cpu" are accepted. Asking for
    CUDA on a machine without it raises: the port never carries on on the
    CPU when the card was requested.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (CLI: -d cpu) to run the plain "
                "PyTorch versions on the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")


def make_mesh(n: int, device: str | torch.device = "cuda") -> Mesh | None:
    """The mesh of the CLI's `--mesh N` on `device`'s type (the JAX CLI's
    `_mesh`): None for n == 0; on "cuda" the cards cuda:0 ... cuda:n-1,
    shrunk with a warning to the cards there are, as JAX shrinks to
    `jax.devices()`; on "cpu" n shards on the CPU device, the counterpart
    of the JAX tests' virtual CPU devices. "cuda" without a card raises."""
    if n < 0:
        raise ValueError(f"mesh size must be >= 0, got {n}")
    if not n:
        return None
    dev = resolve_device(device)
    if dev.type == "cpu":
        return (dev,) * n
    avail = torch.cuda.device_count()
    if avail < n:
        logger.warning("requested mesh of %d devices but only %d available; using %d",
                       n, avail, avail)
        n = avail
    return tuple(torch.device("cuda", i) for i in range(n))


def resolve_mesh(mesh: Sequence[str | torch.device]) -> Mesh:
    """An explicit device list as a mesh: every entry resolved, all of one
    type. A list may repeat a device (several shards on one card or on
    the CPU); "cuda" means the card the process is on at this call."""
    devs = tuple(torch.device(d) for d in mesh)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"a mesh's devices must be of one type, got {devs}")
    devs = tuple(resolve_device(d) for d in devs)
    if devs[0].type == "cuda":
        devs = tuple(torch.device("cuda", torch.cuda.current_device() if d.index is None
                                  else d.index) for d in devs)
    return devs
