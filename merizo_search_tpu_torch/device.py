"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


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
