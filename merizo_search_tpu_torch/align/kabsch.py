"""Batched weighted Kabsch superposition (PyTorch).

The superposition core of the device TM-align (align/tmalign.py): the rigid
transform (R, t) minimising the weighted RMSD between paired point sets, by
the SVD formulation R = V diag(1, 1, det(V U^T)) U^T. Every leading
dimension is a batch dimension, so thousands of superpositions run as one
batched [..., 3, 3] SVD on the tensors' device.
"""

from __future__ import annotations

import torch


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] matrices by cofactor expansion (elementwise:
    no LU factorisation, no host round trip)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def kabsch(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor):
    """Optimal rigid transform mapping p onto q (both [..., N, 3], broadcast
    against each other), weighted by w [..., N] (>= 0; zero rows are
    ignored).

    Returns (R [..., 3, 3], t [..., 3]) such that p @ R.T + t ~= q.
    """
    wsum = w.sum(-1, keepdim=True)
    wn = w / torch.clamp(wsum, min=1e-9)
    mu_p = (p * wn[..., None]).sum(-2)
    mu_q = (q * wn[..., None]).sum(-2)
    pc = p - mu_p[..., None, :]
    qc = q - mu_q[..., None, :]
    h = torch.matmul((pc * wn[..., None]).transpose(-1, -2), qc)   # covariance [..., 3, 3]
    u, _, vt = torch.linalg.svd(h, full_matrices=False)
    v = vt.transpose(-1, -2)
    ut = u.transpose(-1, -2)
    det = _det3(torch.matmul(v, ut))
    one = torch.ones_like(det)
    d = torch.stack([one, one, det], -1)
    r = torch.matmul(v * d[..., None, :], ut)
    t = mu_q - torch.matmul(r, mu_p[..., None])[..., 0]
    return r, t


def transform(r: torch.Tensor, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply (R [..., 3, 3], t [..., 3]) to points p [..., N, 3]."""
    return torch.matmul(p, r.transpose(-1, -2)) + t[..., None, :]


def weighted_rmsd(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """RMSD between p and q over weights w, with NO superposition."""
    d2 = ((p - q) ** 2).sum(-1)
    wsum = torch.clamp(w.sum(-1), min=1e-9)
    return torch.sqrt((d2 * w).sum(-1) / wsum)
