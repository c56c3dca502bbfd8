"""Rigid-frame math as plain functions.

The reference carries an OpenFold-derived Rotation/Rigid class hierarchy
(programs/Merizo/model/ipa/nndef_ipa_primitives.py:439-1545) because AF2's
structure module updates frames. Merizo never updates frames: it only
applies fixed backbone frames to points, so two products and the
Gram-Schmidt constructor are all it needs (as in the JAX package).
"""

from __future__ import annotations

import numpy as np
import torch


def apply(R: torch.Tensor, t: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """R [..,3,3] applied to pts [..,3] plus translation: R @ p + t.

    Parity: Rigid.apply -> rot_vec_mul + t (nndef_ipa_primitives.py:1201-1213).
    Broadcasts over leading dims.
    """
    return (R @ pts.unsqueeze(-1)).squeeze(-1) + t


def invert_apply(R: torch.Tensor, t: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Inverse transform: R^T @ (p - t) (nndef_ipa_primitives.py:1215-1230)."""
    return (R.transpose(-1, -2) @ (pts - t).unsqueeze(-1)).squeeze(-1)


def frames_from_backbone(n_xyz: np.ndarray, ca_xyz: np.ndarray, c_xyz: np.ndarray,
                         eps: float = 1e-8):
    """Gram-Schmidt rigid frames from N/CA/C coordinates ([N,3] each).

    Parity: rigidFrom3Points (programs/Merizo/model/utils/frames.py:44-84),
    the r3.py variant: v1 = CA - N, v2 = C - CA; e3 = e1 x e2; translation = CA.
    Returns (R [N,3,3] with columns e1,e2,e3, t [N,3]) as float32 numpy.
    """
    v1 = ca_xyz - n_xyz
    v2 = c_xyz - ca_xyz
    e1 = v1 / np.sqrt(np.sum(v1 ** 2, axis=-1, keepdims=True) + eps)
    u2 = v2 - e1 * np.sum(e1 * v2, axis=-1, keepdims=True)
    e2 = u2 / np.sqrt(np.sum(u2 ** 2, axis=-1, keepdims=True) + eps)
    e3 = np.cross(e1, e2)
    R = np.stack([e1, e2, e3], axis=-1)  # columns are the basis vectors
    return R.astype(np.float32), ca_xyz.astype(np.float32)
