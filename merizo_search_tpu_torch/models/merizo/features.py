"""Merizo input feature generation.

Parity: programs/Merizo/model/utils/features.py:31-68 (generate_features_domain):
one-hot(20) sequence, CA distance-matrix pair feature, Gram-Schmidt backbone
frames, residue indices and b-factors. Host-side numpy, the port's copy of
the JAX package's module; arrays are returned unpadded.
"""

from __future__ import annotations

import numpy as np

from ...io.pdb import get_xyz, parse_backbone, select_atoms
from ...utils.residues import encode_seq, seq_from_three
from .rigid import frames_from_backbone


def generate_features(path: str, chain: str = "A") -> dict:
    """Parse a PDB chain and build Merizo features.

    Returns dict with:
      s  [N,20] float32 one-hot sequence
      z  [N,N]  float32 CA distance map (computed in float64, then cast)
      r  [N,3,3], t [N,3] float32 backbone frames
      ri [N] float32 residue indices
      b  [N] float64 b-factors
      pdb  structured array (all backbone atoms, for output writing)
      ca   structured array of the CA atoms
      seq  one-letter string
      nres int
    """
    mol = parse_backbone(path, chain)
    if len(mol) == 0:
        raise ValueError(f"Chain {chain!r} not present or no complete backbone in {path}")
    ca = select_atoms(mol, "n", ["CA"])
    n_at = select_atoms(mol, "n", ["N"])
    c_at = select_atoms(mol, "n", ["C"])

    seq = seq_from_three(ca["resn"])
    ids = np.clip(encode_seq(seq), 0, 19)
    s = np.zeros((len(ids), 20), np.float32)
    s[np.arange(len(ids)), ids] = 1.0

    xyz = get_xyz(ca)  # float64, parity with scipy distance_matrix in f64
    diff = xyz[:, None, :] - xyz[None, :, :]
    z = np.sqrt(np.sum(diff * diff, axis=-1)).astype(np.float32)

    r, t = frames_from_backbone(get_xyz(n_at), get_xyz(ca), get_xyz(c_at))

    return {
        "s": s,
        "z": z,
        "r": r,
        "t": t,
        "ri": ca["resi"].astype(np.float32),
        "b": ca["b"].copy(),
        "pdb": mol,
        "ca": ca,
        "seq": seq,
        "nres": len(ca),
    }
