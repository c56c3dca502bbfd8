"""Synthetic structures made from a seed, for the segmenter's and the DB
builder's checks (tests and chip_smoke.py): no downloaded data is needed.

`helical_backbone(rng, n)` builds an N/CA/C/O backbone of `n` residues out
of compact domains: each domain is a bundle of ideal alpha helices packed
around its own axis (well-defined Gram-Schmidt frames, CA-CA 3.8 A within a
helix), and the domains sit 40 A apart, so the CA distance map has clear
blocks. `write_backbone_pdb` writes it as a PDB file that io.pdb's parsers
read.
"""

from __future__ import annotations

import numpy as np

AA3 = ("ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
       "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL")
ATOMS = ("N", "CA", "C", "O")
# cylindrical placement of each backbone atom of an ideal alpha helix,
# relative to its CA: (radius A, phase deg, rise A); 100 deg and 1.5 A a residue
_HELIX = {"N": (1.55, -28.0, -0.91), "CA": (2.3, 0.0, 0.0),
          "C": (1.6, 28.0, 0.88), "O": (1.9, 40.0, 2.0)}


def _helix(n: int) -> np.ndarray:
    """[n, 4, 3] backbone of an ideal helix along +z, starting at z = 0."""
    i = np.arange(n)[:, None]
    out = np.empty((n, 4, 3))
    for a, name in enumerate(ATOMS):
        r, ph, dz = _HELIX[name]
        ang = np.deg2rad(i * 100.0 + ph)
        out[:, a] = np.concatenate([r * np.cos(ang), r * np.sin(ang), i * 1.5 + dz], 1)
    return out


def rotation(rng) -> np.ndarray:
    """A random proper rotation [3, 3] (QR of a Gaussian matrix)."""
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


def helical_backbone(rng, n: int, domain_len=(80, 160), helix_len=(12, 20)) -> np.ndarray:
    """[n, 4, 3] float64 N/CA/C/O coordinates of compact helical domains."""
    chunks, done, d = [], 0, 0
    while done < n:
        size = min(int(rng.integers(*domain_len)), n - done)
        if 0 < n - done - size < 30:        # no stub domain at the end
            size = n - done
        centre = 40.0 * np.array([d % 4, (d // 4) % 4, d // 16], float)
        rot = rotation(rng)
        k, placed = 0, 0
        while placed < size:
            h = min(int(rng.integers(*helix_len)), size - placed)
            bb = _helix(h) - np.array([0.0, 0.0, h * 0.75])
            if k % 2:
                bb = bb * np.array([1.0, -1.0, -1.0])      # antiparallel neighbour
            ang = 2.0 * np.pi * k / 6.0
            shift = (5.0 + 5.0 * (k // 6)) * np.array([np.cos(ang), np.sin(ang), 0.0])
            chunks.append((bb + shift) @ rot.T + centre)
            placed += h
            k += 1
        done += size
        d += 1
    return np.concatenate(chunks)[:n]


def write_backbone_pdb(path: str, bb: np.ndarray, rng=None, chain: str = "A") -> None:
    """Write an [n, 4, 3] backbone as ATOM records (residue names random
    from the 20 amino acids when `rng` is given, else ALA; b-factors 50)."""
    names = (AA3[j] for j in rng.integers(0, 20, len(bb))) if rng is not None \
        else ("ALA" for _ in bb)
    k = 0
    with open(path, "w") as fh:
        for r, (res, resn) in enumerate(zip(bb, names), start=1):
            for name, (x, y, z) in zip(ATOMS, res):
                k += 1
                fh.write(f"ATOM  {k:5d}  {name:<3s} {resn} {chain}{r:4d}    "
                         f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00 50.00           {name[0]}\n")
        fh.write("END\n")
