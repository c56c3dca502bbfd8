"""Synthetic protein backbones made from a seed: a copy of the port's
`tools/synthetic.py` generator, kept with the benchmark so that its
traffic does not move with the program.

`helical_backbone(rng, n)` builds an N/CA/C/O backbone of `n` residues out
of compact domains: each domain is a bundle of ideal alpha helices packed
around its own axis (CA-CA 3.8 A within a helix), and the domains sit 40 A
apart. `rotation(rng)` is a random proper rotation.
"""

from __future__ import annotations

import numpy as np

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
