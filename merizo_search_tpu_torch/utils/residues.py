"""Amino-acid tables of the CA readers and the Merizo feature path.

The port's copy of the JAX package's tables. Parity targets:
- three/single letter maps: reference programs/Foldclass/constants.py:1-10;
- the extended three-letter map of the Merizo feature path: reference
  programs/Merizo/model/utils/features.py:21-29;
- special/excluded residues: reference
  programs/Merizo/model/utils/build_info.py:145-178.
"""

from __future__ import annotations

import numpy as np

# Canonical 20 amino acids in the one-hot order of the Merizo encoder. The
# reference encodes via str.translate('ARNDCQEGHILKMFPSTWYV...' ->
# 'ABCDEFGHIJKLMNOPQRST...') - ord('A') (features.py:28-29,174-180): the
# integer class of a residue is its position in this string.
AA_ORDER = "ARNDCQEGHILKMFPSTWYV"

THREE_TO_ONE = {
    "ALA": "A", "CYS": "C", "ASP": "D", "GLU": "E", "PHE": "F",
    "GLY": "G", "HIS": "H", "ILE": "I", "LYS": "K", "LEU": "L",
    "MET": "M", "ASN": "N", "PRO": "P", "GLN": "Q", "ARG": "R",
    "SER": "S", "THR": "T", "VAL": "V", "TRP": "W", "TYR": "Y",
    "UNK": "X", "ASH": "D", "GLH": "E", "HID": "H", "HIE": "H",
    "HIP": "H", "HSD": "H", "HSE": "H", "LYN": "K",
}

ONE_TO_THREE = {v: k for k, v in THREE_TO_ONE.items()}

# Extended map of the Merizo feature path (includes PAD -> X).
THREE_TO_ONE_EXT = dict(THREE_TO_ONE)
THREE_TO_ONE_EXT.update({"PAD": "X", "SEC": "C", "MSE": "M", "PYL": "K"})

# Non-standard residues remapped to standard equivalents when parsing PDBs.
SPECIAL_AA_CONVERT = {
    "MSE": "MET",  # selenomethionine
    "SEC": "CYS",  # selenocysteine
    "CSD": "CYS",  # sulphinoalanine
    "PCA": "GLU",  # pyroglutamic acid
    "PYL": "LYS",  # pyrrolysine
}

EXCLUDE_AA = ("ASX", "GLX", "UNK")

# Integer encoding: residue class id in [0, 20); letters outside the
# canonical alphabet map to 19, as in the JAX package (the reference's
# classes 20/21 for B/J/O/U/X/Z would overflow its one-hot of 20).
_ENC = np.full(256, 19, dtype=np.int32)
for _i, _a in enumerate(AA_ORDER):
    _ENC[ord(_a)] = _i


def encode_seq(seq: str) -> np.ndarray:
    """Encode a one-letter sequence into int class ids [0,20).

    Parity: programs/Merizo/model/utils/features.py:174-180 for the canonical
    20-letter alphabet.
    """
    b = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
    return _ENC[b]


def seq_from_three(resn: np.ndarray) -> str:
    """Three-letter residue-name array -> one-letter string (X for unknowns)."""
    return "".join(THREE_TO_ONE_EXT.get(r, "X") for r in resn)
