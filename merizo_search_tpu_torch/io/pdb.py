"""PDB CA reader for the search path.

Vectorised NumPy fixed-width parsing (the reference parses line-by-line in
Python: programs/Foldclass/utils.py:42-72). This is the port's copy of the
JAX package's numpy reader, which is also that package's behavioural
specification for its native parser.
"""

from __future__ import annotations

import numpy as np

from ..utils.residues import THREE_TO_ONE


def _read_bytes(path: str) -> bytes:
    """File bytes, transparently gunzipped for .gz inputs (the PDB archive
    distributes structures as pdb<id>.ent.gz)."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if path.endswith(".gz"):
        import gzip

        raw = gzip.decompress(raw)
    return raw


def _line_matrix(path: str) -> np.ndarray:
    """Read a PDB file into a [n_lines, 80] uint8 matrix (lines padded/truncated)."""
    lines = _read_bytes(path).splitlines()
    mat = np.full((len(lines), 80), ord(" "), dtype=np.uint8)
    for k, ln in enumerate(lines):
        m = min(len(ln), 80)
        mat[k, :m] = np.frombuffer(ln[:m], dtype=np.uint8)
    return mat


def _col_str(mat: np.ndarray, a: int, b: int) -> np.ndarray:
    """Fixed-width column slice -> stripped unicode array."""
    width = b - a
    col = np.ascontiguousarray(mat[:, a:b]).view(f"S{width}").ravel()
    return np.char.strip(col.astype(f"U{width}"))


def _col_float(strs: np.ndarray) -> np.ndarray:
    out = np.zeros(len(strs), dtype=np.float64)
    ok = strs != ""
    if ok.any():
        out[ok] = strs[ok].astype(np.float64)
    return out


def read_ca(path: str, chain: str = "A") -> dict:
    """CA-only reader used by the search path.

    Parity: programs/Foldclass/utils.py:42-72 (read_pdb): plain ATOM records
    with atom name ' CA ' and chain character at column 21; no altloc
    handling; unknown residues become 'X'.

    Returns {'coords': float32 [N,3], 'seq': str, 'name': path}.
    mmCIF inputs (.cif/.mmcif, optionally .gz) are dispatched to io.mmcif.
    """
    from ..utils.names import CIF_EXTS

    if path.endswith(CIF_EXTS):
        from .mmcif import read_ca_mmcif

        return read_ca_mmcif(path, chain)
    if len(chain) != 1:
        raise ValueError(f"Invalid chain ID: {chain!r}")
    mat = _line_matrix(path)
    rec = _col_str(mat, 0, 4)
    name4 = np.ascontiguousarray(mat[:, 12:16]).view("S4").ravel().astype("U4")
    keep = (rec == "ATOM") & (name4 == " CA ") & (mat[:, 21] == ord(chain))
    mat = mat[keep]
    if len(mat) == 0:
        raise ValueError(f"Chain ID {chain!r} not present in PDB file {path}")
    coords = np.stack(
        [
            _col_float(_col_str(mat, 30, 38)),
            _col_float(_col_str(mat, 38, 46)),
            _col_float(_col_str(mat, 46, 54)),
        ],
        axis=-1,
    ).astype(np.float32)
    resn = _col_str(mat, 17, 20)
    seq = "".join(THREE_TO_ONE.get(r, "X") for r in resn)
    return {"coords": coords, "seq": seq, "name": path}
