"""PDB structure I/O: the CA reader of createdb/search, the backbone parser
of the segmenter, and the segmenter's PDB writers.

Vectorised NumPy fixed-width parsing (the reference parses line-by-line in
Python: programs/Merizo/model/utils/pdb_parser.py:25-96 and
programs/Foldclass/utils.py:42-72). This is the port's copy of the JAX
package's module; `read_ca` dispatches to the native C++ scan
(io/native_parse.py) and keeps the numpy path as its specification.
"""

from __future__ import annotations

import numpy as np

from ..utils.residues import (EXCLUDE_AA, SPECIAL_AA_CONVERT, THREE_TO_ONE,
                              seq_from_three)

ATOM_DTYPE = [
    ("type", "U6"), ("i", "i4"), ("n", "U4"), ("alt", "U1"),
    ("resn", "U3"), ("chain", "U2"), ("resi", "i4"), ("x", "f8"),
    ("y", "f8"), ("z", "f8"), ("occ", "f8"), ("b", "f8"), ("conf", "f8"),
]

BACKBONE_ATOMS = ("N", "CA", "C", "O")


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
    """CA-only reader of the search and createdb paths.

    Parity: programs/Foldclass/utils.py:42-72 (read_pdb): plain ATOM records
    with atom name ' CA ' and chain character at column 21; no altloc
    handling; unknown residues become 'X'.

    The scan runs in the native C++ library when it builds
    (io/_native/pdbparse.cpp, same record semantics); the numpy path below
    is the specification and the fallback without g++.

    Returns {'coords': float32 [N,3], 'seq': str, 'name': path}.
    mmCIF inputs (.cif/.mmcif, optionally .gz) are dispatched to io.mmcif.
    """
    from ..utils.names import CIF_EXTS

    if path.endswith(CIF_EXTS):
        from .mmcif import read_ca_mmcif

        return read_ca_mmcif(path, chain)
    if len(chain) != 1:
        raise ValueError(f"Invalid chain ID: {chain!r}")
    from . import native_parse

    if native_parse.available():
        out = native_parse.parse_ca_bytes(_read_bytes(path), chain)
        if out is not None:
            coords, seq = out
            if len(coords) == 0:
                raise ValueError(
                    f"Chain ID {chain!r} not present in PDB file {path}")
            return {"coords": coords, "seq": seq, "name": path}
    return read_ca_numpy(path, chain)


def read_ca_numpy(path: str, chain: str = "A") -> dict:
    """The numpy path of `read_ca` for PDB files: the specification the
    native parser is held to."""
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


def parse_backbone(path: str, chain: str = "A") -> np.ndarray:
    """Parse backbone (N, CA, C, O) atoms of one chain into a structured array.

    Combines the semantics of the reference's open_pdb + check_alt_res +
    check_bb + resi sort (pdb_parser.py:25-96,215-253,256-282; features.py:70-84):

    - only the first model (stop at END/ENDMDL);
    - ATOM records, plus HETATM records for special residues (MSE/SEC/CSD/PCA/PYL)
      which are remapped to their standard equivalents;
    - residues in EXCLUDE_AA (ASX/GLX/UNK) and hydrogen-numbered atom names skipped;
    - alternate locations resolved by highest occupancy (ties -> last record);
    - residues missing any of N/CA/C/O dropped entirely;
    - output sorted by residue index (stable).

    Returns a structured array with ATOM_DTYPE fields.
    mmCIF inputs (.cif/.mmcif, optionally .gz) are dispatched to io.mmcif.
    """
    from ..utils.names import CIF_EXTS

    if path.endswith(CIF_EXTS):
        from .mmcif import parse_backbone_mmcif

        return parse_backbone_mmcif(path, chain)
    mat = _line_matrix(path)
    rec = _col_str(mat, 0, 6)

    # First model only.
    is_end = (rec == "END") | (rec == "ENDMDL")
    if is_end.any():
        stop = int(np.argmax(is_end))
        mat = mat[:stop]
        rec = rec[:stop]

    resn = _col_str(mat, 17, 20)
    is_atom = rec == "ATOM"
    is_special_het = (rec == "HETATM") & np.isin(resn, list(SPECIAL_AA_CONVERT))
    keep = is_atom | is_special_het

    # Skip hydrogen-style names where column 12 is a digit (pdb_parser.py:57).
    digit12 = (mat[:, 12] >= ord("0")) & (mat[:, 12] <= ord("9"))
    keep &= ~digit12
    keep &= ~np.isin(resn, list(EXCLUDE_AA))

    name = _col_str(mat, 12, 16)
    keep &= np.isin(name, list(BACKBONE_ATOMS))

    chain_col = _col_str(mat, 20, 22)  # reference uses line[20:22].strip()
    keep &= chain_col == chain

    if not keep.any():
        return np.empty(0, dtype=ATOM_DTYPE)

    mat = mat[keep]
    out = np.empty(keep.sum(), dtype=ATOM_DTYPE)
    out["type"] = "ATOM"
    out["i"] = _col_str(mat, 6, 11).astype(np.int64)
    out["n"] = name[keep]
    out["alt"] = _col_str(mat, 16, 17)
    rn = resn[keep]
    for special, std in SPECIAL_AA_CONVERT.items():
        rn[rn == special] = std
    out["resn"] = rn
    out["chain"] = chain_col[keep]
    out["resi"] = _col_str(mat, 22, 26).astype(np.int64)
    out["x"] = _col_float(_col_str(mat, 30, 38))
    out["y"] = _col_float(_col_str(mat, 38, 46))
    out["z"] = _col_float(_col_str(mat, 46, 54))
    out["occ"] = _col_float(_col_str(mat, 54, 60))
    out["b"] = _col_float(_col_str(mat, 60, 66))
    out["conf"] = 0.0

    return finalize_backbone(out)


def finalize_backbone(out: np.ndarray) -> np.ndarray:
    """Shared tail of the backbone parsers (PDB and mmCIF): altloc
    resolution, complete-backbone filter, residue sort."""
    # Alternate-location resolution: for duplicate (resi, atom-name), keep the
    # highest-occupancy record (stable; ties -> last), cf. check_alt_res.
    order = np.arange(len(out))
    sort_idx = np.lexsort((order, out["occ"], out["n"], out["resi"]))
    s = out[sort_idx]
    # last entry of each (resi, n) group wins (highest occ, ties -> last)
    nxt_differs = np.ones(len(s), dtype=bool)
    if len(s) > 1:
        nxt_differs[:-1] = (s["resi"][:-1] != s["resi"][1:]) | (s["n"][:-1] != s["n"][1:])
    s = s[nxt_differs]

    # Complete-backbone filter: after dedup each (resi, n) appears once, so a
    # residue with all four backbone atoms counts 4.
    _, inv, counts = np.unique(s["resi"], return_inverse=True, return_counts=True)
    s = s[counts[inv] == 4]

    # Stable sort by resi (features.py:76).
    return s[np.argsort(s["resi"], kind="stable")]


def select_atoms(mol: np.ndarray, field: str, values) -> np.ndarray:
    """Rows of a structured array whose `field` is in `values`.

    Parity: pdb_parser.py:165-176 (select_from_mol).
    """
    return mol[np.isin(mol[field], values)]


def backbone_to_ca(mol: np.ndarray) -> np.ndarray:
    return select_atoms(mol, "n", ["CA"])


def get_xyz(mol: np.ndarray) -> np.ndarray:
    """Coordinates as [N, 3] float64 (reference returns [3, N]; we use [N, 3])."""
    return np.stack([mol["x"], mol["y"], mol["z"]], axis=-1)


def write_pdb_records(mol: np.ndarray, path: str, comments=None) -> None:
    """Write a structured-array molecule to a PDB file.

    Parity: programs/Merizo/model/utils/pdb_parser.py:9-22 (write_pdb), including
    the occupancy column carrying domain ids (%6.2f) and b-factor as %6d.
    """
    with open(path, "w") as fh:
        for line in mol:
            fh.write(
                "ATOM  %5d  %-4s%s %-1s%4d    %8.3f%8.3f%8.3f%6.2f%6d\n"
                % (
                    line["i"], line["n"], line["resn"], line["chain"], line["resi"],
                    line["x"], line["y"], line["z"], line["occ"], line["b"],
                )
            )
        fh.write("END\n\n")
        if comments:
            for c in comments:
                fh.write("REMARK  %s\n" % c)


def mol_to_fasta(mol: np.ndarray) -> str:
    """One-letter sequence of the CA atoms of a molecule (features.py:88-98)."""
    return seq_from_three(mol[mol["n"] == "CA"]["resn"])
