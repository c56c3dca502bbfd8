"""Minimal mmCIF (PDBx) readers: CA records and the backbone.

The reference only consumes legacy .pdb files (makedb.py:47 lists *.pdb),
but AFDB/PDB distribution has moved to mmCIF; createdb and the query paths
accept .cif/.mmcif here. Parses the `_atom_site` loop directly (no gemmi
dependency): field order is taken from the loop header, so any column
arrangement works.

`read_ca_mmcif` returns the same {'coords', 'seq', 'name'} dict as
io.pdb.read_ca; `parse_backbone_mmcif` the same structured array as
io.pdb.parse_backbone. The port's copy of the JAX package's reader.
"""

from __future__ import annotations

import gzip

import numpy as np

from ..utils.residues import THREE_TO_ONE


def _tokenize(line: str) -> list[str]:
    """Whitespace split honouring single/double-quoted fields."""
    if "'" not in line and '"' not in line:
        return line.split()
    out, i, n = [], 0, len(line)
    while i < n:
        while i < n and line[i] in " \t":
            i += 1
        if i >= n:
            break
        if line[i] in "'\"":
            qc = line[i]
            j = line.find(qc, i + 1)
            j = n if j < 0 else j
            out.append(line[i + 1:j])
            i = j + 1
        else:
            j = i
            while j < n and line[j] not in " \t":
                j += 1
            out.append(line[i:j])
            i = j
    return out


def _atom_site(path: str):
    """Extract the _atom_site loop: (field->column dict, token rows)."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as fh:
        lines = fh.read().splitlines()

    fields: list[str] = []
    rows: list[list[str]] = []
    i = 0
    n = len(lines)
    while i < n:
        if lines[i].strip() == "loop_":
            j = i + 1
            hdr = []
            while j < n and lines[j].strip().startswith("_"):
                hdr.append(lines[j].strip().split()[0])
                j += 1
            if hdr and hdr[0].startswith("_atom_site."):
                fields = [h.split(".", 1)[1] for h in hdr]
                while j < n:
                    s = lines[j].strip()
                    if not s or s.startswith(("#", "loop_", "_", "data_")):
                        break
                    rows.append(_tokenize(s))
                    j += 1
                break
            i = j
        else:
            i += 1

    if not fields:
        raise ValueError(f"no _atom_site loop in mmCIF file {path}")
    idx = {f: k for k, f in enumerate(fields)}

    def col(row, name, default=None):
        """Field accessor treating missing columns AND mmCIF null tokens
        ('.', '?') as the default."""
        k = idx.get(name)
        if k is None or k >= len(row):
            return default
        v = row[k]
        return default if v in (".", "?") else v

    return col, idx, rows


def _to_float(v, default=0.0):
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


def _to_int(v, default=0):
    try:
        return int(v)
    except (TypeError, ValueError):
        return default


def read_ca_mmcif(path: str, chain: str = "A") -> dict:
    """CA-only mmCIF reader. Prefers auth_asym_id for chain matching (what
    PDB-derived files label chains with), falling back to label_asym_id."""
    col, idx, rows = _atom_site(path)

    coords, seq = [], []
    chain_field = "auth_asym_id" if "auth_asym_id" in idx else "label_asym_id"
    first_model = None
    for row in rows:
        if col(row, "group_PDB", "ATOM") != "ATOM":
            continue
        if col(row, "label_atom_id") != "CA":
            continue
        if col(row, chain_field, "A") != chain:
            continue
        # multi-model entries (NMR) share one _atom_site loop — keep only
        # the first model or every residue appears once per model
        model = col(row, "pdbx_PDB_model_num", "1")
        if first_model is None:
            first_model = model
        elif model != first_model:
            continue
        alt = col(row, "label_alt_id", ".")
        if alt not in (".", "?", "A"):
            continue  # first altloc only (parity with the fast PDB reader)
        x, y, z = (col(row, f) for f in ("Cartn_x", "Cartn_y", "Cartn_z"))
        if x is None or y is None or z is None:
            continue  # truncated/null row
        coords.append([_to_float(x), _to_float(y), _to_float(z)])
        seq.append(THREE_TO_ONE.get(col(row, "label_comp_id", ""), "X"))

    if not coords:
        raise ValueError(f"Chain ID {chain!r} not present in mmCIF file {path}")
    return {"coords": np.asarray(coords, np.float32),
            "seq": "".join(seq), "name": path}


def parse_backbone_mmcif(path: str, chain: str = "A") -> np.ndarray:
    """Backbone (N, CA, C, O) mmCIF parser with the same semantics as
    io.pdb.parse_backbone: first model, special-residue remapping,
    altloc-by-occupancy resolution, complete-backbone filter, resi sort.
    Returns a structured array with io.pdb.ATOM_DTYPE fields."""
    from .pdb import ATOM_DTYPE, BACKBONE_ATOMS, finalize_backbone
    from ..utils.residues import SPECIAL_AA_CONVERT, EXCLUDE_AA

    col, idx, rows = _atom_site(path)

    chain_field = "auth_asym_id" if "auth_asym_id" in idx else "label_asym_id"
    resi_field = "auth_seq_id" if "auth_seq_id" in idx else "label_seq_id"
    first_model = None
    recs = []
    for row in rows:
        grp = col(row, "group_PDB", "ATOM")
        resn = col(row, "label_comp_id", "")
        if grp == "HETATM":
            if resn not in SPECIAL_AA_CONVERT:
                continue
        elif grp != "ATOM":
            continue
        name = col(row, "label_atom_id")
        if name not in BACKBONE_ATOMS:
            continue
        if col(row, chain_field, "A") != chain:
            continue
        model = col(row, "pdbx_PDB_model_num", "1")
        if first_model is None:
            first_model = model
        elif model != first_model:
            continue
        if resn in EXCLUDE_AA:
            continue
        resn = SPECIAL_AA_CONVERT.get(resn, resn)
        x, y, z = (col(row, f) for f in ("Cartn_x", "Cartn_y", "Cartn_z"))
        resi = col(row, resi_field)
        if x is None or y is None or z is None or resi is None:
            continue  # truncated or null-token row
        recs.append((
            "ATOM", _to_int(col(row, "id", "0")), name,
            col(row, "label_alt_id", ""), resn,
            col(row, chain_field, "A"), _to_int(resi),
            _to_float(x), _to_float(y), _to_float(z),
            _to_float(col(row, "occupancy"), 1.0),
            _to_float(col(row, "B_iso_or_equiv"), 0.0), 0.0))

    if not recs:
        return np.empty(0, dtype=ATOM_DTYPE)
    return finalize_backbone(np.array(recs, dtype=ATOM_DTYPE))
