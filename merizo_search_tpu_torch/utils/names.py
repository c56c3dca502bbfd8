"""Structure-file naming helpers shared by createdb/search/multidomain."""

from __future__ import annotations

import os

CIF_EXTS = (".cif", ".mmcif", ".cif.gz", ".mmcif.gz")
PDB_EXTS = (".pdb", ".pdb.gz", ".ent", ".ent.gz")  # .ent: PDB archive naming
STRUCT_EXTS = PDB_EXTS + CIF_EXTS


def strip_struct_ext(name: str) -> str:
    """Drop a structure-file extension (.pdb/.ent/.cif/.mmcif, optionally .gz).

    The reference only ever strips '.pdb' (e.g. dbsearch.py target names,
    dbsearch_fulllength.py:36-39); with mmCIF inputs supported, every
    consumer must strip consistently or chain grouping silently breaks.
    """
    for e in STRUCT_EXTS:
        if name.endswith(e):
            return name[:-len(e)]
    return name


def struct_basename(path: str) -> str:
    return strip_struct_ext(os.path.basename(path))
