"""createdb: embed a directory of PDB files into a Foldclass database.

Reference: programs/Foldclass/makedb.py:34-94: sequential, unbatched, writes
the pt layout only, and a crash restarts from scratch. The port's copy of
the JAX package's builder:

- structures are parsed with the CA reader (native C++ scan, numpy
  fallback) on an 8-thread pool, grouped into length buckets and embedded
  as masked batches on the model's device, or data parallel over a mesh
  (pipeline.embed);
- output is the reference pt layout or the mmap layout (scales to DBs far
  larger than RAM), optionally with an int8/bf16 embedding sidecar;
- mmap builds are resumable: progress is the writer's entry count, and a
  restart with resume=True truncates the DB to the last checkpoint and
  skips the files already consumed.

The phases `createdb.parse`, `createdb.embed` and `createdb.write` are timed
by utils.profiling; `embed` ends in each batch's copy to the host.
"""

from __future__ import annotations

import json
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..db import codecs
from ..io.pdb import read_ca
from ..utils import profiling
from ..utils.names import STRUCT_EXTS, strip_struct_ext
from .embed import MAX_RES, embed_structures, load_foldclass_params

logger = logging.getLogger(__name__)


def list_pdb_files(input_dir: str) -> list[str]:
    files = [os.path.join(input_dir, f) for f in os.listdir(input_dir)
             if f.endswith(STRUCT_EXTS)]
    files.sort()  # parity: makedb.py:48 keeps runs deterministic
    return files


def _parse(path):
    try:
        return path, read_ca(path)
    except (ValueError, TypeError, KeyError, OSError, EOFError) as e:
        # malformed/truncated files must not abort an hours-long build
        logger.warning("unreadable structure file %s: %s", path, e)
        return path, None


def run_createdb(input_dir: str, out_db: str, weights: str | None = None,
                 fmt: str = "pt", resume: bool = False,
                 chunk_files: int = 4096, model=None, device="cuda",
                 sidecar: str | None = None, mesh=None) -> int:
    """Build a database. Returns the number of entries written.

    fmt: "pt" (reference small-DB layout) or "mmap" (large, resumable).
    model: a loaded Foldclass network (its device is the one used); else
    it is loaded from `weights` (None: the default weights) onto `device`
    (with a mesh, onto mesh[0]). mesh: devices (device.make_mesh) to embed
    on data parallel. sidecar: "int8" or "bf16" adds a quantised embedding
    sidecar to an mmap build (codecs.write_quantized_sidecar).
    """
    if fmt not in ("pt", "mmap"):
        raise ValueError(f"unknown db format: {fmt}")
    files = list_pdb_files(input_dir)
    logger.info("%d PDB files found in model directory. Will generate Foldclass database..",
                len(files))
    if model is None:
        model = load_foldclass_params(weights, device if mesh is None else mesh[0])

    progress_path = out_db + ".progress"
    skip_files = 0
    writer = None
    if fmt == "mmap":
        if resume and os.path.exists(progress_path):
            with open(progress_path) as fh:
                prog = json.load(fh)
            skip_files = int(prog.get("files_done", 0))
            # drop any entries written after the last progress checkpoint
            codecs.truncate_mmap_db(out_db, int(prog.get("entries", 0)))
            logger.info("resuming: %d files already consumed", skip_files)
        writer = codecs.MmapDBWriter(out_db, dim=128, append=resume and skip_files > 0)

    all_embs, all_entries = [], []
    t0 = time.time()
    # process in file chunks so host memory stays bounded for huge inputs
    for c0 in range(skip_files, len(files), chunk_files):
        chunk = files[c0:min(c0 + chunk_files, len(files))]
        names, coords, seqs = [], [], []
        with profiling.phase("createdb.parse"):
            with ThreadPoolExecutor(max_workers=8) as ex:
                parsed = list(ex.map(_parse, chunk))
        for path, d in parsed:
            if d is None or len(d["coords"]) == 0:
                logger.warning("No CA atoms read from PDB file %s; skipping.", path)
                continue
            names.append(path)
            coords.append(d["coords"][:MAX_RES])
            seqs.append(d["seq"][:MAX_RES])

        if names:
            with profiling.phase("createdb.embed"):
                embs = embed_structures(model, coords, mesh=mesh)
            with profiling.phase("createdb.write"):
                for j, name in enumerate(names):
                    if fmt == "mmap":
                        writer.add(strip_struct_ext(os.path.basename(name)),
                                   embs[j], coords[j], seqs[j])
                    else:
                        all_embs.append(embs[j])
                        all_entries.append((name, coords[j], seqs[j]))
        files_done = min(c0 + chunk_files, len(files))
        if fmt == "mmap":
            writer.flush()      # the checkpoint counts only entries on disk
            with open(progress_path, "w") as fh:
                json.dump({"files_done": files_done, "total": len(files),
                           "entries": writer.count}, fh)
        logger.info("embedded %d/%d files (%.1fs)", files_done, len(files), time.time() - t0)

    with profiling.phase("createdb.write"):
        if fmt == "mmap":
            writer.finalize()
            total = writer.count
            if sidecar:
                codecs.write_quantized_sidecar(out_db, sidecar)
        else:
            total = len(all_entries)
            if total == 0:
                raise ValueError("no embeddable structures found")
            codecs.write_pt_db(out_db, np.stack(all_embs), all_entries)
    logger.info("Output database contains %d PDBs.", total)
    return total
