"""Database codecs.

Two on-disk layouts are supported, byte-compatible with the reference so that
databases built by either tool are interchangeable:

1. "pt" layout (small DBs, reference programs/Foldclass/makedb.py:85-91):
     <name>.pt      torch-saved float32 tensor [D, 128]
     <name>.index   pickled list of (path, ca_coords float32 [N,3], seq) tuples
     <name>.metadata / <name>.metadata.index   optional (start,end)-indexed blob

2. "mmap" layout (large DBs, reference programs/Foldclass/dbutil.py + the JSON
   descriptor schema of examples/database/ted100_9606_small.json):
     <name>.json with keys:
       dbfname_IP   raw float32 [DB_SIZE, DB_DIM] row-major, L2-normalised
       DB_SIZE, DB_DIM
       db_names_f   fixed 33-byte records (32-char name + '\\n')
       sif/sdf      sequence (start,end) int64-pair index + ascii blob
       cif/cdf      CA-coordinate index + raw float32 blob (N*3 floats/entry)
       mif/mdf      optional metadata index + ascii blob

Readers use np.memmap; writers stream. A `FlatDB` facade gives the search
engine a single interface over both.

Extension with no reference counterpart: the mmap layout can carry
quantised embedding sidecars, read natively when the DB is made resident in
that precision. Extra JSON keys (ignored by the reference reader, which
accesses keys by name):
       dbfname_int8    int8 [DB_SIZE, DB_DIM], block-quantised
       dbfname_scales  float32 [DB_SIZE] dequant scales, uniform per
                       QUANT_BLOCK consecutive rows (ops.topk
                       `quantize_blocks` layout — the fused int8 scan's
                       required format)
       dbfname_bf16    bfloat16 [DB_SIZE, DB_DIM] (stored as uint16 bits)
       QUANT_BLOCK     rows per shared int8 scale (128)
The fp32 `dbfname_IP` file always remains authoritative for interop.

This is the port's copy of the JAX package's codecs: files written by either
package read back in the other. bf16 sidecars are handled as raw uint16 bits
here (torch converts them), so no numpy bfloat16 extension is needed.
"""

from __future__ import annotations

import json
import os
import pickle
import logging

import numpy as np

logger = logging.getLogger(__name__)

NAME_RECORD = 33  # 32 chars + newline (dbutil.py:107-108)


# ---------------------------------------------------------------------------
# start/end indexed blob files ("startend" codec, dbutil.py:119-145)

def read_startend(index_path: str, n: int | None = None) -> np.ndarray:
    arr = np.memmap(index_path, dtype=np.int64, mode="r")
    arr = arr.reshape(-1, 2)
    if n is not None:
        assert arr.shape[0] >= n, f"{index_path}: expected >= {n} entries"
        arr = arr[:n]
    return arr


def fetch_blob(blob_path_or_mm, startend: np.ndarray, idxs) -> list[bytes]:
    """Fetch raw byte ranges for entries `idxs`."""
    if isinstance(blob_path_or_mm, str):
        mm = np.memmap(blob_path_or_mm, dtype=np.uint8, mode="r")
    else:
        mm = blob_path_or_mm
    out = []
    for i in np.atleast_1d(np.asarray(idxs)):
        s, e = int(startend[i, 0]), int(startend[i, 1])
        out.append(mm[s:e].tobytes())
    return out


def bytes_to_coords(b: bytes) -> np.ndarray:
    d = np.frombuffer(b, dtype=np.float32)
    assert len(d) % 3 == 0
    return d.reshape(-1, 3)


class StartEndWriter:
    """Streaming writer for a (start,end)-indexed blob pair."""

    def __init__(self, index_path: str, blob_path: str, append: bool = False):
        mode = "ab" if append else "wb"
        self._if = open(index_path, mode)
        self._bf = open(blob_path, mode)
        self._pos = self._bf.tell()

    def add(self, payload: bytes) -> None:
        start = self._pos
        self._bf.write(payload)
        self._pos += len(payload)
        self._if.write(np.asarray([start, self._pos], dtype=np.int64).tobytes())

    def flush(self) -> None:
        self._if.flush()
        self._bf.flush()

    def close(self) -> None:
        self._if.close()
        self._bf.close()


# ---------------------------------------------------------------------------
# pt layout

def read_pt_db(db_prefix: str):
    """Load `<prefix>.pt` + `<prefix>.index` into numpy. Returns (emb, index)."""
    import torch

    emb = torch.load(db_prefix + ".pt", map_location="cpu").numpy()
    with open(db_prefix + ".index", "rb") as fh:
        index = pickle.load(fh)
    assert len(index) == emb.shape[0], "db/index length mismatch"
    return emb, index


def write_pt_db(db_prefix: str, embeddings: np.ndarray, entries: list[tuple]) -> None:
    """Write the reference pt layout (makedb.py:85-91). entries: (name, ca, seq)."""
    import torch

    torch.save(torch.from_numpy(np.ascontiguousarray(embeddings, dtype=np.float32)), db_prefix + ".pt")
    with open(db_prefix + ".index", "wb") as fh:
        pickle.dump(entries, fh)


# ---------------------------------------------------------------------------
# mmap layout

def read_dbinfo(json_path: str) -> dict:
    with open(json_path) as fh:
        return json.load(fh)


class MmapDBWriter:
    """Streaming writer for the mmap layout. Entries must be added in order;
    `finalize()` writes the JSON descriptor.
    """

    def __init__(self, out_prefix: str, dim: int = 128, with_metadata: bool = False,
                 append: bool = False):
        self.prefix = out_prefix
        self.dim = dim
        base = os.path.basename(out_prefix)
        self._files = {
            "dbfname_IP": base + "_raw_128d_norm.db",
            "db_names_f": base + "_raw_128d.index_names",
            "sif": base + "_seq.index",
            "sdf": base + "_seq.db",
            "cif": base + "_ca.index",
            "cdf": base + "_ca.db",
        }
        self.with_metadata = with_metadata
        if with_metadata:
            self._files["mif"] = base + "_metadata.index"
            self._files["mdf"] = base + "_metadata.db"
        d = os.path.dirname(out_prefix) or "."
        os.makedirs(d, exist_ok=True)
        mode = "ab" if append else "wb"
        self._emb_f = open(os.path.join(d, self._files["dbfname_IP"]), mode)
        self._names_f = open(os.path.join(d, self._files["db_names_f"]), mode)
        self._seq = StartEndWriter(os.path.join(d, self._files["sif"]),
                                   os.path.join(d, self._files["sdf"]), append)
        self._ca = StartEndWriter(os.path.join(d, self._files["cif"]),
                                  os.path.join(d, self._files["cdf"]), append)
        self._meta = (StartEndWriter(os.path.join(d, self._files["mif"]),
                                     os.path.join(d, self._files["mdf"]), append)
                      if with_metadata else None)
        self.count = self._names_f.tell() // NAME_RECORD if append else 0

    def add(self, name: str, embedding: np.ndarray, ca: np.ndarray, seq: str,
            metadata: str | None = None) -> None:
        emb = np.ascontiguousarray(embedding, dtype=np.float32)
        assert emb.shape == (self.dim,)
        # stored normalised for inner-product search (dbsearch.py:303-304)
        nrm = float(np.linalg.norm(emb))
        if nrm > 0:
            emb = emb / nrm
        self._emb_f.write(emb.tobytes())
        self._names_f.write(f"{name[:32]:<32}\n".encode("ascii"))
        self._seq.add(seq.encode("ascii"))
        self._ca.add(np.ascontiguousarray(ca, dtype=np.float32).tobytes())
        if self._meta is not None:
            self._meta.add((metadata or "{ }").encode("ascii"))
        self.count += 1

    def flush(self) -> None:
        """Push every entry added so far to the files, so that a checkpoint
        written after this call never counts entries still in a buffer."""
        self._emb_f.flush()
        self._names_f.flush()
        for w in (self._seq, self._ca, self._meta):
            if w is not None:
                w.flush()

    def finalize(self) -> str:
        self._emb_f.close()
        self._names_f.close()
        self._seq.close()
        self._ca.close()
        if self._meta is not None:
            self._meta.close()
        info = dict(self._files)
        info["DB_SIZE"] = self.count
        info["DB_DIM"] = self.dim
        json_path = self.prefix + ".json"
        with open(json_path, "w") as fh:
            json.dump(info, fh)
        return json_path


QUANT_BLOCK = 128  # rows per shared int8 scale (= ops.topk.BLOCK)


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits (round to nearest even) as uint16."""
    import torch

    t = torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def write_quantized_sidecar(db_prefix: str, kind: str = "int8",
                            chunk_rows: int = 1 << 18) -> None:
    """Add a quantised embedding sidecar to an existing mmap-layout DB.

    Streams the fp32 embedding file once (chunk_rows at a time, 128 MB of
    host RAM at the default), writes `<base>_raw_128d_norm.{int8,bf16}`
    (+ `.scales` for int8), and records the new files in the JSON
    descriptor. int8 uses one shared symmetric scale per QUANT_BLOCK
    consecutive rows — exactly the `quantize_blocks` layout the fused int8
    scan requires (see ops/fused_scan.py). Works on reference-built DBs too
    (the fp32 file is left untouched)."""
    from ..ops.topk import quantize_blocks

    if kind not in ("int8", "bf16"):
        raise ValueError(f"unknown quantisation kind: {kind}")
    info = read_dbinfo(db_prefix + ".json")
    d = os.path.dirname(db_prefix + ".json") or "."
    size, dim = int(info["DB_SIZE"]), int(info["DB_DIM"])
    emb = np.memmap(os.path.join(d, info["dbfname_IP"]), dtype=np.float32,
                    mode="r", shape=(size, dim))
    base = os.path.basename(db_prefix)
    # chunk boundaries must fall on QUANT_BLOCK rows so per-chunk block
    # quantisation equals one global quantize_blocks pass
    chunk_rows = max(QUANT_BLOCK, (chunk_rows // QUANT_BLOCK) * QUANT_BLOCK)
    if kind == "int8":
        qf = base + "_raw_128d_norm.int8"
        sf = base + "_raw_128d_norm.scales"
        with open(os.path.join(d, qf), "wb") as qfh, \
                open(os.path.join(d, sf), "wb") as sfh:
            for i0 in range(0, size, chunk_rows):
                blk = np.asarray(emb[i0:i0 + chunk_rows], np.float32)
                qv, s = quantize_blocks(blk, QUANT_BLOCK)
                qfh.write(qv.tobytes())
                sfh.write(s.tobytes())
        info["dbfname_int8"] = qf
        info["dbfname_scales"] = sf
        info["QUANT_BLOCK"] = QUANT_BLOCK
    else:
        qf = base + "_raw_128d_norm.bf16"
        with open(os.path.join(d, qf), "wb") as qfh:
            for i0 in range(0, size, chunk_rows):
                blk = np.asarray(emb[i0:i0 + chunk_rows], np.float32)
                qfh.write(_bf16_bits(blk).tobytes())
        info["dbfname_bf16"] = qf
    with open(db_prefix + ".json", "w") as fh:
        json.dump(info, fh)
    logger.info("wrote %s sidecar for %s (%d rows)", kind, db_prefix, size)


# ---------------------------------------------------------------------------
# FlatDB facade

def truncate_mmap_db(out_prefix: str, n_entries: int, dim: int = 128,
                     with_metadata: bool = False) -> None:
    """Truncate a partially-written mmap DB back to exactly n_entries
    (crash-recovery for resumable createdb builds)."""
    d = os.path.dirname(out_prefix) or "."
    base = os.path.basename(out_prefix)

    def _trunc(path, size):
        if os.path.exists(path) and os.path.getsize(path) > size:
            with open(path, "r+b") as fh:
                fh.truncate(size)

    _trunc(os.path.join(d, base + "_raw_128d_norm.db"), n_entries * dim * 4)
    _trunc(os.path.join(d, base + "_raw_128d.index_names"), n_entries * NAME_RECORD)
    pairs = [("_seq.index", "_seq.db"), ("_ca.index", "_ca.db")]
    if with_metadata:
        pairs.append(("_metadata.index", "_metadata.db"))
    for isuf, bsuf in pairs:
        ipath = os.path.join(d, base + isuf)
        if not os.path.exists(ipath):
            continue
        _trunc(ipath, n_entries * 16)
        if n_entries > 0:
            se = np.memmap(ipath, dtype=np.int64, mode="r").reshape(-1, 2)
            end = int(se[n_entries - 1, 1]) if len(se) >= n_entries else 0
        else:
            end = 0
        _trunc(os.path.join(d, base + bsuf), end)


class FlatDB:
    """Uniform read access to either DB layout for the search engine.

    embeddings(): float32 [D, dim] (memmap for the mmap layout — never fully
    materialised in host RAM unless asked).
    """

    _emb8 = None      # int8 sidecar memmap (mmap layout only)
    _scales = None    # f32 block-uniform dequant scales for _emb8
    _embbf = None     # bf16 sidecar memmap

    def __init__(self, kind: str, **kw):
        self.kind = kind
        self.__dict__.update(kw)
        self.max_block_read = 0  # largest single embedding read (rows);
        #                          tests assert residency loads stay chunked

    # -- constructors -------------------------------------------------------
    @classmethod
    def open(cls, db_name: str):
        """Open `<db_name>.pt`/`.index` or `<db_name>.json` (reference
        read_database, dbsearch.py:48-72)."""
        if os.path.exists(db_name + ".pt"):
            emb, index = read_pt_db(db_name)
            lengths = np.asarray([len(t[2]) for t in index], dtype=np.int32)
            mdfn, mifn = db_name + ".metadata", db_name + ".metadata.index"
            has_meta = os.path.exists(mdfn) and os.path.exists(mifn)
            return cls(
                "pt", prefix=db_name, _emb=emb, _index=index, _lengths=lengths,
                _meta_se=read_startend(mifn, len(index)) if has_meta else None,
                _meta_blob=mdfn if has_meta else None,
                size=emb.shape[0], dim=emb.shape[1], normalised=False,
            )
        if os.path.exists(db_name + ".json"):
            info = read_dbinfo(db_name + ".json")
            d = os.path.dirname(db_name + ".json") or "."
            size, dim = int(info["DB_SIZE"]), int(info["DB_DIM"])
            emb = np.memmap(os.path.join(d, info["dbfname_IP"]), dtype=np.float32,
                            mode="r", shape=(size, dim))
            names = np.memmap(os.path.join(d, info["db_names_f"]), dtype=f"S{NAME_RECORD}",
                              mode="r", shape=(size,))
            seq_se = read_startend(os.path.join(d, info["sif"]), size)
            ca_se = read_startend(os.path.join(d, info["cif"]), size)
            has_meta = "mif" in info and "mdf" in info
            emb8 = scales = embbf = None
            if "dbfname_int8" in info and os.path.exists(
                    os.path.join(d, info["dbfname_int8"])):
                emb8 = np.memmap(os.path.join(d, info["dbfname_int8"]),
                                 dtype=np.int8, mode="r", shape=(size, dim))
                scales = np.memmap(os.path.join(d, info["dbfname_scales"]),
                                   dtype=np.float32, mode="r", shape=(size,))
            if "dbfname_bf16" in info and os.path.exists(
                    os.path.join(d, info["dbfname_bf16"])):
                embbf = np.memmap(os.path.join(d, info["dbfname_bf16"]),
                                  dtype=np.uint16, mode="r",
                                  shape=(size, dim))
            return cls(
                "mmap", prefix=db_name, _emb=emb, _names=names,
                _seq_se=seq_se, _seq_blob=os.path.join(d, info["sdf"]),
                _ca_se=ca_se, _ca_blob=os.path.join(d, info["cdf"]),
                _meta_se=read_startend(os.path.join(d, info["mif"]), size) if has_meta else None,
                _meta_blob=os.path.join(d, info["mdf"]) if has_meta else None,
                _lengths=None, size=size, dim=dim, normalised=True,
                _emb8=emb8, _scales=scales, _embbf=embbf,
            )
        raise FileNotFoundError(
            f"{db_name} is not a valid db: neither {db_name}.pt nor {db_name}.json found")

    @classmethod
    def from_arrays(cls, embeddings: np.ndarray,
                    entries: list[tuple[str, np.ndarray, str]],
                    normalised: bool = False):
        """In-memory database over (name, ca_coords, seq) entries — lets
        createdb stream straight into a SearchEngine without a disk
        round-trip (used by build-and-serve deployments and tests)."""
        emb = np.asarray(embeddings, np.float32)
        lengths = np.asarray([len(e[2]) for e in entries], np.int32)
        return cls("pt", prefix=None, _emb=emb, _index=list(entries),
                   _lengths=lengths, _meta_se=None, _meta_blob=None,
                   size=emb.shape[0], dim=emb.shape[1], normalised=normalised)

    # -- embeddings ---------------------------------------------------------
    def embeddings(self) -> np.ndarray:
        return self._emb

    def has_quant(self, kind: str) -> bool:
        """True if a quantised sidecar of `kind` ("int8"/"bf16") is attached."""
        return (self._emb8 if kind == "int8" else self._embbf) is not None

    def read_rows(self, lo: int, hi: int, normalised: bool = True) -> np.ndarray:
        """f32 embedding rows [lo:hi) (hi clipped to size), normalised on
        request. The chunked accessor residency/streaming loads go through —
        never materialises more than the requested range in host RAM."""
        hi = min(hi, self.size)
        blk = np.asarray(self._emb[lo:hi], np.float32)
        self.max_block_read = max(self.max_block_read, hi - lo)
        if normalised and not self.normalised:
            # out of place: for same-dtype arrays np.asarray returned a VIEW
            # of the DB's backing store, and an in-place divide would
            # silently rewrite the raw embeddings to unit norm
            n = np.linalg.norm(blk, axis=1, keepdims=True)
            blk = blk / np.maximum(n, 1e-12)
        return blk

    def read_rows_quant(self, lo: int, hi: int, kind: str):
        """Quantised sidecar rows [lo:hi). int8 -> (int8 block, f32 scales);
        bf16 -> uint16 block of bfloat16 bits. For int8, lo must fall on a QUANT_BLOCK boundary
        so the shared-scale blocks stay aligned."""
        hi = min(hi, self.size)
        self.max_block_read = max(self.max_block_read, hi - lo)
        if kind == "int8":
            if lo % QUANT_BLOCK:
                raise ValueError(f"int8 reads must align to {QUANT_BLOCK} rows")
            return (np.asarray(self._emb8[lo:hi]),
                    np.asarray(self._scales[lo:hi]))
        return np.asarray(self._embbf[lo:hi])

    # -- per-entry accessors ------------------------------------------------
    def lengths(self) -> np.ndarray:
        if self._lengths is None:
            # derive from the seq startend index: end-start bytes == seq length
            self._lengths = (self._seq_se[:, 1] - self._seq_se[:, 0]).astype(np.int32)
        return self._lengths

    def name(self, idx: int) -> str:
        return self.names([idx])[0]

    def names(self, idxs) -> list[str]:
        if self.kind == "pt":
            return [self._index[int(i)][0] for i in np.atleast_1d(idxs)]
        return [self._names[int(i)].decode().rstrip() for i in np.atleast_1d(idxs)]

    def seq(self, idx: int) -> str:
        if self.kind == "pt":
            return self._index[int(idx)][2]
        return fetch_blob(self._seq_blob, self._seq_se, idx)[0].decode("ascii")

    def coords(self, idx: int) -> np.ndarray:
        if self.kind == "pt":
            return self._index[int(idx)][1]
        return bytes_to_coords(fetch_blob(self._ca_blob, self._ca_se, idx)[0])

    def metadata(self, idx: int) -> str:
        if self._meta_se is None:
            return "{ }"
        return fetch_blob(self._meta_blob, self._meta_se, idx)[0].decode("ascii")

    def entry(self, idx: int) -> tuple[str, np.ndarray, str]:
        """(name, ca_coords, seq) triple, cf. dbsearch.py:124."""
        return self.name(idx), self.coords(idx), self.seq(idx)
