"""The search engine: cosine top-k over a Foldclass DB.

The JAX package's engine modes:

- "device": the whole DB lives in device memory in its storage precision,
  with the per-row target lengths beside it for the mincov channel;
- "stream": a DB over the device budget (`max_device_gb`, the JAX default
  of 8 GB, times the devices of the mesh) is scanned in superblocks of
  `stream_block` rows, read from the host (np.memmap, or the quantised
  sidecars natively) by a small thread pool, staged to the device and
  merged once at the end (`ops/topk.merge_partials`).

and two indexes over each (`index`):

- "flat": the exact scan. bf16 and int8 go through the fused scan
  (ops/fused_scan.py: the phase-A and phase-C CUDA kernels on the card).
  int8 stores the DB with block-uniform scales (`quantize_blocks`, or the
  DB's int8 sidecar), the queries with per-row scales (`quantize_rows`,
  once a search), and dequantises the returned scores per query. fp32
  goes through the plain exact scan (ops/topk.topk_scan), as the JAX
  package leaves f32 to XLA. Both modes scan with the same functions, so
  their results are equal (indices may differ only where scores tie).
- "ivf": the balanced inverted file of search/ivf.py. In device mode the
  DB is resident in its cluster-contiguous permuted layout (built once and
  cached next to the DB as `.ivf{nlist}.npz`, keyed by a fingerprint of
  the DB file), and a search runs phase C on the probed clusters' blocks
  (`ivf_search`; `ivf_rerank` adds an f32 sidecar that rescores the top
  blocks through phase C's f32 mode). In stream mode the layout is
  persisted as disk sidecars (`.ivfdisk{nlist}.{precision}.*`) and each
  search stages only the union of the batch's probed clusters, in
  coalesced runs, through the same staging as the flat stream, running
  the fused scan on each group of clusters.

With a `mesh` (device.py: a tuple of devices, one process) the DB is
sharded by rows, the JAX package's `build_mesh_search` and
`build_mesh_ivf_search`: each device holds an equal run of whole 128-row
blocks (device IVF: of nlist/ndev whole clusters, the centroids on every
device), scans it with the same kernels as one device does, and each
shard's [Q, k] partial is copied to the first device and merged there
(`merge_partials`; a layout with duplicates dedups by id). In stream mode
each staged superblock or cluster group is split into one row slice a
device, each device with its own slots and copy stream. A mesh of one
device takes the mesh path too, as in JAX.

On the card the stream mode stages through a ring of pinned host buffers,
which the pool's threads fill straight from the memmap; each item is
copied on a side stream into one of three device slots and scanned on the
current stream once its copy's event has fired, so the scan of item i
overlaps the copy of i+1 and the host reads of the ones after it. A pinned
buffer is refilled only after its copies' events have completed, a device
slot is rewritten only after the scan that read it, and the host waits on
the scan two items back (the JAX engine's backpressure). Nothing in the
loop reads a device value; the stream IVF reads its probe union before
the loop, and both read the merged top-k once at the end.

Lazy builds (residency, the IVF layout, the disk sidecars) run under a
lock with double-checked state, so threads that search one fresh engine
build once; the disk sidecars also take an `fcntl` lock on a `.lock` file
beside them, so two processes sharing a DB do not interleave their writes.
"""

from __future__ import annotations

import fcntl
import logging
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..db.codecs import FlatDB
from ..device import resolve_device, resolve_mesh
from ..ops import topk as topk_ops
from ..ops.fused_scan import fused_topk
from ..utils import profiling
from . import ivf as ivf_mod

logger = logging.getLogger(__name__)

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}
_STAGE = 1 << 18   # rows per host staging chunk (128 MB of f32 at dim 128)
MAX_DEVICE_GB = 8.0  # the JAX engine's device-mode budget a device; larger DBs stream
DEVICE_SLOTS = 3     # superblocks on the card at once in stream mode
_DISK_PRECISION = {torch.int8: "int8", torch.bfloat16: "bf16", torch.float32: "f32"}


def _normalize_rows(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return (x / np.maximum(n, 1e-12)).astype(x.dtype)


def _host(x: np.ndarray) -> torch.Tensor:
    """A writable host tensor copy of a (possibly read-only memmap) array."""
    return torch.from_numpy(np.array(x))


def stage_threads() -> int:
    """Host staging threads of the stream mode (MERIZO_STAGE_THREADS, 3)."""
    return max(1, int(os.environ.get("MERIZO_STAGE_THREADS", "3")))


def _ordered_prefetch(items, fn, threads: int | None = None):
    """Yield fn(item) for each item IN ORDER, prepared by a thread pool.

    The stream scan's host staging (memmap read, quantise, pad) is
    memcpy-bound and releases the GIL; a small pool prepares the next few
    superblocks concurrently while the consumer scans the current one. At
    most threads + 1 calls are queued or running, which bounds host RAM.

    An exception from fn reaches the consumer at that item's turn. If the
    consumer stops early (an error, or closing the generator), the pool's
    queued work is cancelled: running calls finish and are dropped.
    """
    threads = stage_threads() if threads is None else threads
    ex = ThreadPoolExecutor(max_workers=threads)
    try:
        futs: deque = deque()
        it = iter(items)
        for item in it:
            futs.append(ex.submit(fn, item))
            if len(futs) > threads:
                break
        while futs:
            out = futs.popleft().result()
            nxt = next(it, None)
            if nxt is not None:
                futs.append(ex.submit(fn, nxt))
            yield out
    finally:
        ex.shutdown(wait=False, cancel_futures=True)


def scan_rows(query, rows, n_valid: int, k: int, tlen, qlen, mincov: float,
              use_len: bool, scales=None):
    """Top-k of one resident DB, shard or staged slice on its device:
    query = (qd, qs) (ops.topk.query_operands: int8 with per-row scales),
    rows [Npad, 128] in the storage dtype (rows >= n_valid are padding),
    tlen [Npad] (None where the length channel is off in stream mode),
    scales the int8 block scales. bf16 and int8 run the fused scan, f32 the
    plain exact scan. Returns device tensors (vals [Q, k], idxs [Q, k])."""
    qd, qs = query
    if rows.dtype == torch.float32:
        return topk_ops.topk_scan(
            qd, rows, n_valid, k, tlen=tlen if use_len else None,
            qlen=qlen if use_len else None, mincov=mincov)
    vals, idxs = fused_topk(qd, rows, n_valid, k, tlen=tlen, qlen=qlen,
                            mincov=mincov, use_len=use_len, scales=scales)
    if qs is not None:
        # per-query dequantisation (positive, so -inf stays -inf)
        with profiling.phase("scan.dequant", vals.device):
            vals = vals * qs[:, None]
    return vals, idxs


def shard_topk(rep, shard: dict, me: int, n_valid: int, k: int, mincov: float,
               use_len: bool):
    """Shard me's top-k (scan_rows) of equal row shards of R rows: the rows
    [me*R, (me+1)*R) of a DB or staged item of n_valid valid rows. The
    shard scans local_valid = clip(n_valid - me*R, 0, R) rows, and its ids
    move by me*R, or, for a staged IVF group, map through its "perm" to
    the DB's. rep = (qd, qs, qlen) on the shard's device; shard = {"rows",
    "tlen", "scales", "perm"} (the last three optional)."""
    nrows = shard["rows"].shape[0]
    qd, qs, qlen = rep
    local = min(max(n_valid - me * nrows, 0), nrows)
    v, i = scan_rows((qd, qs), shard["rows"], local, k, shard.get("tlen"), qlen, mincov,
                     use_len, shard.get("scales"))
    if "perm" in shard:
        i = torch.where(i >= 0, shard["perm"][i.clamp(min=0)], -1)
    elif me:
        i = torch.where(i >= 0, i + me * nrows, i)
    return v, i


def mesh_search(reps, shards, n_valid: int, k: int, mincov: float = 0.0,
                use_len: bool = False):
    """The scan sharded over a mesh, the counterpart of the JAX package's
    `build_mesh_search`: shard_topk on each shard (one a device, each
    with its rep), every shard's launches issued before the first copy;
    the shards' [Q, k] partials are copied to the first shard's device
    (its all_gather) and merged there (merge_partials). Returns (vals,
    idxs) on that device."""
    parts = [shard_topk(rep, sh, me, n_valid, k, mincov, use_len)
             for me, (rep, sh) in enumerate(zip(reps, shards))]
    dev0 = shards[0]["rows"].device
    return topk_ops.merge_partials(
        torch.stack([v.to(dev0, non_blocking=True) for v, _ in parts]),
        torch.stack([i.to(dev0, non_blocking=True) for _, i in parts]), k)


class SearchEngine:
    """Top-k search over a FlatDB.

    dtype: "fp32", "bf16" or "int8" (or the torch dtype): the on-device
    storage of the DB. device: "cuda" (default) or "cpu". mesh: a sequence
    of devices (device.make_mesh, or an explicit list, which may repeat a
    device) to shard the DB over; `device` is then mesh[0]. max_device_gb:
    the device-mode budget a device; a DB larger than it times the devices
    in its storage dtype runs the stream mode in superblocks of
    stream_block rows (int8: rounded down to a multiple of 128, so
    superblocks start on scale blocks; stream IVF: groups of whole
    clusters, at least one).
    index: "flat" (exact) or "ivf". ivf_nlist: clusters (0: ~sqrt(N), a
    power of two, at least 16; rounded up to a multiple of the mesh's
    devices); ivf_nprobe: clusters probed a query; ivf_rerank: rescore the
    top blocks from an f32 sidecar in device mode (+4 bytes a dim a row of
    device memory; values are then exact f32).
    """

    def __init__(self, db: FlatDB, dtype="bf16", device="cuda",
                 max_device_gb: float = MAX_DEVICE_GB, stream_block: int = 2 ** 21,
                 index: str = "flat", ivf_nlist: int = 0, ivf_nprobe: int = 32,
                 ivf_rerank: bool = False, mesh=None):
        self.db = db
        self.dtype = DTYPES.get(dtype, dtype)
        if self.dtype not in _ITEMSIZE:
            raise ValueError(f"unsupported storage dtype {dtype!r}")
        if index not in ("flat", "ivf"):
            raise ValueError(f"unknown index type: {index}")
        self.mesh = None if mesh is None else resolve_mesh(mesh)
        self.devices = self.mesh or (resolve_device(device),)
        self.device = self.devices[0]
        ndev = len(self.devices)
        db_bytes = db.size * db.dim * _ITEMSIZE[self.dtype]
        budget = max_device_gb * (1 << 30) * ndev
        self.mode = "device" if db_bytes <= budget else "stream"
        self.stream_block = stream_block
        self.index = index
        self.ivf_nprobe = ivf_nprobe
        self.ivf_rerank = ivf_rerank
        self.ivf_nlist = ivf_nlist or max(16, 1 << int(
            np.ceil(np.log2(max(np.sqrt(db.size), 16)))))
        if self.ivf_nlist % ndev:
            # shard boundaries on cluster boundaries
            self.ivf_nlist = -(-self.ivf_nlist // ndev) * ndev
        # the last stream search's readings: superblocks (stream IVF: cluster
        # groups, clusters and rows staged), rows/s, the pool's staging
        # seconds (summed over threads), the consumer's wait for it, and on
        # the card the copies' and the scans' spans (CUDA events on the side
        # and compute streams, summed over the mesh's devices; a scan's span
        # includes the host's gaps between its launches)
        self.stream_stats = None
        self.ivf_build_s = None   # seconds of the IVF build, when this engine built one
        self._init_lock = threading.Lock()
        self._shards = None       # device mode: one dict a device (IVF: its layout)
        self._sivf = None

    def _where(self) -> str:
        return ", ".join(str(d) for d in self.devices)

    # -- residency ----------------------------------------------------------
    def _load_resident(self):
        """Copy the DB to the devices in its storage dtype, once (double-
        checked under the lock): one shard a device of an equal run of
        128-row blocks, padded to a multiple of 128 rows a device (padding
        rows are zeros with length 1e9, so the length channel masks them
        too). int8 reads the DB's int8 sidecar where there is one, else
        quantises f32 rows per 128-row block; bf16 reads the bf16 sidecar
        where there is one. index="ivf" loads the permuted layout instead
        (_load_ivf_resident)."""
        if self._shards is not None:
            return
        with self._init_lock:
            if self._shards is not None:
                return
            with profiling.phase("db_resident"):
                self._load_resident_now()

    def _load_resident_now(self):
        if self.index == "ivf":
            self._load_ivf_resident()
            return
        t0 = time.time()
        n = self.db.size
        rows = -(-n // (len(self.devices) * topk_ops.BLOCK)) * topk_ops.BLOCK
        shards = [self._resident_rows(me * rows, (me + 1) * rows, dev)
                  for me, dev in enumerate(self.devices)]
        self._n_valid = n
        self._shards = shards       # last: the double-checked state
        logger.info("DB resident on %s: %d rows %s (%.2f GB, %.2fs)", self._where(),
                    n, str(self.dtype).replace("torch.", ""),
                    rows * len(shards) * self.db.dim * _ITEMSIZE[self.dtype] / 2 ** 30,
                    time.time() - t0)

    def _resident_rows(self, lo: int, hi: int, dev) -> dict:
        """Rows [lo, hi) of the padded DB on `dev` (lo a multiple of 128, so
        int8 sidecar reads and scale blocks start on block boundaries):
        {"rows", "tlen", "scales" (int8, else None)}, _STAGE rows at a
        time through the host."""
        db, n, dim = self.db, self.db.size, self.db.dim
        quant = self.dtype == torch.int8
        rows = torch.zeros((hi - lo, dim), dtype=self.dtype, device=dev)
        scales = torch.ones(hi - lo, dtype=torch.float32) if quant else None
        for c0 in range(lo, min(hi, n), _STAGE):
            c1 = min(c0 + _STAGE, hi, n)
            if quant:
                if db.has_quant("int8"):
                    qv, s = db.read_rows_quant(c0, c1, "int8")
                else:
                    qv, s = topk_ops.quantize_blocks(db.read_rows(c0, c1))
                part = _host(qv)
                scales[c0 - lo:c1 - lo] = _host(s)
            elif self.dtype == torch.bfloat16 and db.has_quant("bf16"):
                bits = db.read_rows_quant(c0, c1, "bf16").view(np.int16)
                part = _host(bits).view(torch.bfloat16)
            else:
                part = _host(db.read_rows(c0, c1)).to(self.dtype)
            rows[c0 - lo:c1 - lo] = part.to(dev)
        if quant and lo < n < hi and n % topk_ops.BLOCK:
            # the padding rows of the block straddling n share its scale, so
            # the scales stay uniform within every block
            scales[n - lo:-(-n // topk_ops.BLOCK) * topk_ops.BLOCK - lo] = scales[n - lo - 1]
        lengths = np.full(hi - lo, 1e9, np.float32)
        if lo < n:
            lengths[:min(hi, n) - lo] = db.lengths()[lo:min(hi, n)]
        return {"rows": rows, "tlen": torch.from_numpy(lengths).to(dev),
                "scales": scales.to(dev) if quant else None}

    def _build_ivf(self, emb) -> dict:
        t0 = time.perf_counter()
        ivf = ivf_mod.build_ivf(emb, self.ivf_nlist, multiple_of=len(self.devices),
                                device=self.device)
        self.ivf_build_s = time.perf_counter() - t0
        return ivf

    def _ivf_layout(self, emb) -> dict:
        """The IVF layout of this DB: the `.ivf{nlist}.npz` cache next to an
        on-disk DB when its fingerprint matches (a DB rebuilt under the same
        prefix must not reuse a stale permutation), else a fresh build,
        published to the cache by tmp + rename. The cache's keys and
        fingerprint are the JAX package's, so either package opens the
        other's."""
        prefix = getattr(self.db, "prefix", None)
        cache = f"{prefix}.ivf{self.ivf_nlist}.npz" if prefix else None
        fp = self._db_fingerprint()
        if cache and os.path.exists(cache):
            z = np.load(cache)
            if "fingerprint" in z and np.array_equal(z["fingerprint"], fp):
                logger.info("IVF loaded from %s", cache)
                return {"centroids": z["centroids"], "perm": z["perm"],
                        "cluster_rows": int(z["cluster_rows"]),
                        "nlist": int(z["centroids"].shape[0]),
                        # caches from before multi-assignment hold layouts
                        # without duplicates: dedup stays off for them
                        "dup": bool(z["dup"]) if "dup" in z else False}
            logger.warning("IVF cache %s is stale (database changed since the "
                           "build); rebuilding", cache)
        ivf = self._build_ivf(emb)
        if cache:
            tmp = f"{cache}.tmp{os.getpid()}"
            try:
                with open(tmp, "wb") as fh:
                    np.savez(fh, centroids=ivf["centroids"], perm=ivf["perm"],
                             cluster_rows=ivf["cluster_rows"], dup=ivf["dup"],
                             fingerprint=fp)
                os.replace(tmp, cache)
            except OSError as e:
                logger.warning("could not cache IVF build: %s", e)
        return ivf

    def _load_ivf_resident(self):
        """The DB on the devices in its permuted IVF layout
        (ivf.resident_layout: the storage dtype, permuted lengths, and with
        ivf_rerank the f32 sidecar), _STAGE permuted rows at a time; with a
        mesh, nlist/ndev whole clusters a device. A cached layout whose
        nlist the devices do not divide (built for another mesh) is built
        again, and not cached, as in JAX."""
        t0 = time.time()
        emb = self._normalised_embeddings()
        ivf = self._ivf_layout(emb)
        nd = len(self.devices)
        if ivf["nlist"] % nd:
            logger.info("IVF layout of %d clusters does not shard over %d devices; "
                        "rebuilding", ivf["nlist"], nd)
            ivf = self._build_ivf(emb)
        rows = len(ivf["perm"]) // nd
        shards = [ivf_mod.resident_layout(emb, ivf, self.dtype, dev, lengths=self.db.lengths(),
                                          rerank=self.ivf_rerank, slab=_STAGE,
                                          rows=(me * rows, (me + 1) * rows))
                  for me, dev in enumerate(self.devices)]
        self.ivf_nlist = int(ivf["centroids"].shape[0])   # the build may clamp
        self._shards = shards       # last: the double-checked state
        logger.info("IVF DB resident on %s: %d rows in %d clusters of %d (%.2f GB, %.2fs)",
                    self._where(), self.db.size, self.ivf_nlist, ivf["cluster_rows"],
                    len(ivf["perm"]) * self.db.dim * _ITEMSIZE[self.dtype] / 2 ** 30,
                    time.time() - t0)

    def _normalised_embeddings(self):
        """Unit-norm embeddings for index builds: the mmap layout is stored
        normalised (its memmap is used as is, rows fancy-indexed in bounded
        slabs); a pt DB (small) is materialised and normalised."""
        if self.db.normalised:
            return self.db.embeddings()
        return _normalize_rows(np.asarray(self.db.embeddings(), dtype=np.float32))

    def _db_fingerprint(self) -> np.ndarray:
        """A cheap identity of the DB's content for the staleness checks of
        the IVF cache and sidecars: (rows, dim, embeddings-file size,
        embeddings-file mtime), as the JAX package computes it."""
        f = getattr(self.db.embeddings(), "filename", None)
        if f is None:
            prefix = getattr(self.db, "prefix", None)
            f = prefix + ".pt" if prefix else None
        fsz = mt = 0
        if f and os.path.exists(f):
            st = os.stat(f)
            fsz, mt = st.st_size, int(st.st_mtime)
        return np.asarray([self.db.size, self.db.dim, fsz, mt], np.int64)

    # -- public API ---------------------------------------------------------
    def search(self, query_embs: np.ndarray, k: int,
               query_lens: np.ndarray | None = None, mincov: float = 0.0):
        """Search query embeddings [Q, 128] (normalised here).

        Returns (scores [Q, k] float32, indices [Q, k] int64) as numpy,
        descending, with -inf / -1 where fewer than k valid entries exist.
        A call is the span "search", with the children "search.prepare"
        (normalise, upload, quantise), "search.scan" (the launches, or the
        whole stream), "search.copy_back" (the host waiting for the top-k)
        and "search.finish" (the -1 mapping and the padding).
        """
        with profiling.phase("search"):
            return self._search(query_embs, k, query_lens, mincov)

    def _search(self, query_embs, k, query_lens, mincov):
        flat_device = self.mode == "device" and self.index == "flat"
        if self.mode == "device":
            self._load_resident()
        with profiling.phase("search.prepare"):
            q = _normalize_rows(np.asarray(query_embs, np.float32))
            k_eff = min(k, self.db.size)
            use_len = query_lens is not None and mincov > 0.0
            qlen = torch.from_numpy(np.asarray(
                query_lens if use_len else np.zeros(q.shape[0]), np.float32)).to(self.device)
            if flat_device:
                reps = self._replicas(q, qlen)
        with profiling.phase("search.scan"):
            if self.mode == "stream" and self.index == "ivf":
                vals, idxs = self._stream_ivf_search(q, k_eff, qlen, float(mincov), use_len)
            elif self.mode == "stream":
                vals, idxs = self._stream_search(q, k_eff, qlen, float(mincov), use_len)
            elif self.index == "ivf":
                vals, idxs = self._ivf_search(q, k_eff, qlen, float(mincov), use_len)
            else:
                vals, idxs = self._sharded_scan(reps, self._shards, self._n_valid, k_eff,
                                                float(mincov), use_len)
        with profiling.phase("search.copy_back"):
            vals = vals.cpu().numpy().astype(np.float32)
            idxs = idxs.cpu().numpy()
        with profiling.phase("search.finish"):
            idxs = np.where(np.isfinite(vals), idxs, -1)
            if vals.shape[1] < k:
                pad_v = np.full((q.shape[0], k - vals.shape[1]), -np.inf, np.float32)
                pad_i = np.full((q.shape[0], k - vals.shape[1]), -1, idxs.dtype)
                vals = np.concatenate([vals, pad_v], axis=1)
                idxs = np.concatenate([idxs, pad_i], axis=1)
        return vals, idxs

    def _replicas(self, q: np.ndarray, qlen) -> list[tuple]:
        """The scan's query operands (ops.topk.query_operands: int8
        quantised once) and qlen on every device of the engine:
        [(qd, qs or None, qlen)] one a device, made once a search."""
        qd, qs = topk_ops.query_operands(q, self.dtype, self.device)
        return [(qd.to(d), None if qs is None else qs.to(d), qlen.to(d)) for d in self.devices]

    def _sharded_scan(self, reps, shards, n_valid: int, k: int, mincov: float,
                      use_len: bool):
        """The top-k over the engine's row shards, one a device (reps:
        _replicas): mesh_search with a mesh, else the one shard's
        shard_topk as it is."""
        if self.mesh is None:
            return shard_topk(reps[0], shards[0], 0, n_valid, k, mincov, use_len)
        return mesh_search(reps, shards, n_valid, k, mincov, use_len)

    def _ivf_search(self, q, k, qlen, mincov, use_len):
        """Device-mode IVF (ivf.search_resident) on the resident layout, or
        with a mesh on its shards (ivf.mesh_ivf_search)."""
        return ivf_mod.search_resident(
            self._shards if self.mesh is not None else self._shards[0],
            torch.from_numpy(q).to(self.device),
            topk_ops.query_operands(q, self.dtype, self.device), k, self.ivf_nprobe,
            qlen=qlen, mincov=mincov, use_len=use_len, rerank=self.ivf_rerank)

    # -- streaming ----------------------------------------------------------
    def _superblock_rows(self) -> int:
        block = max(1, int(self.stream_block))
        if self.dtype == torch.int8:
            # int8 scales are shared per 128 rows (sidecar or quantize_blocks):
            # superblocks start on scale blocks, as in device mode
            block = max(topk_ops.BLOCK, block // topk_ops.BLOCK * topk_ops.BLOCK)
        return block

    def _padded(self, rows: int) -> int:
        """rows rounded up to a multiple of 128 rows a device, so a staged
        item splits into equal row slices of whole blocks."""
        mult = len(self.devices) * topk_ops.BLOCK
        return -(-rows // mult) * mult

    def _staging_buffers(self, rows: int, use_len: bool, device=None,
                         pin: bool = False, perm: bool = False) -> dict:
        """One item's buffers on the host (pinned on request) or on
        `device`: rows in the storage dtype, and the int8 scales, target
        lengths and (stream IVF) permuted row ids where they are used."""
        def empty(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=device, pin_memory=pin)

        buf = {"rows": empty((rows, self.db.dim), self.dtype)}
        if self.dtype == torch.int8:
            buf["scales"] = empty((rows,), torch.float32)
        if use_len:
            buf["tlen"] = empty((rows,), torch.float32)
        if perm:
            buf["perm"] = empty((rows,), torch.int64)
        return buf

    def _fill(self, buf: dict, off: int, block: int, lengths) -> tuple[int, int]:
        """Read superblock [off, off + block) into the host buffers `buf`,
        padded with zero rows to a multiple of 128 rows a device (length
        1e9, the tail block's scale). Returns (rows read, padded rows)."""
        db, n = self.db, self.db.size
        nb = min(block, n - off)
        npad = self._padded(nb)
        rows = buf["rows"]
        if self.dtype == torch.int8:
            if db.has_quant("int8"):
                qv, s = db.read_rows_quant(off, off + nb, "int8")
            else:
                qv, s = topk_ops.quantize_blocks(db.read_rows(off, off + nb))
            np.copyto(rows.numpy()[:nb], qv)
            sc = buf["scales"].numpy()
            np.copyto(sc[:nb], s)
            sc[nb:npad] = s[-1]
        elif self.dtype == torch.bfloat16 and db.has_quant("bf16"):
            np.copyto(rows.view(torch.int16).numpy()[:nb],
                      db.read_rows_quant(off, off + nb, "bf16").view(np.int16))
        elif self.dtype == torch.bfloat16:
            rows[:nb].copy_(_host(db.read_rows(off, off + nb)))
        else:
            np.copyto(rows.numpy()[:nb], db.read_rows(off, off + nb))
        rows[nb:npad].zero_()
        if lengths is not None:
            tl = buf["tlen"].numpy()
            tl[:nb] = lengths[off:off + nb]
            tl[nb:npad] = 1e9
        return nb, npad

    def _staged_scans(self, items, rows_cap: int, use_len: bool, fill, scan,
                      perm: bool = False) -> dict:
        """For each item in order: fill(host buffers, item) -> (npad, meta)
        on the staging pool, then scan(shards, meta) on the consumer, with
        shards the item's npad rows cut into one equal slice a device of the
        engine, each on its device (module docstring: the pinned ring, a
        side stream and three slots a device, backpressure two items back).
        rows_cap is a multiple of 128 rows a device. Returns the readings:
        items, the pool's staging seconds, the consumer's wait, and a
        function that gives, once the caller has synchronised (on the card),
        the copies' and the scans' spans, summed over the devices."""
        devs = self.devices
        nd = len(devs)
        cuda = devs[0].type == "cuda"
        threads = stage_threads()
        stage_s, lock = [0.0], threading.Lock()

        if cuda:
            # ring of pinned buffers: item i fills slot i % ring. Item i is
            # submitted to the pool only after the consumer has issued the
            # copies of item i - threads - 1 (_ordered_prefetch's window), so
            # with ring = threads + 2 the slot's last copies have their
            # events recorded by then, and the filler waits on them before
            # writing
            ring = threads + 2
            host = [self._staging_buffers(rows_cap, use_len, pin=True, perm=perm)
                    for _ in range(ring)]
            copied = [[] for _ in range(ring)]
            slots = [[self._staging_buffers(rows_cap // nd, use_len, dev, perm=perm)
                      for _ in range(DEVICE_SLOTS)] for dev in devs]
            scanned = [None] * DEVICE_SLOTS
            side = [torch.cuda.Stream(dev) for dev in devs]
            main = [torch.cuda.current_stream(dev) for dev in devs]

        def prepare(entry):
            i, item = entry
            t = time.perf_counter()
            if cuda:
                for ev in copied[i % ring]:
                    ev.synchronize()
                buf = host[i % ring]
            else:
                buf = self._staging_buffers(rows_cap, use_len, perm=perm)
            npad, meta = fill(buf, item)
            with lock:
                stage_s[0] += time.perf_counter() - t
            return i, npad, meta, buf

        timing, n_items = [], 0
        wait_s, t_wait = 0.0, time.perf_counter()
        for i, npad, meta, buf in _ordered_prefetch(enumerate(items), prepare, threads):
            wait_s += time.perf_counter() - t_wait
            r = npad // nd
            if cuda:
                s = i % DEVICE_SLOTS
                evs, shards = [], []
                for j in range(nd):
                    d = slots[j][s]
                    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                    with torch.cuda.stream(side[j]):
                        if scanned[s] is not None:
                            side[j].wait_event(scanned[s][j])
                        ev[0].record(side[j])
                        for key, t in buf.items():
                            d[key][:r].copy_(t[j * r:(j + 1) * r], non_blocking=True)
                        ev[1].record(side[j])
                    main[j].wait_event(ev[1])
                    ev[2].record(main[j])
                    evs.append(ev)
                    shards.append({key: t[:r] for key, t in d.items()})
                copied[i % ring] = [ev[1] for ev in evs]
            else:
                shards = [{key: t[j * r:(j + 1) * r] for key, t in buf.items()}
                          for j in range(nd)]
            scan(shards, meta)
            n_items += 1
            if cuda:
                for j, ev in enumerate(evs):
                    ev[3].record(main[j])
                scanned[s] = [ev[3] for ev in evs]
                timing.append(evs)
                if len(timing) >= 3:
                    # backpressure, as in the JAX engine: the host waits on
                    # the scans two items back
                    for ev in timing[-3]:
                        ev[3].synchronize()
            t_wait = time.perf_counter()

        def spans():
            if not cuda:
                return {"copy_s": None, "scan_s": None}
            return {"copy_s": sum(e[0].elapsed_time(e[1]) for evs in timing for e in evs) / 1e3,
                    "scan_s": sum(e[2].elapsed_time(e[3]) for evs in timing for e in evs) / 1e3}

        return {"items": n_items, "stage_thread_s": stage_s[0],
                "consumer_wait_s": wait_s}, spans

    @staticmethod
    def _merge(parts_v, parts_i, k: int):
        """One top-k over the partial results [Q, k'] (device tensors)."""
        kk = max(v.shape[1] for v in parts_v)
        pv = torch.stack([torch.nn.functional.pad(v, (0, kk - v.shape[1]), value=float("-inf"))
                          for v in parts_v])
        pi = torch.stack([torch.nn.functional.pad(x, (0, kk - x.shape[1]), value=-1)
                          for x in parts_i])
        return topk_ops.merge_partials(pv, pi, k)

    def _stream_search(self, q, k, qlen, mincov, use_len):
        """Scan the DB superblock by superblock and merge the partial top-k
        (module docstring). Returns host tensors (vals [Q, k], idxs)."""
        t0 = time.perf_counter()
        n, block = self.db.size, self._superblock_rows()
        lengths = self.db.lengths().astype(np.float32) if use_len else None
        reps = self._replicas(q, qlen)
        parts_v, parts_i = [], []

        def fill(buf, off):
            nb, npad = self._fill(buf, off, block, lengths)
            return npad, (off, nb)

        def scan(shards, meta):
            off, nb = meta
            vals, idxs = self._sharded_scan(reps, shards, nb, min(k, nb), mincov, use_len)
            parts_v.append(vals)
            parts_i.append(torch.where(idxs >= 0, idxs + off, idxs))

        st, spans = self._staged_scans(range(0, n, block), self._padded(block), use_len,
                                       fill, scan)
        vals, idxs = self._merge(parts_v, parts_i, min(k, n))
        vals, idxs = vals.cpu(), idxs.cpu()         # the loop's one sync
        wall = time.perf_counter() - t0
        self.stream_stats = {
            "superblocks": st.pop("items"), "rows": n, "block": block, "wall_s": wall,
            "rows_per_s": n / wall, **st, **spans()}
        logger.info("stream scan: %d rows in %d superblocks, %.3f s", n,
                    self.stream_stats["superblocks"], wall)
        return vals, idxs

    # -- disk-streaming IVF ---------------------------------------------------
    def _load_stream_ivf(self):
        """Open, or build, the cluster-contiguous disk sidecars (ivf.py)
        next to the DB, once."""
        if self._sivf is not None:
            return
        with self._init_lock:
            if self._sivf is not None:
                return
            self._load_stream_ivf_now()

    def _fresh_sidecar(self, p: str, fp: np.ndarray):
        """The sidecar set at `p` if it exists and its fingerprint matches
        the DB's (it snapshots the embeddings: a rebuilt DB must not be
        served from it), else None."""
        if not os.path.exists(p + ".npz"):
            return None
        siv = ivf_mod.load_disk_ivf(p)
        old = siv.get("fingerprint")
        if old is None or not np.array_equal(old, fp):
            logger.warning("disk IVF sidecar at %s is stale (DB changed); rebuilding", p)
            return None
        return siv

    def _load_stream_ivf_now(self):
        t0 = time.perf_counter()
        prefix = getattr(self.db, "prefix", None)
        if not prefix:
            raise ValueError("disk-streaming IVF needs an on-disk DB "
                             "(no prefix to place the sidecars next to)")
        p = f"{prefix}.ivfdisk{self.ivf_nlist}.{_DISK_PRECISION[self.dtype]}"
        fp = self._db_fingerprint()
        siv = self._fresh_sidecar(p, fp)
        if siv is None:
            # cross-PROCESS guard (the lock above serialises this engine's
            # threads only): flock, then check again, since another process
            # may have built it meanwhile; write_disk_ivf publishes by rename
            with open(p + ".lock", "w") as lk:
                fcntl.flock(lk, fcntl.LOCK_EX)
                siv = self._fresh_sidecar(p, fp)
                if siv is None:
                    siv = ivf_mod.write_disk_ivf(
                        self._normalised_embeddings(), self.db.lengths(), self.ivf_nlist, p,
                        precision=_DISK_PRECISION[self.dtype], fingerprint=fp,
                        device=self.device)
                    self.ivf_build_s = time.perf_counter() - t0
                    logger.info("disk IVF built at %s (%.2fs)", p, self.ivf_build_s)
        siv["dcent"] = torch.from_numpy(
            np.ascontiguousarray(siv["centroids"], np.float32)).to(self.device)
        self.ivf_nlist = siv["nlist"]   # the build may clamp
        self._sivf = siv

    def _stream_ivf_search(self, q, k, qlen, mincov, use_len):
        """Sublinear search over a DB over the device budget: stage only
        the union of the batch's probed clusters from the disk sidecars, in
        coalesced runs of whole clusters, and run the flat scan on each
        group of staged clusters (exact within the probed set; with a mesh,
        each group row-sharded over the devices). Slot and shard padding
        rows carry +inf lengths; mincov is folded into the finite lengths
        only (inf * 0 is NaN) and the scan masks tl <= qcap at mincov 1.0.
        With duplicates in the layout, each group's top-k is
        k * (DUP_PREF + 1) deep and the merge dedups by original id
        (ivf._dedup_topk, on the device)."""
        self._load_stream_ivf()
        siv = self._sivf
        c_rows, nlist = siv["cluster_rows"], siv["nlist"]
        dev = self.device
        if q.shape[0] == 0:   # empty batch: nothing to probe or stage
            return (torch.full((0, k), float("-inf")), torch.full((0, k), -1, dtype=torch.int64))
        t0 = time.perf_counter()
        qf = torch.from_numpy(q).to(dev)
        probe = torch.topk(qf @ siv["dcent"].T, min(self.ivf_nprobe, nlist), dim=1).indices
        union = torch.unique(probe).cpu().numpy()     # sorted cluster ids (a sync)
        qcap = qlen if use_len else torch.full((q.shape[0],), 3e38, device=dev)
        reps = self._replicas(q, qcap)
        fold = np.float32(mincov if use_len else 0.0)
        per_group = max(1, self.stream_block // c_rows)
        dup = bool(siv.get("dup"))
        parts_v, parts_i = [], []

        def fill(buf, g0):
            rows, tl, pm = buf["rows"], buf["tlen"].numpy(), buf["perm"].numpy()
            rows_np = rows.view(torch.int16).numpy() if self.dtype == torch.bfloat16 \
                else rows.numpy()
            at = 0
            for a, b in ivf_mod.cluster_runs(union[g0:g0 + per_group]):
                lo, hi = a * c_rows, b * c_rows
                m = hi - lo
                np.copyto(rows_np[at:at + m], siv["emb"][lo:hi].view(rows_np.dtype))
                tl[at:at + m] = siv["lengths"][lo:hi]
                pm[at:at + m] = siv["perm"][lo:hi]
                if siv["scales"] is not None:
                    buf["scales"].numpy()[at:at + m] = siv["scales"][lo:hi]
                at += m
            fin = np.isfinite(tl[:at])
            tl[:at][fin] *= fold
            npad = self._padded(at)         # the mesh's shard padding: masked rows
            rows_np[at:npad] = 0
            tl[at:npad] = np.inf
            pm[at:npad] = -1
            if siv["scales"] is not None:
                buf["scales"].numpy()[at:npad] = 1.0
            return npad, at

        def scan(shards, nb):
            kk = min(k * (ivf_mod.DUP_PREF + 1) if dup else k, nb)
            vals, idxs = self._sharded_scan(reps, shards, nb, kk, 1.0, True)
            parts_v.append(vals)
            parts_i.append(idxs)

        st, spans = self._staged_scans(range(0, len(union), per_group),
                                       self._padded(per_group * c_rows), True, fill, scan,
                                       perm=True)
        staged = len(union) * c_rows
        if dup:
            # copies of a multi-assigned row can win in several groups with
            # one score: merge by unique original id
            vals, idxs = ivf_mod._dedup_topk(torch.cat(parts_v, dim=1),
                                             torch.cat(parts_i, dim=1), min(k, staged))
        else:
            vals, idxs = self._merge(parts_v, parts_i, min(k, staged))
        vals, idxs = vals.cpu(), idxs.cpu()          # the loop's one sync
        wall = time.perf_counter() - t0
        npad = len(siv["perm"])
        self.stream_stats = {
            "groups": st.pop("items"), "clusters": len(union), "nlist": nlist,
            "rows_staged": staged, "staged_share": staged / npad, "rows": npad,
            "wall_s": wall, **st, **spans()}
        logger.info("stream IVF: %d/%d clusters staged (%d rows, %.1f%% of the layout) in "
                    "%.3f s", len(union), nlist, staged, 100.0 * staged / npad, wall)
        return vals, idxs
