"""The search engine: exact cosine top-k over a Foldclass DB.

Two of the JAX package's engine modes:

- "device": the whole DB lives in the memory of one device in its storage
  precision, with the per-row target lengths beside it for the mincov
  channel;
- "stream": a DB over the device budget (`max_device_gb`, the JAX default
  of 8 GB) is scanned in superblocks of `stream_block` rows, read from the
  host (np.memmap, or the quantised sidecars natively) by a small thread
  pool, staged to the card and merged once at the end
  (`ops/topk.merge_partials`).

Both modes scan with the same functions, so their results are equal
(indices may differ only where scores tie):

- bf16 and int8 go through the fused scan (ops/fused_scan.py: the phase-A
  and phase-C CUDA kernels on the card). int8 stores the DB with
  block-uniform scales (`quantize_blocks`, or the DB's int8 sidecar), the
  queries with per-row scales (`quantize_rows`, once a search), and
  dequantises the returned scores per query.
- fp32 goes through the plain exact scan (ops/topk.topk_scan), as the JAX
  package leaves f32 to XLA.

On the card the stream mode stages through a ring of pinned host buffers,
which the pool's threads fill straight from the memmap; each superblock is
copied on a side stream into one of three device slots and scanned on the
current stream once its copy's event has fired, so the scan of superblock
i overlaps the copy of i+1 and the host reads of the ones after it. A
pinned buffer is refilled only after its copy's event has completed, a
device slot is rewritten only after the scan that read it, and the host
waits on the scan two superblocks back (the JAX engine's backpressure).
Nothing in the loop reads a device value; the one sync is the final copy
of the merged top-k to the host.

The IVF and mesh modes are later slices of the port (ROADMAP.md, queue 1):
the CLI rejects their flags.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..db.codecs import FlatDB
from ..device import resolve_device
from ..ops import topk as topk_ops
from ..ops.fused_scan import fused_topk
from ..utils import profiling

logger = logging.getLogger(__name__)

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}
_STAGE = 1 << 18   # rows per host staging chunk (128 MB of f32 at dim 128)
MAX_DEVICE_GB = 8.0  # the JAX engine's device-mode budget; larger DBs stream
DEVICE_SLOTS = 3     # superblocks on the card at once in stream mode


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


class SearchEngine:
    """Exact top-k search over a FlatDB.

    dtype: "fp32", "bf16" or "int8" (or the torch dtype): the on-device
    storage of the DB. device: "cuda" (default) or "cpu". max_device_gb:
    the device-mode budget; a DB larger than it in its storage dtype runs
    the stream mode in superblocks of stream_block rows (int8: rounded down
    to a multiple of 128, so superblocks start on scale blocks).
    """

    def __init__(self, db: FlatDB, dtype="bf16", device="cuda",
                 max_device_gb: float = MAX_DEVICE_GB, stream_block: int = 2 ** 21):
        self.db = db
        self.dtype = DTYPES.get(dtype, dtype)
        if self.dtype not in _ITEMSIZE:
            raise ValueError(f"unsupported storage dtype {dtype!r}")
        self.device = resolve_device(device)
        db_bytes = db.size * db.dim * _ITEMSIZE[self.dtype]
        self.mode = "device" if db_bytes <= max_device_gb * (1 << 30) else "stream"
        self.stream_block = stream_block
        # the last stream search's readings: superblocks, rows/s, the pool's
        # staging seconds (summed over threads), the consumer's wait for it,
        # and on the card the copies' and the scans' spans (CUDA events on
        # the side and compute streams; a scan's span includes the host's
        # gaps between its launches)
        self.stream_stats = None
        self._demb = None

    # -- residency ----------------------------------------------------------
    def _load_resident(self):
        """Copy the DB to the device in its storage dtype, padded to a
        multiple of 128 rows (padding rows are zeros with length 1e9, so
        the length channel masks them too). int8 reads the DB's int8
        sidecar where there is one, else quantises f32 rows per 128-row
        block; bf16 reads the bf16 sidecar where there is one."""
        if self._demb is not None:
            return
        with profiling.phase("db_resident"):
            self._load_resident_now()

    def _load_resident_now(self):
        t0 = time.time()
        db, n, dim = self.db, self.db.size, self.db.dim
        npad = -(-n // topk_ops.BLOCK) * topk_ops.BLOCK
        quant = self.dtype == torch.int8
        demb = torch.zeros((npad, dim), dtype=self.dtype, device=self.device)
        scales = torch.ones(npad, dtype=torch.float32) if quant else None
        for c0 in range(0, n, _STAGE):
            c1 = min(c0 + _STAGE, n)
            if quant:
                if db.has_quant("int8"):
                    qv, s = db.read_rows_quant(c0, c1, "int8")
                else:
                    qv, s = topk_ops.quantize_blocks(db.read_rows(c0, c1))
                rows = _host(qv)
                scales[c0:c1] = _host(s)
            elif self.dtype == torch.bfloat16 and db.has_quant("bf16"):
                bits = db.read_rows_quant(c0, c1, "bf16").view(np.int16)
                rows = _host(bits).view(torch.bfloat16)
            else:
                rows = _host(db.read_rows(c0, c1)).to(self.dtype)
            demb[c0:c1] = rows.to(self.device)
        if quant:
            # the padding rows of the block straddling n share its scale, so
            # the scales stay uniform within every block
            if n % topk_ops.BLOCK:
                scales[n:npad] = scales[n - 1]
            self._dscale = scales.to(self.device)
        lengths = np.full(npad, 1e9, np.float32)
        lengths[:n] = db.lengths()
        self._dlen = torch.from_numpy(lengths).to(self.device)
        self._n_valid = n
        self._demb = demb
        logger.info("DB resident on %s: %d rows %s (%.2f GB, %.2fs)", self.device,
                    n, str(self.dtype).replace("torch.", ""),
                    demb.numel() * demb.element_size() / 2 ** 30, time.time() - t0)

    # -- public API ---------------------------------------------------------
    def search(self, query_embs: np.ndarray, k: int,
               query_lens: np.ndarray | None = None, mincov: float = 0.0):
        """Search query embeddings [Q, 128] (normalised here).

        Returns (scores [Q, k] float32, indices [Q, k] int64) as numpy,
        descending, with -inf / -1 where fewer than k valid entries exist.
        """
        q = _normalize_rows(np.asarray(query_embs, np.float32))
        k_eff = min(k, self.db.size)
        use_len = query_lens is not None and mincov > 0.0
        qlen = torch.from_numpy(np.asarray(
            query_lens if use_len else np.zeros(q.shape[0]), np.float32)).to(self.device)
        if self.mode == "stream":
            vals, idxs = self._stream_search(q, k_eff, qlen, float(mincov), use_len)
        else:
            self._load_resident()
            vals, idxs = self._scan(self._query_operands(q), self._demb, self._n_valid,
                                    k_eff, self._dlen, qlen, float(mincov), use_len,
                                    self._dscale if self.dtype == torch.int8 else None)
        vals = vals.cpu().numpy().astype(np.float32)
        idxs = idxs.cpu().numpy()
        idxs = np.where(np.isfinite(vals), idxs, -1)
        if k_eff < k:
            pad_v = np.full((q.shape[0], k - k_eff), -np.inf, np.float32)
            pad_i = np.full((q.shape[0], k - k_eff), -1, idxs.dtype)
            vals = np.concatenate([vals, pad_v], axis=1)
            idxs = np.concatenate([idxs, pad_i], axis=1)
        return vals, idxs

    def _query_operands(self, q: np.ndarray):
        """The queries on the device in the scan's dtype, and for int8 their
        per-row scales: (q, scales or None)."""
        if self.dtype == torch.int8:
            q8, qs = topk_ops.quantize_rows(q)
            return (torch.from_numpy(q8).to(self.device),
                    torch.from_numpy(qs).to(self.device))
        return torch.from_numpy(q).to(self.device).to(self.dtype), None

    def _scan(self, query, rows, n_valid: int, k: int, tlen, qlen, mincov: float,
              use_len: bool, scales):
        """Top-k of one resident DB or superblock: rows [Npad, 128] in the
        storage dtype, tlen [Npad] (None where the length channel is off in
        stream mode). Returns device tensors (vals [Q, k], idxs [Q, k])."""
        qd, qs = query
        if self.dtype == torch.float32:
            return topk_ops.topk_scan(
                qd, rows, n_valid, k, tlen=tlen if use_len else None,
                qlen=qlen if use_len else None, mincov=mincov)
        vals, idxs = fused_topk(qd, rows, n_valid, k, tlen=tlen, qlen=qlen,
                                mincov=mincov, use_len=use_len, scales=scales)
        if qs is not None:
            # per-query dequantisation (positive, so -inf stays -inf)
            vals = vals * qs[:, None]
        return vals, idxs

    # -- streaming ----------------------------------------------------------
    def _superblock_rows(self) -> int:
        block = max(1, int(self.stream_block))
        if self.dtype == torch.int8:
            # int8 scales are shared per 128 rows (sidecar or quantize_blocks):
            # superblocks start on scale blocks, as in device mode
            block = max(topk_ops.BLOCK, block // topk_ops.BLOCK * topk_ops.BLOCK)
        return block

    def _staging_buffers(self, rows: int, use_len: bool, device=None,
                         pin: bool = False) -> dict:
        """One superblock's buffers on the host (pinned on request) or on
        `device`: rows in the storage dtype, and the int8 scales and target
        lengths where they are used."""
        def empty(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=device, pin_memory=pin)

        buf = {"rows": empty((rows, self.db.dim), self.dtype)}
        if self.dtype == torch.int8:
            buf["scales"] = empty((rows,), torch.float32)
        if use_len:
            buf["tlen"] = empty((rows,), torch.float32)
        return buf

    def _fill(self, buf: dict, off: int, block: int, lengths) -> tuple[int, int]:
        """Read superblock [off, off + block) into the host buffers `buf`,
        padded with zero rows to a multiple of 128 (length 1e9, the tail
        block's scale). Returns (rows read, padded rows)."""
        db, n = self.db, self.db.size
        nb = min(block, n - off)
        npad = -(-nb // topk_ops.BLOCK) * topk_ops.BLOCK
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

    def _stream_search(self, q, k, qlen, mincov, use_len):
        """Scan the DB superblock by superblock and merge the partial top-k
        (module docstring). Returns device tensors (vals [Q, k], idxs)."""
        t0 = time.perf_counter()
        n, block, dev = self.db.size, self._superblock_rows(), self.device
        lengths = self.db.lengths().astype(np.float32) if use_len else None
        query = self._query_operands(q)          # int8: quantised once
        cuda = dev.type == "cuda"
        threads = stage_threads()
        rows_cap = -(-block // topk_ops.BLOCK) * topk_ops.BLOCK
        stage_s, lock = [0.0], threading.Lock()

        if cuda:
            # ring of pinned buffers: item i fills slot i % ring. Item i is
            # submitted to the pool only after the consumer has issued the
            # copy of item i - threads - 1 (_ordered_prefetch's window), so
            # with ring = threads + 2 the slot's last copy has its event
            # recorded by then, and the filler waits on it before writing
            ring = threads + 2
            host = [self._staging_buffers(rows_cap, use_len, pin=True) for _ in range(ring)]
            copied = [None] * ring
            slots = [self._staging_buffers(rows_cap, use_len, dev)
                     for _ in range(DEVICE_SLOTS)]
            scanned = [None] * DEVICE_SLOTS
            side = torch.cuda.Stream(dev)
            main = torch.cuda.current_stream(dev)

        def prepare(item):
            i, off = item
            t = time.perf_counter()
            if cuda:
                if copied[i % ring] is not None:
                    copied[i % ring].synchronize()
                buf = host[i % ring]
            else:
                buf = self._staging_buffers(
                    min(rows_cap, -(-(n - off) // topk_ops.BLOCK) * topk_ops.BLOCK), use_len)
            nb, npad = self._fill(buf, off, block, lengths)
            with lock:
                stage_s[0] += time.perf_counter() - t
            return i, off, nb, npad, buf

        parts_v, parts_i, timing = [], [], []
        wait_s, t_wait = 0.0, time.perf_counter()
        for i, off, nb, npad, buf in _ordered_prefetch(
                enumerate(range(0, n, block)), prepare, threads):
            wait_s += time.perf_counter() - t_wait
            if cuda:
                d = slots[i % DEVICE_SLOTS]
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                with torch.cuda.stream(side):
                    if scanned[i % DEVICE_SLOTS] is not None:
                        side.wait_event(scanned[i % DEVICE_SLOTS])
                    ev[0].record(side)
                    for key, t in buf.items():
                        d[key][:npad].copy_(t[:npad], non_blocking=True)
                    ev[1].record(side)
                copied[i % ring] = ev[1]
                main.wait_event(ev[1])
                ev[2].record(main)
            else:
                d = buf
            vals, idxs = self._scan(
                query, d["rows"][:npad], nb, min(k, nb),
                d["tlen"][:npad] if use_len else None, qlen, mincov, use_len,
                d["scales"][:npad] if self.dtype == torch.int8 else None)
            parts_v.append(vals)
            parts_i.append(torch.where(idxs >= 0, idxs + off, idxs))
            if cuda:
                ev[3].record(main)
                scanned[i % DEVICE_SLOTS] = ev[3]
                timing.append(ev)
                if len(timing) >= 3:
                    # backpressure, as in the JAX engine: the host waits on
                    # the scan two superblocks back
                    timing[-3][3].synchronize()
            t_wait = time.perf_counter()

        kk = max(v.shape[1] for v in parts_v)
        pv = torch.stack([torch.nn.functional.pad(v, (0, kk - v.shape[1]), value=float("-inf"))
                          for v in parts_v])
        pi = torch.stack([torch.nn.functional.pad(x, (0, kk - x.shape[1]), value=-1)
                          for x in parts_i])
        vals, idxs = topk_ops.merge_partials(pv, pi, min(k, n))
        vals, idxs = vals.cpu(), idxs.cpu()         # the loop's one sync
        wall = time.perf_counter() - t0
        self.stream_stats = {
            "superblocks": len(parts_v), "rows": n, "block": block, "wall_s": wall,
            "rows_per_s": n / wall, "stage_thread_s": stage_s[0],
            "consumer_wait_s": wait_s,
            "copy_s": sum(e[0].elapsed_time(e[1]) for e in timing) / 1e3 if cuda else None,
            "scan_s": sum(e[2].elapsed_time(e[3]) for e in timing) / 1e3 if cuda else None}
        logger.info("stream scan: %d rows in %d superblocks, %.3f s", n, len(parts_v), wall)
        return vals, idxs
