"""The search engine: exact cosine top-k over a device-resident Foldclass DB.

Device mode of the JAX package's engine: the whole DB lives in the memory
of one device in its storage precision, with the per-row target lengths
beside it for the mincov channel.

- bf16 and int8 go through the fused scan (ops/fused_scan.py: the phase-A
  and phase-C CUDA kernels on the card). int8 stores the DB with
  block-uniform scales (`quantize_blocks`, or the DB's int8 sidecar), the
  queries with per-row scales (`quantize_rows`), and dequantises the
  returned scores per query.
- fp32 goes through the plain exact scan (ops/topk.topk_scan), as the JAX
  package leaves f32 to XLA.

The stream (larger-than-memory), IVF and mesh modes are later slices of
the port (ROADMAP.md, queue 1): a DB over the device-mode budget raises
NotImplementedError, and the CLI rejects the IVF and mesh flags.
"""

from __future__ import annotations

import logging
import time

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


def _normalize_rows(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return (x / np.maximum(n, 1e-12)).astype(x.dtype)


def _host(x: np.ndarray) -> torch.Tensor:
    """A writable host tensor copy of a (possibly read-only memmap) array."""
    return torch.from_numpy(np.array(x))


class SearchEngine:
    """Exact top-k search over a FlatDB resident on one device.

    dtype: "fp32", "bf16" or "int8" (or the torch dtype) — the on-device
    storage of the DB. device: "cuda" (default) or "cpu".
    """

    def __init__(self, db: FlatDB, dtype="bf16", device="cuda"):
        self.db = db
        self.dtype = DTYPES.get(dtype, dtype)
        if self.dtype not in _ITEMSIZE:
            raise ValueError(f"unsupported storage dtype {dtype!r}")
        if db.size * db.dim * _ITEMSIZE[self.dtype] > MAX_DEVICE_GB * (1 << 30):
            raise NotImplementedError(
                f"the DB exceeds {MAX_DEVICE_GB} GB of device memory: the stream "
                "mode it needs is not ported yet (ROADMAP.md, queue 1)")
        self.device = resolve_device(device)
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
        self._load_resident()
        q = _normalize_rows(np.asarray(query_embs, np.float32))
        k_eff = min(k, self.db.size)
        use_len = query_lens is not None and mincov > 0.0
        qlen = torch.from_numpy(np.asarray(
            query_lens if use_len else np.zeros(q.shape[0]), np.float32)).to(self.device)
        qt = torch.from_numpy(q).to(self.device)
        if self.dtype == torch.float32:
            vals, idxs = topk_ops.topk_scan(
                qt, self._demb, self._n_valid, k_eff,
                tlen=self._dlen if use_len else None,
                qlen=qlen if use_len else None, mincov=float(mincov))
        elif self.dtype == torch.int8:
            q8, qs = topk_ops.quantize_rows(q)
            vals, idxs = fused_topk(
                torch.from_numpy(q8).to(self.device), self._demb, self._n_valid,
                k_eff, tlen=self._dlen, qlen=qlen, mincov=float(mincov),
                use_len=use_len, scales=self._dscale)
            # per-query dequantisation (positive, so -inf stays -inf)
            vals = vals * torch.from_numpy(qs).to(self.device)[:, None]
        else:
            vals, idxs = fused_topk(
                qt.to(self.dtype), self._demb, self._n_valid, k_eff,
                tlen=self._dlen, qlen=qlen, mincov=float(mincov),
                use_len=use_len)
        vals = vals.cpu().numpy().astype(np.float32)
        idxs = idxs.cpu().numpy()
        idxs = np.where(np.isfinite(vals), idxs, -1)
        if k_eff < k:
            pad_v = np.full((q.shape[0], k - k_eff), -np.inf, np.float32)
            pad_i = np.full((q.shape[0], k - k_eff), -1, idxs.dtype)
            vals = np.concatenate([vals, pad_v], axis=1)
            idxs = np.concatenate([idxs, pad_i], axis=1)
        return vals, idxs
