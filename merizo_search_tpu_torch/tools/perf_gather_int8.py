"""Where int8 phase C's time goes: the read of the selected blocks
(dma_only), staging them (concat_only), the dot (full), and the read through
wide 16-byte loads (int32view), each beside the bytes bound and beside the
port's production phase C (gather_block_scores, no scales) on the same
blocks as a yardstick. No single PyTorch call computes such a gather, so
there is no library time.

bidx is the JAX tool's: numpy default_rng(seed).integers(0, NB, (Q, KB)),
and timed call i reads (bidx + i) % NB, as the JAX tool shifts it each
iteration. The DB is the JAX tool's shape (int8: clip(40 x normal); bf16:
normal), the queries int8 uniform in [-100, 100) or bf16 normal.

    python -m merizo_search_tpu_torch.tools.perf_gather_int8 [--q 256]
        [--kb 102] [--g 34] [--dtypes int8,bf16] [--log2-rows 24]
        [--iters 10] [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.gather import gather_block_scores
from ..ops.gather_variants import G, KB, gather_variant
from ..ops.topk import BLOCK
from . import _bench_util as bu


def make_bidx(qn, kb, nb, seed, dev):
    """The JAX tool's random block ids, int32 [Q, KB]."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, nb, (qn, kb)).astype(np.int32)).to(dev)


def make_queries(qn, dtype, seed, gen, dev):
    if dtype == "int8":
        rng = np.random.default_rng(seed)
        return torch.from_numpy(rng.integers(-100, 100, (qn, 128)).astype(np.int8)).to(dev)
    return torch.randn((qn, 128), generator=gen, device=dev, dtype=torch.bfloat16)


def shifted(bidx, nb, count):
    """(bidx + i) % nb for i < count, built before the timing."""
    return [((bidx.long() + i) % nb).to(torch.int32) for i in range(count)]


def cycler(fn, args_list):
    """fn over args_list, one entry a call, round and round."""
    state = {"i": 0}

    def call():
        a = args_list[state["i"] % len(args_list)]
        state["i"] += 1
        return fn(a)
    return call


def sweep(db, dtype, q, bidx, g, iters, dev, kinds):
    """Time each mode of `kinds` and the production phase C on bidx shifted
    each call. Returns one row a mode."""
    nb, (qn, kb) = db.shape[0] // BLOCK, bidx.shape
    isz = db.element_size()
    flush = bu.flush_buffer(dev)
    bids = shifted(bidx, nb, iters + 2)
    nblk = int(torch.unique(bids[0]).numel())       # blocks one call reads
    out_bytes = qn * kb * BLOCK * 4
    base = nblk * BLOCK * 128 * isz + bidx.numel() * 4 + out_bytes
    prod_ms = bu.time_ms(cycler(lambda b: gather_block_scores(q, db, b, db.shape[0]), bids),
                         dev, iters, flush)
    rows = []
    for kind in kinds:
        ms = bu.time_ms(cycler(lambda b, k=kind: gather_variant(q, db, b, k, g), bids),
                        dev, iters, flush)
        full = kind == "full"
        b_ms, b_by = bu.bound(base + (qn * 128 * isz if full else 0),
                              2 * qn * kb * BLOCK * 128 if full else 0, dtype)
        rows.append({"mode": kind, "dtype": dtype, "q": qn, "kb": kb, "g": g,
                     "n": db.shape[0], "blocks": nblk, "ms": ms, "bound_ms": b_ms,
                     "bound_by": b_by, "phase_c_ms": prod_ms, "library_ms": None})
        share = "" if dev.type == "cpu" else f"  ({b_ms / ms:.3f} of the {b_by} bound)"
        print(f"{dtype} {kind:12s} {ms:9.4f} ms{share}  [phase C {prod_ms:.4f} ms]",
              flush=True)
    return rows


def main(argv=None, dbs=None):
    """Runs the sweep; `dbs` (dtype -> (db, scales)) may hold prebuilt DBs
    of 2^log2-rows rows. Returns {"rows": one dict a mode and dtype}."""
    p = bu.parser(__doc__)
    p.add_argument("--q", type=int, default=256)
    p.add_argument("--kb", type=int, default=KB)
    p.add_argument("--g", type=int, default=G)
    p.add_argument("--dtypes", default="int8,bf16")
    p.add_argument("--log2-rows", type=int, default=24)
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args(argv)
    dev, gen = bu.setup(args)
    n = 1 << args.log2_rows
    bidx = make_bidx(args.q, args.kb, n // BLOCK, args.seed, dev)
    print(f"# Q={args.q}, KB={args.kb}, G={args.g}, N={n}", flush=True)
    rows = []
    for dtype in args.dtypes.split(","):
        db, _ = bu.db_for(dbs, n, dtype, gen, dev)
        q = make_queries(args.q, dtype, args.seed, gen, dev)
        kinds = ["dma_only", "concat_only", "full"] + (["int32view"] if dtype == "int8" else [])
        rows += sweep(db, dtype, q, bidx, args.g, args.iters, dev, kinds)
        del db
    return {"rows": rows}


if __name__ == "__main__":
    main()
