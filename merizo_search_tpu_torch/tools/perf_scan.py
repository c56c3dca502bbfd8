"""Device times of the fused scan's kernels at the shapes PERF.md reports:
phase A (blockmax_scan), phase C (gather_block_scores) and the pipelined
scan's kernel (blockmax_scan_gather, with the pipelined and sequential ms a
batch of tools/perf_pipelined).

Phase A at 2^24 rows for Q = 32, 64, 128 and 256 (one a query tile width),
bf16 and int8, and at Q = 256 with the length channel on (tl uniform in
[0, 280), qcap uniform in [0, 400): about 70% of the rows kept); at the
search shape (500,096 rows, Q = 32) with the channel on and off. Phase C on
the blocks phase B picks from each BM: Q = 32, k = 10 (KB 12) at the search
shape and Q = 256, k = 100 (KB 102) at 2^24 rows (int8 with the selected
blocks' scales). The pipelined kernel on a batch and the previous batch's
top-101 blocks (int8 with their scales), Q 64 at the search shape and Q 256
at 2^24 rows, beside phase A then phase C launched apart on the same inputs
and itself with no previous selection (phase A alone); the pipelined and
the sequential scan's ms a batch at Q 256, 2^24 rows. Phase B's select
kernel (ops/select.py phase_b, with the int8 DB's scales) on random block
maxima at TED's shard shape ([256, 356,441], k 100) and CATH's ([256 / 32 /
1, 3,907], k 100 / 10 / 10), checked against its plain version on the card
bit for bit, beside `torch.topk` over the same maxima (`select_bound`). Each time is a
CUDA-event mean over --iters launches with the L2 flushed before each,
beside its bound (bytes over 3.35 TB/s or operations over the dtype's
peak, whichever is larger; `phase_a_bound`, `phase_c_bound`,
`bm_gather_bound`) and, for phase A, the library call's time
(`torch.matmul` or `torch._int_mm` of the whole score matrix). chip_smoke.py's kernels
phase runs `phase_rows` at 2^24 rows and shares the bounds. The DB is the JAX
tools' synthetic one (tools/_bench_util.make_db).

It uses only the ops' public entry points, so the same file can be run
from a checkout of another commit to compare two versions in one call:

    python -m merizo_search_tpu_torch.tools.perf_scan [--log2-rows 24]
        [--search-rows 500096] [--iters 10] [--label NAME] [--device cuda|cpu]
        [--only phases|pipelined|select]

Prints the device line, then one JSON line {"label", "rows": [...]}.
"""

from __future__ import annotations

import json
import sys

import torch

from ..ops import blockmax, gather, pipelined, select
from ..ops.fused_scan import select_blocks, selected_scales
from . import _bench_util as bu
from . import perf_pipelined


def library_product(q, db):
    """The library yardstick for phase A: the whole score matrix q @ db.T by
    one PyTorch call (cuBLAS bf16 GEMM, or the int8 `_int_mm` to int32)."""
    return torch._int_mm(q, db.T) if q.dtype == torch.int8 else torch.matmul(q, db.T)


def phase_a_bound(nq, npad, isz, dtype, masked=False, scaled=False):
    """bu.bound of phase A on Q = nq and npad rows of isz bytes: the DB read
    once, the queries, BM written, tl and qcap with the length channel, one
    scale a block in int8; 2*Q*128 operations a row."""
    nb = npad // 128
    nbytes = (npad * 128 * isz + nq * 128 * isz + nq * nb * 4
              + (npad * 4 + nq * 4 if masked else 0) + (nb * 4 if scaled else 0))
    return bu.bound(nbytes, 2 * nq * npad * 128, dtype)


def phase_c_bound(nq, isz, bidx, dtype, masked=False, scale_sel=False, row_scales=False):
    """bu.bound of phase C on selection bidx [Q, KB]: each distinct selected
    block once (with its tl values and per-row scales where the call reads
    them), the queries, bidx (and scale_sel), qcap, the [Q, KB*128] output;
    2*128*128 operations a selected (non-padding) column."""
    valid = bidx[bidx >= 0]
    nblk = int(torch.unique(valid).numel())
    row = 128 * isz + (4 if masked else 0) + (4 if row_scales else 0)
    nbytes = (nblk * 128 * row + nq * 128 * isz + bidx.numel() * 4 * (2 if scale_sel else 1)
              + (nq * 4 if masked else 0) + bidx.numel() * 128 * 4)
    return bu.bound(nbytes, 2 * int(valid.numel()) * 128 * 128, dtype)


def bm_gather_bound(nq, npad, isz, bidx, dtype, scaled=False):
    """bu.bound of the pipelined kernel on Q = nq this batch and the previous
    selection bidx [Qp, KB]: the DB read once (the selected blocks are its
    rows), both batches' queries, bidx (and scale_sel), one scale a block in
    int8, BM and the [Qp, KB*128] output; phase A's operations and 2*128*128
    a selected (non-padding) column."""
    nqp, kb = bidx.shape
    nb = npad // 128
    nbytes = (npad * 128 * isz + (nq + nqp) * 128 * isz + bidx.numel() * 4
              + (nb * 4 + bidx.numel() * 4 if scaled else 0)
              + nq * nb * 4 + nqp * kb * 128 * 4)
    ops = 2 * nq * npad * 128 + 2 * int((bidx >= 0).sum()) * 128 * 128
    return bu.bound(nbytes, ops, dtype)


def select_bound(nq, nb, k):
    """bu.bound of phase B over BM [nq, nb]: BM read once, each level's
    candidate (key, id) pairs written and read, bidx and scale_sel written
    and the selected blocks' scales read; no operations counted."""
    kk, levels = select.plan(nb, k)
    cands = sum(nq * slices * kk * 8 * 2 for _, _, _, slices in (levels or [])[:-1])
    return bu.bound(nq * nb * 4 + cands + nq * (kk + 1) * 12, 0, "f32")


SELECT_SHAPES = ((256, 356_441, 100), (256, 3_907, 100), (32, 3_907, 10), (1, 3_907, 10))


def select_rows(iters, flush, dev, gen, shapes=SELECT_SHAPES):
    """Phase B's kernel at each (Q, NB, k): normal block maxima, n_valid
    mid-row, block scales; checked against phase_b_plain on the same card
    (bit for bit), timed beside the plain version and torch.topk."""
    rows = []
    for nq, nb, k in shapes:
        bm = torch.randn((nq, nb), generator=gen, device=dev)
        scales = torch.rand(nb, generator=gen, device=dev).repeat_interleave(128)
        n = (nb // 2) * 128 + 17
        got, want = select.phase_b(bm, n, k, scales), select.phase_b_plain(bm, n, k, scales)
        exact = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
        if not exact:
            raise AssertionError(f"select kernel differs from its plain version at "
                                 f"Q={nq} NB={nb} k={k}")
        kk, levels = select.plan(nb, k)
        b_ms, b_by = select_bound(nq, nb, k)
        rows.append({
            "kernel": "select", "q": nq, "nb": nb, "k": k, "kb": kk + 1,
            "launches": select.launches(nb, k), "exact": exact,
            "ms": bu.time_ms(lambda: select.phase_b(bm, n, k, scales), dev, iters, flush),
            "plain_ms": bu.time_ms(lambda: select.phase_b_plain(bm, n, k, scales), dev, 3,
                                   flush),
            "library_ms": bu.time_ms(lambda: torch.topk(bm, kk, dim=1), dev, iters, flush),
            "bound_ms": b_ms, "bound_by": b_by})
    return rows


def bm_gather_row(db, sc, n, nq, k, iters, flush, dev, gen):
    """The pipelined kernel on a batch of nq queries and the previous batch's
    top-(k+1) blocks, timed beside phase A then phase C launched apart and
    beside itself with no previous selection."""
    dtype = "int8" if sc is not None else "bf16"
    q, pv_q = perf_pipelined.make_queries(nq, dtype, gen, dev)[:2]
    bidx = select_blocks(blockmax.blockmax_scan(pv_q, db, n, scales=sc), n, k)
    ss = None if sc is None else selected_scales(sc, bidx)
    ms = bu.time_ms(lambda: pipelined.blockmax_scan_gather(q, db, n, pv_q, bidx, sc, ss),
                    dev, iters, flush)
    apart = bu.time_ms(lambda: (blockmax.blockmax_scan(q, db, n, scales=sc),
                                gather.gather_block_scores(pv_q, db, bidx, n, scale_sel=ss)),
                       dev, iters, flush)
    empty = bidx.new_empty((nq, 0))
    a_only = bu.time_ms(lambda: pipelined.blockmax_scan_gather(q, db, n, pv_q, empty, sc),
                        dev, iters, flush)
    b_ms, b_by = bm_gather_bound(nq, db.shape[0], db.element_size(), bidx, dtype,
                                 sc is not None)
    return {"kernel": "blockmax_scan_gather", "dtype": dtype, "n": db.shape[0], "q": nq,
            "kb": bidx.shape[1], "ms": ms, "two_launches_ms": apart,
            "phase_a_alone_ms": a_only, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def phase_rows(db, sc, n, qs, masks, ks, iters, flush, dev, gen, on_bm=None):
    """Rows of phase A for each batch size in qs (the channel on where the
    batch is in `masks`), with the library call's time a batch, and of
    phase C after it for each (Q, k) in ks. on_bm(q, bm, tl, qcap), where
    given, sees each phase-A result (tl and qcap None with the channel off)."""
    isz = db.element_size()
    tl = torch.rand(db.shape[0], generator=gen, device=dev) * 280.0
    qc = torch.rand(max(qs), generator=gen, device=dev) * 400.0
    q_all = torch.randn((max(qs), 128), generator=gen, device=dev, dtype=torch.bfloat16)
    if sc is not None:
        q_all = q_all.mul_(40).clamp_(-127, 127).to(torch.int8)
    rows, dtype = [], "int8" if sc is not None else "bf16"
    for nq in qs:
        q = q_all[:nq].contiguous()
        lib = bu.time_ms(lambda: library_product(q, db), dev, 3, flush)
        for masked in (False, True) if nq in masks else (False,):
            lk = (tl, qc[:nq].contiguous()) if masked else (None, None)
            bm = blockmax.blockmax_scan(q, db, n, *lk, scales=sc)
            if on_bm is not None:
                on_bm(q, bm, *lk)
            ms = bu.time_ms(lambda: blockmax.blockmax_scan(q, db, n, *lk, scales=sc), dev,
                            iters, flush)
            b_ms, b_by = phase_a_bound(nq, db.shape[0], isz, dtype, masked, sc is not None)
            rows.append({"kernel": "blockmax_scan", "dtype": dtype, "n": db.shape[0], "q": nq,
                         "mask": masked, "tile": blockmax.tile_width(nq), "ms": ms,
                         "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib})
            for k in (k for (kq, k) in ks if kq == nq and not masked):
                bidx = select_blocks(bm, n, k)
                kw = {} if sc is None else {"scale_sel": selected_scales(sc, bidx)}
                gms = bu.time_ms(lambda: gather.gather_block_scores(q, db, bidx, n, **kw),
                                 dev, iters, flush)
                g_ms, g_by = phase_c_bound(nq, isz, bidx, dtype, scale_sel=bool(kw))
                rows.append({"kernel": "gather_block_scores", "dtype": dtype,
                             "mode": "scale_sel" if kw else "none", "n": db.shape[0],
                             "q": nq, "kb": bidx.shape[1], "ms": gms, "bound_ms": g_ms,
                             "bound_by": g_by, "library_ms": None})
    return rows


def main(argv=None):
    p = bu.parser(__doc__)
    p.add_argument("--log2-rows", type=int, default=24)
    p.add_argument("--search-rows", type=int, default=500_096,
                   help="rows of the search shape's DB (the CLI search's 500,000 entries)")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--label", default="")
    p.add_argument("--only", choices=("phases", "pipelined", "select"), default=None,
                   help="phases A and C alone, the pipelined kernel and scan alone, or "
                        "phase B's select kernel alone")
    args = p.parse_args(argv)
    dev, gen = bu.setup(args)
    flush = bu.flush_buffer(dev)
    rows = [] if args.only not in (None, "select") else select_rows(args.iters, flush, dev, gen)
    phases, pipe = args.only in (None, "phases"), args.only in (None, "pipelined")
    for dtype in ("bf16", "int8") if phases or pipe else ():
        db, sc = bu.make_db(args.search_rows, dtype, gen, dev)
        if phases:
            rows += phase_rows(db, sc, args.search_rows, (32,), (32,), ((32, 10),),
                               args.iters, flush, dev, gen)
        if pipe:
            rows.append(bm_gather_row(db, sc, args.search_rows, 64, 100, args.iters, flush,
                                      dev, gen))
        n = 1 << args.log2_rows
        db, sc = bu.make_db(n, dtype, gen, dev)
        if phases:
            rows += phase_rows(db, sc, n, (32, 64, 128, 256), (256,), ((256, 100),),
                               args.iters, flush, dev, gen)
        if pipe:
            rows.append(bm_gather_row(db, sc, n, 256, 100, args.iters, flush, dev, gen))
            r = perf_pipelined.run(db, sc, n, 100,
                                   perf_pipelined.make_queries(256, dtype, gen, dev), 8, dev)
            rows.append({"kernel": "pipelined_scan", "dtype": dtype, "n": n, "q": 256,
                         "exact": r["exact"], "pipelined_ms": r["pipe_ms"],
                         "sequential_ms": r["seq_ms"]})
        del db, sc
    for r in rows:
        if r["kernel"] == "select":
            print(f"select Q={r['q']} NB={r['nb']} k={r['k']}: {r['ms']:.4f} ms (bound "
                  f"{r['bound_ms']:.4f}, torch.topk {r['library_ms']:.4f}, plain "
                  f"{r['plain_ms']:.4f}), {r['launches']} launches", flush=True)
            continue
        if r["kernel"] == "pipelined_scan":
            print(f"pipelined scan {r['dtype']} N={r['n']} Q={r['q']}: {r['pipelined_ms']:.4f}"
                  f" ms a batch (sequential {r['sequential_ms']:.4f}), exact {r['exact']}",
                  flush=True)
            continue
        print(f"{r['kernel']} {r['dtype']} N={r['n']} Q={r['q']}"
              + (f" KB={r['kb']}" if "kb" in r else f" mask={r['mask']}")
              + f": {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, {r['bound_by']})", flush=True)
    out = {"label": args.label, "rows": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
