"""Device times of the fused scan's two kernels at the shapes PERF.md
reports: phase A (blockmax_scan) and phase C (gather_block_scores).

Phase A at 2^24 rows for Q = 32, 64, 128 and 256 (one a query tile width),
bf16 and int8, and at Q = 256 with the length channel on (tl uniform in
[0, 280), qcap uniform in [0, 400): about 70% of the rows kept); at the
search shape (500,096 rows, Q = 32) with the channel on and off. Phase C on
the blocks phase B picks from each BM: Q = 32, k = 10 (KB 12) at the search
shape and Q = 256, k = 100 (KB 102) at 2^24 rows (int8 with the selected
blocks' scales). Each time is a CUDA-event mean over --iters launches with
the L2 flushed before each, beside its bound (bytes over 3.35 TB/s or
operations over the dtype's peak, whichever is larger; `phase_a_bound`,
`phase_c_bound`) and, for phase A, the library call's time (`torch.matmul`
or `torch._int_mm` of the whole score matrix). chip_smoke.py's kernels
phase runs `phase_rows` at 2^24 rows and shares the bounds. The DB is the JAX
tools' synthetic one (tools/_bench_util.make_db).

It uses only the ops' public entry points, so the same file can be run
from a checkout of another commit to compare two versions in one call:

    python -m merizo_search_tpu_torch.tools.perf_scan [--log2-rows 24]
        [--search-rows 500096] [--iters 10] [--label NAME] [--device cuda|cpu]

Prints the device line, then one JSON line {"label", "rows": [...]}.
"""

from __future__ import annotations

import json
import sys

import torch

from ..ops import blockmax, gather
from ..ops.fused_scan import select_blocks, selected_scales
from . import _bench_util as bu


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
    args = p.parse_args(argv)
    dev, gen = bu.setup(args)
    flush = bu.flush_buffer(dev)
    rows = []
    for dtype in ("bf16", "int8"):
        db, sc = bu.make_db(args.search_rows, dtype, gen, dev)
        rows += phase_rows(db, sc, args.search_rows, (32,), (32,), ((32, 10),), args.iters,
                           flush, dev, gen)
        n = 1 << args.log2_rows
        db, sc = bu.make_db(n, dtype, gen, dev)
        rows += phase_rows(db, sc, n, (32, 64, 128, 256), (256,), ((256, 100),), args.iters,
                           flush, dev, gen)
        del db, sc
    for r in rows:
        print(f"{r['kernel']} {r['dtype']} N={r['n']} Q={r['q']}"
              + (f" KB={r['kb']}" if "kb" in r else f" mask={r['mask']}")
              + f": {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, {r['bound_by']})", flush=True)
    out = {"label": args.label, "rows": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
