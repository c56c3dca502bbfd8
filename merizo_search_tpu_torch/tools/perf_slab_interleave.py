"""Phase A in slabs (slab_scan) against the port's phase A, at each nslab.

For each dtype: blockmax_scan with the length channel off (the JAX tool's
"baseline"), slab_scan at each --tiles and --nslabs (a CTA walks one slab,
tile/nslab rows, so the pair sets the work a CTA is given), and the
library product of the same queries and DB (torch.matmul in bf16,
torch._int_mm in int8, writing the whole score matrix) as a yardstick,
each beside the bound (the DB read once, q and the outputs, vs the
operations at the tensor-core peak). Then the JAX tool's spot check, for
every tile and nslab: max |dBM| and max |dSBM| of slab_scan against
blockmax_scan (SBM: its BM's max over each tile), which are 0 on the card
(both take every score from one dot routine).

The DB is the JAX tool's (bf16 normal rows; int8 clip(40 x normal), scales
1/40), and so are the queries (bf16 normal; int8 uniform in [-124, 124)).

    python -m merizo_search_tpu_torch.tools.perf_slab_interleave [--q 256]
        [--tiles 32768] [--nslabs 2,4,8] [--dtypes bf16,int8] [--log2-rows 24]
        [--n-valid N] [--no-sbm] [--iters 5] [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.blockmax import blockmax_scan
from ..ops.slab_interleave import NSLABS, slab_scan
from . import _bench_util as bu


def make_queries(qn, dtype, seed, gen, dev):
    if dtype == "int8":
        rng = np.random.default_rng(seed)
        return torch.from_numpy(rng.integers(-124, 124, (qn, 128), dtype=np.int8)).to(dev)
    return torch.randn((qn, 128), generator=gen, device=dev, dtype=torch.bfloat16)


def library_product(q, db):
    """One PyTorch call for the same product: the whole score matrix."""
    return torch._int_mm(q, db.T) if q.dtype == torch.int8 else torch.matmul(q, db.T)


def sweep(db, scales, dtype, q, n_valid, tiles, nslabs, iters, dev, no_sbm=False):
    """Time the baseline, each (tile, nslab) (and, with no_sbm, each without
    the SBM output) and the library product; then the spot check. Returns
    one row a timing (spot check in the slab rows)."""
    n, qn, isz = db.shape[0], q.shape[0], db.element_size()
    nb = n // 128
    flush = bu.flush_buffer(dev)
    ops = 2 * qn * n * 128
    in_bytes = n * 128 * isz + qn * 128 * isz + (nb * 4 if scales is not None else 0)
    rows = []

    def report(what, ms, out_bytes, **kw):
        b_ms, b_by = bu.bound(in_bytes + out_bytes, ops, dtype)
        rows.append({"what": what, "dtype": dtype, "q": qn, "n": n, "ms": ms,
                     "bound_ms": b_ms, "bound_by": b_by, **kw})
        share = "" if dev.type == "cpu" else f"  ({b_ms / ms:.3f} of the {b_by} bound)"
        print(f"{dtype} {what:26s} {ms:9.4f} ms{share}", flush=True)

    ms = bu.time_ms(lambda: blockmax_scan(q, db, n_valid, scales=scales), dev, iters, flush)
    report("baseline blockmax_scan", ms, qn * nb * 4)
    bm0 = blockmax_scan(q, db, n_valid, scales=scales)
    for tile in tiles:
        sb0 = bm0.view(qn, n // tile, tile // 128).amax(dim=2)
        for ns in nslabs:
            if ns not in NSLABS or tile % (128 * ns) or n % tile:
                continue                    # not instantiated, or no whole slabs
            ms = bu.time_ms(lambda t=tile, s=ns: slab_scan(q, db, n_valid, t, s, scales), dev,
                            iters, flush)
            bm, sb = slab_scan(q, db, n_valid, tile, ns, scales)
            dbm, dsb = float((bm - bm0).abs().max()), float((sb - sb0).abs().max())
            report(f"slab tile={tile} x{ns}", ms, qn * (nb + n // tile) * 4, tile=tile,
                   nslab=ns, dbm=dbm, dsbm=dsb)
            del bm, sb
            if no_sbm:          # BM alone: the search path's phase A, channel compiled out
                ms = bu.time_ms(lambda t=tile, s=ns: slab_scan(q, db, n_valid, t, s, scales,
                                                               sbm=False), dev, iters, flush)
                bm, _ = slab_scan(q, db, n_valid, tile, ns, scales, sbm=False)
                report(f"slab tile={tile} x{ns} BM only", ms, qn * nb * 4, tile=tile,
                       nslab=ns, sbm=False, dbm=float((bm - bm0).abs().max()), dsbm=0.0)
                del bm
    ms = bu.time_ms(lambda: library_product(q, db), dev, iters, flush)
    report("library " + ("torch._int_mm" if dtype == "int8" else "torch.matmul"), ms,
           qn * n * (4 if dtype == "int8" else 2))     # int32 or bf16 scores
    for r in rows:
        if "nslab" in r:
            print(f"{dtype} tile={r['tile']} nslab={r['nslab']} max|dBM| = {r['dbm']}  "
                  f"max|dSBM| = {r['dsbm']}", flush=True)
    return rows


def main(argv=None, dbs=None):
    """Runs the sweep; `dbs` (dtype -> (db, scales)) may hold prebuilt DBs
    of 2^log2-rows rows. Returns {"rows": one dict a timing}."""
    p = bu.parser(__doc__)
    p.add_argument("--q", type=int, default=256)
    p.add_argument("--tiles", type=bu.ints, default=[32768])
    p.add_argument("--nslabs", type=bu.ints, default=[2, 4, 8])
    p.add_argument("--dtypes", default="bf16,int8")
    p.add_argument("--log2-rows", type=int, default=24)
    p.add_argument("--n-valid", type=int, default=None,
                   help="rows that count (default: all); blocks past it are NEG_CAP")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--no-sbm", action="store_true",
                   help="also time each slab_scan without its SBM output (BM alone)")
    args = p.parse_args(argv)
    dev, gen = bu.setup(args)
    n = 1 << args.log2_rows
    n_valid = n if args.n_valid is None else args.n_valid
    print(f"# Q={args.q}, tiles={args.tiles}, N={n}, n_valid={n_valid}", flush=True)
    rows = []
    for dtype in args.dtypes.split(","):
        db, scales = bu.db_for(dbs, n, dtype, gen, dev)
        q = make_queries(args.q, dtype, args.seed, gen, dev)
        rows += sweep(db, scales, dtype, q, n_valid, args.tiles, args.nslabs, args.iters, dev,
                      args.no_sbm)
        del db, scales
    return {"rows": rows}


if __name__ == "__main__":
    main()
