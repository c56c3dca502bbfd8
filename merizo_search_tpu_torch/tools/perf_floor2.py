"""Floor sweep of the scan: the dot alone (mini_scan "none"), the dot with
the block-max reduce (mini_scan "reduce"), the port's phase A
(blockmax_scan) and the port's full fused_topk, over tile, nslab, Q and
dtype, each beside the bound of the same product (bytes of one DB pass vs
operations at the tensor-core peak).

The DB is the JAX tool's (bf16 normal rows; int8 clip(40 x normal), scales
1/40); the queries too (int8: every row -64..63; bf16: the DB's first Q
rows). Phase A runs with the length channel on and passing every row (tl 0,
qcap inf), as the JAX tools time the production phase A.

    python -m merizo_search_tpu_torch.tools.perf_floor2 [--q 256]
        [--dtypes int8] [--tiles 32768,65536] [--nslabs 2,4,8]
        [--log2-rows 24] [--k 100] [--iters 5] [--device cuda|cpu]
"""

from __future__ import annotations

import torch

from ..ops.blockmax import blockmax_scan
from ..ops.fused_scan import fused_topk
from ..ops.probes import MODES, mini_scan
from . import _bench_util as bu


def make_queries(db, qn, dtype):
    if dtype == "int8":
        return torch.arange(-64, 64, dtype=torch.int8, device=db.device).repeat(qn, 1)
    return db[:qn].contiguous()


def sweep(db, scales, dtype, qn, tiles, nslabs, k, iters, dev):
    """Time every (tile, nslab, mode) of mini_scan, then phase A and the
    full fused_topk; returns one row per timing."""
    n, isz = db.shape[0], db.element_size()
    q = make_queries(db, qn, dtype)
    flush = bu.flush_buffer(dev)
    ops = 2 * qn * n * 128
    in_bytes = n * 128 * isz + qn * 128 * isz
    print(f"# Q={qn} {dtype} N={n}: bound {bu.bound(in_bytes, ops, dtype)[0]:.4f} ms "
          f"(bytes {in_bytes / bu.HBM_BPS * 1e3:.4f}, operations "
          f"{ops / bu.PEAK_OPS[dtype] * 1e3:.4f})", flush=True)
    rows = []

    def report(tag, ms, out_bytes, **kw):
        b_ms, b_by = bu.bound(in_bytes + out_bytes, ops, dtype)
        rows.append({"what": tag, "dtype": dtype, "q": qn, "n": n, "ms": ms,
                     "bound_ms": b_ms, "bound_by": b_by, **kw})
        share = "" if dev.type == "cpu" else f"  ({b_ms / ms:.3f} of the {b_by} bound)"
        print(f"Q={qn} {dtype} {tag:34s} {ms:9.4f} ms{share}", flush=True)

    for tile in tiles:
        for ns in nslabs:
            if tile % ns or (tile // ns) % 128 or tile > n:
                continue
            for mode in MODES:
                ms = bu.time_ms(lambda t=tile, s=ns, m=mode: mini_scan(q, db, t, s, m),
                                dev, iters, flush)
                width = 8 if mode == "none" else tile // 128
                report(f"tile={tile} nslab={ns} "
                       f"{'dot_only' if mode == 'none' else 'dot+reduce'}", ms,
                       n // tile * qn * width * 4, tile=tile, nslab=ns, mode=mode)
    tl = torch.zeros((n,), dtype=torch.float32, device=dev)
    qcap = torch.full((qn,), float("inf"), dtype=torch.float32, device=dev)
    ms = bu.time_ms(lambda: blockmax_scan(q, db, n, tl, qcap, scales), dev, iters, flush)
    report("phaseA (blockmax_scan)", ms, qn * (n // 128) * 4 + n * 4 + qn * 4)
    ms = bu.time_ms(lambda: fused_topk(q, db, n, k, scales=scales), dev, iters, flush)
    report(f"full fused_topk k={k}", ms, qn * k * 12)
    return rows


def main(argv=None, dbs=None):
    """Runs the sweep; `dbs` (dtype -> (db, scales)) may hold prebuilt DBs
    of 2^log2-rows rows. Returns {"rows": one dict a timing}."""
    p = bu.parser(__doc__)
    p.add_argument("--q", type=bu.ints, default=[256])
    p.add_argument("--dtypes", default="int8")
    p.add_argument("--tiles", type=bu.ints, default=[32768, 65536])
    p.add_argument("--nslabs", type=bu.ints, default=[2, 4, 8])
    p.add_argument("--log2-rows", type=int, default=24)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--iters", type=int, default=5)
    args = p.parse_args(argv)
    dev, gen = bu.setup(args)
    rows = []
    for dtype in args.dtypes.split(","):
        db, scales = bu.db_for(dbs, 1 << args.log2_rows, dtype, gen, dev)
        for qn in args.q:
            rows += sweep(db, scales, dtype, qn, args.tiles, args.nslabs, args.k,
                          args.iters, dev)
        del db, scales
    return {"rows": rows}


if __name__ == "__main__":
    main()
