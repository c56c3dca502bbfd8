"""Floor sweep of the scan: the dot alone (mini_scan "none"), the dot with
the block-max reduce (mini_scan "reduce"), the port's phase A
(blockmax_scan) and the port's full fused_topk, over tile, nslab, Q and
dtype, each beside the bound of the same product (bytes of one DB pass vs
operations at the tensor-core peak).

The DB is the JAX tool's (bf16 normal rows; int8 clip(40 x normal), scales
1/40); the queries too (int8: every row -64..63; bf16: the DB's first Q
rows). Phase A runs with the length channel on and passing every row (tl 0,
qcap inf), as the JAX tools time the production phase A. mini_scan's rows
time its kernel alone (`probes.kernel_alone`), as blockmax_scan's wrapper
adds no device work of its own.

mini_scan runs phase A's walk, so the sweep also splits phase A's time at
the first tile and nslab (`split`): the dot ("none"), the block-max reduce
("reduce" - "none"), the scale, NEG_CAP floor and store (blockmax_scan
with the channel off - "reduce") and the length channel (on - off), each
a difference of two readings of one run.

    python -m merizo_search_tpu_torch.tools.perf_floor2 [--q 256]
        [--dtypes int8] [--tiles 32768,65536] [--nslabs 2,4,8]
        [--log2-rows 24 | --rows N] [--k 100] [--iters 5] [--device cuda|cpu]
"""

from __future__ import annotations

import torch

from ..ops.blockmax import blockmax_scan
from ..ops.fused_scan import fused_topk
from ..ops.probes import MODES, kernel_alone
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
                ms = bu.time_ms(kernel_alone(q, db, tile, ns, mode), dev, iters, flush)
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


def split(rows, db, scales, dtype, qn, tile, nslab, iters, dev):
    """Phase A's time split into parts for one (dtype, Q), from the sweep's
    `rows` at (tile, nslab) and a reading of blockmax_scan with the length
    channel off taken here. Returns None where the sweep skipped the tile."""
    def ms(**key):
        got = [r["ms"] for r in rows if r["dtype"] == dtype and r["q"] == qn
               and all(r.get(k) == v for k, v in key.items())]
        return got[0] if got else None

    none, red = ms(tile=tile, nslab=nslab, mode="none"), ms(tile=tile, nslab=nslab,
                                                              mode="reduce")
    on = ms(what="phaseA (blockmax_scan)")
    if none is None or red is None:
        return None
    n = db.shape[0]
    q = make_queries(db, qn, dtype)
    off = bu.time_ms(lambda: blockmax_scan(q, db, n, scales=scales), dev, iters,
                     bu.flush_buffer(dev))
    out = {"dtype": dtype, "q": qn, "n": n, "tile": tile, "nslab": nslab,
           "none_ms": none, "reduce_ms": red, "phase_a_off_ms": off, "phase_a_on_ms": on,
           "reduce_part_ms": red - none, "store_part_ms": off - red,
           "channel_part_ms": on - off, "dot_ops_per_s": None}
    rate = ""
    if dev.type != "cpu":        # the dot's rate on the card, from "none"
        out["dot_ops_per_s"] = 2 * qn * n * 128 / (none * 1e-3)
        rate = f"; dot at {out['dot_ops_per_s'] / 1e12:.1f} T op/s"
    print(f"# split of phase A, Q={qn} {dtype} N={n}: dot {none:.4f} ms, reduce "
          f"{red - none:+.4f}, scale/NEG_CAP/store {off - red:+.4f}, channel "
          f"{on - off:+.4f} (phase A {on:.4f} ms{rate})", flush=True)
    return out


def main(argv=None, dbs=None):
    """Runs the sweep; `dbs` (dtype -> (db, scales)) may hold prebuilt DBs
    of the run's rows. Returns {"rows": one dict a timing, "split": one
    dict a (dtype, Q), phase A's parts at the first tile and nslab}."""
    p = bu.parser(__doc__)
    p.add_argument("--q", type=bu.ints, default=[256])
    p.add_argument("--dtypes", default="int8")
    p.add_argument("--tiles", type=bu.ints, default=[32768, 65536])
    p.add_argument("--nslabs", type=bu.ints, default=[2, 4, 8])
    p.add_argument("--log2-rows", type=int, default=24)
    p.add_argument("--rows", type=int, default=None, help="DB rows (overrides --log2-rows)")
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--iters", type=int, default=5)
    args = p.parse_args(argv)
    dev, gen = bu.setup(args)
    n = args.rows or 1 << args.log2_rows
    rows, splits = [], []
    for dtype in args.dtypes.split(","):
        db, scales = bu.db_for(dbs, n, dtype, gen, dev)
        for qn in args.q:
            got = sweep(db, scales, dtype, qn, args.tiles, args.nslabs, args.k,
                        args.iters, dev)
            rows += got
            splits.append(split(got, db, scales, dtype, qn, args.tiles[0], args.nslabs[0],
                                args.iters, dev))
        del db, scales
    return {"rows": rows, "split": [s for s in splits if s is not None]}


if __name__ == "__main__":
    main()
