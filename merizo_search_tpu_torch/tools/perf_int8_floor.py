"""Where the int8 scan's time goes, at Q = 256 over 2^24 int8 rows: the dot
alone (mini_scan "none", fixed tile 32768), the dot with the block-max
reduce ("reduce"), the port's phase A and the port's full fused_topk, and
phase A's time split into the dot, the reduce, the store and the length
channel at the first nslab (perf_floor2's `split`).

The fixed-tile front of perf_floor2 (same DB, queries and bounds), as the
JAX package's tools/perf_int8_floor.py is of its perf_floor2.py.

    python -m merizo_search_tpu_torch.tools.perf_int8_floor [nslab ...]
        [--q 256] [--log2-rows 24] [--k 100] [--iters 5] [--device cuda|cpu]
"""

from __future__ import annotations

from ..ops.probes import TILE
from . import _bench_util as bu
from .perf_floor2 import split, sweep


def main(argv=None, dbs=None):
    """As perf_floor2.main: `dbs` may hold a prebuilt int8 DB."""
    p = bu.parser(__doc__)
    p.add_argument("nslabs", type=int, nargs="*", default=[4])
    p.add_argument("--q", type=int, default=256)
    p.add_argument("--log2-rows", type=int, default=24)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--iters", type=int, default=5)
    args = p.parse_args(argv)
    dev, gen = bu.setup(args)
    db, scales = bu.db_for(dbs, 1 << args.log2_rows, "int8", gen, dev)
    rows = sweep(db, scales, "int8", args.q, [TILE], args.nslabs, args.k, args.iters, dev)
    got = split(rows, db, scales, "int8", args.q, TILE, args.nslabs[0], args.iters, dev)
    return {"rows": rows, "split": [got] if got else []}


if __name__ == "__main__":
    main()
