"""Exactness and per-batch time of the two-batch pipelined scan
(fused_topk_step) against the sequential fused_topk.

For each dtype and batch size: 3 batches through the pipeline plus a drain,
each batch's (v, idx) held against fused_topk of the same batch exactly
(indices equal, scores equal; the first step must return the all-miss
primer); then the steady-state time per batch of each, over --repeats
batches back to back. The DB is the JAX tool's: bf16 normal rows, or int8
clip(40 x normal) with scales 1/40.

    python -m merizo_search_tpu_torch.tools.perf_pipelined [--log2-rows 24]
        [--dtype both|bf16|int8] [--q 64,256] [--k 100] [--repeats 8]
        [--device cuda|cpu]

Exits 1 if any batch differs.
"""

from __future__ import annotations

import sys

import torch

from ..ops.fused_scan import fused_topk
from ..ops.pipelined import fused_topk_step
from . import _bench_util as bu


def make_queries(qn, dtype, gen, dev):
    """Three query batches of the DB's dtype, as the JAX tool makes them."""
    out = []
    for _ in range(3):
        x = torch.randn((qn, 128), generator=gen, device=dev, dtype=torch.bfloat16)
        out.append(x if dtype == "bf16" else x.mul_(40).clamp_(-127, 127).to(torch.int8))
    return out


def check_exact(db, scales, n, k, qs):
    """3 batches plus a drain through fused_topk_step against fused_topk."""
    carry, outs = None, []
    for i in range(4):
        res, carry = fused_topk_step(qs[min(i, 2)], db, n, k, carry, scales)
        outs.append(res)
    primer = bool((outs[0][0] == float("-inf")).all() and (outs[0][1] == -1).all())
    idx_diffs, max_dv, exact = 0, 0.0, primer
    for i in range(3):
        vr, ir = fused_topk(qs[i], db, n, k, scales=scales)
        vp, ip = outs[i + 1]
        idx_diffs += int((ir != ip).sum())
        fin = torch.isfinite(vr) & torch.isfinite(vp)
        if fin.any():
            max_dv = max(max_dv, float((vr[fin] - vp[fin]).abs().max()))
        exact = exact and torch.equal(ir, ip) and torch.equal(vr, vp)
    return {"primer": primer, "exact": exact, "idx_diffs": idx_diffs, "max_dv": max_dv}


def run(db, scales, n, k, qs, repeats, dev):
    """Exactness, then ms per batch of the sequential and the pipelined scan."""
    res = check_exact(db, scales, n, k, qs)
    res["seq_ms"] = bu.loop_ms(lambda i: fused_topk(qs[i % 3], db, n, k, scales=scales),
                               dev, repeats)
    state = {"carry": fused_topk_step(qs[0], db, n, k, None, scales)[1]}

    def step(i):
        state["carry"] = fused_topk_step(qs[i % 3], db, n, k, state["carry"], scales)[1]

    res["pipe_ms"] = bu.loop_ms(step, dev, repeats)
    return res


def main(argv=None, dbs=None):
    """Runs every (dtype, Q); `dbs` (dtype -> (db, scales)) may hold
    prebuilt DBs of 2^log2-rows rows. Returns {"n", "k", "runs"}."""
    p = bu.parser(__doc__)
    p.add_argument("--log2-rows", type=int, default=24)
    p.add_argument("--dtype", choices=("both", "bf16", "int8"), default="both")
    p.add_argument("--q", type=bu.ints, default=[64, 256])
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--repeats", type=int, default=8)
    args = p.parse_args(argv)
    dev, gen = bu.setup(args)
    n = 1 << args.log2_rows
    print(f"# N={n}, D=128, K={args.k}, repeats={args.repeats}", flush=True)
    runs = []
    for dtype in ("bf16", "int8") if args.dtype == "both" else (args.dtype,):
        db, scales = bu.db_for(dbs, n, dtype, gen, dev)
        gb = db.numel() * db.element_size() / 1e9
        for qn in args.q:
            r = run(db, scales, n, args.k, make_queries(qn, dtype, gen, dev),
                    args.repeats, dev)
            r.update(dtype=dtype, q=qn)
            runs.append(r)
            print(f"{dtype} Q={qn}: " + (
                "pipelined == sequential on 3 batches + drain (exact)" if r["exact"] else
                f"MISMATCH: primer ok {r['primer']}, {r['idx_diffs']} index diffs, "
                f"max |dv| {r['max_dv']}"), flush=True)
            for tag in ("seq", "pipe"):
                t = r[f"{tag}_ms"]
                print(f"  {dtype} Q={qn} {'sequential' if tag == 'seq' else 'pipelined '}: "
                      f"{t:.4f} ms/batch ({gb / t * 1e3:.1f} GB/s, {qn / t * 1e3:.0f} q/s)",
                      flush=True)
        del db, scales
    return {"n": n, "k": args.k, "runs": runs}


if __name__ == "__main__":
    sys.exit(0 if all(r["exact"] for r in main()["runs"]) else 1)
