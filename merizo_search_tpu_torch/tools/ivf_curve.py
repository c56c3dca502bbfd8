"""IVF recall@k and queries/s by nprobe, the port's counterpart of the JAX
package's tools/ivf_curve.py (the same data, shapes and columns).

Data: a mixture of max(64, nlist/4) Gaussian centres (x3) plus unit noise,
rows normalised (numpy default_rng(seed), 0 by default: the JAX tool's
draws), and Q queries that are DB rows plus 0.05 noise, normalised. The
IVF is built with the port's build_ivf (expand 0.25 by default) and the
build's seconds are split into Lloyd / prefs / host balancing / refine /
duplicates. Recall@k is measured against the exact float64 ranking
(computed on the device), for each storage dtype and nprobe, with and
without the f32 rerank; queries/s is Q over the mean time of one
ivf_search call, back to back, from CUDA events (on the CPU: host-clock
times, not device metrics).

    python -m merizo_search_tpu_torch.tools.ivf_curve [--log2-rows 20]
        [--nlist 1024] [--k 100] [--q 256] [--expand 0.25]
        [--nprobe 4,8,16,32,64,128] [--iters 10]
        [--device cuda|cpu]

Prints one line a point and returns (and prints as its last line) one JSON
object {"config", "build_s", "build_split_s", "points"}.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from ..ops.topk import query_operands
from ..search import ivf as ivf_mod
from ..search.engine import DTYPES
from . import _bench_util as bu


def make_data(n: int, nlist: int, nq: int = 256, seed: int = 0):
    """(emb [n, 128] f32 unit rows, q [nq, 128] f32 unit queries): the JAX
    tool's generator, draw for draw."""
    ncenters = max(64, nlist // 4)
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(ncenters, 128)).astype(np.float32) * 3
    emb = centers[rng.integers(0, ncenters, n)] + rng.normal(size=(n, 128)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = emb[rng.choice(n, nq, replace=False)].copy()
    q += rng.normal(size=q.shape).astype(np.float32) * 0.05
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return emb, q


def exact_topk(emb: np.ndarray, q: np.ndarray, k: int, dev, chunk: int = 1 << 18):
    """The exact top-k ids [Q, k] of q against emb by float64 scores,
    computed on `dev` a chunk of rows at a time."""
    qd = torch.from_numpy(q).to(dev, torch.float64)
    best_v = torch.full((q.shape[0], 0), float("-inf"), dtype=torch.float64, device=dev)
    best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64, device=dev)
    for c0 in range(0, emb.shape[0], chunk):
        s = qd @ torch.from_numpy(emb[c0:c0 + chunk]).to(dev, torch.float64).T
        v, i = torch.topk(torch.cat([best_v, s], 1), k, dim=1)
        ids = torch.cat([best_i, torch.arange(c0, c0 + s.shape[1], device=dev).expand(
            q.shape[0], -1)], 1)
        best_v, best_i = v, torch.gather(ids, 1, i)
    return best_i.cpu().numpy()


def recall(idx: np.ndarray, ref: np.ndarray) -> float:
    k = ref.shape[1]
    return float(np.mean([len(set(idx[r].tolist()) & set(ref[r].tolist())) / k
                          for r in range(len(ref))]))


def search_fn(lay: dict, q: np.ndarray, k: int, nprobe: int, rerank: bool, dev):
    """A no-argument callable running one device-mode IVF search on a
    resident_layout, as the engine runs it (ivf.search_resident), with the
    query operands made once."""
    qf = torch.from_numpy(q).to(dev)
    query = query_operands(q, lay["db"].dtype, dev)
    return lambda: ivf_mod.search_resident(lay, qf, query, k, nprobe, rerank=rerank)


def main(argv=None, state=None):
    """Runs the curve. Returns the JSON object described above; `state`, a
    dict, receives emb, q, the build ("ivf") and the exact ids ("ref")."""
    p = bu.parser(__doc__)
    p.add_argument("--log2-rows", type=int, default=20)
    p.add_argument("--nlist", type=int, default=1024)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--q", type=int, default=256)
    p.add_argument("--expand", type=float, default=0.25)
    p.add_argument("--nprobe", type=bu.ints, default=[4, 8, 16, 32, 64, 128])
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args(argv)
    dev, _ = bu.setup(args)
    n = 1 << args.log2_rows
    emb, q = make_data(n, args.nlist, args.q, args.seed)
    split = {}
    t0 = time.perf_counter()
    ivf = ivf_mod.build_ivf(emb, args.nlist, expand=args.expand, device=dev, timings=split)
    build_s = time.perf_counter() - t0
    print(f"# build {build_s:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()),
          flush=True)
    ref = exact_topk(emb, q, args.k, dev)
    if state is not None:
        state.update(emb=emb, q=q, ivf=ivf, ref=ref)
    rk = f"recall_at_{args.k}"
    points = []
    for dtype in ("bf16", "int8"):
        lay = ivf_mod.resident_layout(emb, ivf, DTYPES[dtype], dev, rerank=True)
        for nprobe in args.nprobe:
            if nprobe > ivf["nlist"]:
                break
            row = {"dtype": dtype, "nprobe": nprobe,
                   "db_fraction_probed": nprobe / ivf["nlist"]}
            for tag, rerank in (("", False), ("rerank_", True)):
                fn = search_fn(lay, q, args.k, nprobe, rerank, dev)
                _, idx = fn()
                row[tag + rk] = recall(idx.cpu().numpy(), ref)
                ms = bu.loop_ms(lambda i: fn(), dev, args.iters)
                row[tag + "ms"] = ms
                row[tag + "qps"] = len(q) / (ms / 1e3)
            points.append(row)
            print(f"{dtype} nprobe={nprobe:4d}  recall@{args.k}={row[rk]:.4f} "
                  f"qps={row['qps']:10.1f}  rerank: {row['rerank_' + rk]:.4f} @ "
                  f"{row['rerank_qps']:10.1f}", flush=True)
        del lay
    out = {"config": {"N": len(emb), "D": 128, "nlist": ivf["nlist"], "k": args.k,
                      "q_batch": len(q), "expand": args.expand,
                      "cluster_rows": ivf["cluster_rows"], "multi_assignment": ivf["dup"],
                      "device": bu.device_line(dev),
                      "data": f"mixture of {max(64, args.nlist // 4)} gaussian clusters "
                              "(x3 + unit noise), unit-norm; queries: rows + 0.05 noise"},
           "build_s": build_s, "build_split_s": split, "points": points}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
