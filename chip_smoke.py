"""Chip smoke test of the PyTorch/CUDA port: `python3 chip_smoke.py` on one H100.

Drives the port's main path (the `search` verb) on the card and checks it:

1. device   the card's name and power limit (nvidia-smi) and torch's name;
2. build    nvcc for the scan kernels (csrc/*.cu), g++ for TM-align, timed;
3. kernels  phase A (blockmax_scan) and phase C (gather_block_scores, all
            three scale modes) against their plain PyTorch versions on the
            card at N = 500,000 rows (Q = 32 and 256, bf16 and int8, length
            mask on and off), then timed there and at the 16M-row scan shape;
            and the cover invariant at both shapes (Q = 32 and 256 at
            500,000 rows, Q = 256 at 2^24 rows; bf16 and int8, mask on and
            off): phase C's max over each selected block below n_valid
            equals phase A's BM for it, exactly;
4. fused    fused_topk against the plain exact scan: recall@100 = 1.0 at
            N = 500,000, Q = 256, k = 100 (scores within 1e-5 are ties);
5. e2e      the `search` CLI on a 500,000-entry mmap DB with an int8 sidecar
            and 32 query PDBs, at bf16 and int8: every query's planted row
            is its rank-1 hit with TM-score >= 0.9, and both kernels'
            launch counters rose during these runs.
6. pipelined the pipelined two-batch scan through its tool
            (tools/perf_pipelined: 2^24 rows, Q = 64 and 256, k = 100, bf16
            and int8): equal to the sequential fused_topk exactly on 3
            batches plus a drain, and its per-batch time beside the
            sequential one; then its kernel (bm_gather) against its plain
            version at N = 500,000 and at 2^24 rows, timed there.
7. probes   the scan's floor probes through their tools (tools/perf_hbm,
            perf_int8_floor, perf_floor2 at 2^24 rows, Q = 256, and
            perf_floor2 at 500,096 rows, Q = 32): the read rate, the dot
            alone and the dot with the reduce on phase A's walk, and phase
            A's time split into the dot, the reduce, the scale/NEG_CAP/store
            and the length channel; then mini_scan (both modes, both dtypes)
            and stream_probe against their plain versions, sinks included,
            timed there.
8. variants phase A in slabs and the phase-C gather variants through their
            tools (tools/perf_slab_interleave at 2^24 rows, Q = 256, tiles
            8192/16384/32768, nslab 1/2/4/8; tools/perf_gather_int8 at 2^24 rows,
            Q = 256, KB = 102, G = 34, every mode): slab_scan, with its SBM
            output and without, equal to blockmax_scan with the length
            channel off for every nslab; then
            slab_scan and every gather mode against their plain versions,
            sinks included, at N = 500,000 and at 2^24 rows.

Each path (e2e, pipelined, probes, variants) starts with every kernel's
launch count at 0 and fails unless each of its kernels was launched. The
2^24-row rows of phases 3 and 6-8 share one bf16 and one int8 DB a run (the
tools' synthetic DB); the kernel table takes the times and bounds of the
probes and variants from their tools' rows and times only the plain
versions and library calls itself.

Prints one line per phase with its seconds, a JSON line of the tools'
results, a JSON line {"phase_a_split": [...]}, the nvidia-smi line, a JSON
line {"kernels": [...]}, and as its last line {"ok": true, "device": {...}}.
Any failed check, build, launch or phase deadline raises and exits non-zero;
with no CUDA device it exits non-zero before printing any result. Scratch
files live in a temporary directory outside the checkout and are removed.
"""

from __future__ import annotations

import faulthandler
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from merizo_search_tpu_torch.tools import _bench_util
from merizo_search_tpu_torch.tools._bench_util import bound, device_line

HERE = os.path.dirname(os.path.abspath(__file__))
TOTAL_BUDGET_S = 300       # hard watchdog: dump stacks and exit(1) past this
# per-phase deadlines, a few times each phase's measured seconds
PHASE_BUDGET_S = {"device": 30, "build": 60, "kernels": 60, "fused": 30, "e2e": 90,
                  "pipelined": 20, "probes": 25, "variants": 30}
N_MAIN = 500_000           # CATH-scale DB rows (BASELINE.json's second config)
N_BIG = 16_777_216         # the 16M-row scan shape
BF16_TOL = 1e-5            # |kernel - plain| for unit-norm bf16 rows

T0 = time.perf_counter()


class Phase:
    """Times a phase, prints one line, and fails it past its deadline. The
    watchdog is re-armed per phase, so a hang inside a CUDA call or a
    compiler still ends the run with a stack dump and exit code 1."""

    def __init__(self, name):
        self.name, self.budget = name, PHASE_BUDGET_S[name]
        self.notes = []

    def __enter__(self):
        remaining = TOTAL_BUDGET_S - (time.perf_counter() - T0)
        faulthandler.dump_traceback_later(max(1.0, min(self.budget, remaining)), exit=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *_):
        faulthandler.cancel_dump_traceback_later()
        dt = time.perf_counter() - self.t0
        extra = f" ({'; '.join(self.notes)})" if self.notes else ""
        print(f"phase {self.name}: {dt:.2f} s{extra}", flush=True)
        if exc_type is None and dt > self.budget:
            raise RuntimeError(f"phase {self.name} overran its {self.budget} s deadline")
        return False


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, iters=10, flush=None):
    """Mean device time of fn() in ms, from CUDA events around each call;
    `flush` (a large buffer) is rewritten before each call, outside the
    timed window, so the call finds the 50 MB L2 cold, as the pipeline does."""
    return _bench_util.time_ms(fn, torch.device("cuda"), iters, flush)


def max_err(got, want, exact, rel=False):
    """Max |got - want| over entries that are not sentinels; the sentinel
    pattern and (for int8) every value must agree exactly. bf16 entries may
    differ by BF16_TOL, times max(1, |want|) where `rel` (rows that are not
    unit-norm)."""
    from merizo_search_tpu_torch.ops.blockmax import NEG_CAP

    gm, wm = got <= NEG_CAP, want <= NEG_CAP
    check(torch.equal(gm, wm), "kernel and plain versions disagree on masked entries")
    if not (~wm).any():
        return 0.0
    diff, w = (got[~wm] - want[~wm]).abs(), want[~wm]
    allowed = 0.0 if exact else BF16_TOL * (w.abs().clamp(min=1.0) if rel else 1.0)
    check(bool((diff <= allowed).all()), f"kernel deviates from plain by {diff.max().item()}")
    return diff.max().item()


def unit_rows(n, gen, dev, chunk=1 << 20):
    out = torch.empty((n, 128), dtype=torch.float32, device=dev)
    for i in range(0, n, chunk):
        x = torch.randn((min(chunk, n - i), 128), generator=gen, device=dev)
        out[i:i + len(x)] = x / x.norm(dim=1, keepdim=True)
    return out


def library_product(q, db):
    """The library yardstick for phase A: the whole score matrix q @ db.T by
    one PyTorch call (cuBLAS bf16 GEMM, or the int8 `_int_mm` to int32)."""
    return torch._int_mm(q, db.T) if q.dtype == torch.int8 else torch.matmul(q, db.T)


def make_problem(n, nq, gen, dev):
    """bf16 and int8 versions of one seeded problem with the length channel."""
    from merizo_search_tpu_torch.ops.topk import quantize_blocks, quantize_rows

    npad = -(-n // 128) * 128
    db = torch.zeros((npad, 128), device=dev)
    db[:n] = unit_rows(n, gen, dev)
    q = unit_rows(nq, gen, dev)
    tlen = torch.full((npad,), 1e9, device=dev)
    tlen[:n] = torch.randint(50, 401, (n,), generator=gen, device=dev).float()
    qlen = torch.randint(50, 401, (nq,), generator=gen, device=dev).float()
    db8, sc = quantize_blocks(db.cpu().numpy())
    q8, _ = quantize_rows(q.cpu().numpy())
    return {"n": n, "tl": tlen * torch.tensor(0.7, device=dev), "tlen": tlen, "qlen": qlen,
            "bf16": (q.to(torch.bfloat16), db.to(torch.bfloat16), None),
            "int8": (torch.from_numpy(q8).to(dev), torch.from_numpy(db8).to(dev),
                     torch.from_numpy(sc).to(dev))}


def big_dbs(gen, dev):
    """The one bf16 and one int8 DB of N_BIG rows a run: the tools' synthetic
    DB (_bench_util.make_db), shared by the 16M-row rows of the kernels
    phase and by the pipelined and probes phases and their tools."""
    return {dtype: _bench_util.make_db(N_BIG, dtype, gen, dev) for dtype in ("bf16", "int8")}


def cover_row(dtype, n, q, db, sc, bm, tl=None, qc=None, k=100):
    """The cover invariant on the card: phase B's top-(k+1) blocks from
    the kernel's BM, rescored by the phase-C kernel (int8 with the selected
    blocks' scales); every compared block's max must equal its BM."""
    from merizo_search_tpu_torch.ops import gather
    from merizo_search_tpu_torch.ops.fused_scan import (cover_check, select_blocks,
                                                        selected_scales)

    bidx = select_blocks(bm, n, k)
    kw = {} if sc is None else {"scale_sel": selected_scales(sc, bidx)}
    scores = gather.gather_block_scores(q, db, bidx, n, tl, qc, **kw)
    compared, differ = cover_check(bm, scores, bidx, n)
    row = {"dtype": dtype, "n": db.shape[0], "q": q.shape[0], "mask": tl is not None,
           "compared": compared, "differ": differ}
    check(compared > 0 and differ == 0, f"phase C's block maxima differ from BM: {row}")
    return row


def kernels_phase(dev, gen, flush, big):
    """Hold both kernels against their plain versions and to the cover
    invariant, then time them."""
    from merizo_search_tpu_torch.ops import blockmax, gather
    from merizo_search_tpu_torch.ops.fused_scan import select_blocks, selected_scales
    from merizo_search_tpu_torch.tools.perf_pipelined import make_queries

    bm_modes, g_modes, cover = [], [], []
    p = make_problem(N_MAIN, 256, gen, dev)
    for dtype in ("bf16", "int8"):
        q, db, sc = p[dtype]
        isz = db.element_size()
        for nq in (32, 256):
            for masked in (False, True):
                tl, qc = (p["tl"], p["qlen"][:nq].contiguous()) if masked else (None, None)
                qq = q[:nq].contiguous()
                args = (qq, db, p["n"], tl, qc, sc)
                got = blockmax.blockmax_scan(*args)
                torch.cuda.synchronize()
                want = blockmax.blockmax_plain(*args)
                err = max_err(got, want, dtype == "int8")
                cover.append(cover_row(dtype, p["n"], qq, db, sc, got, tl, qc))
                ms = time_ms(lambda: blockmax.blockmax_scan(*args), flush=flush)
                plain_ms = time_ms(lambda: blockmax.blockmax_plain(*args), 3, flush)
                npad, nb = db.shape[0], db.shape[0] // 128
                nbytes = (npad * 128 * isz + nq * 128 * isz + nq * nb * 4
                          + (npad * 4 + nq * 4 if masked else 0)
                          + (nb * 4 if sc is not None else 0))   # one scale a block
                b_ms, b_by = bound(nbytes, 2 * nq * npad * 128, dtype)
                lib = time_ms(lambda: library_product(qq, db), flush=flush)
                bm_modes.append({"dtype": dtype, "n": npad, "q": nq, "mask": masked,
                                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib})
                # phase C on the blocks phase B picks from this BM
                for k in (10, 100) if masked else ():
                    if (nq, k) not in ((32, 10), (256, 100)):
                        continue
                    bidx = select_blocks(got, p["n"], k)
                    bidx[::3, 1] = -1                      # padding columns too
                    modes = [("none", {})] if dtype == "bf16" else [
                        ("scale_sel", {"scale_sel": torch.where(
                            bidx >= 0, sc[bidx.clamp(min=0).long() * 128], 1.0).contiguous()}),
                        ("row_scales", {"scales": sc})]
                    for mode, kw in modes:
                        gargs = (qq, db, bidx, p["n"], tl, qc)
                        g = gather.gather_block_scores(*gargs, **kw)
                        torch.cuda.synchronize()
                        gerr = max_err(g, gather.gather_plain(*gargs, **kw), dtype == "int8")
                        gms = time_ms(lambda: gather.gather_block_scores(*gargs, **kw),
                                      flush=flush)
                        # the sub-0.1 ms readings' spread within a run (PERF.md rows 2-3)
                        reps = [time_ms(lambda: gather.gather_block_scores(*gargs, **kw),
                                        flush=flush) for _ in range(4 if nq == 32 else 0)]
                        gplain = time_ms(lambda: gather.gather_plain(*gargs, **kw), 3, flush)
                        kbv = int((bidx >= 0).sum())
                        nblk = int(torch.unique(bidx[bidx >= 0]).numel())
                        gbytes = (nblk * 128 * (128 * isz + 4 + (4 if mode == "row_scales" else 0))
                                  + nq * 128 * isz + bidx.numel() * 4
                                  + (bidx.numel() * 4 if mode == "scale_sel" else 0)
                                  + nq * 4 + g.numel() * 4)
                        gb_ms, gb_by = bound(gbytes, 2 * kbv * 128 * 128, dtype)
                        g_modes.append({"dtype": dtype, "mode": mode, "n": npad, "q": nq,
                                        "kb": bidx.shape[1], "max_abs_err": gerr,
                                        "ms": gms, "plain_ms": gplain, "bound_ms": gb_ms,
                                        "bound_by": gb_by, "library_ms": None,
                                        "ms_repeats": reps})
    del p
    torch.cuda.empty_cache()
    # the 16M-row scan shape, Q = 256: kernel times and bounds only
    for dtype in ("bf16", "int8"):
        db, sc = big[dtype]
        q = make_queries(256, dtype, gen, dev)[0]
        isz, nb = db.element_size(), N_BIG // 128
        bm = blockmax.blockmax_scan(q, db, N_BIG, scales=sc)
        cover.append(cover_row(dtype, N_BIG, q, db, sc, bm))
        tl = torch.rand(N_BIG, generator=gen, device=dev) * 280.0
        qc = torch.rand(256, generator=gen, device=dev) * 400.0
        cover.append(cover_row(dtype, N_BIG, q, db, sc,
                               blockmax.blockmax_scan(q, db, N_BIG, tl, qc, sc), tl, qc))
        del tl
        ms = time_ms(lambda: blockmax.blockmax_scan(q, db, N_BIG, scales=sc), 5, flush)
        b_ms, b_by = bound(N_BIG * 128 * isz + 256 * 128 * isz + 256 * nb * 4
                           + (nb * 4 if sc is not None else 0),
                           2 * 256 * N_BIG * 128, dtype)
        lib = time_ms(lambda: library_product(q, db), 3, flush)
        bm_modes.append({"dtype": dtype, "n": N_BIG, "q": 256, "mask": False,
                         "max_abs_err": None, "ms": ms, "plain_ms": None,
                         "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib})
        bidx = select_blocks(bm, N_BIG, 100)
        kw = {} if sc is None else {"scale_sel": selected_scales(sc, bidx)}
        gms = time_ms(lambda: gather.gather_block_scores(q, db, bidx, N_BIG, **kw), 10, flush)
        nblk = int(torch.unique(bidx[bidx >= 0]).numel())
        gb_ms, gb_by = bound(nblk * 128 * 128 * isz + 256 * 128 * isz
                             + bidx.numel() * 4 * (1 + len(kw))
                             + 256 * bidx.shape[1] * 128 * 4,
                             2 * int((bidx >= 0).sum()) * 128 * 128, dtype)
        g_modes.append({"dtype": dtype, "mode": "none" if sc is None else "scale_sel",
                        "n": N_BIG, "q": 256, "kb": bidx.shape[1], "max_abs_err": None,
                        "ms": gms, "plain_ms": None, "bound_ms": gb_ms,
                        "bound_by": gb_by, "library_ms": None})
        del bm
    return bm_modes, g_modes, cover


def recall_check(fv, fi, pv, pi, k):
    """recall@k of the fused result against the plain exact one, where a
    plain hit missing from the fused set counts only if its score clears the
    k-th score by more than the tie tolerance (1e-5, relative above 1)."""
    misses = 0
    for r in range(pv.shape[0]):
        tol = BF16_TOL * max(1.0, abs(float(pv[r, k - 1])))
        got = set(fi[r].tolist())
        for v, i in zip(pv[r].tolist(), pi[r].tolist()):
            if i not in got and v > pv[r, k - 1] + tol:
                misses += 1
        check(np.all(fv[r] >= pv[r] - tol), f"fused scores below plain ones in row {r}")
    return 1.0 - misses / (pv.shape[0] * k)


def fused_phase(dev, gen):
    from merizo_search_tpu_torch.ops.fused_scan import fused_topk
    from merizo_search_tpu_torch.ops.topk import topk_scan

    p = make_problem(N_MAIN, 256, gen, dev)
    k, out = 100, {}
    for dtype in ("bf16", "int8"):
        q, db, sc = p[dtype]
        fv, fi = fused_topk(q, db, p["n"], k, tlen=p["tlen"], qlen=p["qlen"],
                            mincov=0.7, use_len=True, scales=sc)
        if dtype == "bf16":
            pv, pi = topk_scan(q, db, p["n"], k, tlen=p["tlen"], qlen=p["qlen"], mincov=0.7)
        else:   # exact integer dots (< 2^24 in f32) times the block scales
            s = (q.float() @ db.float().T) * sc[None, :]
            keep = (torch.arange(db.shape[0], device=dev) < p["n"])[None, :] & (
                p["qlen"][:, None] >= p["tl"][None, :])
            pv, pi = torch.topk(torch.where(keep, s, float("-inf")), k, dim=1)
        torch.cuda.synchronize()
        out[dtype] = recall_check(fv.cpu().numpy(), fi.cpu().numpy(),
                                  pv.cpu().numpy(), pi.cpu().numpy(), k)
        check(out[dtype] == 1.0, f"fused_topk {dtype} recall@{k} = {out[dtype]}")
    return out


def reset_counts():
    """Every kernel wrapper's launch count to 0: a path starts here."""
    from merizo_search_tpu_torch.ops import (blockmax, gather, gather_variants, pipelined,
                                             probes, slab_interleave)

    blockmax.launches = gather.launches = pipelined.launches = slab_interleave.launches = 0
    for counts in (probes.launches, gather_variants.launches):
        for name in counts:
            counts[name] = 0


def launch_counts():
    from merizo_search_tpu_torch.ops import (blockmax, gather, gather_variants, pipelined,
                                             probes, slab_interleave)

    return {"blockmax_scan": blockmax.launches, "gather_block_scores": gather.launches,
            "blockmax_scan_gather": pipelined.launches, **probes.launches,
            "slab_scan": slab_interleave.launches,
            **{f"gather_variant.{m}": n for m, n in gather_variants.launches.items()}}


def bm_gather_mode(dtype, q, pv_q, db, sc, n, rel, flush, k=100):
    """Hold the pipelined kernel against its plain version on one batch and
    the previous batch's top-(k+1) blocks (int8: with their carried block
    scales, as fused_topk_step passes them), then time it, the plain version
    and, as a labelled yardstick, the two sequential launches it replaces
    (phase A, then phase C) on the same inputs."""
    from merizo_search_tpu_torch.ops import blockmax, gather, pipelined
    from merizo_search_tpu_torch.ops.fused_scan import select_blocks, selected_scales

    pv_bidx = select_blocks(blockmax.blockmax_scan(pv_q, db, n, scales=sc), n, k)
    ss = None if sc is None else selected_scales(sc, pv_bidx)
    args = (q, db, n, pv_q, pv_bidx, sc, ss)
    got = pipelined.blockmax_scan_gather(*args)
    torch.cuda.synchronize()
    want = pipelined.blockmax_scan_gather_plain(*args)
    err = max(max_err(g, w, dtype == "int8", rel) for g, w in zip(got, want))
    del got, want
    ms = time_ms(lambda: pipelined.blockmax_scan_gather(*args), 5, flush)
    plain_ms = time_ms(lambda: pipelined.blockmax_scan_gather_plain(*args), 1, flush)
    seq_ms = time_ms(lambda: (blockmax.blockmax_scan(q, db, n, scales=sc),
                              gather.gather_block_scores(pv_q, db, pv_bidx, n, scale_sel=ss)),
                     5, flush)
    # the fused launch with an empty previous selection runs phase A alone
    no_prev = pv_bidx.new_empty((pv_q.shape[0], 0))
    a_only_ms = time_ms(lambda: pipelined.blockmax_scan_gather(q, db, n, pv_q, no_prev, sc),
                        5, flush)
    nq, nqp, kb = q.shape[0], pv_q.shape[0], pv_bidx.shape[1]
    npad, isz = db.shape[0], db.element_size()
    nb = npad // 128
    nbytes = (npad * 128 * isz + (nq + nqp) * 128 * isz + pv_bidx.numel() * 4
              + (nb * 4 + pv_bidx.numel() * 4 if sc is not None else 0)
              + nq * nb * 4 + nqp * kb * 128 * 4)
    ops = 2 * nq * npad * 128 + 2 * int((pv_bidx >= 0).sum()) * 128 * 128
    b_ms, b_by = bound(nbytes, ops, dtype)
    return {"dtype": dtype, "n": npad, "q": nq, "kb": kb, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "sequential_kernels_ms": seq_ms, "fused_phase_a_only_ms": a_only_ms}


def pipelined_phase(dev, gen, flush, big):
    """The pipelined path through its tool on the run's 2^24-row DBs, then
    its kernel against the plain version at the 500k problem (unit rows,
    ragged n, Q = 64) and at 2^24 rows (the tool's queries, Q = 256)."""
    from merizo_search_tpu_torch.tools import perf_pipelined

    reset_counts()                                   # the pipelined path starts here
    tool = perf_pipelined.main(["--log2-rows", "24", "--q", "64,256", "--k", "100",
                                "--dtype", "both", "--repeats", "8"], dbs=big)
    counts = launch_counts()
    check(counts["blockmax_scan_gather"] > 0, "the pipelined path never launched bm_gather")
    for r in tool["runs"]:
        check(r["exact"], f"pipelined scan differs from the sequential fused_topk: {r}")
    modes = []
    p = make_problem(N_MAIN, 128, gen, dev)
    for dtype in ("bf16", "int8"):
        q, db, sc = p[dtype]
        modes.append(bm_gather_mode(dtype, q[:64].contiguous(), q[64:].contiguous(), db,
                                    sc, p["n"], False, flush))
    del p
    torch.cuda.empty_cache()
    for dtype in ("bf16", "int8"):
        db, sc = big[dtype]
        qs = perf_pipelined.make_queries(256, dtype, gen, dev)
        modes.append(bm_gather_mode(dtype, qs[0], qs[1], db, sc, N_BIG, True, flush))
    return tool, counts, modes


def tool_row(rows, **key):
    """The one row of a tool's output that matches `key`."""
    got = [r for r in rows if all(r.get(k) == v for k, v in key.items())]
    check(len(got) == 1, f"expected one tool row for {key}, found {len(got)}")
    return got[0]


def probes_phase(dev, gen, flush, big):
    """The floor probes through their tools on the run's 2^24-row DBs (the
    2 GiB int8 DB is stream_probe's buffer) and, for phase A's split at the
    search shape, on a 500,096-row DB with Q = 32 (tile = the whole DB);
    then mini_scan (both modes, both dtypes, tile 32768, nslab 4, Q = 256)
    and stream_probe against their plain versions on the tools' inputs,
    sinks included. Kernel times and bounds are the tools' rows; the plain
    versions and the library yardstick are timed here."""
    from merizo_search_tpu_torch.ops import probes
    from merizo_search_tpu_torch.tools import perf_floor2, perf_hbm, perf_int8_floor

    reset_counts()                                   # the probes path starts here
    tools = {"perf_hbm": perf_hbm.main(["--iters", "5"], x=big["int8"][0]),
             "perf_int8_floor": perf_int8_floor.main(["4", "2", "--iters", "3"], dbs=big),
             "perf_floor2": perf_floor2.main(["--dtypes", "bf16", "--tiles", "32768,65536",
                                              "--nslabs", "4,2", "--iters", "3"], dbs=big),
             "perf_floor2_search_shape": perf_floor2.main(
                 ["--rows", "500096", "--q", "32", "--dtypes", "bf16,int8", "--tiles",
                  "500096", "--nslabs", "1", "--k", "10", "--iters", "20"])}
    counts = launch_counts()
    for name in ("mini_scan", "stream_probe"):
        check(counts[name] > 0, f"the probes path never launched {name}")
    mini, stream = [], []
    for dtype, tool in (("bf16", "perf_floor2"), ("int8", "perf_int8_floor")):
        db, _ = big[dtype]
        q = perf_floor2.make_queries(db, 256, dtype)
        for mode in probes.MODES:
            args = (q, db, probes.TILE, 4, mode)
            got, sink = probes.mini_scan(*args)
            torch.cuda.synchronize()
            want, wsink = probes.mini_scan_plain(*args)
            err = max_err(got, want, dtype == "int8", rel=True)
            serr = abs(sink.item() - wsink.item())
            check(serr <= (0.0 if dtype == "int8" else BF16_TOL * max(1.0, abs(wsink.item()))),
                  f"mini_scan {dtype} {mode}: sink {sink.item()} vs plain {wsink.item()}")
            del got, want
            row = tool_row(tools[tool]["rows"], dtype=dtype, q=256, tile=probes.TILE,
                           nslab=4, mode=mode)
            mini.append({"dtype": dtype, "mode": mode, "n": N_BIG, "q": 256,
                         "tile": probes.TILE, "nslab": 4, "max_abs_err": err,
                         "sink_err": serr, "ms": row["ms"], "ms_from": tool,
                         "plain_ms": time_ms(lambda: probes.mini_scan_plain(*args), 1, flush),
                         "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                         "library_ms": time_ms(lambda: library_product(q, db), 3, flush)})
    x = big["int8"][0]
    hbm = tools["perf_hbm"]["rows"]
    for view, tile in ((x, 65536), (x.view(-1, 1024), 8192)):
        o, sink = probes.stream_probe(view, 1.0, tile)
        torch.cuda.synchronize()
        wo, wsink = probes.stream_probe_plain(view, 1.0, tile)
        check(torch.equal(o, wo) and sink.item() == wsink.item(),
              f"stream_probe d={view.shape[1]}: output or sink differs from plain")
        b_ms, b_by = bound(view.numel() + o.numel() * 4 + 4, 0, "int8")
        stream.append({"d": view.shape[1], "tile": tile, "bytes": view.numel(),
                       "max_abs_err": 0.0,
                       "ms": tool_row(hbm, d=view.shape[1], tile=tile)["ms"],
                       "ms_from": "perf_hbm",
                       "plain_ms": time_ms(lambda: probes.stream_probe_plain(view, 1.0, tile),
                                           3, flush),
                       "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                       "torch_sum_ms": tool_row(hbm, tile=0)["ms"]})
    splits = [sp for t in tools.values() for sp in t.get("split", [])]
    check(len(splits) == 4, f"expected phase A's split at 4 shapes, got {len(splits)}")
    return tools, counts, mini, stream, splits


def pad_rows(db, sc, rows):
    """db (and its scales) padded with zero rows (scale 1) to `rows` rows."""
    pad = rows - db.shape[0]
    return (torch.cat([db, db.new_zeros((pad, 128))]),
            None if sc is None else torch.cat([sc, sc.new_ones(pad)]))


def variants_phase(dev, gen, flush, big):
    """Phase A in slabs and the gather variants through their tools on the
    run's 2^24-row DBs; then each kernel against its plain version at the
    500k problem (unit rows; slab_scan on the DB padded to 16 tiles of
    32768 rows, n_valid 500,000 cutting a block; bidx random with negative
    and repeated ids) and at 2^24 rows (the tools' queries and bidx). Kernel
    times and bounds are the tools' rows; the plain versions are timed
    here at 2^24 rows."""
    from merizo_search_tpu_torch.ops import blockmax, gather_variants, slab_interleave
    from merizo_search_tpu_torch.tools import perf_gather_int8, perf_slab_interleave

    reset_counts()                                   # the variants path starts here
    rows = ["--log2-rows", str(N_BIG.bit_length() - 1)]
    tools = {"perf_slab_interleave": perf_slab_interleave.main(
                 ["--tiles", "8192,16384,32768", "--nslabs", "1,2,4,8", "--no-sbm",
                  "--iters", "3", *rows], dbs=big),
             "perf_gather_int8": perf_gather_int8.main(["--iters", "10", *rows], dbs=big)}
    counts = launch_counts()
    for name in ["slab_scan"] + [f"gather_variant.{m}" for m in gather_variants.MODES]:
        check(counts[name] > 0, f"the variants path never launched {name}")
    srows, grows = tools["perf_slab_interleave"]["rows"], tools["perf_gather_int8"]["rows"]
    for r in srows:
        if "nslab" in r:
            check(r["dbm"] == 0.0 and r["dsbm"] == 0.0,
                  f"slab_scan differs from blockmax_scan at 2^24 rows: {r}")

    def slab_check(q, db, sc, n, rel):
        """Every nslab against the plain version and, bit for bit, against
        blockmax_scan with the channel off; returns the max error."""
        want = slab_interleave.slab_scan_plain(q, db, n, slab_interleave.TILE, 1, sc)
        bm0 = blockmax.blockmax_scan(q, db, n, scales=sc)
        sb0 = bm0.view(q.shape[0], -1, slab_interleave.TILE // 128).amax(dim=2)
        err = 0.0
        for ns in slab_interleave.NSLABS:
            bm, sbm = slab_interleave.slab_scan(q, db, n, slab_interleave.TILE, ns, sc)
            torch.cuda.synchronize()
            bm_only, _ = slab_interleave.slab_scan(q, db, n, slab_interleave.TILE, ns, sc,
                                                   sbm=False)
            torch.cuda.synchronize()
            check(torch.equal(bm, bm0) and torch.equal(sbm, sb0) and torch.equal(bm_only, bm0),
                  f"slab_scan nslab={ns} is not blockmax_scan's BM bit for bit")
            for g, w in ((bm, want[0]), (sbm, want[1])):
                err = max(err, max_err(g, w, q.dtype == torch.int8, rel))
        return err

    def gather_check(q, db, bidx, rel):
        """Every mode against the plain version, sinks exact; returns the
        max error of each mode."""
        errs = {}
        for kind in gather_variants.MODES:
            if kind == "int32view" and db.dtype != torch.int8:
                continue
            got, sink = gather_variants.gather_variant(q, db, bidx, kind)
            torch.cuda.synchronize()
            want, wsink = gather_variants.gather_variant_plain(q, db, bidx, kind)
            exact = db.dtype == torch.int8 or kind != "full"
            errs[kind] = max_err(got, want, exact, rel)
            check((sink is None and wsink is None) or sink.item() == wsink.item(),
                  f"gather_variant {kind}: sink differs from the plain version's")
        return errs

    p = make_problem(N_MAIN, 256, gen, dev)
    rng = np.random.default_rng(1)
    small = {}
    for dtype in ("bf16", "int8"):
        q, db, sc = p[dtype]
        dbp, scp = pad_rows(db, sc, 16 * slab_interleave.TILE)
        slab_err = slab_check(q, dbp, scp, N_MAIN, False)
        bidx = torch.from_numpy(rng.integers(0, db.shape[0] // 128, (256, 102))
                                .astype(np.int32)).to(dev)
        bidx[::7, 5] = -1
        bidx[::11, 1] = bidx[::11, 0]
        small[dtype] = (slab_err, gather_check(q, db, bidx, False))
    del p
    torch.cuda.empty_cache()
    slab, gvar = [], []
    for dtype in ("bf16", "int8"):
        db, sc = big[dtype]
        q = perf_slab_interleave.make_queries(256, dtype, 0, gen, dev)
        err = max(small[dtype][0], slab_check(q, db, sc, N_BIG, True))
        args = (q, db, N_BIG, slab_interleave.TILE, 2, sc)
        plain_ms = time_ms(lambda: slab_interleave.slab_scan_plain(*args), 1, flush)
        lib = tool_row(srows, dtype=dtype, what="library " + (
            "torch._int_mm" if dtype == "int8" else "torch.matmul"))
        for r in srows:
            if r["dtype"] == dtype and "nslab" in r:
                slab.append({"dtype": dtype, "n": N_BIG, "q": 256, "tile": r["tile"],
                             "nslab": r["nslab"], "sbm": r.get("sbm", True),
                             "max_abs_err": err, "ms": r["ms"],
                             "ms_from": "perf_slab_interleave", "plain_ms": plain_ms,
                             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                             "library_ms": lib["ms"], "baseline_blockmax_ms": tool_row(
                                 srows, dtype=dtype, what="baseline blockmax_scan")["ms"]})
        qg = perf_gather_int8.make_queries(256, dtype, 0, gen, dev)
        bidx = perf_gather_int8.make_bidx(256, 102, N_BIG // 128, 0, dev)
        errs = gather_check(qg, db, bidx, True)
        for kind, e in errs.items():
            r = tool_row(grows, dtype=dtype, mode=kind)
            gvar.append({"dtype": dtype, "mode": kind, "n": N_BIG, "q": 256, "kb": 102,
                         "g": 34, "max_abs_err": max(e, small[dtype][1][kind]),
                         "ms": r["ms"], "ms_from": "perf_gather_int8",
                         "plain_ms": time_ms(lambda k=kind: gather_variants.gather_variant_plain(
                             qg, db, bidx, k), 1, flush),
                         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                         "library_ms": None, "phase_c_ms": r["phase_c_ms"]})
    return tools, counts, slab, gvar


def walk(rng, n):
    steps = rng.normal(size=(n, 3))
    for i in range(1, n):
        steps[i] = 0.6 * steps[i - 1] + 0.4 * steps[i]
    steps /= np.linalg.norm(steps, axis=1, keepdims=True)
    return np.round(np.cumsum(steps * 3.8, axis=0), 3).astype(np.float32)


def write_pdb(path, coords):
    with open(path, "w") as fh:
        for i, (x, y, z) in enumerate(coords, start=1):
            fh.write(f"ATOM  {i:5d}  CA  ALA A{i:4d}    {x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00\n")
        fh.write("END\n")


def write_mmap_db(prefix, emb, names, coords_of, pool):
    """The mmap layout MmapDBWriter writes, in bulk: entry i's coordinates
    and sequence are pool[coords_of[i]] (start/end pairs into one blob)."""
    from merizo_search_tpu_torch.db.codecs import NAME_RECORD

    d, base = os.path.dirname(prefix), os.path.basename(prefix)
    files = {"dbfname_IP": base + "_raw_128d_norm.db",
             "db_names_f": base + "_raw_128d.index_names",
             "sif": base + "_seq.index", "sdf": base + "_seq.db",
             "cif": base + "_ca.index", "cdf": base + "_ca.db"}
    emb.astype(np.float32).tofile(os.path.join(d, files["dbfname_IP"]))
    rec = np.array([f"{nm[:32]:<32}\n".encode("ascii") for nm in names], f"S{NAME_RECORD}")
    rec.tofile(os.path.join(d, files["db_names_f"]))
    lens = np.array([len(c) for c in pool], np.int64)
    for idx, blob, per_res in (("cif", "cdf", 12), ("sif", "sdf", 1)):
        start = np.concatenate([[0], np.cumsum(lens * per_res)[:-1]])
        se = np.stack([start[coords_of], start[coords_of] + lens[coords_of] * per_res], 1)
        se.astype(np.int64).tofile(os.path.join(d, files[idx]))
        with open(os.path.join(d, files[blob]), "wb") as fh:
            for c in pool:
                fh.write(c.astype(np.float32).tobytes() if per_res == 12
                         else b"A" * len(c))
    info = dict(files, DB_SIZE=len(emb), DB_DIM=emb.shape[1])
    with open(prefix + ".json", "w") as fh:
        json.dump(info, fh)


def e2e_phase(dev, tmp):
    from merizo_search_tpu_torch import cli
    from merizo_search_tpu_torch.db.codecs import FlatDB, write_quantized_sidecar
    from merizo_search_tpu_torch.ops import blockmax, gather
    from merizo_search_tpu_torch.pipeline.embed import embed_structures, load_foldclass_params
    from merizo_search_tpu_torch.utils import profiling

    z = np.load(os.path.join(HERE, "tests", "golden", "foldclass.npz"))
    weights = os.path.join(tmp, "foldclass.pt")
    torch.save({k[3:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd.")}, weights)

    rng = np.random.default_rng(7)
    qcoords = [walk(rng, int(n)) for n in rng.integers(60, 401, 32)]
    pdbs = []
    for i, c in enumerate(qcoords):
        pdbs.append(os.path.join(tmp, f"q{i:02d}.pdb"))
        write_pdb(pdbs[-1], c)
    qemb = embed_structures(load_foldclass_params(weights, dev), qcoords)
    qemb /= np.linalg.norm(qemb, axis=1, keepdims=True)

    gen = torch.Generator(device=dev).manual_seed(11)
    emb = unit_rows(N_MAIN, gen, dev).cpu().numpy()
    pool = [walk(rng, int(n)) for n in rng.integers(50, 401, 64)] + qcoords
    coords_of = np.arange(N_MAIN) % 64
    names = [f"e{i:07d}" for i in range(N_MAIN)]
    planted = {}
    for qi, e in enumerate(qemb):
        row = 7 + (N_MAIN // 33) * qi
        noisy = e + 0.01 * rng.normal(size=128).astype(np.float32) / np.sqrt(128)
        emb[row] = noisy / np.linalg.norm(noisy)
        coords_of[row] = 64 + qi
        names[row] = f"planted_{qi:02d}"
        planted[os.path.basename(pdbs[qi])[:-4]] = names[row]
    prefix = os.path.join(tmp, "cath_scale")
    write_mmap_db(prefix, emb, names, coords_of, pool)
    write_quantized_sidecar(prefix, "int8")
    check(FlatDB.open(prefix).has_quant("int8"), "int8 sidecar missing")

    reset_counts()                                 # the search path starts here
    runs = {}
    for prec in ("bf16", "int8"):
        profiling.reset()
        before = (blockmax.launches, gather.launches)
        out = os.path.join(tmp, f"res_{prec}")
        cli.main(["search", *pdbs, prefix, out, "-k", "10", "-d", "cuda",
                  "--precision", prec, "--mmap_cov_filter", "--output_headers",
                  "--weights", weights])
        torch.cuda.synchronize()
        with open(out + "_search.tsv") as fh:
            header = fh.readline().rstrip("\n").split("\t")
            rows = [dict(zip(header, ln.rstrip("\n").split("\t"))) for ln in fh]
        first = {}
        for r in rows:
            first.setdefault(r["query"], r)
        check(set(first) == set(planted), f"{prec}: queries without hits: "
              f"{sorted(set(planted) - set(first))}")
        for qname, r in first.items():
            check(r["target"] == planted[qname],
                  f"{prec}: {qname} rank-1 hit is {r['target']}, not {planted[qname]}")
            check(float(r["max_tm"]) >= 0.9, f"{prec}: {qname} TM-score {r['max_tm']} < 0.9")
        t = profiling.timings()
        runs[prec] = {"phase_s": {k: round(v[0], 4) for k, v in t.items()},
                      "launches": {"blockmax_scan": blockmax.launches - before[0],
                                   "gather_block_scores": gather.launches - before[1]}}
        check(all(v > 0 for v in runs[prec]["launches"].values()),
              f"{prec}: a kernel was not launched on the main path: {runs[prec]['launches']}")
    return runs, launch_counts()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        sys.exit(2)
    faulthandler.enable()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        with Phase("device") as ph:
            smi = device_line(dev)
            kind = torch.cuda.get_device_name(0)
            print(smi, flush=True)
            ph.notes.append(f"torch: {kind}, {torch.__version__}, CUDA {torch.version.cuda}")

        with Phase("build") as ph:
            from merizo_search_tpu_torch.align import native
            from merizo_search_tpu_torch.ops import _build

            t = time.perf_counter()
            _build.library()
            ph.notes.append(f"nvcc {time.perf_counter() - t:.2f} s")
            t = time.perf_counter()
            native.load()
            ph.notes.append(f"g++ {time.perf_counter() - t:.2f} s")

        gen = torch.Generator(device=dev).manual_seed(0)
        flush = _bench_util.flush_buffer(dev)
        with Phase("kernels") as ph:
            big = big_dbs(gen, dev)
            bm_modes, g_modes, cover = kernels_phase(dev, gen, flush, big)
            ph.notes.append(f"{len(bm_modes)} phase-A and {len(g_modes)} phase-C configurations; "
                            f"cover invariant exact in {len(cover)} configurations, "
                            f"{sum(r['compared'] for r in cover)} blocks")

        with Phase("fused") as ph:
            rec = fused_phase(dev, gen)
            ph.notes.append(f"recall@100 {rec}")

        with Phase("e2e") as ph:
            runs, launches = e2e_phase(dev, tmp)
            for prec, r in runs.items():
                ph.notes.append(f"{prec}: " + ", ".join(f"{k} {v:.3f} s"
                                                         for k, v in r["phase_s"].items()))

        with Phase("pipelined") as ph:
            pipe_tool, pipe_counts, bmg_modes = pipelined_phase(dev, gen, flush, big)
            for r in pipe_tool["runs"]:
                ph.notes.append(f"{r['dtype']} Q={r['q']}: exact, sequential "
                                f"{r['seq_ms']:.3f} / pipelined {r['pipe_ms']:.3f} ms a batch")

        with Phase("probes") as ph:
            probe_tools, probe_counts, mini_modes, stream_modes, splits = probes_phase(
                dev, gen, flush, big)
            best = probe_tools["perf_hbm"]["best"]
            ph.notes.append(f"best read {best['gbps']:.1f} GB/s ({best['probe']})")
            for sp in splits:
                ph.notes.append(f"phase A {sp['dtype']} N={sp['n']} Q={sp['q']}: dot "
                                f"{sp['none_ms']:.4f} ms, reduce {sp['reduce_part_ms']:+.4f}, "
                                f"store {sp['store_part_ms']:+.4f}, channel "
                                f"{sp['channel_part_ms']:+.4f}")

        with Phase("variants") as ph:
            var_tools, var_counts, slab_modes, gvar_modes = variants_phase(dev, gen, flush, big)
            for r in slab_modes:
                if r["nslab"] == 2 and r["tile"] == 32768 and r["sbm"]:
                    ph.notes.append(f"{r['dtype']} slab x2 {r['ms']:.3f} ms (blockmax_scan "
                                    f"{r['baseline_blockmax_ms']:.3f})")

        def entry(name, source, replaces, modes, main, launched, **extra):
            """One kernel: top-level numbers are those of the configuration
            its path gives it (search kernels: the e2e bf16 run's Q = 32,
            N = 500,096, mask on; the others: the 2^24-row shape of their
            tools); every measured configuration is under `modes`."""
            m = next(x for x in modes if all(x.get(k) == v for k, v in main.items()))
            errs = [x["max_abs_err"] for x in modes if x["max_abs_err"] is not None]
            return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": launched, "max_abs_err": max(errs), "ms": m["ms"],
                    "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                    "bound_by": m["bound_by"], "library_ms": m["library_ms"],
                    **extra, "modes": modes}

        kernels = [
            entry("blockmax_scan", "merizo_search_tpu_torch/csrc/blockmax.cu",
                  "merizo_search_tpu/ops/pallas_scan.py:65", bm_modes,
                  {"dtype": "bf16", "q": 32, "mask": True, "n": -(-N_MAIN // 128) * 128},
                  launches["blockmax_scan"], cover=cover),
            entry("gather_block_scores", "merizo_search_tpu_torch/csrc/gather.cu",
                  "merizo_search_tpu/ops/pallas_scan.py:644", g_modes,
                  {"dtype": "bf16", "q": 32, "n": -(-N_MAIN // 128) * 128},
                  launches["gather_block_scores"],
                  also_replaces="merizo_search_tpu/ops/pallas_scan.py:847 (row_scales mode)"),
            entry("blockmax_scan_gather", "merizo_search_tpu_torch/csrc/bm_gather.cu",
                  "merizo_search_tpu/ops/pallas_scan.py:1014", bmg_modes,
                  {"dtype": "bf16", "q": 256, "n": N_BIG},
                  pipe_counts["blockmax_scan_gather"],
                  yardstick="sequential_kernels_ms: phase A then phase C (int8: with the "
                            "carried block scales), two launches, same inputs; "
                            "fused_phase_a_only_ms: this kernel with an empty previous selection"),
            entry("mini_scan", "merizo_search_tpu_torch/csrc/probes.cu (tensor cores: "
                  "phase A's walk, csrc/blockmax.cuh walk_blocks, every score from "
                  "csrc/scan_common.cuh mma_rows)",
                  "tools/perf_floor2.py:32", mini_modes,
                  {"dtype": "bf16", "mode": "reduce"}, probe_counts["mini_scan"],
                  also_replaces="tools/perf_int8_floor.py:37 (tile 32768, int8)"),
            entry("stream_probe", "merizo_search_tpu_torch/csrc/probes.cu",
                  "tools/perf_hbm.py:37", stream_modes, {"d": 128, "tile": 65536},
                  probe_counts["stream_probe"],
                  yardstick="torch_sum_ms: x.sum(dtype=torch.int32) over the same bytes"),
            entry("slab_scan", "merizo_search_tpu_torch/csrc/slab_interleave.cu",
                  "tools/perf_slab_interleave.py:38", slab_modes,
                  {"dtype": "bf16", "tile": 32768, "nslab": 2, "sbm": True},
                  var_counts["slab_scan"],
                  yardstick="baseline_blockmax_ms: blockmax_scan with the length channel "
                            "off, same inputs (the JAX tool's baseline)"),
            entry("gather_variant", "merizo_search_tpu_torch/csrc/gather_variants.cu",
                  "tools/perf_gather_int8.py:80",
                  [m for m in gvar_modes if m["mode"] != "int32view"],
                  {"dtype": "int8", "mode": "full"},
                  sum(var_counts[f"gather_variant.{m}"]
                      for m in ("dma_only", "concat_only", "full")),
                  yardstick="phase_c_ms: gather_block_scores (no scales) on the same blocks; "
                            "no single PyTorch call computes the gather"),
            entry("gather_variant (int32view)",
                  "merizo_search_tpu_torch/csrc/gather_variants.cu",
                  "tools/perf_gather_int8.py:159",
                  [m for m in gvar_modes if m["mode"] == "int32view"],
                  {"dtype": "int8", "mode": "int32view"},
                  var_counts["gather_variant.int32view"],
                  yardstick="phase_c_ms: gather_block_scores (no scales) on the same blocks; "
                            "no single PyTorch call computes the gather"),
        ]
        print(json.dumps({"e2e": runs, "fused_recall_at_100": rec,
                          "pipelined": pipe_tool, "probe_tools": probe_tools,
                          "variant_tools": var_tools,
                          "path_launches": {"search": launches, "pipelined": pipe_counts,
                                            "probes": probe_counts, "variants": var_counts},
                          "total_s": round(time.perf_counter() - T0, 2)}), flush=True)
        print(json.dumps({"phase_a_split": splits}), flush=True)
        print(smi, flush=True)
        print(json.dumps({"kernels": kernels}), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}),
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
