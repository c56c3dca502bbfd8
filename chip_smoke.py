"""Chip smoke test of the PyTorch/CUDA port: `python3 chip_smoke.py` on one H100.

Drives the port's main paths (the `search` verb, and the `serve` verb's
server) on the card and checks them:

1. device   the card's name and power limit (nvidia-smi) and torch's name;
2. build    nvcc for the scan kernels (csrc/*.cu), g++ for TM-align, timed;
            the ptxas report of every kernel (registers, spills, static
            shared memory, warnings) from _build/nvcc.log, where this run
            compiled the library (a cached library's rows say so);
3. kernels  phase A (blockmax_scan) and phase C (gather_block_scores, all
            three scale modes) against their plain PyTorch versions on the
            card at N = 500,000 rows (Q = 32 and 256, bf16 and int8, length
            mask on and off), then timed there and at the 16M-row scan shape
            (phase A at Q = 32, 64, 128 and 256, one a query tile width,
            and at Q = 256 with the length channel; phase C at Q = 256, KB
            102); and the cover invariant at both shapes (Q = 32 and 256 at
            500,000 rows, every tile width at 2^24 rows; bf16 and int8, mask
            on and off): phase C's max over each selected block below
            n_valid equals phase A's BM for it, exactly; then phase B's
            select kernel (tools/perf_scan select_rows) against its plain
            version bit for bit at TED's [256, 356,441] k 100 and CATH's
            [256 / 32 / 1, 3,907], timed beside torch.topk;
4. fused    fused_topk against the plain exact scan: recall@100 = 1.0 at
            N = 500,000, Q = 256, k = 100 (scores within 1e-5 are ties);
5. e2e      the `search` CLI on a 500,000-entry mmap DB with an int8 sidecar
            and 32 query PDBs, at bf16 and int8: every query's planted row
            is its rank-1 hit with TM-score >= 0.9, and the three scan
            kernels' launch counters (phases A, B and C) rose during these
            runs.
6. pipelined the pipelined two-batch scan through its tool
            (tools/perf_pipelined: 2^24 rows, Q = 64 and 256, k = 100, bf16
            and int8): equal to the sequential fused_topk exactly on 3
            batches plus a drain, and its per-batch time beside the
            sequential one; then its kernel (bm_gather: one pass over the
            DB that scores the previous selection on phase A's ring slots,
            after inverting it block-major) against phase A then phase C
            launched apart (bit for bit) and against its plain version, at
            N = 500,000 and at 2^24 rows (the top-101 selection and a hot
            one: every previous query selecting the same blocks), timed
            there with the inversion alone, the two launches apart and
            phase A alone.
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
9. createdb the `createdb` CLI on the card (default weights) over 2,068
            synthetic CA PDBs: 2,048 of 50-400 residues, 16 of 410-710
            and four over 2,000 (truncated to 2,000): an mmap DB with an
            int8 sidecar, built by one run interrupted after two chunks of
            512 files (`run_createdb`, the CLI's call, with checkpoints every
            512 files) and one `createdb --resume`; `dbinfo --verify --sample 0`; 32
            sampled entries' embeddings against the port's CPU embedding
            (1e-4); the 16 of 410-710 residues searched by the `search` CLI
            at bf16 and int8, each its own rank-1 hit with TM-score >= 0.99,
            with both scan kernels launched. Prints structures/s, the
            parse / embed / write seconds, and the card's idle share while
            one chunk of 512 is embedded again under torch.profiler.
10. segment the `segment` CLI on the card (default weights, `--iterate
            --save_domains`) over synthetic N/CA/C/O backbones of compact
            helical domains: 80, 300, 700, 1,500 and 16 of 100-400 residues,
            then 2,900 alone; every chain's TSV row has its residue count;
            on the chains of <= 300 residues, domain ids equal and
            confidences within 1e-3 of the port's CPU run. Prints
            residues/s, the seconds of each chain, the peak device memory
            at 2,900 residues (above what earlier phases hold), and the
            card's idle share in one forward at
            700 under torch.profiler. Then the 16 chains of 100-400
            through `segment_structures` batched by length bucket and one
            chain a forward, in turns: domain ids equal, confidences
            within 2e-4, residues/s of each; the card's idle share in one
            batched forward and in one chain of it; the peak memory of a
            full pair-budget batch at bucket 1,536 (7 chains).
11. stream  the stream mode (superblocks staged through pinned buffers and
            a side stream): an mmap DB of 2^24 seeded unit rows with int8
            and bf16 sidecars (write_quantized_sidecar), Q = 32, k = 100,
            bf16 and int8; a stream-mode engine (a lowered max_device_gb,
            superblocks of 262,144 rows: 64) against a device-mode engine:
            scores equal bit for bit, indices equal except among tied
            scores, phases A and C launched once a superblock. Then
            run_dbsearch with a stream engine over the e2e DB writes the e2e
            int8 run's TSV. Prints rows/s (page cache hot: the files were
            just written), the seconds of host staging, copies and scan,
            and the card's idle share over one pass under torch.profiler.
12. easy_search `easy-search --multi_domain_search` on the card in both
            modes over four synthetic helical chains of 300-1,500 residues,
            against a DB (`createdb`) of the domains the `segment` CLI cut
            out of them (default weights): every multi-domain chain is its
            own category-3 match with pair scores >= 0.99 (TM) or 0.999
            (cosine); the 300-residue chain run with `-d cpu` chops the
            same, finds the same hits and multi-domain rows, scores within
            1e-4. Prints each run's phase seconds and scan launches.

13. ivf     the IVF index (tools/ivf_curve's data: 2^20 unit rows around 256
            Gaussian centres, Q = 256 queries near DB rows, nlist 1024,
            expand 0.25, k = 100): the build's seconds by step; recall@100
            against the float64 ranking and queries/s at nprobe 4-128, bf16
            and int8, with and without the f32 rerank (recall never falls as
            nprobe rises, rerank never below plain); at nprobe = nlist (Q =
            32) the flat fused scan's result, scores bit for bit; phase C at
            the IVF shapes (the probe gather at nprobe 32, bf16 and int8; the
            f32 mode at the rerank shape, Q = 256, KB = 101, within 1e-5 of
            float64): the per-query kernel against its plain version, the
            block-major launch the IVF runs (gather_block_scores_by_block:
            each distinct block read once) equal to it bit for bit with every
            slot written, both timed in turns (and the inversion alone);
            then SearchEngine(index="ivf") over an mmap DB of these rows in
            device mode (with and without rerank: three block-major phase-C
            launches, one in the f32 mode, and no per-query one) and forced
            to stream (disk sidecars built in the run's temp directory;
            phases A and C once a staged group; recall >= device mode's; at
            nprobe = nlist the device flat scan's result bit for bit; at
            Q = 8, whose probe union is a few percent of the layout, staged
            64 clusters a group: under the whole layout, in more than one
            group, and the same engine's result on the CPU within 1e-5); and
            `search --search_index ivf` over the e2e DB, every planted row at
            rank 1. Prints the card's busy share in one search (bf16,
            nprobe 32, with and without rerank) under torch.profiler.

14. tmalign  the device TM-align (align/tmalign.py, plain PyTorch) on the
            card: against itself on the CPU on 32 pairs a bucket at 64, 128
            and 256 and 16 at 512, fast and full (qtm and ttm within 1e-3 but
            for at most one pair a group, that one within 0.05; len_ali within
            2 and rmsd within 0.05 A); against the native aligner (homologs at
            TM >= 0.9 in both, |device - native| <= 0.02 in the decision
            region 0.4-0.6, unrelated pairs under the 0.5 gate in both, their
            deficit recorded); pairs/s beside the native aligner's at b = 256
            (32, 256 and 1,365 pairs, the chunk cap) and at b = 128 and 512
            (256 pairs); one b = 256 chunk under torch.profiler (device
            events, the card's busy share, host seconds of the DP, the
            superposition search, the SVD and the inits); the peak device
            memory at b = 2048 for 21 pairs.
15. serve   the search server (server.py) over the e2e DB in bf16, on
            127.0.0.1 through real HTTP: 32 concurrent /search requests (k 10,
            native TM-align; again; then skip_tmalign) against the same
            requests sent one at a time: micro-batched (fewer batches than
            requests), every planted row at rank 1 with TM >= 0.9, every hit
            equal to the serial run's but emb_score, which may move by 1e-4;
            the same with max_batch 1; an /easy-search beside a burst, equal
            to its serial run; /healthz and /stats; requests/s, p50 and p99;
            a service with the device aligner answering 8 planted requests;
            and `search --tmalign_backend tpu` over the e2e DB, its
            tmalign_rescore seconds beside the native run's.
16. mesh    the mesh modes (one process, a tuple of devices): four shards
            on one card ((cuda:0,) * 4), and with two or more cards the
            flat and IVF checks again on distinct cards. Device mode over
            the e2e DB (500,000 rows, bf16 and int8, Q 32, k 100, mincov
            0.7) and over the stream phase's 2^24-row DB in bf16 (Q 256);
            stream mode over that DB (bf16 and int8, a quarter GiB a
            device: 64 superblocks, each cut into four slices); the IVF
            over the ivf phase's DB and cached layout (nlist 1024 with
            duplicates, nprobe 32, Q 256, k 100; bf16, bf16 + rerank,
            int8). Each against the one-device engine: scores bit for bit,
            ids equal except among tied scores, every scan kernel of the
            path launched once a shard (a superblock). The data-parallel
            embed of 512 structures within 1e-4 of one device;
            `search --mesh 4` (its TSV equal to the e2e bf16 run's) and
            `createdb --mesh 4` over 128 of the createdb phase's files
            (embeddings within 1e-4 of that build), both shrunk to the
            cards there are with JAX's warning; a service with the DB on
            four shards answering a burst of /search equal to serial
            requests. Prints ms a call (stream: rows/s) on four shards and
            on one, the card's busy share in one mesh flat and one mesh
            IVF call (torch.profiler), and the number of distinct cards
            the phase used.

Each path (e2e, pipelined, probes, variants, createdb's search, stream,
easy-search, the ivf phase's device, stream, small-batch stream and CLI
runs, serve, each mesh path) starts with
every kernel's launch count at 0 and fails unless each of its kernels was launched. The
2^24-row rows of phases 3 and 6-8 share one bf16 and one int8 DB a run (the
tools' synthetic DB); the kernel table takes the times and bounds of the
probes and variants from their tools' rows and times only the plain
versions and library calls itself.

Prints one line per phase with its seconds, a JSON line of the tools'
results, a JSON line {"createdb": ..., "segment": ...} of phases 9-10, a
JSON line {"stream": ..., "easy_search": ...} of phases 11-12, a
JSON line {"phase_a_split": [...]}, a JSON line {"ivf": ...} of phase 13,
a JSON line {"tmalign": ..., "serve": ...} of phases 14-15, a JSON line
{"mesh": ...} of phase 16, the nvidia-smi line, a JSON
line {"kernels": [...]} (each kernel with its ptxas rows and, for the scan
kernels, the tile widths, stages and dynamic shared memory its launches
take, read from the built library), and as its last line {"ok": true, "device": {...}}.
Any failed check, build, launch or phase deadline raises and exits non-zero;
with no CUDA device it exits non-zero before printing any result. Scratch
files live in a temporary directory outside the checkout and are removed.
"""

from __future__ import annotations

import faulthandler
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from merizo_search_tpu_torch.tools import _bench_util, perf_scan
from merizo_search_tpu_torch.tools._bench_util import bound, device_line

HERE = os.path.dirname(os.path.abspath(__file__))
TOTAL_BUDGET_S = 650       # hard watchdog: dump stacks and exit(1) past this
# per-phase deadlines, a few times each phase's measured seconds
PHASE_BUDGET_S = {"device": 30, "build": 60, "kernels": 90, "fused": 30, "e2e": 90,
                  "pipelined": 20, "probes": 25, "variants": 30, "createdb": 120,
                  "segment": 90, "stream": 240, "easy_search": 150, "ivf": 120,
                  "tmalign": 180, "serve": 120, "mesh": 90}
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


PTXAS_NOT_THIS_RUN = "not from this run: the library was loaded from the cache"


def ptxas_report():
    """Every kernel entry of the build's ptxas report (_build/nvcc.log,
    written when this process compiled the library): registers, spill
    stores and loads, stack frame and static shared memory, by demangled
    name (c++filt, where the machine has it); and the report's warnings.
    None where this process loaded a cached library: the log may then
    belong to another build."""
    from merizo_search_tpu_torch.ops import _build
    from merizo_search_tpu_torch.utils.nativebuild import BUILD_DIR

    path = os.path.join(BUILD_DIR, "nvcc.log")
    if _build.build_seconds == 0:
        return None
    entries, cur, warnings = {}, None, []
    with open(path) as fh:
        for line in fh:
            if "warning" in line:
                warnings.append(line.strip())
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                cur = entries.setdefault(m.group(1), {})
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m and cur is not None:
                cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                sm = re.search(r"(\d+) bytes smem", line)
                cur.update(registers=int(m.group(1)), static_smem=int(sm.group(1)) if sm else 0)
    names = list(entries)
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True, check=True).stdout.split("\n")[:len(names)]
    rows = [{"entry": re.sub(r"\(.*", "", n), **v} for n, v in zip(names, entries.values())]
    return {"entries": rows, "warnings": warnings}


def ptxas_rows(report, *kernels):
    """The report's entries of the named __global__ functions (demangled,
    or by their mangled name's length-prefixed part); PTXAS_NOT_THIS_RUN
    without a report."""
    if report is None:
        return PTXAS_NOT_THIS_RUN
    return [r for r in report["entries"]
            if any(f"::{k}<" in r["entry"] or r["entry"].endswith(f"::{k}")
                   or f"{len(k)}{k}I" in r["entry"] or f"{len(k)}{k}E" in r["entry"]
                   for k in kernels)]


def kernels_phase(dev, gen, flush, big):
    """Hold phases A and C against their plain versions and to the cover
    invariant, then time them; then phase B's select kernel."""
    from merizo_search_tpu_torch.ops import blockmax, gather
    from merizo_search_tpu_torch.ops.fused_scan import select_blocks

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
                npad = db.shape[0]
                b_ms, b_by = perf_scan.phase_a_bound(nq, npad, isz, dtype, masked,
                                                     sc is not None)
                lib = time_ms(lambda: perf_scan.library_product(qq, db), flush=flush)
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
                        gb_ms, gb_by = perf_scan.phase_c_bound(
                            nq, isz, bidx, dtype, masked=True, scale_sel=mode == "scale_sel",
                            row_scales=mode == "row_scales")
                        g_modes.append({"dtype": dtype, "mode": mode, "n": npad, "q": nq,
                                        "kb": bidx.shape[1], "max_abs_err": gerr,
                                        "ms": gms, "plain_ms": gplain, "bound_ms": gb_ms,
                                        "bound_by": gb_by, "library_ms": None,
                                        "ms_repeats": reps})
    del p
    torch.cuda.empty_cache()
    # the 16M-row scan shape (tools/perf_scan.py's rows): phase A at every
    # tile width (Q = 32, 64, 128, 256; at 256 with the length channel too),
    # each BM held to the cover invariant; phase C at Q = 256, KB 102.
    # Kernel and library times and bounds only
    for dtype in ("bf16", "int8"):
        db, sc = big[dtype]
        rows = perf_scan.phase_rows(
            db, sc, N_BIG, (32, 64, 128, 256), (256,), ((256, 100),), 10, flush, dev, gen,
            on_bm=lambda q, bm, tl, qc: cover.append(
                cover_row(dtype, N_BIG, q, db, sc, bm, tl, qc)))
        for r in rows:
            row = {k: v for k, v in r.items() if k != "kernel"}
            row.update(max_abs_err=None, plain_ms=None)
            (bm_modes if r["kernel"] == "blockmax_scan" else g_modes).append(row)
    sel_modes = [{**{k: v for k, v in r.items() if k != "kernel"}, "max_abs_err": 0.0}
                 for r in perf_scan.select_rows(10, flush, dev, gen)]
    return bm_modes, g_modes, cover, sel_modes


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
    from merizo_search_tpu_torch.utils import profiling

    profiling.reset_counters()


def launch_counts():
    """The launch counters (utils/profiling, named by each wrapper's module
    constants) under this script's names."""
    from merizo_search_tpu_torch.ops import (blockmax, gather, gather_variants, pipelined,
                                             probes, select, slab_interleave)
    from merizo_search_tpu_torch.utils import profiling

    names = {"blockmax_scan": blockmax.LAUNCHES, "gather_block_scores": gather.LAUNCHES,
             "select_blocks": select.LAUNCHES,
             "gather_block_scores.f32": gather.LAUNCHES_F32,
             "gather_block_scores_by_block": gather.LAUNCHES_BY_BLOCK,
             "gather_block_scores_by_block.f32": gather.LAUNCHES_BY_BLOCK_F32,
             "blockmax_scan_gather": pipelined.LAUNCHES,
             "blockmax_scan_gather.inversion": pipelined.INVERSIONS,
             "mini_scan": probes.MINI_SCAN_LAUNCHES,
             "stream_probe": probes.STREAM_PROBE_LAUNCHES,
             "slab_scan": slab_interleave.LAUNCHES,
             **{f"gather_variant.{m}": n for m, n in gather_variants.LAUNCHES.items()}}
    return {k: profiling.counter(n) for k, n in names.items()}


def scan_launches_since(before: dict) -> dict:
    """Phase A's, phase B's and phase C's launches since `before`
    (launch_counts)."""
    now = launch_counts()
    return {k: now[k] - before[k]
            for k in ("blockmax_scan", "select_blocks", "gather_block_scores")}


def bm_gather_mode(dtype, q, pv_q, db, sc, n, rel, flush, k=100, hot=False):
    """Hold the pipelined kernel against phase A then phase C launched apart
    (bit for bit) and against its plain version, on one batch and the
    previous batch's top-(k+1) blocks (int8: with their carried block
    scales, as fused_topk_step passes them); with `hot`, every previous
    query selects the first one's blocks (hot blocks: Qp entries each).
    Then time it, the plain version, the inversion of the previous
    selection alone, and as labelled yardsticks the two sequential launches
    it replaces and itself with no previous selection (phase A alone)."""
    from merizo_search_tpu_torch.ops import blockmax, gather, pipelined
    from merizo_search_tpu_torch.ops.fused_scan import select_blocks, selected_scales

    pv_bidx = select_blocks(blockmax.blockmax_scan(pv_q, db, n, scales=sc), n, k)
    if hot:
        pv_bidx = pv_bidx[:1].expand_as(pv_bidx).contiguous()
    ss = None if sc is None else selected_scales(sc, pv_bidx)
    args = (q, db, n, pv_q, pv_bidx, sc, ss)
    seq = lambda: (blockmax.blockmax_scan(q, db, n, scales=sc),
                   gather.gather_block_scores(pv_q, db, pv_bidx, n, scale_sel=ss))
    got, apart = pipelined.blockmax_scan_gather(*args), seq()
    torch.cuda.synchronize()
    check(all(torch.equal(g, w) for g, w in zip(got, apart)),
          f"bm_gather {dtype} differs from phase A then phase C launched apart")
    del apart
    want = pipelined.blockmax_scan_gather_plain(*args)
    err = max(max_err(g, w, dtype == "int8", rel) for g, w in zip(got, want))
    del got, want
    ms = time_ms(lambda: pipelined.blockmax_scan_gather(*args), 5, flush)
    plain_ms = time_ms(lambda: pipelined.blockmax_scan_gather_plain(*args), 1, flush)
    seq_ms = time_ms(seq, 5, flush)
    nb = db.shape[0] // 128
    inv_ms = time_ms(lambda: pipelined.invert_previous(pv_q, pv_bidx, nb, ss), 5, flush)
    # the fused launch with an empty previous selection runs phase A alone
    no_prev = pv_bidx.new_empty((pv_q.shape[0], 0))
    a_only_ms = time_ms(lambda: pipelined.blockmax_scan_gather(q, db, n, pv_q, no_prev, sc),
                        5, flush)
    b_ms, b_by = perf_scan.bm_gather_bound(q.shape[0], db.shape[0], db.element_size(),
                                           pv_bidx, dtype, sc is not None)
    return {"dtype": dtype, "n": db.shape[0], "q": q.shape[0], "kb": pv_bidx.shape[1],
            "selection": "hot" if hot else "top", "max_abs_err": err,
            "equal_to_two_launches": True, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "sequential_kernels_ms": seq_ms,
            "fused_phase_a_only_ms": a_only_ms, "inversion_ms": inv_ms}


def pipelined_phase(dev, gen, flush, big):
    """The pipelined path through its tool on the run's 2^24-row DBs, then
    its kernel against the two launches apart and the plain version at the
    500k problem (unit rows, ragged n, Q = 64) and at 2^24 rows (the tool's
    queries, Q = 256; the top-101 selection and the hot one)."""
    from merizo_search_tpu_torch.tools import perf_pipelined

    reset_counts()                                   # the pipelined path starts here
    tool = perf_pipelined.main(["--log2-rows", "24", "--q", "64,256", "--k", "100",
                                "--dtype", "both", "--repeats", "8"], dbs=big)
    counts = launch_counts()
    check(counts["blockmax_scan_gather"] > 0, "the pipelined path never launched bm_gather")
    check(counts["blockmax_scan_gather.inversion"] > 0,
          "the pipelined path never inverted a previous selection")
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
        for hot in (False, True):
            modes.append(bm_gather_mode(dtype, qs[0], qs[1], db, sc, N_BIG, True, flush,
                                        hot=hot))
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
                         "library_ms": time_ms(lambda: perf_scan.library_product(q, db), 3, flush)})
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

    rec = np.array([f"{nm[:32]:<32}\n".encode("ascii") for nm in names], f"S{NAME_RECORD}")
    files = write_mmap_tables(prefix, rec, coords_of, pool, emb.shape[1])
    emb.astype(np.float32).tofile(os.path.join(os.path.dirname(prefix), files["dbfname_IP"]))


def write_mmap_tables(prefix, name_records, coords_of, pool, dim):
    """Everything of the mmap layout but the embeddings file: the name
    records, the coordinate and sequence blobs with their start/end pairs,
    and the JSON descriptor. Returns the descriptor's file names."""
    d, base = os.path.dirname(prefix), os.path.basename(prefix)
    files = {"dbfname_IP": base + "_raw_128d_norm.db",
             "db_names_f": base + "_raw_128d.index_names",
             "sif": base + "_seq.index", "sdf": base + "_seq.db",
             "cif": base + "_ca.index", "cdf": base + "_ca.db"}
    name_records.tofile(os.path.join(d, files["db_names_f"]))
    lens = np.array([len(c) for c in pool], np.int64)
    for idx, blob, per_res in (("cif", "cdf", 12), ("sif", "sdf", 1)):
        start = np.concatenate([[0], np.cumsum(lens * per_res)[:-1]])
        se = np.stack([start[coords_of], start[coords_of] + lens[coords_of] * per_res], 1)
        se.astype(np.int64).tofile(os.path.join(d, files[idx]))
        with open(os.path.join(d, files[blob]), "wb") as fh:
            for c in pool:
                fh.write(c.astype(np.float32).tobytes() if per_res == 12
                         else b"A" * len(c))
    info = dict(files, DB_SIZE=len(name_records), DB_DIM=dim)
    with open(prefix + ".json", "w") as fh:
        json.dump(info, fh)
    return files


def e2e_phase(dev, tmp):
    from merizo_search_tpu_torch import cli
    from merizo_search_tpu_torch.db.codecs import FlatDB, write_quantized_sidecar
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
        before = launch_counts()
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
                      "launches": scan_launches_since(before)}
        check(all(v > 0 for v in runs[prec]["launches"].values()),
              f"{prec}: a kernel was not launched on the main path: {runs[prec]['launches']}")
    return runs, launch_counts(), {"pdbs": pdbs, "weights": weights, "prefix": prefix,
                                   "planted": planted, "qcoords": qcoords}


N_CREATEDB = 2048          # createdb phase: structures of 50-400 residues,
CREATEDB_QUERIES = tuple(range(410, 730, 20))   # 16 of lengths no other entry has,
CREATEDB_LONG = (2050, 2300, 2600, 3000)  # and these, cut to createdb.MAX_RES = 2000


class Interrupted(Exception):
    """Raised into the first createdb run, as a crash would end it."""


def read_tsv(path):
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        return [dict(zip(header, ln.rstrip("\n").split("\t"))) for ln in fh]


def device_busy(fn, cpu=True):
    """Run fn() under torch.profiler: (wall s, device-busy s or None, the
    three kernels with the most device time, the device seconds of every
    kernel and copy by name, the number of device events). Busy is the
    union of the device events' intervals (kernels and copies); None when
    the profiler records no device event. cpu=False records the device
    alone (a run of ~10^5 launches otherwise takes the profiler tens of
    seconds to process)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return wall, None, [], {}, 0
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    busy += hi - lo
    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    top = sorted(per.items(), key=lambda kv: -kv[1])[:3]
    return wall, busy / 1e6, [[k[:80], v] for k, v in top], per, len(spans)


def createdb_phase(dev, tmp):
    """The DB builder on the card, through the CLI, with a crash and a resume;
    then dbinfo, the CPU embedding of sampled entries, and a self-search."""
    import contextlib
    import io

    from merizo_search_tpu_torch import cli
    from merizo_search_tpu_torch.db.codecs import FlatDB
    from merizo_search_tpu_torch.pipeline import createdb
    from merizo_search_tpu_torch.pipeline.embed import embed_structures, load_foldclass_params
    from merizo_search_tpu_torch.utils import profiling

    rng = np.random.default_rng(21)
    src = os.path.join(tmp, "createdb_in")
    os.makedirs(src)
    lengths = ([int(n) for n in rng.integers(50, 401, N_CREATEDB)] + list(CREATEDB_QUERIES)
               + list(CREATEDB_LONG))
    t = time.perf_counter()
    for i, n in enumerate(lengths):
        write_pdb(os.path.join(src, f"s{i:05d}.pdb"), walk(rng, n))
    out = {"structures": len(lengths), "write_inputs_s": time.perf_counter() - t}

    prefix = os.path.join(tmp, "built", "db")
    chunk = N_CREATEDB // 4
    real, calls = createdb.embed_structures, []

    def crash_after_two_chunks(*a, **kw):
        if len(calls) == 2:
            raise Interrupted
        calls.append(1)
        return real(*a, **kw)

    profiling.reset()
    t = time.perf_counter()
    createdb.embed_structures = crash_after_two_chunks
    try:     # the CLI's own call, with checkpoints every `chunk` files
        createdb.run_createdb(src, prefix, fmt="mmap", resume=False, chunk_files=chunk,
                              device="cuda", sidecar="int8")
    except Interrupted:
        pass
    else:
        raise AssertionError("the interrupted createdb run ran to its end")
    finally:
        createdb.embed_structures = real
    with open(prefix + ".progress") as fh:
        prog = json.load(fh)
    check(prog["files_done"] == prog["entries"] == 2 * chunk, f"checkpoint after 2 chunks: {prog}")
    cli.main(["createdb", src, prefix, "-d", "cuda", "--db_format", "mmap",
              "--precision", "int8", "--resume"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    split = {k.split(".")[1]: v[0] for k, v in profiling.timings().items()
             if k.startswith("createdb.")}
    out.update(build_s=wall, structures_per_s=len(lengths) / wall, phase_s=split,
               embed_calls=profiling.timings()["createdb.embed"][1])

    db = FlatDB.open(prefix)
    lens = db.lengths()
    check(db.size == len(lengths) and db.has_quant("int8"), f"DB of {db.size} entries")
    check(int((lens == createdb.MAX_RES).sum()) == len(CREATEDB_LONG)
          and int(lens.max()) == createdb.MAX_RES, "long chains were not truncated")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["dbinfo", prefix, "--verify", "--sample", "0"])
    check(f"verify:     {db.size}/{db.size} entries OK" in buf.getvalue()
          and "sidecars:   int8" in buf.getvalue(), f"dbinfo: {buf.getvalue()}")

    # how much of the embed step the card is busy: one chunk re-embedded
    # under the profiler (the build syncs a batch at a time)
    model = load_foldclass_params(None, dev)
    chunk_coords = [db.coords(i) for i in range(chunk)]
    embed_structures(model, chunk_coords[:8])                        # warm
    e_wall, e_busy, e_top, *_ = device_busy(lambda: embed_structures(model, chunk_coords))
    out["embed_profile"] = {"structures": chunk, "wall_s": e_wall, "device_busy_s": e_busy,
                            "idle_share": None if e_busy is None else 1 - e_busy / e_wall,
                            "top_kernels_s": e_top}

    short = np.nonzero(lens <= 150)[0]     # the CPU embeds them in seconds
    ids = np.sort(rng.choice(short, 32, replace=False))
    cpu = embed_structures(load_foldclass_params(None, "cpu"), [db.coords(int(i)) for i in ids])
    cpu /= np.linalg.norm(cpu, axis=1, keepdims=True)
    err = float(np.abs(np.asarray(db.embeddings()[ids]) - cpu).max())
    check(err <= 1e-4, f"card embeddings differ from the CPU's by {err}")
    out["embed_vs_cpu_max_abs_err"] = err

    # With the default (random) weights an embedding is nearly a function of
    # the chain's length: random walks of one length agree in cosine to 1e-6.
    # So the self-search queries are the entries whose lengths no other
    # entry has (20 residues apart), and each must be its own first hit.
    queries = [os.path.join(src, f"s{N_CREATEDB + i:05d}.pdb")
               for i in range(len(CREATEDB_QUERIES))]
    reset_counts()                                 # the createdb search path starts here
    out["search"] = {}
    for prec in ("bf16", "int8"):
        before = launch_counts()
        res = os.path.join(tmp, f"self_{prec}")
        t = time.perf_counter()
        cli.main(["search", *queries, prefix, res, "-k", "10", "-d", "cuda",
                  "--precision", prec, "--output_headers"])
        dt = time.perf_counter() - t
        first = {}
        for r in read_tsv(res + "_search.tsv"):
            first.setdefault(r["query"], r)
        for q in queries:
            name = os.path.basename(q)[:-4]
            r = first.get(name)
            check(r is not None and r["target"] == name,
                  f"{prec}: {name} is not its own rank-1 hit ({r and r['target']})")
            check(float(r["max_tm"]) >= 0.99, f"{prec}: {name} self TM-score {r['max_tm']}")
        launched = scan_launches_since(before)
        check(all(v > 0 for v in launched.values()), f"{prec}: scan kernels not launched")
        out["search"][prec] = {"cli_s": dt, "launches": launched}
    return out, launch_counts()


def held_before_peak():
    """Reset the device's peak-memory counter and return the bytes allocated
    now (earlier phases' DBs), to subtract from the next peak."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


SEGMENT_LENGTHS = (80, 300, 700, 1500)
SEGMENT_BIG = 2900
SEGMENT_PROFILED = 700


def segment_phase(dev, tmp):
    """The segmenter on the card, through the CLI, at full width with the
    default weights; the short chains against the port on the CPU."""
    from merizo_search_tpu_torch import cli
    from merizo_search_tpu_torch.models.merizo.features import generate_features
    from merizo_search_tpu_torch.models.merizo.network import load_merizo_params
    from merizo_search_tpu_torch.segment.pipeline import segment_structures
    from merizo_search_tpu_torch.tools.synthetic import helical_backbone, write_backbone_pdb

    rng = np.random.default_rng(31)
    src, dst = os.path.join(tmp, "segment_in"), os.path.join(tmp, "segment_out")
    os.makedirs(src)
    lengths = {f"len{n}": n for n in SEGMENT_LENGTHS}
    lengths.update({f"batch{i:02d}": int(n) for i, n in enumerate(rng.integers(100, 401, 16))})
    lengths[f"len{SEGMENT_BIG}"] = SEGMENT_BIG
    paths = {}
    for name, n in lengths.items():
        paths[name] = os.path.join(src, name + ".pdb")
        write_backbone_pdb(paths[name], helical_backbone(rng, n), rng)
    flags = ["-d", "cuda", "--iterate", "--save_domains", "--output_headers",
             "--merizo_output", dst]
    out, rows = {"cli_s": {}}, []
    big = f"len{SEGMENT_BIG}"
    for label, names in (("chains", [k for k in lengths if k != big]), (big, [big])):
        base = held_before_peak()
        t = time.perf_counter()
        cli.main(["segment", *(paths[k] for k in names), os.path.join(dst, label), *flags])
        torch.cuda.synchronize()
        out["cli_s"][label] = time.perf_counter() - t
        out.setdefault("peak_mem_gib", {})[label] = (torch.cuda.max_memory_allocated()
                                                     - base) / 2 ** 30
        rows += read_tsv(os.path.join(dst, label + "_segment.tsv"))
    got = {r["filename"]: r for r in rows}
    check(sorted(got) == sorted(lengths), f"TSV rows for {sorted(got)}")
    for name, n in lengths.items():
        check(int(got[name]["nres"]) == n, f"{name}: nres {got[name]['nres']} != {n}")
    out["chain_s"] = {name: float(r["runtime"]) for name, r in got.items()}
    out["ndom"] = {name: int(r["ndom"]) for name, r in got.items()}
    out["residues_per_s"] = sum(lengths.values()) / sum(out["chain_s"].values())

    # where one forward spends the card's time, at 700 residues: at 2,900 the
    # profiler's ~300k kernel and launch records take a minute to parse
    model = load_merizo_params(None, "cuda")
    f = generate_features(paths[f"len{SEGMENT_PROFILED}"])
    x = [torch.from_numpy(f[k])[None].to(dev) for k in ("s", "z", "r", "t", "ri")]
    x[1] = x[1][..., None]
    f_wall, f_busy, f_top, *_ = device_busy(lambda: model.forward_features(*x))
    out["forward_profile"] = {"nres": SEGMENT_PROFILED, "wall_s": f_wall, "device_busy_s": f_busy,
                              "idle_share": None if f_busy is None else 1 - f_busy / f_wall,
                              "top_kernels_s": f_top}
    del x, f

    batch = [k for k in lengths if k.startswith("batch")]
    out["batched"] = segment_batched(model, [paths[k] for k in batch],
                                     [lengths[k] for k in batch], src, rng)

    t = time.perf_counter()
    small = [paths[k] for k, n in lengths.items() if n <= 300]
    res = {d: segment_structures(model if d == "cuda" else load_merizo_params(None, d), small,
                                 ["A"] * len(small), iterate=True) for d in ("cuda", "cpu")}
    err = 0.0
    for path, g, c in zip(small, res["cuda"], res["cpu"]):
        check(np.array_equal(g["domain_ids"], c["domain_ids"]),
              f"{path}: card and CPU domain ids differ")
        err = max(err, float(np.abs(g["conf_res"] - c["conf_res"]).max()))
    check(err <= 1e-3, f"card and CPU confidences differ by {err}")
    out.update(compared_chains=len(small), conf_max_abs_err=err,
               cpu_compare_s=time.perf_counter() - t)
    return out

def segment_batched(model, paths, nres, src, rng):
    """The segmenter's batched forward against one chain a forward, on the
    16 chains of 100-400 residues: each way twice, in turns (one a forward,
    batched, batched, one a forward), iterate off; domain ids and ndom
    equal, confidences within 2e-4. residues/s of each run; one batched
    forward (the bucket with the most chains, lengths from the host) and one
    chain of it alone under torch.profiler; the peak memory and seconds of
    one full pair-budget batch at bucket 1,536 (7 chains of 1,400-1,536
    residues)."""
    from merizo_search_tpu_torch.models.merizo.features import generate_features
    from merizo_search_tpu_torch.segment import pipeline as seg
    from merizo_search_tpu_torch.tools.synthetic import helical_backbone, write_backbone_pdb

    t_part = time.perf_counter()
    cap, res, rate = seg.MAX_BATCH, {}, {"one_a_forward": [], "batched": []}
    try:
        for label in ("one_a_forward", "batched", "batched", "one_a_forward"):
            seg.MAX_BATCH = 1 if label == "one_a_forward" else cap
            t = time.perf_counter()
            res[label] = seg.segment_structures(model, paths, ["A"] * len(paths))
            rate[label].append(sum(nres) / (time.perf_counter() - t))
    finally:
        seg.MAX_BATCH = cap
    err = 0.0
    for path, b, o in zip(paths, res["batched"], res["one_a_forward"]):
        check(np.array_equal(b["domain_ids"], o["domain_ids"]) and b["ndom"] == o["ndom"],
              f"{path}: batched and one-a-forward domain ids differ")
        err = max(err, float(np.abs(b["conf_res"] - o["conf_res"]).max()))
    check(err <= 2e-4, f"batched and one-a-forward confidences differ by {err}")
    buckets = {}
    for path, n in zip(paths, nres):
        buckets.setdefault(seg.bucketing.bucket_for(n), []).append(path)
    out = {"residues": sum(nres), "residues_per_s": rate, "conf_max_abs_err": err,
           "batches": {b: -(-len(v) // seg.batch_size(b)) for b, v in sorted(buckets.items())},
           "part_s": {"compare": time.perf_counter() - t_part}}
    t_part = time.perf_counter()

    group = max(buckets.values(), key=len)
    feats = [generate_features(p) for p in group]
    feats.sort(key=lambda f: -f["nres"])
    for label, fs in (("batched", feats), ("one_chain", feats[:1])):
        x = [torch.from_numpy(a).to(model.linear_s_in.weight.device)
             for a in seg._padded_features(fs, fs[0]["nres"])]
        lens = torch.tensor([f["nres"] for f in fs])
        m = None if int(lens.min()) == fs[0]["nres"] else x[5]
        wall, busy, top, *_ = device_busy(
            lambda: model.forward_features(*x[:5], m, None if m is None else lens), cpu=False)
        out.setdefault("forward_profile", {})[label] = {
            "chains": len(fs), "nres": [f["nres"] for f in fs], "wall_s": wall,
            "device_busy_s": busy, "idle_share": None if busy is None else 1 - busy / wall,
            "top_kernels_s": top}
    del x
    out["part_s"]["profiles"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    big = []
    for i, n in enumerate(rng.integers(1400, 1537, seg.batch_size(1536))):
        big.append(os.path.join(src, f"full{i}.pdb"))
        write_backbone_pdb(big[-1], helical_backbone(rng, int(n)), rng)
    feats = [generate_features(p) for p in big]
    base = held_before_peak()
    t = time.perf_counter()
    got = seg._forward_batch(model, feats)
    dt = time.perf_counter() - t
    check(all(len(ids) == f["nres"] and np.isfinite(c).all() for (ids, c), f in zip(got, feats)),
          "the 1,536 batch gave ids or confidences of the wrong length, or non-finite ones")
    out["full_batch_1536"] = {"chains": len(feats), "nres": [f["nres"] for f in feats],
                              "seconds": dt, "peak_mem_gib": (torch.cuda.max_memory_allocated()
                                                              - base) / 2 ** 30,
                              "residues_per_s": sum(f["nres"] for f in feats) / dt}
    out["part_s"]["full_batch"] = time.perf_counter() - t_part
    return out


STREAM_BLOCK = 262_144     # the CLI's --search_batchsize default: 64 superblocks at N_BIG
STREAM_Q, STREAM_K = 32, 100


def numbered_records(n, letter):
    """The name records of n entries named letter + 8 digits (00000000...)."""
    from merizo_search_tpu_torch.db.codecs import NAME_RECORD

    idx = np.arange(n, dtype=np.int64)
    rec = np.full((n, NAME_RECORD), ord(" "), np.uint8)
    rec[:, 0], rec[:, -1] = ord(letter), ord("\n")
    for p in range(8):
        rec[:, 8 - p] = ord("0") + (idx // 10 ** p) % 10
    return rec.view(f"S{NAME_RECORD}").ravel()


def write_stream_db(prefix, gen, dev):
    """An mmap DB of N_BIG seeded unit rows (made on the card, written a
    chunk at a time) with names s00000000..., each entry's coordinates one
    of 64 pooled walks, and the int8 and bf16 sidecars of the port's
    write_quantized_sidecar. Returns the seconds of each step."""
    from merizo_search_tpu_torch.db.codecs import write_quantized_sidecar

    t, out = time.perf_counter(), {}
    rng = np.random.default_rng(41)
    pool = [walk(rng, int(n)) for n in rng.integers(50, 401, 64)]
    idx = np.arange(N_BIG, dtype=np.int64)
    files = write_mmap_tables(prefix, numbered_records(N_BIG, "s"), idx % 64, pool, 128)
    with open(os.path.join(os.path.dirname(prefix), files["dbfname_IP"]), "wb") as fh:
        for i in range(0, N_BIG, 1 << 21):
            fh.write(unit_rows(1 << 21, gen, dev).cpu().numpy().tobytes())
    out["write_db_s"] = time.perf_counter() - t
    for kind in ("int8", "bf16"):
        t = time.perf_counter()
        write_quantized_sidecar(prefix, kind)
        out[f"write_{kind}_sidecar_s"] = time.perf_counter() - t
    return out


def stream_phase(dev, tmp, e2e_db):
    """The stream mode on the card: a DB of N_BIG rows scanned by a device-
    mode engine and by a stream-mode engine (forced by a lowered budget),
    superblocks of STREAM_BLOCK rows; then run_dbsearch with a stream
    engine over the e2e DB against the e2e run's TSV."""
    from merizo_search_tpu_torch.db.codecs import FlatDB
    from merizo_search_tpu_torch.io.results import SEARCH_FIELDS, write_search_results
    from merizo_search_tpu_torch.ops import blockmax, gather
    from merizo_search_tpu_torch.pipeline.dbsearch import run_dbsearch
    from merizo_search_tpu_torch.search.engine import SearchEngine

    gen = torch.Generator(device=dev).manual_seed(43)
    prefix = os.path.join(tmp, "stream", "db")
    os.makedirs(os.path.dirname(prefix))
    out = {"rows": N_BIG, "block": STREAM_BLOCK, "q": STREAM_Q, "k": STREAM_K,
           "page_cache": "hot: the DB's files were written in this run",
           "build": write_stream_db(prefix, gen, dev), "runs": {}}
    db = FlatDB.open(prefix)
    check(db.has_quant("int8") and db.has_quant("bf16"), "stream DB sidecars missing")
    q = unit_rows(STREAM_Q, gen, dev).cpu().numpy()
    counts = {}
    for prec in ("bf16", "int8"):
        t = time.perf_counter()
        want = SearchEngine(db, prec, "cuda").search(q, STREAM_K)
        device_s = time.perf_counter() - t                 # residency included
        st = SearchEngine(db, prec, "cuda", max_device_gb=N_BIG * 128 / 2 ** 31,
                          stream_block=STREAM_BLOCK)       # half the int8 DB
        check(st.mode == "stream", f"{prec}: the lowered budget did not force the stream mode")
        reset_counts()                                     # the stream path starts here
        got = st.search(q, STREAM_K)
        counts[prec] = launch_counts()
        stats = dict(st.stream_stats)
        check(stats["superblocks"] == N_BIG // STREAM_BLOCK,
              f"{prec}: {stats['superblocks']} superblocks")
        for name in ("blockmax_scan", "gather_block_scores"):
            check(counts[prec][name] == stats["superblocks"],
                  f"{prec}: {name} launched {counts[prec][name]} times in "
                  f"{stats['superblocks']} superblocks")
        check(np.array_equal(got[0], want[0]), f"{prec}: stream scores differ from device mode")
        ties = 0
        for va, ia, ib in zip(got[0], got[1], want[1]):
            for v in np.unique(va):
                tied = va == v
                if tied.sum() == 1:
                    check(ia[tied] == ib[tied], f"{prec}: stream index differs from device mode")
                else:
                    ties += int(tied.sum())
        wall, busy, top, per, _ = device_busy(lambda: st.search(q, STREAM_K))
        copies = sum(v for k, v in per.items() if k.startswith("Memcpy"))
        out["runs"][prec] = {
            "device_mode_s": device_s, "stream": stats, "tied_entries": ties,
            "profiled_pass": {"wall_s": wall, "device_busy_s": busy,
                              "idle_share": None if busy is None else 1 - busy / wall,
                              "copy_engine_s": copies,
                              "kernels_s": sum(per.values()) - copies,
                              "rows_per_s": N_BIG / wall, "top_kernels_s": top},
            "bytes_per_row": 128 * (1 if prec == "int8" else 2) + (4 if prec == "int8" else 0)}
    # the search path with a stream engine: the e2e int8 run's TSV
    reset_counts()
    e2e = FlatDB.open(e2e_db["prefix"])
    eng = SearchEngine(e2e, "int8", "cuda", max_device_gb=e2e.size * 128 / 2 ** 31,
                       stream_block=STREAM_BLOCK)
    check(eng.mode == "stream", "the e2e DB did not stream")
    res, _ = run_dbsearch(e2e_db["pdbs"], e2e_db["prefix"], topk=10, weights=e2e_db["weights"],
                          engine=eng, mmap_cov_filter=True, device="cuda")
    counts["search_path"] = launch_counts()
    mine = os.path.join(tmp, "res_int8_stream_search.tsv")
    write_search_results(res, mine, SEARCH_FIELDS.split(","), header=True)
    with open(mine) as a, open(os.path.join(tmp, "res_int8_search.tsv")) as b:
        check(a.read() == b.read(), "run_dbsearch with a stream engine wrote another TSV")
    out["search_path"] = {"superblocks": eng.stream_stats["superblocks"], "same_tsv": True}
    return out, counts


IVF_ROWS_LOG2, IVF_NLIST, IVF_K, IVF_Q = 20, 1024, 100, 256   # the IVF curve's shape
IVF_PROBE = 32             # the engine's and the CLI's default nprobe
IVF_Q_SMALL = 8            # a batch whose probe union is a few percent of the layout


def gather_bytes(q, db, bidx, kw):
    """Bytes phase C must move at least: each distinct selected block (rows
    and tl) once, its scales in the per-row mode, the queries, bidx (and
    scale_sel), qcap and the output."""
    nq, kb = bidx.shape
    nblk = int(torch.unique(bidx[bidx >= 0]).numel())
    return nblk, (nblk * 128 * (128 * db.element_size() + 4 + (4 if "scales" in kw else 0))
                  + nq * 128 * q.element_size()
                  + bidx.numel() * 4 * (2 if "scale_sel" in kw else 1) + nq * 4
                  + nq * kb * 128 * 4)


def gather_row(mode, q, db, bidx, npad, tl, qc, flush, bb_kw=None, **kw):
    """Phase C in one mode at an IVF shape: the per-query kernel
    (`gather_block_scores` with `kw`) against its plain version, and the
    block-major launch the IVF runs (`bb_kw`, default `kw`) against its
    plain version and equal to the per-query output bit for bit, with every
    slot written (an out= full of NaN). Timed in turns (per-query,
    block-major, block-major, per-query), and its inversion alone. Returns
    the two rows of the kernel table."""
    from merizo_search_tpu_torch.ops import _build, gather

    bb_kw = kw if bb_kw is None else bb_kw
    got = gather.gather_block_scores(q, db, bidx, npad, tl, qc, **kw)
    out = torch.full_like(got, float("nan"))
    bb = gather.gather_block_scores_by_block(q, db, bidx, npad, tl, qc, out=out, **bb_kw)
    torch.cuda.synchronize()
    check(not torch.isnan(bb).any(), f"{mode}: the block-major launch left slots unwritten")
    check(torch.equal(bb, got), f"{mode}: the block-major launch differs from the per-query "
          "kernel")
    want = gather.gather_plain(q, db, bidx, npad, tl, qc, **kw)
    err = max_err(got, want, mode == "int8")
    if bb_kw is not kw:
        want = gather.gather_plain(q, db, bidx, npad, tl, qc, **bb_kw)
    bb_err = max_err(bb, want, mode == "int8")
    del got, out, bb, want
    pq = lambda: gather.gather_block_scores(q, db, bidx, npad, tl, qc, **kw)
    by = lambda: gather.gather_block_scores_by_block(q, db, bidx, npad, tl, qc, **bb_kw)
    t = [time_ms(f, 10, flush) for f in (pq, by, by, pq)]
    ms, bb_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    plain_ms = time_ms(lambda: gather.gather_plain(q, db, bidx, npad, tl, qc, **kw), 1, flush)
    bb_plain_ms = plain_ms if bb_kw is kw else time_ms(
        lambda: gather.gather_plain(q, db, bidx, npad, tl, qc, **bb_kw), 1, flush)
    nq, kb = bidx.shape
    # the block-major launch's inversion alone (its four launches into the
    # workspace), the part of bb_ms that reads no block
    lib, nb = _build.library(), db.shape[0] // 128
    ws = torch.empty(lib.mst_by_block_ws(nb, nq * kb, None), dtype=torch.int32, device=db.device)
    bp = _build.ptr(bidx, "bidx", torch.int32, (nq, kb))
    inv_ms = time_ms(lambda: _build.check_launch(lib.mst_invert_blocks(
        bp, ws.data_ptr(), nq, kb, nb, torch.cuda.current_stream().cuda_stream),
        "invert_blocks"), 10, flush)
    ops = 2 * int((bidx >= 0).sum()) * 128 * 128
    kind = {torch.float32: "f32"}.get(db.dtype, mode)
    rows = []
    for name, kws, t_ms, t_plain, e in (("", kw, ms, plain_ms, err),
                                         ("by_block_", bb_kw, bb_ms, bb_plain_ms, bb_err)):
        nblk, nbytes = gather_bytes(q, db, bidx, kws)
        b_ms, b_by = bound(nbytes, ops, kind)
        scale = next((k for k in ("scale_sel", "scales") if k in kws), "none")
        rows.append({"dtype": mode, "mode": name + ("f32_rerank" if kind == "f32" else
                                                    scale + "_ivf_probe"),
                     "n": npad, "q": nq, "kb": kb, "distinct_blocks": nblk, "max_abs_err": e,
                     "ms": t_ms, "plain_ms": t_plain, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
    rows[0]["by_block_ms"] = bb_ms
    rows[1].update(per_query_ms=ms, equal_to_per_query=True, turns_ms=t, invert_ms=inv_ms)
    return rows


def ivf_phase(dev, tmp, e2e_db, flush):
    """The IVF index on the card (module docstring, phase 13). Returns
    (readings, launch counts by path, phase-C rows for the kernel table:
    per-query and block-major)."""
    from merizo_search_tpu_torch import cli
    from merizo_search_tpu_torch.db.codecs import FlatDB
    from merizo_search_tpu_torch.ops import gather
    from merizo_search_tpu_torch.ops.fused_scan import fused_topk, selected_scales
    from merizo_search_tpu_torch.ops.topk import quantize_rows
    from merizo_search_tpu_torch.search import ivf
    from merizo_search_tpu_torch.search.engine import SearchEngine
    from merizo_search_tpu_torch.tools import ivf_curve
    from merizo_search_tpu_torch.utils import profiling

    out, counts, rows, bb_rows = {}, {}, [], []
    # (a) the build and (b) recall and queries/s by nprobe: the port's curve tool
    st = {}
    curve = ivf_curve.main(["--log2-rows", str(IVF_ROWS_LOG2), "--nlist", str(IVF_NLIST),
                            "--k", str(IVF_K), "--q", str(IVF_Q), "--iters", "5"], state=st)
    emb, q, lay, ref = st["emb"], st["q"], st["ivf"], st["ref"]
    out["curve"] = curve
    check(lay["nlist"] == IVF_NLIST and lay["dup"], f"IVF build: {curve['config']}")
    rk = f"recall_at_{IVF_K}"
    for dtype in ("bf16", "int8"):
        pts = [p for p in curve["points"] if p["dtype"] == dtype]
        check([p["nprobe"] for p in pts] == [4, 8, 16, 32, 64, 128], f"{dtype} curve points")
        for a, b in zip(pts, pts[1:]):
            check(b[rk] >= a[rk], f"{dtype}: recall fell from nprobe {a['nprobe']} to "
                  f"{b['nprobe']}: {a[rk]} -> {b[rk]}")
        for p in pts:
            check(p["rerank_" + rk] >= p[rk], f"{dtype} nprobe {p['nprobe']}: rerank recall "
                  f"{p['rerank_' + rk]} < {p[rk]}")
    # nprobe = nlist (Q 32) equals the flat fused scan, scores bit for bit
    d = ivf.resident_layout(emb, lay, torch.bfloat16, dev, rerank=True)
    q32 = torch.from_numpy(q[:32]).to(dev).to(torch.bfloat16)
    v, i = ivf.ivf_search(q32, d["db"], d["centroids"], d["perm"], IVF_K, IVF_NLIST, dedup=True)
    flat = torch.from_numpy(emb).to(dev).to(torch.bfloat16)
    fv, fi = fused_topk(q32, flat, len(emb), IVF_K)
    check(torch.equal(v, fv), "IVF at nprobe = nlist: scores differ from the flat fused scan")
    ties = 0
    for r in range(32):
        for x in torch.unique(fv[r]):
            tied = fv[r] == x
            ties += int(tied.sum()) if tied.sum() > 1 else 0
            check(sorted(i[r][tied].tolist()) == sorted(fi[r][tied].tolist()),
                  "IVF at nprobe = nlist: ids differ from the flat fused scan")
    out["full_probe"] = {"q": 32, "equal": True, "tied_entries": ties}
    del flat, v, i, fv, fi
    # where the time of one search goes (bf16, nprobe 32, Q 256): the card's
    # busy share and its top kernels under torch.profiler
    out["profile"] = {}
    for rerank in (False, True):
        fn = ivf_curve.search_fn(d, q, IVF_K, IVF_PROBE, rerank, dev)
        fn()
        wall, busy, top, per, _ = device_busy(fn)
        out["profile"]["rerank" if rerank else "plain"] = {
            "wall_s": wall, "device_busy_s": busy,
            "idle_share": None if busy is None else 1 - busy / wall, "top_kernels_s": top,
            "kernels_s": {k[:80]: v for k, v in sorted(per.items(), key=lambda kv: -kv[1])}}
    # (c) phase C at the IVF shapes: the probe gather (nprobe 32, KB 320) in
    # bf16 and int8, and the f32 mode at the rerank shape (Q 256, KB 101)
    npad = d["db"].shape[0]
    tl = torch.where(d["perm"] >= 0, 0.0, float("inf")).to(torch.float32)
    qc = torch.full((IVF_Q,), 3e38, device=dev)
    qf = torch.from_numpy(q).to(dev)
    bidx = ivf._probe_blocks(qf.to(torch.bfloat16), d["centroids"], IVF_PROBE,
                             lay["cluster_rows"] // 128)
    qb = qf.to(torch.bfloat16)

    def add(pair):
        rows.append(pair[0])
        bb_rows.append(pair[1])

    add(gather_row("bf16", qb, d["db"], bidx, npad, tl, qc, flush))
    scores = gather.gather_block_scores_by_block(qb, d["db"], bidx, npad, tl, qc)
    _, bidx2 = ivf._rerank_blocks(qf, d["hi"], scores, bidx, tl, qc, IVF_K)
    check(tuple(bidx2.shape) == (IVF_Q, IVF_K + 1), f"rerank shape {tuple(bidx2.shape)}")
    add(gather_row("f32", qf, d["hi"], bidx2, npad, tl, qc, flush))
    for r in (rows[-1], bb_rows[-1]):
        check(r["max_abs_err"] <= 1e-5, f"f32 mode off by {r['max_abs_err']}")
    del d, scores
    d8 = ivf.resident_layout(emb, lay, torch.int8, dev)
    q8 = torch.from_numpy(quantize_rows(q)[0]).to(dev)
    bidx8 = ivf._probe_blocks(qf, d8["centroids"], IVF_PROBE, lay["cluster_rows"] // 128)
    # the per-query kernel with per-selected-block scales (the flat scan's
    # mode); the block-major launch as the IVF runs it (per-row scales)
    add(gather_row("int8", q8, d8["db"], bidx8, npad, tl, qc, flush,
                   bb_kw={"scales": d8["scales"]},
                   scale_sel=selected_scales(d8["scales"], bidx8)))
    del d8, tl, qc
    torch.cuda.empty_cache()

    # the entry points: a DB of these rows, searched by the engine
    prefix = os.path.join(tmp, "ivf", "db")
    os.makedirs(os.path.dirname(prefix))
    rng = np.random.default_rng(47)
    pool = [walk(rng, int(n)) for n in rng.integers(50, 401, 64)]
    t = time.perf_counter()
    idx = np.arange(len(emb), dtype=np.int64)
    files = write_mmap_tables(prefix, numbered_records(len(emb), "v"), idx % 64, pool, 128)
    emb.tofile(os.path.join(os.path.dirname(prefix), files["dbfname_IP"]))
    out["write_db_s"] = time.perf_counter() - t
    db = FlatDB.open(prefix)

    def recall(idxs):
        return ivf_curve.recall(np.asarray(idxs), ref)

    # device IVF through the engine (builds and caches the layout; the
    # second engine opens the cache and holds the f32 sidecar too)
    eng = SearchEngine(db, "bf16", "cuda", index="ivf", ivf_nlist=IVF_NLIST,
                       ivf_nprobe=IVF_PROBE)
    eng.search(q[:1], IVF_K)
    rr = SearchEngine(db, "bf16", "cuda", index="ivf", ivf_nlist=IVF_NLIST,
                      ivf_nprobe=IVF_PROBE, ivf_rerank=True)
    rr.search(q[:1], IVF_K)
    check(rr.ivf_build_s is None, "the rerank engine rebuilt the cached layout")
    reset_counts()                                  # the device-IVF path starts here
    t = time.perf_counter()
    dv, di = eng.search(q, IVF_K)
    rv, ri = rr.search(q, IVF_K)
    dev_s = time.perf_counter() - t
    counts["device"] = launch_counts()
    check(counts["device"]["gather_block_scores_by_block"] == 3
          and counts["device"]["gather_block_scores_by_block.f32"] == 1
          and counts["device"]["gather_block_scores"] == 0
          and counts["device"]["blockmax_scan"] == 0,
          f"device IVF launches (three block-major, one of them f32): {counts['device']}")
    dev_pt = next(p for p in curve["points"] if p["dtype"] == "bf16"
                  and p["nprobe"] == IVF_PROBE)
    out["device_engine"] = {"build_s": eng.ivf_build_s, "two_searches_s": dev_s,
                            "recall": recall(di), "rerank_recall": recall(ri),
                            "tool_recall": dev_pt[rk], "tool_rerank_recall": dev_pt["rerank_" + rk]}
    # the engine normalises the queries again (a last-bit change can move a
    # bf16 rounding), so its recall may differ from the tool's in the noise
    check(abs(out["device_engine"]["recall"] - dev_pt[rk]) <= 0.01,
          f"engine and tool recall differ: {out['device_engine']}")
    del eng, rr
    torch.cuda.empty_cache()

    # (d) stream IVF: the same DB forced to stream (sidecars built here)
    small = 1e-3                                    # GB: far below the 256 MiB bf16 DB
    se = SearchEngine(db, "bf16", "cuda", index="ivf", ivf_nlist=IVF_NLIST,
                      ivf_nprobe=IVF_PROBE, max_device_gb=small, stream_block=STREAM_BLOCK)
    check(se.mode == "stream", "the IVF DB did not stream")
    se.search(q[:1], IVF_K)                         # builds the disk sidecars
    reset_counts()                                  # the stream-IVF path starts here
    sv, si = se.search(q, IVF_K)
    counts["stream"] = launch_counts()
    stats = dict(se.stream_stats)
    for name in ("blockmax_scan", "gather_block_scores"):
        check(counts["stream"][name] == stats["groups"],
              f"stream IVF: {name} launched {counts['stream'][name]} times in "
              f"{stats['groups']} groups")
    srec = recall(si)
    check(srec >= out["device_engine"]["recall"], f"stream IVF recall {srec} < device IVF "
          f"{out['device_engine']['recall']}")
    t = time.perf_counter()
    for _ in range(3):
        se.search(q, IVF_K)
    batch_s = (time.perf_counter() - t) / 3
    # at Q 256 the probe union is the whole layout; at Q 8 it is a few
    # percent of it, staged in coalesced runs across gaps, 64 clusters a
    # group: that path is held against the same engine on the CPU (the
    # plain versions, on the same sidecars)
    qsm, grp = q[:IVF_Q_SMALL], 64 * lay["cluster_rows"]
    sm = SearchEngine(db, "bf16", "cuda", index="ivf", ivf_nlist=IVF_NLIST,
                      ivf_nprobe=IVF_PROBE, max_device_gb=small, stream_block=grp)
    reset_counts()                                  # the small-batch stream-IVF path
    mv, mi = sm.search(qsm, IVF_K)
    counts["stream_small_q"] = launch_counts()
    check(sm.ivf_build_s is None, "the small-batch stream engine rebuilt the sidecars")
    sst = dict(sm.stream_stats)
    check(sst["staged_share"] < 1 and sst["groups"] > 1,
          f"stream IVF at Q {IVF_Q_SMALL}: staged {sst['staged_share']} in {sst['groups']} "
          "groups")
    for name in ("blockmax_scan", "gather_block_scores"):
        check(counts["stream_small_q"][name] == sst["groups"],
              f"stream IVF at Q {IVF_Q_SMALL}: {name} launched "
              f"{counts['stream_small_q'][name]} times in {sst['groups']} groups")
    ce = SearchEngine(db, "bf16", "cpu", index="ivf", ivf_nlist=IVF_NLIST,
                      ivf_nprobe=IVF_PROBE, max_device_gb=small, stream_block=grp)
    cv, ci = ce.search(qsm, IVF_K)
    check(ce.stream_stats["clusters"] == sst["clusters"]
          and ce.stream_stats["groups"] == sst["groups"],
          f"stream IVF at Q {IVF_Q_SMALL}: the CPU staged {ce.stream_stats['clusters']} "
          f"clusters in {ce.stream_stats['groups']} groups, the card {sst['clusters']} in "
          f"{sst['groups']}")
    small_err = float(np.max(np.abs(mv - cv)))
    check(small_err <= BF16_TOL, f"stream IVF at Q {IVF_Q_SMALL}: scores off the CPU's by "
          f"{small_err}")
    for r in range(IVF_Q_SMALL):
        cut = cv[r, -1] + 2 * BF16_TOL
        check(set(mi[r][mv[r] > cut].tolist()) == set(ci[r][cv[r] > cut].tolist()),
              f"stream IVF at Q {IVF_Q_SMALL}: ids differ from the CPU's (query {r})")
    small_q = {"q": IVF_Q_SMALL, "stats": sst, "max_abs_err_vs_cpu": small_err,
               "recall": ivf_curve.recall(mi, ref[:IVF_Q_SMALL])}
    del sm, ce
    full = SearchEngine(db, "bf16", "cuda", index="ivf", ivf_nlist=IVF_NLIST,
                        ivf_nprobe=IVF_NLIST, max_device_gb=small, stream_block=STREAM_BLOCK)
    gv, gi = full.search(q[:32], IVF_K)
    check(full.ivf_build_s is None, "the full-probe stream engine rebuilt the sidecars")
    wv, wi = SearchEngine(db, "bf16", "cuda").search(q[:32], IVF_K)
    check(np.array_equal(gv, wv), "stream IVF at nprobe = nlist: scores differ from the "
          "device flat scan")
    for r in range(32):
        for x in np.unique(wv[r]):
            tied = wv[r] == x
            check(sorted(gi[r][tied]) == sorted(wi[r][tied]),
                  "stream IVF at nprobe = nlist: ids differ from the device flat scan")
    out["stream"] = {"sidecar_build_s": se.ivf_build_s, "recall": srec, "stats": stats,
                     "seconds_a_batch": batch_s, "full_probe_equal": True, "small_q": small_q,
                     "full_probe_stats": dict(full.stream_stats)}
    del se, full

    # (e) the CLI over the e2e DB: search --search_index ivf, default nprobe
    reset_counts()                                  # the CLI-IVF path starts here
    profiling.reset()
    res = os.path.join(tmp, "res_ivf")
    cli.main(["search", *e2e_db["pdbs"], e2e_db["prefix"], res, "-k", "10", "-d", "cuda",
              "--search_index", "ivf", "--mmap_cov_filter", "--output_headers",
              "--weights", e2e_db["weights"]])
    torch.cuda.synchronize()
    counts["cli"] = launch_counts()
    check(counts["cli"]["gather_block_scores_by_block"] > 0
          and counts["cli"]["gather_block_scores"] == 0, f"CLI IVF launches: {counts['cli']}")
    first = {}
    for r in read_tsv(res + "_search.tsv"):
        first.setdefault(r["query"], r)
    check(len(first) == len(e2e_db["planted"]), "CLI IVF: queries without hits")
    for qname, r in first.items():
        check(r["target"] == e2e_db["planted"][qname],
              f"CLI IVF: {qname} rank-1 hit is {r['target']}")
    out["cli"] = {"phase_s": {k: v[0] for k, v in profiling.timings().items()},
                  "queries": len(first), "planted_rank1": True}
    return out, counts, rows, bb_rows, {"prefix": prefix, "q": q}


EASY_LENGTHS = (300, 600, 900, 1500)
# Pair thresholds (-m) of the multi-domain runs. The synthetic domains are
# bundles of ideal helices, alike enough that 97% of their pairs align at TM
# >= 0.5 (40% at >= 0.8, 2% at >= 0.9), and the random Foldclass weights put
# most cosines above 0.99: at the defaults the assignment paths of an
# 11-domain chain run into the 100,000 cap. A self match scores 1.0 in both.
EASY_MINTM = {"exhaustive_tmalign": "0.9", "embscore": "0.999"}


def easy_search_phase(dev, tmp):
    """easy-search --multi_domain_search on the card, both modes, over
    synthetic multi-domain chains whose domains (cut by the port's segment
    verb, default weights) make the DB; then the smallest chain on the CPU."""
    import glob

    from merizo_search_tpu_torch import cli
    from merizo_search_tpu_torch.tools.synthetic import helical_backbone, write_backbone_pdb
    from merizo_search_tpu_torch.utils import profiling

    rng = np.random.default_rng(52)          # the 300-residue chain gets 3 domains
    src, seg, dbin = (os.path.join(tmp, "easy", x) for x in ("in", "seg", "dbin"))
    for x in (src, dbin):
        os.makedirs(x)
    chains = []
    for i, n in enumerate(EASY_LENGTHS):
        chains.append(os.path.join(src, f"mdc{i}.pdb"))
        write_backbone_pdb(chains[-1], helical_backbone(rng, n), rng)
    profiling.reset()
    t = time.perf_counter()
    cli.main(["segment", *chains, os.path.join(seg, "s"), "-d", "cuda", "--save_domains",
              "--output_headers", "--merizo_output", seg])
    for f in sorted(glob.glob(os.path.join(seg, "*.dom_pdb"))):
        shutil.copy(f, os.path.join(dbin, os.path.basename(f)[:-len(".dom_pdb")] + ".pdb"))
    db = os.path.join(tmp, "easy", "db")
    cli.main(["createdb", dbin, db, "-d", "cuda"])
    ndom = {r["filename"]: int(r["ndom"]) for r in read_tsv(os.path.join(seg, "s_segment.tsv"))}
    check(ndom["mdc0"] >= 2 and sum(v >= 2 for v in ndom.values()) >= 2,
          f"too few multi-domain chains: {ndom}")
    out = {"chains": dict(zip((f"mdc{i}" for i in range(len(chains))), EASY_LENGTHS)),
           "ndom": ndom, "db_entries": len(os.listdir(dbin)),
           "build_db_s": time.perf_counter() - t, "mintm": EASY_MINTM, "runs": {}}
    counts, rows = {}, {}
    for mode, d in (("exhaustive_tmalign", "cuda"), ("embscore", "cuda"),
                    ("exhaustive_tmalign", "cpu")):
        inputs = chains if d == "cuda" else chains[:1]
        res = os.path.join(tmp, "easy", f"{mode}_{d}", "res")
        reset_counts()                                 # the easy-search path starts here
        profiling.reset()
        t = time.perf_counter()
        cli.main(["easy-search", *inputs, db, res, "-d", d, "--multi_domain_search",
                  "--multi_domain_mode", mode, "-k", "100", "-m", EASY_MINTM[mode],
                  "--output_headers", "--merizo_output", os.path.dirname(res)])
        if d == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts[f"{mode}_{d}"] = launch_counts()
        rows[(mode, d)] = {x: read_tsv(f"{res}_{x}.tsv")
                           for x in ("segment", "search", "search_multi_dom")}
        launched = {k: counts[f"{mode}_{d}"][k] for k in ("blockmax_scan", "gather_block_scores")}
        out["runs"][f"{mode}_{d}"] = {
            "wall_s": wall, "launches": launched,
            "phase_s": {k: v[0] for k, v in profiling.timings().items() if "." not in k},
            "multi_dom_rows": len(rows[(mode, d)]["search_multi_dom"])}
        if d == "cpu":
            continue
        check(all(v > 0 for v in launched.values()), f"{mode}: a scan kernel was not launched")
        bound = 0.99 if mode == "exhaustive_tmalign" else 0.999
        for name, n in ndom.items():
            if n < 2:
                continue
            selves = [r for r in rows[(mode, d)]["search_multi_dom"]
                      if r["query_chain"] == name and r["hit_chain"] == name + "_merizo"
                      and r["match_category"] == "3"]
            check(len(selves) == 1, f"{mode}: {name} is not its own category-3 match")
            scores = [float(f.split(":")[2]) for f in selves[0]["match_info"].split(",")]
            check(min(scores) >= bound, f"{mode}: {name} self scores {scores}")
    # the smallest chain on the CPU against the card
    g, c = rows[("exhaustive_tmalign", "cuda")], rows[("exhaustive_tmalign", "cpu")]
    gs = [r for r in g["segment"] if r["filename"] == "mdc0"]
    check(len(gs) == 1 and len(c["segment"]) == 1 and gs[0]["result"] == c["segment"][0]["result"],
          "card and CPU chop mdc0 differently")
    err = 0.0
    for field in ("emb_score", "max_tm"):
        gh = {(r["query"], r["target"]): float(r[field]) for r in g["search"]
              if r["query"].startswith("mdc0_")}
        ch = {(r["query"], r["target"]): float(r[field]) for r in c["search"]}
        check(gh and set(gh) == set(ch), "card and CPU hit sets differ for mdc0")
        err = max([err] + [abs(gh[x] - ch[x]) for x in gh])
    gm = [r for r in g["search_multi_dom"] if r["query_chain"] == "mdc0"]
    cm = c["search_multi_dom"]
    check(gm and len(gm) == len(cm), "card and CPU multi-domain rows differ for mdc0")
    for a, b in zip(gm, cm):
        check({k: v for k, v in a.items() if k != "match_info"}
              == {k: v for k, v in b.items() if k != "match_info"},
              "card and CPU multi-domain rows differ for mdc0")
        for x, y in zip(a["match_info"].split(","), b["match_info"].split(",")):
            check(x.split(":")[:2] == y.split(":")[:2], "multi-domain matches differ")
            err = max(err, abs(float(x.split(":")[2]) - float(y.split(":")[2])))
    # the TSVs print 4 decimals: one unit of the last place is within 1e-4
    check(err <= 1e-4 + 1e-9, f"card and CPU scores differ by {err}")
    out["cpu_vs_card"] = {"chain": "mdc0", "ndom": ndom["mdc0"], "max_abs_err": err}
    return out, counts


TM_PAIRS = {64: 32, 128: 32, 256: 32, 512: 16}   # tmalign phase: card against CPU
TM_TOL = 1e-3              # |card - CPU| in qtm and ttm, all but one pair a group
TM_NEAR = 0.05             # ... and that one pair (a DP near-tie flipped by an ulp)
TM_DECISION = 0.02         # |device - native| in the decision region (NEAR_THRESHOLD_BAND)
TM_THROUGHPUT = ((256, 32), (256, 256), (256, 1365), (128, 256), (512, 256))
TM_BIG = (2048, 21)        # the largest bucket at its chunk cap: peak device memory
KINDS = ("homolog", "decision", "unrelated")


def tm_pairs(rng, b, n):
    """n pairs of bucket b (chains of b/2+1 to b residues), homologs, decision-
    region constructions and unrelated walks in turn. A homolog is a rigid-
    moved copy with 0.2 A noise a coordinate; a decision-region pair one with
    noise of 0.5-0.75 d0(n), which puts TM-scores around 0.5."""
    from merizo_search_tpu_torch.align.tmalign import tm_d0
    from merizo_search_tpu_torch.tools.synthetic import rotation

    pairs, kinds = [], []
    for i in range(n):
        a = walk(rng, int(rng.integers(b // 2 + 1, b + 1)))
        kind = KINDS[i % 3]
        if kind == "unrelated":
            c = walk(rng, int(rng.integers(b // 2 + 1, b + 1)))
        else:
            sigma = 0.2 if kind == "homolog" else float(tm_d0(len(a))) * rng.uniform(0.5, 0.75)
            c = ((a + rng.normal(size=a.shape) * sigma) @ rotation(rng).T + 10.0).astype(np.float32)
        pairs.append(({"coords": a, "seq": "A" * len(a)}, {"coords": c, "seq": "A" * len(c)}))
        kinds.append(kind)
    return pairs, kinds


def max_tm(r):
    return max(r["qtm"], r["ttm"])


def timed(fn, dev):
    t = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t


def tmalign_profile(pairs):
    """One b = 256 chunk under torch.profiler (device activity only): the
    device events (kernels, and the few copies of inputs and results), the
    card's busy share and the kernels with the most device time. Then the chunk again with a synchronised host timer
    around each DP, superposition search, SVD and initial alignment
    (inclusive: the inits hold their own DP and SVD calls; the syncs cost
    the run a little overlap)."""
    import contextlib

    from merizo_search_tpu_torch.align import tmalign as T

    wall, busy, _, per, n_events = device_busy(
        lambda: T.tmalign_pairs(pairs, device="cuda"), cpu=False)

    names = {"_dp_align": "dp", "tm_score_search": "score_search",
             "_threading_init": "init.threading", "_ss_init": "init.ss",
             "_fragment_init": "init.fragment"}
    real = {n: getattr(T, n) for n in names}
    real_svd = torch.linalg.svd
    parts = {}

    def timed_part(fn, label):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                s, c = parts.get(label, (0.0, 0))
                parts[label] = (s + time.perf_counter() - t0, c + 1)
        return wrapper

    with contextlib.ExitStack() as undo:
        for n, label in names.items():
            setattr(T, n, timed_part(real[n], label))
            undo.callback(setattr, T, n, real[n])
        torch.linalg.svd = timed_part(real_svd, "svd")
        undo.callback(setattr, torch.linalg, "svd", real_svd)
        _, split_wall = timed(lambda: T.tmalign_pairs(pairs, device="cuda"), torch.device("cuda"))
    return {"pairs": len(pairs), "bucket": 256, "wall_s": wall,
            "device_events": n_events, "device_busy_s": busy,
            "busy_share": None if busy is None else busy / wall,
            "top_kernels_s": [[k[:80], v] for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:6]],
            "split_wall_s": split_wall,
            "split_s": {k: v[0] for k, v in sorted(parts.items())},
            "split_calls": {k: v[1] for k, v in sorted(parts.items())}}


def tmalign_phase(dev):
    """The device aligner on the card: against itself on the CPU per bucket
    (fast and full), against the native aligner, pairs/s beside it, one
    chunk under torch.profiler, and the peak memory of the largest bucket."""
    from merizo_search_tpu_torch.align import native
    from merizo_search_tpu_torch.align import tmalign as T

    rng = np.random.default_rng(41)
    out = {"card_vs_cpu": [], "vs_native": {}, "throughput": []}
    full = []
    for b, n in TM_PAIRS.items():
        pairs, kinds = tm_pairs(rng, b, n)
        for fast in (True, False):
            card, card_s = timed(lambda: T.tmalign_pairs(pairs, fast=fast, device="cuda"), dev)
            cpu, cpu_s = timed(lambda: T.tmalign_pairs(pairs, fast=fast, device="cpu"),
                               torch.device("cpu"))
            d = [max(abs(g["qtm"] - w["qtm"]), abs(g["ttm"] - w["ttm"])) for g, w in zip(card, cpu)]
            close = [i for i, x in enumerate(d) if x <= TM_TOL]
            la = max([abs(card[i]["len_ali"] - cpu[i]["len_ali"]) for i in close] + [0])
            rm = max([abs(card[i]["rmsd"] - cpu[i]["rmsd"]) for i in close] + [0.0])
            check(len(pairs) - len(close) <= 1 and max(d) <= TM_NEAR,
                  f"b={b} fast={fast}: card and CPU TM-scores differ by {sorted(d)[-3:]}")
            check(la <= 2 and rm <= 0.05, f"b={b} fast={fast}: len_ali {la}, rmsd {rm} apart")
            out["card_vs_cpu"].append({"bucket": b, "fast": fast, "pairs": len(pairs),
                                       "max_tm_diff": max(d), "over_tol": len(pairs) - len(close),
                                       "max_len_ali_diff": la, "max_rmsd_diff": rm,
                                       "card_s": card_s, "cpu_s": cpu_s})
            if not fast:
                full += [(p, k, g) for p, k, g in zip(pairs, kinds, card)]

    nat = native.tmalign_pairs_native([p for p, _, _ in full])
    dev_tm = [max_tm(g) for _, _, g in full]
    nat_tm = [max_tm(r) for r in nat]
    homo = [(a, b) for (_, k, _), a, b in zip(full, dev_tm, nat_tm) if k == "homolog"]
    check(min(min(a, b) for a, b in homo) >= 0.9,
          f"a homolog pair scores under 0.9: {min(min(a, b) for a, b in homo)}")
    region = [(a, b) for a, b in zip(dev_tm, nat_tm) if 0.4 <= max(a, b) <= 0.6]
    check(len(region) >= 8, f"only {len(region)} pairs in the decision region")
    worst = max(abs(a - b) for a, b in region)
    check(worst <= TM_DECISION, f"device and native differ by {worst} in the decision region")
    unrel = [(a, b) for (_, k, _), a, b in zip(full, dev_tm, nat_tm) if k == "unrelated"]
    check(max(max(a, b) for a, b in unrel) < 0.5, "an unrelated pair passes the 0.5 gate")
    out["vs_native"] = {
        "homologs": len(homo), "homolog_min_tm": min(min(a, b) for a, b in homo),
        "decision_region_pairs": len(region), "decision_region_max_abs_diff": worst,
        "unrelated": len(unrel),
        "unrelated_max_deficit": max(b - a for a, b in unrel),
        "unrelated_over_0.03": sum(b - a > 0.03 for a, b in unrel),
        "unrelated_max_tm": max(max(a, b) for a, b in unrel)}

    for b, n in TM_THROUGHPUT:
        pairs, _ = tm_pairs(rng, b, n)
        _, dev_s = timed(lambda: T.tmalign_pairs(pairs, device="cuda"), dev)
        _, nat_s = timed(lambda: native.tmalign_pairs_native(pairs), torch.device("cpu"))
        out["throughput"].append({"bucket": b, "pairs": n, "chunks": -(-n // T._dispatch_cap(b)),
                                  "device_s": dev_s, "device_pairs_per_s": n / dev_s,
                                  "native_s": nat_s, "native_pairs_per_s": n / nat_s,
                                  "native_threads": os.cpu_count()})
        if (b, n) == (256, 256):
            out["profile"] = tmalign_profile(pairs)

    b, n = TM_BIG
    pairs, _ = tm_pairs(rng, b, n)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    res, big_s = timed(lambda: T.tmalign_pairs(pairs, fast=True, device="cuda"), dev)
    check(all(np.isfinite(max_tm(r)) for r in res), "non-finite TM-score at b = 2048")
    out["big"] = {"bucket": b, "pairs": n, "fast": True, "seconds": big_s,
                  "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30}
    torch.cuda.empty_cache()
    return out


def http_json(base, path, body=None):
    """(response JSON, seconds) of one request."""
    import urllib.request

    t = time.perf_counter()
    req = urllib.request.Request(base + path, data=None if body is None else
                                 json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        out = json.loads(resp.read())
    return out, time.perf_counter() - t


def burst(base, bodies, path="/search"):
    """All bodies at once, one client thread each: (results, latencies, wall s)."""
    from concurrent.futures import ThreadPoolExecutor

    t = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(bodies)) as ex:
        got = list(ex.map(lambda b: http_json(base, path, b), bodies))
    return [g[0] for g in got], [g[1] for g in got], time.perf_counter() - t


def rate(lat, wall):
    return {"requests": len(lat), "requests_per_s": len(lat) / wall, "wall_s": wall,
            "p50_s": float(np.percentile(lat, 50)), "p99_s": float(np.percentile(lat, 99))}


def same_hits(got, want):
    """Hits equal but for emb_score, which may move by 1e-4 (the JSON's 4
    decimals): a query embedded in a batch of another size gets other GEMM
    shapes on the card. Returns whether they are equal exactly too."""
    check(len(got) == len(want), f"{len(got)} hits where a serial run has {len(want)}")
    for g, w in zip(got, want):
        check({k: v for k, v in g.items() if k != "emb_score"}
              == {k: v for k, v in w.items() if k != "emb_score"},
              f"a hit differs from the serial run's: {g} / {w}")
        check(abs(g["emb_score"] - w["emb_score"]) <= 1e-4 + 1e-9,
              f"emb_score {g['emb_score']} where a serial run has {w['emb_score']}")
    return got == want


def serve_phase(dev, tmp, e2e_db, e2e_runs):
    """The server on the card over the e2e DB, through real HTTP: concurrent
    /search bursts (native TM-align and skip_tmalign) against serial runs,
    with and without micro-batching; /easy-search beside a burst; /healthz,
    /stats; a service with the device aligner; and the search CLI with
    --tmalign_backend tpu."""
    from merizo_search_tpu_torch import cli
    from merizo_search_tpu_torch import server as srv
    from merizo_search_tpu_torch.tools.synthetic import helical_backbone, write_backbone_pdb
    from merizo_search_tpu_torch.utils import profiling

    prefix, weights, planted = e2e_db["prefix"], e2e_db["weights"], e2e_db["planted"]
    qnames = sorted(planted)
    bodies = [{"coords": c.tolist(), "seq": "A" * len(c), "name": qn, "k": 10}
              for qn, c in zip(qnames, e2e_db["qcoords"])]
    skip = [dict(b, skip_tmalign=True) for b in bodies]
    out = {"db": {"rows": N_MAIN, "precision": "bf16"}, "bursts": {}}

    def start(svc):
        httpd = srv.ThreadingHTTPServer(("127.0.0.1", 0), srv.make_handler(svc))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"

    def stop(httpd):
        httpd.shutdown()
        httpd.server_close()

    def planted_first(results, label):
        """With TM-align the planted row is the first hit (TM >= 0.9; the
        other planted rows' embeddings tie with it to ~1e-5 under random
        weights, and TM-align drops them under mintm); without it, among
        the k hits."""
        for qn, r in zip(qnames, results):
            targets = [h["target"] for h in r["hits"]]
            if r["hits"] and r["hits"][0]["q_tm"] is None:
                check(planted[qn] in targets, f"{label}: {qn} misses {planted[qn]}: {targets}")
                continue
            top = r["hits"][0] if r["hits"] else {}
            check(top.get("target") == planted[qn],
                  f"{label}: {qn} rank-1 hit is {top.get('target')}, not {planted[qn]}")
            check(min(top["q_tm"], top["t_tm"]) >= 0.9, f"{label}: {qn} TM {top}")

    reset_counts()                                 # the serve path starts here
    t = time.perf_counter()
    svc = srv.SearchService(prefix, precision="bf16", weights=weights, device="cuda")
    out["boot_s"] = time.perf_counter() - t
    httpd, base = start(svc)
    try:
        health, _ = http_json(base, "/healthz")
        check(health == {"status": "ok", "db_size": N_MAIN, "mode": "device"}, f"healthz {health}")
        serial = {"tm": [http_json(base, "/search", b)[0] for b in bodies],
                  "skip": [http_json(base, "/search", b)[0] for b in skip]}
        planted_first(serial["tm"], "serial")
        planted_first(serial["skip"], "serial skip_tmalign")
        exact = 0
        for label, bb, want in (("tm", bodies, serial["tm"]), ("tm_again", bodies, serial["tm"]),
                                ("skip", skip, serial["skip"])):
            n0, r0 = svc.n_batches, svc.n_requests
            res, lat, wall = burst(base, bb)
            planted_first(res, label)
            exact += sum(same_hits(g["hits"], w["hits"]) for g, w in zip(res, want))
            nb = svc.n_batches - n0
            check(nb < svc.n_requests - r0, f"{label}: {nb} batches for {len(bb)} requests")
            out["bursts"][f"batched_{label}"] = dict(rate(lat, wall), batches=nb)

        # /easy-search on a handler thread beside a /search burst
        rng = np.random.default_rng(61)
        pdb = os.path.join(tmp, "serve_easy.pdb")
        write_backbone_pdb(pdb, helical_backbone(rng, 300), rng)
        with open(pdb) as fh:
            easy_body = {"pdb": fh.read(), "chain": "A", "k": 10, "name": "mdc"}
        easy_serial, easy_s = http_json(base, "/easy-search", easy_body)
        check(easy_serial["ndom"] >= 1 and len(easy_serial["hits_per_domain"])
              == len(easy_serial["domains"]), f"easy-search: {easy_serial['ndom']} domains")
        box = {}
        th = threading.Thread(target=lambda: box.update(
            r=http_json(base, "/easy-search", easy_body)))
        th.start()
        res, lat, wall = burst(base, bodies)
        th.join()
        easy_conc, easy_conc_s = box["r"]
        check({k: v for k, v in easy_conc.items() if k != "hits_per_domain"}
              == {k: v for k, v in easy_serial.items() if k != "hits_per_domain"},
              "easy-search beside a burst cuts other domains")
        for g, w in zip(easy_conc["hits_per_domain"], easy_serial["hits_per_domain"]):
            exact += same_hits(g, w)
        exact += sum(same_hits(g["hits"], w["hits"]) for g, w in zip(res, serial["tm"]))
        out["easy_search"] = {"ndom": easy_serial["ndom"], "serial_s": easy_s,
                              "beside_burst_s": easy_conc_s,
                              "burst": rate(lat, wall)}
        stats, _ = http_json(base, "/stats")
        check(stats["requests"] == svc.n_requests and stats["search_batches"] == svc.n_batches
              and "db_scan" in stats["phase_timings"], f"stats {stats}")
        out["stats"] = {k: stats[k] for k in ("requests", "search_batches")}
    finally:
        stop(httpd)
    first = launch_counts()
    check(first["blockmax_scan"] > 0 and first["gather_block_scores"] > 0,
          f"the serve path did not launch both scan kernels: {first}")
    out["launches_first_service"] = {k: first[k] for k in ("blockmax_scan",
                                                           "gather_block_scores")}
    del svc

    svc1 = srv.SearchService(prefix, precision="bf16", weights=weights, device="cuda", max_batch=1)
    httpd, base = start(svc1)
    try:
        for label, bb, want in (("tm", bodies, serial["tm"]), ("skip", skip, serial["skip"])):
            res, lat, wall = burst(base, bb)
            exact += sum(same_hits(g["hits"], w["hits"]) for g, w in zip(res, want))
            out["bursts"][f"max_batch_1_{label}"] = dict(rate(lat, wall), batches=len(bb))
    finally:
        stop(httpd)
    del svc1
    out["results_equal_to_serial_exactly"] = exact

    t = time.perf_counter()
    svc_tpu = srv.SearchService(prefix, precision="bf16", weights=weights, device="cuda", tmalign_backend="tpu")
    out["tpu_boot_s"] = time.perf_counter() - t
    httpd, base = start(svc_tpu)
    try:
        res, lat, wall = burst(base, bodies[:8])
        for qn, r in zip(qnames[:8], res):
            top = r["hits"][0]
            check(top["target"] == planted[qn] and min(top["q_tm"], top["t_tm"]) >= 0.9,
                  f"device aligner: {qn} rank-1 hit {top}")
        out["bursts"]["device_aligner_tm"] = dict(rate(lat, wall))
    finally:
        stop(httpd)
    del svc_tpu

    profiling.reset()
    res = os.path.join(tmp, "res_tpu")
    t = time.perf_counter()
    cli.main(["search", *e2e_db["pdbs"], prefix, res, "-k", "10", "-d", "cuda",
              "--precision", "bf16", "--mmap_cov_filter", "--output_headers",
              "--weights", weights, "--tmalign_backend", "tpu"])
    torch.cuda.synchronize()
    first = {}
    for r in read_tsv(res + "_search.tsv"):
        first.setdefault(r["query"], r)
    for qn in qnames:
        r = first.get(qn)
        check(r is not None and r["target"] == planted[qn] and float(r["max_tm"]) >= 0.9,
              f"search --tmalign_backend tpu: {qn} rank-1 hit {r}")
    tt = profiling.timings()
    out["cli_tpu"] = {"wall_s": time.perf_counter() - t,
                      "tmalign_rescore_s": tt["tmalign_rescore"][0],
                      "native_tmalign_rescore_s": e2e_runs["bf16"]["phase_s"]["tmalign_rescore"],
                      "phase_s": {k: v[0] for k, v in tt.items()}}
    torch.cuda.empty_cache()
    return out, launch_counts()


MESH_SHARDS = 4            # mesh phase: shards of every mesh path
MESH_CREATEDB = 128        # structures of the `createdb --mesh` run
MESH_EMBED = 512           # structures of the data-parallel embed


def same_result(got, want, label):
    """A mesh's (scores, ids) against one device's: scores bit for bit, ids
    equal except among tied scores (any of the tied entries may be kept at
    the k-th score). Returns the number of tied entries."""
    check(np.array_equal(got[0], want[0]), f"{label}: scores differ from one device's")
    ties = 0
    for va, ia, ib in zip(got[0], got[1], want[1]):
        for v in np.unique(va):
            tied = va == v
            if tied.sum() == 1:
                check(ia[tied] == ib[tied], f"{label}: an id differs from one device's")
            else:
                ties += int(tied.sum())
                check(v == va[-1] or sorted(ia[tied]) == sorted(ib[tied]),
                      f"{label}: tied ids differ from one device's")
    return ties


def call_ms(fns, iters=5):
    """Host ms a call of each of fns (searches that end in numpy, so each
    call waits for its device work), timed in turns: a, b, b, a."""
    for fn in fns:
        fn()
    times = {i: [] for i in range(len(fns))}
    for i in list(range(len(fns))) + list(reversed(range(len(fns)))):
        t = time.perf_counter()
        for _ in range(iters):
            fns[i]()
        times[i].append((time.perf_counter() - t) / iters * 1e3)
    return [float(np.mean(times[i])) for i in range(len(fns))]


def mesh_phase(dev, tmp, e2e_db, ivf_db):
    """The mesh modes on the card (module docstring, phase 16). Returns
    (readings, launch counts by path)."""
    import logging

    from merizo_search_tpu_torch import cli
    from merizo_search_tpu_torch import server as srv
    from merizo_search_tpu_torch.db.codecs import FlatDB
    from merizo_search_tpu_torch.device import make_mesh
    from merizo_search_tpu_torch.pipeline.embed import embed_structures, load_foldclass_params
    from merizo_search_tpu_torch.search.engine import SearchEngine

    ncards = torch.cuda.device_count()
    shards = (torch.device("cuda", 0),) * MESH_SHARDS        # four shards on one card
    meshes = {"one_card": shards}
    if ncards >= 2:
        meshes["cards"] = make_mesh(1 << (ncards.bit_length() - 1), "cuda")
    used = set(shards)
    out = {"shards": MESH_SHARDS, "devices": [str(d) for d in shards],
           "note": "shards on one card measure the mesh's overhead (a launch a shard, the "
                   "partial copies, the merge), not a multi-card speed-up",
           "flat": {}, "stream": {}, "ivf": {}}
    counts = {}

    def profile(fn):
        """One call under torch.profiler: the card's busy share and the
        kernels with the most device time (section 5 of PERF.md)."""
        wall, busy, top, _, events = device_busy(fn)
        return {"wall_s": wall, "device_busy_s": busy, "device_events": events,
                "idle_share": None if busy is None else 1 - busy / wall, "top_kernels_s": top}

    def run_path(label, mesh, eng, fn, want, per_shard):
        """One mesh path from 0 counts: its result against one device's,
        each scan kernel of the path launched per_shard times a shard."""
        reset_counts()
        got = fn(eng)
        c = counts[label] = launch_counts()
        for name, n in per_shard.items():
            check(c[name] == n * len(mesh), f"{label}: {name} launched {c[name]} times, "
                  f"not {n} on each of {len(mesh)} shards")
        used.update(mesh)
        return same_result(got, want, label)

    rng = np.random.default_rng(71)

    def unit(n):
        x = rng.normal(size=(n, 128)).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    # (a) flat device mode: the e2e DB (CATH scale), Q 32, k 100, mincov 0.7
    e2e = FlatDB.open(e2e_db["prefix"])
    q32, qlen = unit(32), rng.integers(50, 401, 32)
    for prec in ("bf16", "int8"):
        one = SearchEngine(e2e, prec, "cuda")
        fn = lambda e: e.search(q32, 100, query_lens=qlen, mincov=0.7)  # noqa: E731
        want = fn(one)
        for name, mesh in meshes.items():
            m = SearchEngine(e2e, prec, "cuda", mesh=mesh)
            m.search(q32[:1], 100)                                      # residency
            label = f"flat_{prec}" + ("" if name == "one_card" else f"_{name}")
            ties = run_path(label, mesh, m, fn, want,
                            {"blockmax_scan": 1, "gather_block_scores": 1})
            ms, one_ms = call_ms([lambda: fn(m), lambda: fn(one)])
            out["flat"][label] = {"rows": e2e.size, "q": 32, "k": 100, "mincov": 0.7,
                                  "shards": len(mesh), "tied_entries": ties,
                                  "ms_a_call": ms, "one_device_ms_a_call": one_ms}
            if label == "flat_bf16":
                out["flat"][label]["profile"] = {"mesh": profile(lambda: fn(m)),
                                                 "one_device": profile(lambda: fn(one))}
        del one, m
    # (b) 2^24 rows bf16 (the stream phase's DB, 4 GiB: a TED superblock's
    # scale) resident on the shards, Q 256, k 100
    big = FlatDB.open(os.path.join(tmp, "stream", "db"))
    q256 = unit(256)
    one = SearchEngine(big, "bf16", "cuda")
    fn = lambda e: e.search(q256, 100)                                  # noqa: E731
    want = fn(one)
    m = SearchEngine(big, "bf16", "cuda", mesh=shards)
    m.search(q256[:1], 100)
    ties = run_path("flat16m_bf16", shards, m, fn, want,
                    {"blockmax_scan": 1, "gather_block_scores": 1})
    ms, one_ms = call_ms([lambda: fn(m), lambda: fn(one)], iters=3)
    out["flat"]["flat16m_bf16"] = {"rows": big.size, "q": 256, "k": 100, "shards": MESH_SHARDS,
                                   "tied_entries": ties, "ms_a_call": ms,
                                   "one_device_ms_a_call": one_ms}
    del one, m
    torch.cuda.empty_cache()
    # (c) stream mode over the same DB: a budget of a quarter GiB a device
    # streams it at both precisions on four shards too
    gb = N_BIG * 128 / 2 ** 33
    for prec in ("bf16", "int8"):
        kw = dict(max_device_gb=gb, stream_block=STREAM_BLOCK)
        one = SearchEngine(big, prec, "cuda", **kw)
        m = SearchEngine(big, prec, "cuda", mesh=shards, **kw)
        check(one.mode == m.mode == "stream", f"stream {prec}: not streamed")
        fn = lambda e: e.search(q32, 100)                               # noqa: E731
        want = fn(one)
        one_stats = dict(one.stream_stats)
        nsb = N_BIG // STREAM_BLOCK
        ties = run_path(f"stream_{prec}", shards, m, fn, want,
                        {"blockmax_scan": nsb, "gather_block_scores": nsb})
        check(m.stream_stats["superblocks"] == nsb, f"stream {prec}: superblocks")
        out["stream"][prec] = {"rows": N_BIG, "q": 32, "k": 100, "superblocks": nsb,
                               "tied_entries": ties, "stats": dict(m.stream_stats),
                               "rows_per_s": m.stream_stats["rows_per_s"],
                               "one_device_rows_per_s": one_stats["rows_per_s"]}
        del one, m
    # (d) IVF: the ivf phase's DB and cached layout (2^20 rows, nlist 1024,
    # duplicates), nprobe 32, Q 256, k 100
    idb, qi = FlatDB.open(ivf_db["prefix"]), ivf_db["q"]
    for prec, rerank in (("bf16", False), ("bf16", True), ("int8", False)):
        kw = dict(index="ivf", ivf_nlist=IVF_NLIST, ivf_nprobe=IVF_PROBE, ivf_rerank=rerank)
        one = SearchEngine(idb, prec, "cuda", **kw)
        fn = lambda e: e.search(qi, IVF_K)                              # noqa: E731
        want = fn(one)
        for name, mesh in meshes.items():
            m = SearchEngine(idb, prec, "cuda", mesh=mesh, **kw)
            m.search(qi[:1], IVF_K)
            check(one.ivf_build_s is None and m.ivf_build_s is None,
                  "a mesh IVF engine rebuilt the cached layout")
            check(all(sh["dup"] for sh in m._shards), "the IVF layout has no duplicates")
            label = f"ivf_{prec}" + ("_rerank" if rerank else "") + (
                "" if name == "one_card" else f"_{name}")
            ties = run_path(label, mesh, m, fn, want,
                            {"gather_block_scores_by_block": 2 if rerank else 1,
                             "gather_block_scores_by_block.f32": int(rerank),
                             "blockmax_scan": 0, "gather_block_scores": 0})
            ms, one_ms = call_ms([lambda: fn(m), lambda: fn(one)])
            out["ivf"][label] = {"rows": idb.size, "nlist": IVF_NLIST, "nprobe": IVF_PROBE,
                                 "q": len(qi), "k": IVF_K, "shards": len(mesh),
                                 "tied_entries": ties, "ms_a_call": ms,
                                 "one_device_ms_a_call": one_ms}
            if label == "ivf_bf16":
                out["ivf"][label]["profile"] = {"mesh": profile(lambda: fn(m)),
                                                "one_device": profile(lambda: fn(one))}
        del one, m
    torch.cuda.empty_cache()

    # (e) the data-parallel embed: MESH_EMBED structures of the createdb phase's DB
    built = FlatDB.open(os.path.join(tmp, "built", "db"))
    coords = [built.coords(i) for i in range(MESH_EMBED)]
    model = load_foldclass_params(None, dev)
    embed_structures(model, coords[:8], mesh=shards)                    # warm
    t = time.perf_counter()
    one_e = embed_structures(model, coords)
    one_s = time.perf_counter() - t
    t = time.perf_counter()
    mesh_e = embed_structures(model, coords, mesh=shards)
    mesh_s = time.perf_counter() - t
    err = float(np.abs(mesh_e - one_e).max())
    check(err <= 1e-4, f"the data-parallel embed differs from one device's by {err}")
    out["embed"] = {"structures": MESH_EMBED, "shards": MESH_SHARDS, "max_abs_err": err,
                    "seconds": mesh_s, "one_device_seconds": one_s}

    # (f) the CLI: --mesh 4 shrinks to the cards there are, with JAX's warning
    class Grab(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    grab = Grab()
    logging.getLogger("merizo_search_tpu_torch.device").addHandler(grab)
    cli_mesh = min(MESH_SHARDS, ncards)
    try:
        reset_counts()
        res = os.path.join(tmp, "res_mesh")
        cli.main(["search", *e2e_db["pdbs"], e2e_db["prefix"], res, "-k", "10", "-d", "cuda",
                  "--precision", "bf16", "--mmap_cov_filter", "--output_headers",
                  "--weights", e2e_db["weights"], "--mesh", str(MESH_SHARDS)])
        torch.cuda.synchronize()
        c = counts["cli_search"] = launch_counts()
        check(c["blockmax_scan"] == c["gather_block_scores"] == cli_mesh,
              f"search --mesh: launches {c}")
        with open(res + "_search.tsv") as a, open(os.path.join(tmp, "res_bf16_search.tsv")) as b:
            check(a.read() == b.read(), "search --mesh wrote another TSV than search")
        sub = os.path.join(tmp, "mesh_createdb_in")
        os.makedirs(sub)
        names = sorted(os.listdir(os.path.join(tmp, "createdb_in")))[:MESH_CREATEDB]
        for f in names:
            os.symlink(os.path.join(tmp, "createdb_in", f), os.path.join(sub, f))
        mprefix = os.path.join(tmp, "mesh_built", "db")
        t = time.perf_counter()
        cli.main(["createdb", sub, mprefix, "-d", "cuda", "--db_format", "mmap",
                  "--mesh", str(MESH_SHARDS)])
        cdb_s = time.perf_counter() - t
    finally:
        logging.getLogger("merizo_search_tpu_torch.device").removeHandler(grab)
    warn = (f"requested mesh of {MESH_SHARDS} devices but only {ncards} available; "
            f"using {ncards}")
    if ncards < MESH_SHARDS:
        check(grab.lines == [warn, warn], f"--mesh warnings: {grab.lines}")
    mdb = FlatDB.open(mprefix)
    want_names = [f[:-4] for f in names]
    check([mdb.name(i) for i in range(mdb.size)] == want_names, "createdb --mesh: entries")
    cerr = float(np.abs(np.asarray(mdb.embeddings())
                        - np.asarray(built.embeddings()[:MESH_CREATEDB])).max())
    check(cerr <= 1e-4, f"createdb --mesh embeddings differ from createdb's by {cerr}")
    used.update(torch.device("cuda", i) for i in range(cli_mesh))
    out["cli"] = {"mesh_flag": MESH_SHARDS, "devices": cli_mesh, "warnings": grab.lines,
                  "search_tsv_equal": True, "createdb_structures": MESH_CREATEDB,
                  "createdb_s": cdb_s, "createdb_max_abs_err": cerr}

    # (g) a service with the DB on four shards answers a burst of /search
    planted = e2e_db["planted"]
    qnames = sorted(planted)
    bodies = [{"coords": c.tolist(), "seq": "A" * len(c), "name": qn, "k": 10,
               "skip_tmalign": True} for qn, c in zip(qnames, e2e_db["qcoords"])]
    reset_counts()
    t = time.perf_counter()
    svc = srv.SearchService(e2e_db["prefix"], precision="bf16", weights=e2e_db["weights"],
                            device="cuda", mesh=shards)
    boot_s = time.perf_counter() - t
    httpd = srv.ThreadingHTTPServer(("127.0.0.1", 0), srv.make_handler(svc))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        serial = [http_json(base, "/search", b)[0] for b in bodies]
        res, lat, wall = burst(base, bodies)
        exact = sum(same_hits(g["hits"], w["hits"]) for g, w in zip(res, serial))
        for qn, r in zip(qnames, res):
            check(planted[qn] in [h["target"] for h in r["hits"]],
                  f"mesh service: {qn} misses its planted row")
    finally:
        httpd.shutdown()
        httpd.server_close()
    c = counts["serve"] = launch_counts()
    check(c["blockmax_scan"] > 0 and c["blockmax_scan"] % MESH_SHARDS == 0
          and c["gather_block_scores"] == c["blockmax_scan"], f"mesh service: launches {c}")
    out["serve"] = dict(rate(lat, wall), boot_s=boot_s, shards=MESH_SHARDS,
                        equal_to_serial_exactly=exact, requests_served=svc.n_requests)
    del svc
    torch.cuda.empty_cache()
    out["cards"] = len(used)
    return out, counts


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
            from merizo_search_tpu_torch.io import native_parse
            from merizo_search_tpu_torch.ops import _build

            t = time.perf_counter()
            _build.library()
            ph.notes.append(f"nvcc {time.perf_counter() - t:.2f} s")
            ptx = ptxas_report()
            if ptx is None:
                ph.notes.append(f"ptxas: {PTXAS_NOT_THIS_RUN}")
            else:
                ents = ptx["entries"]
                ph.notes.append(f"ptxas: {len(ents)} kernels, registers <= "
                                f"{max(r['registers'] for r in ents)}, spill bytes "
                                f"{sum(r['spill_stores'] + r['spill_loads'] for r in ents)}"
                                f", {len(ptx['warnings'])} warnings")
            t = time.perf_counter()
            native.load()
            check(native_parse.available(), "the native CA parser did not build")
            ph.notes.append(f"g++ {time.perf_counter() - t:.2f} s")

        gen = torch.Generator(device=dev).manual_seed(0)
        flush = _bench_util.flush_buffer(dev)
        with Phase("kernels") as ph:
            big = big_dbs(gen, dev)
            bm_modes, g_modes, cover, sel_modes = kernels_phase(dev, gen, flush, big)
            ph.notes.append(f"{len(bm_modes)} phase-A and {len(g_modes)} phase-C configurations; "
                            f"cover invariant exact in {len(cover)} configurations, "
                            f"{sum(r['compared'] for r in cover)} blocks")
            for r in sel_modes:
                ph.notes.append(f"select Q={r['q']} NB={r['nb']} k={r['k']}: {r['ms']:.4f} ms "
                                f"(torch.topk {r['library_ms']:.4f}, bound {r['bound_ms']:.4f})")

        with Phase("fused") as ph:
            rec = fused_phase(dev, gen)
            ph.notes.append(f"recall@100 {rec}")

        with Phase("e2e") as ph:
            runs, launches, e2e_db = e2e_phase(dev, tmp)
            for prec, r in runs.items():
                ph.notes.append(f"{prec}: " + ", ".join(f"{k} {v:.3f} s"
                                                         for k, v in r["phase_s"].items()))

        with Phase("pipelined") as ph:
            pipe_tool, pipe_counts, bmg_modes = pipelined_phase(dev, gen, flush, big)
            for r in pipe_tool["runs"]:
                ph.notes.append(f"{r['dtype']} Q={r['q']}: exact, sequential "
                                f"{r['seq_ms']:.3f} / pipelined {r['pipe_ms']:.3f} ms a batch")
            for r in bmg_modes:
                ph.notes.append(f"bm_gather {r['dtype']} N={r['n']} Q={r['q']} {r['selection']}: "
                                f"{r['ms']:.4f} ms (two launches {r['sequential_kernels_ms']:.4f}, "
                                f"phase A alone {r['fused_phase_a_only_ms']:.4f}, inversion "
                                f"{r['inversion_ms']:.4f}, bound {r['bound_ms']:.4f})")

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

        with Phase("createdb") as ph:
            cdb, cdb_counts = createdb_phase(dev, tmp)
            idle = cdb["embed_profile"]["idle_share"]
            ph.notes.append(f"{cdb['structures']} structures in {cdb['build_s']:.2f} s "
                            f"({cdb['structures_per_s']:.1f}/s): " + ", ".join(
                                f"{k} {v:.3f} s" for k, v in cdb["phase_s"].items())
                            + "; card idle in embed: "
                            + ("not measured" if idle is None else f"{idle:.3f}"))

        with Phase("segment") as ph:
            seg = segment_phase(dev, tmp)
            ph.notes.append(f"{seg['residues_per_s']:.1f} residues/s; " + ", ".join(
                f"{k} {seg['chain_s'][k]:.3f} s" for k in
                [f"len{n}" for n in SEGMENT_LENGTHS + (SEGMENT_BIG,)]) +
                f"; peak {seg['peak_mem_gib'][f'len{SEGMENT_BIG}']:.2f} GiB at {SEGMENT_BIG}"
                f"; card idle in one forward at {SEGMENT_PROFILED}: " + (
                    "not measured" if seg["forward_profile"]["idle_share"] is None
                    else f"{seg['forward_profile']['idle_share']:.3f}"))
            bt = seg["batched"]
            fp, full, rps = bt["forward_profile"], bt["full_batch_1536"], bt["residues_per_s"]
            ph.notes.append(
                "16 chains: batched " + " / ".join(f"{r:.1f}" for r in rps["batched"])
                + ", one a forward " + " / ".join(f"{r:.1f}" for r in rps["one_a_forward"])
                + " residues/s; card idle in a batched forward of "
                + f"{fp['batched']['chains']}: " + ", one chain of it: ".join(
                    "not measured" if p["idle_share"] is None else f"{p['idle_share']:.3f}"
                    for p in (fp["batched"], fp["one_chain"]))
                + f"; {full['chains']} chains at 1536: {full['seconds']:.2f} s, "
                f"peak {full['peak_mem_gib']:.2f} GiB")

        with Phase("stream") as ph:
            stream, stream_counts = stream_phase(dev, tmp, e2e_db)
            for prec, r in stream["runs"].items():
                sr, pp = r["stream"], r["profiled_pass"]
                ph.notes.append(
                    f"{prec}: {sr['rows_per_s']:.4g} rows/s ({sr['superblocks']} superblocks, "
                    f"page cache hot), staging {sr['stage_thread_s']:.3f} thread-s, copies "
                    f"{sr['copy_s']:.3f} s, scan span {sr['scan_s']:.3f} s; card idle " + (
                        "not measured" if pp["idle_share"] is None
                        else f"{pp['idle_share']:.3f}") + f" of a pass ({pp['wall_s']:.3f} s; "
                    f"kernels {pp['kernels_s']:.4f} s, copies {pp['copy_engine_s']:.4f} s)")

        with Phase("easy_search") as ph:
            easy, easy_counts = easy_search_phase(dev, tmp)
            for label, r in easy["runs"].items():
                ph.notes.append(f"{label}: {r['wall_s']:.2f} s (" + ", ".join(
                    f"{k} {v:.3f}" for k, v in r["phase_s"].items()) + f"), launches "
                    f"A {r['launches']['blockmax_scan']} C {r['launches']['gather_block_scores']}")

        with Phase("ivf") as ph:
            ivf_out, ivf_counts, ivf_rows, bb_rows, ivf_db = ivf_phase(dev, tmp, e2e_db, flush)
            g_modes += ivf_rows
            cfg = ivf_out["curve"]
            ph.notes.append(f"build {cfg['build_s']:.2f} s (" + ", ".join(
                f"{k} {v:.2f}" for k, v in cfg["build_split_s"].items()) + ")")
            for p in cfg["points"]:
                if p["nprobe"] in (8, 32, 128):
                    ph.notes.append(f"{p['dtype']} nprobe {p['nprobe']}: recall "
                                    f"{p['recall_at_100']:.4f} / rerank "
                                    f"{p['rerank_recall_at_100']:.4f}, {p['qps']:.0f} / "
                                    f"{p['rerank_qps']:.0f} q/s")
            ss = ivf_out["stream"]
            ph.notes.append(f"stream: {ss['stats']['staged_share']:.3f} of the layout staged, "
                            f"{ss['seconds_a_batch']:.3f} s a batch, recall {ss['recall']:.4f}")
            for r in bb_rows:
                ph.notes.append(f"{r['dtype']} phase C block-major {r['ms']:.4f} ms (inversion "
                                f"{r['invert_ms']:.4f}), per-query {r['per_query_ms']:.4f} "
                                f"(bound {r['bound_ms']:.4f})")

        with Phase("tmalign") as ph:
            tm_out = tmalign_phase(dev)
            for r in tm_out["throughput"]:
                ph.notes.append(f"b={r['bucket']} {r['pairs']} pairs: device "
                                f"{r['device_pairs_per_s']:.1f} / native "
                                f"{r['native_pairs_per_s']:.1f} pairs/s")
            pr = tm_out["profile"]
            ph.notes.append(f"b=256 chunk: {pr['device_events']} device events, busy " + (
                "not measured" if pr["busy_share"] is None else f"{pr['busy_share']:.3f}"))

        with Phase("serve") as ph:
            serve_out, serve_counts = serve_phase(dev, tmp, e2e_db, runs)
            for k, r in serve_out["bursts"].items():
                ph.notes.append(f"{k}: {r['requests_per_s']:.2f} req/s, p50 {r['p50_s']:.3f} s, "
                                f"p99 {r['p99_s']:.3f} s")
            ph.notes.append(f"search --tmalign_backend tpu: tmalign_rescore "
                            f"{serve_out['cli_tpu']['tmalign_rescore_s']:.3f} s (native "
                            f"{serve_out['cli_tpu']['native_tmalign_rescore_s']:.3f} s)")

        with Phase("mesh") as ph:
            mesh_out, mesh_counts = mesh_phase(dev, tmp, e2e_db, ivf_db)
            for part in ("flat", "ivf"):
                for k, r in mesh_out[part].items():
                    ph.notes.append(f"{k}: {r['ms_a_call']:.3f} ms a call on {r['shards']} "
                                    f"shards, {r['one_device_ms_a_call']:.3f} on one")
            for k, r in mesh_out["stream"].items():
                ph.notes.append(f"stream {k}: {r['rows_per_s']:.4g} rows/s on "
                                f"{MESH_SHARDS} shards, {r['one_device_rows_per_s']:.4g} on one")
            e = mesh_out["embed"]
            ph.notes.append(f"embed of {MESH_EMBED}: {e['seconds']:.2f} s on {MESH_SHARDS} shards, "
                            f"{e['one_device_seconds']:.2f} on one; cards {mesh_out['cards']}")

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

        from merizo_search_tpu_torch.ops import blockmax as bmx
        from merizo_search_tpu_torch.ops import gather as gth
        from merizo_search_tpu_torch.ops import pipelined as pip

        dtypes = {"bf16": torch.bfloat16, "int8": torch.int8}
        # the tile width N each batch gets, and the stages and the dynamic
        # shared memory of each (dtype, N) of phase A's walk and of phase C,
        # as the launchers ask for them (read from the built library)
        walk_geom = {"tile_width": {q: bmx.tile_width(q) for q in (1, 32, 33, 64, 128, 256, 300)},
                     "stages": {k: bmx.walk_layout(d, 32)["stages"] for k, d in dtypes.items()},
                     "dynamic_smem": {f"{k} N={n}": bmx.walk_layout(d, n)["launch"]
                                      for k, d in dtypes.items() for n in bmx.TILE_WIDTHS}}
        gather_geom = {"columns_a_cta": 1,
                       "dynamic_smem": {k: gth.gather_layout(d)["launch"]
                                        for k, d in dtypes.items()}}
        kernels = [
            entry("blockmax_scan", "merizo_search_tpu_torch/csrc/blockmax.cu",
                  "merizo_search_tpu/ops/pallas_scan.py:65", bm_modes,
                  {"dtype": "bf16", "q": 32, "mask": True, "n": -(-N_MAIN // 128) * 128},
                  launches["blockmax_scan"] + sum(c["blockmax_scan"] for c in ivf_counts.values())
                  + serve_counts["blockmax_scan"]
                  + sum(c["blockmax_scan"] for c in mesh_counts.values()),
                  cover=cover, geometry=walk_geom,
                  ptxas=ptxas_rows(ptx, "blockmax_kernel"), launches_by_path={
                      "search": launches["blockmax_scan"],
                      "serve": serve_counts["blockmax_scan"],
                      **{f"ivf_{k}": c["blockmax_scan"] for k, c in ivf_counts.items()},
                      **{f"mesh_{k}": c["blockmax_scan"] for k, c in mesh_counts.items()
                         if not k.startswith("ivf")}}),
            entry("gather_block_scores", "merizo_search_tpu_torch/csrc/gather.cu",
                  "merizo_search_tpu/ops/pallas_scan.py:644", g_modes,
                  {"dtype": "bf16", "q": 32, "n": -(-N_MAIN // 128) * 128},
                  launches["gather_block_scores"]
                  + sum(c["gather_block_scores"] for c in ivf_counts.values())
                  + serve_counts["gather_block_scores"]
                  + sum(c["gather_block_scores"] for c in mesh_counts.values()),
                  also_replaces="merizo_search_tpu/ops/pallas_scan.py:847 (row_scales mode)",
                  geometry=gather_geom, ptxas=ptxas_rows(ptx, "gather_kernel", "gather_kernel_f32"),
                  launches_by_path={
                      "search": launches["gather_block_scores"],
                      "serve": serve_counts["gather_block_scores"],
                      **{f"ivf_{k}": c["gather_block_scores"] for k, c in ivf_counts.items()},
                      **{f"ivf_{k}_by_block": c["gather_block_scores_by_block"]
                         for k, c in ivf_counts.items()},
                      "ivf_device_by_block_f32": ivf_counts["device"][
                          "gather_block_scores_by_block.f32"],
                      **{f"mesh_{k}": c["gather_block_scores"] for k, c in mesh_counts.items()
                         if not k.startswith("ivf")},
                      **{f"mesh_{k}_by_block": c["gather_block_scores_by_block"]
                         for k, c in mesh_counts.items() if k.startswith("ivf")}},
                  f32_mode={k: ivf_rows[1][k] for k in ("ms", "plain_ms", "bound_ms",
                                                        "bound_by", "max_abs_err", "q", "kb")},
                  by_block=bb_rows),
            entry("gather_block_scores_by_block", "merizo_search_tpu_torch/csrc/gather.cu",
                  "merizo_search_tpu/ops/pallas_scan.py:644", bb_rows, {"dtype": "bf16"},
                  sum(c["gather_block_scores_by_block"] for c in ivf_counts.values())
                  + sum(c["gather_block_scores_by_block"] for c in mesh_counts.values()),
                  kernels="inversion bb_count, bb_alloc (gather.cu); CTA bodies "
                          "gather_by_block, gather_by_block_f32 (gather.cuh)",
                  ptxas=ptxas_rows(ptx, "gather_by_block_kernel", "gather_by_block_kernel_f32",
                                   "bb_count", "bb_alloc"),
                  also_replaces="merizo_search_tpu/ops/pallas_scan.py:847 (row_scales mode: "
                                "the IVF's int8 probe)",
                  launches_by_path={
                      **{f"ivf_{k}": c["gather_block_scores_by_block"]
                         for k, c in ivf_counts.items()},
                      "ivf_device_f32_mode": ivf_counts["device"][
                          "gather_block_scores_by_block.f32"],
                      **{f"mesh_{k}": c["gather_block_scores_by_block"]
                         for k, c in mesh_counts.items() if k.startswith("ivf")},
                      **{f"mesh_{k}_f32_mode": c["gather_block_scores_by_block.f32"]
                         for k, c in mesh_counts.items() if "rerank" in k}},
                  yardstick="per_query_ms: gather_block_scores on the same inputs, timed in "
                            "turns; equal to it bit for bit"),
            entry("select_blocks", "merizo_search_tpu_torch/csrc/select.cu",
                  "none: the JAX package left phase B to XLA (merizo_search_tpu/ops/"
                  "pallas_scan.py _select_blocks, _topk_finite)", sel_modes,
                  {"q": 256, "nb": 356_441, "k": 100},
                  launches["select_blocks"] + serve_counts["select_blocks"]
                  + sum(c["select_blocks"] for c in mesh_counts.values()),
                  launches_by_path={
                      "search": launches["select_blocks"],
                      "serve": serve_counts["select_blocks"],
                      **{f"mesh_{k}": c["select_blocks"] for k, c in mesh_counts.items()
                         if not k.startswith("ivf")}},
                  ptxas=ptxas_rows(ptx, "select_level", "sort_tile", "sort_step", "sort_out",
                                   "scales_of"),
                  yardstick="library_ms: torch.topk over the same block maxima (the port "
                            "never calls it in phase B)"),
            entry("blockmax_scan_gather", "merizo_search_tpu_torch/csrc/bm_gather.cu",
                  "merizo_search_tpu/ops/pallas_scan.py:1014", bmg_modes,
                  {"dtype": "bf16", "q": 256, "n": N_BIG, "selection": "top"},
                  pipe_counts["blockmax_scan_gather"],
                  inversion_launches=pipe_counts["blockmax_scan_gather.inversion"],
                  kernels="bm_gather_kernel (phase A's walk, csrc/blockmax.cuh walk_blocks, "
                          "scoring the previous selection on its ring slots); inversion "
                          "bb_count, bb_alloc (gather.cu), bb_gather_rows (bm_gather.cu)",
                  per_batch_ms={f"{r['dtype']} Q={r['q']}": {
                      "sequential": r["seq_ms"], "pipelined": r["pipe_ms"]}
                      for r in pipe_tool["runs"]},
                  geometry={**walk_geom, "dynamic_smem": {
                      f"{k} N={n}": pip.bm_gather_layout(d, n)["launch"]
                      for k, d in dtypes.items() for n in bmx.TILE_WIDTHS}},
                  ptxas=ptxas_rows(ptx, "bm_gather_kernel", "bb_gather_rows"),
                  yardstick="sequential_kernels_ms: phase A then phase C (int8: with the "
                            "carried block scales), two launches, same inputs; "
                            "fused_phase_a_only_ms: this kernel with an empty previous "
                            "selection; inversion_ms: invert_previous alone (inside ms)"),
            entry("mini_scan", "merizo_search_tpu_torch/csrc/probes.cu (phase A's walk, "
                  "csrc/blockmax.cuh walk_blocks: TMA ring, every score from "
                  "csrc/scan_common.cuh score_issue, wgmma)",
                  "tools/perf_floor2.py:32", mini_modes,
                  {"dtype": "bf16", "mode": "reduce"}, probe_counts["mini_scan"],
                  geometry=walk_geom, ptxas=ptxas_rows(ptx, "mini_scan_kernel"),
                  also_replaces="tools/perf_int8_floor.py:37 (tile 32768, int8)"),
            entry("stream_probe", "merizo_search_tpu_torch/csrc/probes.cu",
                  "tools/perf_hbm.py:37", stream_modes, {"d": 128, "tile": 65536},
                  probe_counts["stream_probe"], ptxas=ptxas_rows(ptx, "stream_probe_kernel"),
                  yardstick="torch_sum_ms: x.sum(dtype=torch.int32) over the same bytes"),
            entry("slab_scan", "merizo_search_tpu_torch/csrc/slab_interleave.cu",
                  "tools/perf_slab_interleave.py:38", slab_modes,
                  {"dtype": "bf16", "tile": 32768, "nslab": 2, "sbm": True},
                  var_counts["slab_scan"], geometry=walk_geom,
                  ptxas=ptxas_rows(ptx, "slab_scan_kernel"),
                  yardstick="baseline_blockmax_ms: blockmax_scan with the length channel "
                            "off, same inputs (the JAX tool's baseline)"),
            entry("gather_variant", "merizo_search_tpu_torch/csrc/gather_variants.cu",
                  "tools/perf_gather_int8.py:80",
                  [m for m in gvar_modes if m["mode"] != "int32view"],
                  {"dtype": "int8", "mode": "full"},
                  sum(var_counts[f"gather_variant.{m}"]
                      for m in ("dma_only", "concat_only", "full")),
                  geometry=gather_geom, ptxas=ptxas_rows(ptx, "gather_variant_kernel"),
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
                                            "probes": probe_counts, "variants": var_counts,
                                            "createdb_search": cdb_counts,
                                            **{f"stream_{k}": v for k, v in stream_counts.items()},
                                            **{f"easy_search_{k}": v
                                               for k, v in easy_counts.items()},
                                            **{f"ivf_{k}": v for k, v in ivf_counts.items()},
                                            "serve": serve_counts,
                                            **{f"mesh_{k}": v for k, v in mesh_counts.items()}},
                          "total_s": round(time.perf_counter() - T0, 2)}), flush=True)
        print(json.dumps({"createdb": cdb, "segment": seg}), flush=True)
        print(json.dumps({"stream": stream, "easy_search": easy}), flush=True)
        print(json.dumps({"phase_a_split": splits}), flush=True)
        print(json.dumps({"ivf": ivf_out}), flush=True)
        print(json.dumps({"tmalign": tm_out, "serve": serve_out}), flush=True)
        print(json.dumps({"mesh": mesh_out}), flush=True)
        print(smi, flush=True)
        print(json.dumps({"kernels": kernels}), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}),
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
