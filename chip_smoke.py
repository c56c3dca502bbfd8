"""Chip smoke test of the PyTorch/CUDA port: `python3 chip_smoke.py` on one H100.

Drives the port's main path (the `search` verb) on the card and checks it:

1. device   the card's name and power limit (nvidia-smi) and torch's name;
2. build    nvcc for the scan kernels (csrc/*.cu), g++ for TM-align, timed;
3. kernels  phase A (blockmax_scan) and phase C (gather_block_scores, all
            three scale modes) against their plain PyTorch versions on the
            card at N = 500,000 rows (Q = 32 and 256, bf16 and int8, length
            mask on and off), then timed there and at the 16M-row scan shape;
4. fused    fused_topk against the plain exact scan: recall@100 = 1.0 at
            N = 500,000, Q = 256, k = 100 (scores within 1e-5 are ties);
5. e2e      the `search` CLI on a 500,000-entry mmap DB with an int8 sidecar
            and 32 query PDBs, at bf16 and int8: every query's planted row
            is its rank-1 hit with TM-score >= 0.9, and both kernels'
            launch counters rose during these runs.

Prints one line per phase with its seconds, the nvidia-smi line, a JSON line
{"kernels": [...]}, and as its last line {"ok": true, "device": {...}}.
Any failed check, build, launch or phase deadline raises and exits non-zero;
with no CUDA device it exits non-zero before printing any result. Scratch
files live in a temporary directory outside the checkout and are removed.
"""

from __future__ import annotations

import faulthandler
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
TOTAL_BUDGET_S = 300       # hard watchdog: dump stacks and exit(1) past this
# per-phase deadlines, a few times each phase's measured seconds
PHASE_BUDGET_S = {"device": 30, "build": 60, "kernels": 60, "fused": 30, "e2e": 90}
HBM_BPS = 3.35e12          # H100 SXM memory bandwidth (bytes/s)
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}   # dense tensor-core peaks (op/s)
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
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def bound(nbytes, ops, dtype):
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want, exact):
    """Max |got - want| over entries that are not sentinels; the sentinel
    pattern and (for int8) every value must agree exactly."""
    from merizo_search_tpu_torch.ops.blockmax import NEG_CAP

    gm, wm = got <= NEG_CAP, want <= NEG_CAP
    check(torch.equal(gm, wm), "kernel and plain versions disagree on masked entries")
    err = (got[~wm] - want[~wm]).abs().max().item() if (~wm).any() else 0.0
    check(err <= (0.0 if exact else BF16_TOL), f"kernel deviates from plain by {err}")
    return err


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


def kernels_phase(dev, gen, flush):
    """Hold both kernels against their plain versions, then time them."""
    from merizo_search_tpu_torch.ops import blockmax, gather
    from merizo_search_tpu_torch.ops.fused_scan import select_blocks

    bm_modes, g_modes = [], []
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
                                        "bound_by": gb_by, "library_ms": None})
    del p
    torch.cuda.empty_cache()
    # the 16M-row scan shape, Q = 256: kernel times and bounds only
    q16 = unit_rows(256, gen, dev)
    for dtype in ("bf16", "int8"):
        if dtype == "bf16":
            db = torch.randn((N_BIG, 128), generator=gen, device=dev, dtype=torch.bfloat16)
            q, sc = q16.to(torch.bfloat16), None
        else:
            db = torch.randint(-127, 128, (N_BIG, 128), generator=gen, device=dev,
                               dtype=torch.int8)
            q = torch.randint(-127, 128, (256, 128), generator=gen, device=dev,
                              dtype=torch.int8)
            sc = (torch.rand(N_BIG // 128, generator=gen, device=dev) * 0.01 + 1e-3
                  ).repeat_interleave(128)
        isz, nb = db.element_size(), N_BIG // 128
        bm = blockmax.blockmax_scan(q, db, N_BIG, scales=sc)
        ms = time_ms(lambda: blockmax.blockmax_scan(q, db, N_BIG, scales=sc), 5, flush)
        b_ms, b_by = bound(N_BIG * 128 * isz + 256 * 128 * isz + 256 * nb * 4
                           + (nb * 4 if sc is not None else 0),
                           2 * 256 * N_BIG * 128, dtype)
        lib = time_ms(lambda: library_product(q, db), 3, flush)
        bm_modes.append({"dtype": dtype, "n": N_BIG, "q": 256, "mask": False,
                         "max_abs_err": None, "ms": ms, "plain_ms": None,
                         "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib})
        bidx = select_blocks(bm, N_BIG, 100)
        kw = {} if sc is None else {"scale_sel": torch.where(
            bidx >= 0, sc[bidx.clamp(min=0).long() * 128], 1.0).contiguous()}
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
        del db, bm
        torch.cuda.empty_cache()
    return bm_modes, g_modes


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

    blockmax.launches = gather.launches = 0        # main path starts here
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
    launches = {"blockmax_scan": blockmax.launches, "gather_block_scores": gather.launches}
    return runs, launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        sys.exit(2)
    import merizo_search_tpu_torch  # noqa: F401  (fails fast outside a checkout)

    faulthandler.enable()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        with Phase("device") as ph:
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True, timeout=30, check=True).stdout.strip()
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
        flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
        with Phase("kernels") as ph:
            bm_modes, g_modes = kernels_phase(dev, gen, flush)
            ph.notes.append(f"{len(bm_modes)} phase-A and {len(g_modes)} phase-C configurations")

        with Phase("fused") as ph:
            rec = fused_phase(dev, gen)
            ph.notes.append(f"recall@100 {rec}")

        with Phase("e2e") as ph:
            runs, launches = e2e_phase(dev, tmp)
            for prec, r in runs.items():
                ph.notes.append(f"{prec}: " + ", ".join(f"{k} {v:.3f} s"
                                                         for k, v in r["phase_s"].items()))

        def entry(name, source, replaces, modes, main, launched, **extra):
            """One kernel: top-level numbers are those of the configuration
            the e2e bf16 run gives it (Q = 32, N = 500,096, mask on); every
            measured configuration is under `modes`."""
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
                  launches["blockmax_scan"]),
            entry("gather_block_scores", "merizo_search_tpu_torch/csrc/gather.cu",
                  "merizo_search_tpu/ops/pallas_scan.py:644", g_modes,
                  {"dtype": "bf16", "q": 32, "n": -(-N_MAIN // 128) * 128},
                  launches["gather_block_scores"],
                  also_replaces="merizo_search_tpu/ops/pallas_scan.py:847 (row_scales mode)"),
        ]
        print(json.dumps({"e2e": runs, "fused_recall_at_100": rec,
                          "total_s": round(time.perf_counter() - T0, 2)}), flush=True)
        print(smi, flush=True)
        print(json.dumps({"kernels": kernels}), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}),
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
