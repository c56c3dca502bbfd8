"""The cover invariant of the fused scan, and phase A's launch geometry.

The fused scan is exact because phase A's block max is the maximum of the
very floats phase C computes for that block's rows (ops/fused_scan.py).
Here the plain versions, which the CPU runs, are held to that invariant:
phase B's selection from `blockmax_plain`'s BM, rescored by `gather_plain`,
must give back BM exactly for every selected block wholly below n_valid
(`cover_check`). Both plain versions round one float64 score to float32, so
the invariant is exact; the card's kernels are held to it in
tests/test_torch_kernels_gpu.py. Inputs are made with numpy from a seed.
"""

import os
import re

import numpy as np
import pytest
import torch

from merizo_search_tpu_torch.ops import blockmax, gather, topk
from merizo_search_tpu_torch.ops.fused_scan import cover_check, select_blocks, selected_scales


def _problem(dtype, nq, n=3000, seed=21):
    """Unit rows, n_valid = n ending mid-block (3000 = 23 * 128 + 56), and
    a length channel that masks about half the rows of each query."""
    rng = np.random.default_rng(seed)
    npad = -(-n // 128) * 128
    db = np.zeros((npad, 128), np.float32)
    db[:n] = rng.normal(size=(n, 128))
    db[:n] /= np.linalg.norm(db[:n], axis=1, keepdims=True)
    q = rng.normal(size=(nq, 128)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    tl = np.full(npad, 1e9, np.float32)
    tl[:n] = rng.uniform(50, 300, n).astype(np.float32) * np.float32(0.7)
    qcap = rng.uniform(50, 300, nq).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    if dtype == "int8":
        db8, sc = topk.quantize_blocks(db)
        q8, _ = topk.quantize_rows(q)
        return n, t(q8), t(db8), t(sc), t(tl), t(qcap)
    return n, t(q).to(torch.bfloat16), t(db).to(torch.bfloat16), None, t(tl), t(qcap)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("use_len", [False, True])
@pytest.mark.parametrize("nq", [1, 7, 33])
def test_cover_invariant_on_plain_versions(dtype, use_len, nq):
    n, q, db, sc, tl, qcap = _problem(dtype, nq)
    lk = (tl, qcap) if use_len else (None, None)
    bm = blockmax.blockmax_plain(q, db, n, *lk, sc)
    bidx = select_blocks(bm, n, 10)
    assert int(bidx[:, -1].min()) == n // 128          # the straddling block is in
    kw = {} if sc is None else {"scale_sel": selected_scales(sc, bidx)}
    scores = gather.gather_plain(q, db, bidx, n, *lk, **kw)
    compared, differ = cover_check(bm, scores, bidx, n)
    assert compared >= nq * 10 and differ == 0


def test_cover_check_counts_a_broken_cover():
    """One compared block of one query whose phase-C scores all sit one
    float above the ones phase A saw: exactly that column differs."""
    n, q, db, sc, tl, qcap = _problem("bf16", 7)
    bm = blockmax.blockmax_plain(q, db, n, tl, qcap)
    bidx = select_blocks(bm, n, 10)
    scores = gather.gather_plain(q, db, bidx, n, tl, qcap)
    compared, differ = cover_check(bm, scores, bidx, n)
    assert differ == 0
    kept = scores[3, :128] > -3.0e38                   # column 0: query 3's best block
    assert int(bidx[3, 0]) >= 0 and kept.any()
    scores[3, :128] = torch.where(kept, torch.nextafter(scores[3, :128],
                                                        torch.tensor(2.0)), scores[3, :128])
    assert cover_check(bm, scores, bidx, n) == (compared, 1)


@pytest.mark.parametrize("nq, n", [(1, 32), (7, 32), (32, 32), (33, 64), (64, 64),
                                   (65, 128), (128, 128), (129, 256), (256, 256), (300, 256)])
def test_query_groups(nq, n):
    """Phase A's query tile width: the least of 32, 64, 128, 256 that holds
    the batch (a batch above 256 takes several tiles of 256)."""
    assert blockmax.tile_width(nq) == n


@pytest.mark.parametrize("nq, nb, sms, want", [
    (32, 3907, 132, (32, 30)),            # the search path's shape: 131 CTAs
    (256, 131072, 132, (256, 993)),       # 2^24 rows, Q 256: one CTA an SM
    (256, 131072, 114, (256, 1150)),      # a card of 114 SMs
    (300, 131072, 132, (256, 1986)),      # two query tiles share the grid
    (7, 157, 132, (32, 2)),               # fewer blocks than SMs: 79 CTAs
    (5000, 100, 132, (256, 17)),          # 20 query tiles, 6 chunks each
    (80000, 100, 132, (256, 100)),        # more query tiles than SMs: waves
])
def test_phase_a_geometry(nq, nb, sms, want):
    n, bpc = blockmax.phase_a_geometry(nq, nb, sms)
    assert (n, bpc) == want
    qtiles = -(-nq // n)
    chunks = -(-nb // bpc)
    assert chunks * bpc >= nb > (chunks - 1) * bpc       # every block, once
    assert qtiles * chunks <= max(sms, qtiles)           # one CTA an SM at most


CSRC = os.path.join(os.path.dirname(blockmax.__file__), os.pardir, "csrc")
SMEM_CTA = 232_448     # an H100 CTA's most dynamic shared memory (227 KB)
SMEM_SM = 233_472      # an H100 SM's shared memory (228 KB), 1 KB of each CTA the system's
_DT = {torch.bfloat16: ("Bf16", 2), torch.int8: ("Int8", 1)}


def _headers():
    text = "".join(open(os.path.join(CSRC, f)).read()
                   for f in ("scan_common.cuh", "blockmax.cuh", "gather.cuh", "bm_gather.cu"))
    return re.sub(r"//[^\n]*", "", text)


def cuda_layout(struct, dtype, **params):
    """The `static constexpr int` members of `struct` in the kernels'
    headers (csrc/*.cuh), evaluated as nvcc builds them for T = the dtype's
    struct and the template's int parameters (N=...): the layout the
    launchers ask for, read from the source and not from a copy of it."""
    src = _headers()

    def members(name):
        body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
        return dict(re.findall(r"static constexpr int (\w+) = ([^;]+);", body))

    consts = dict(re.findall(r"^constexpr int (\w+) = ([^;]+);", src, re.M))
    tname, in_bytes = _DT[dtype]
    t_members, slot = members(tname), members("Slot")

    def ev(expr, local):
        e = expr.replace("(int)sizeof(typename T::In)", str(in_bytes))
        e = e.replace("(int)sizeof(BBMeta)", "12")            # BBMeta: an int and two floats
        e = re.sub(r"Slot<T>::(\w+)", lambda m: str(ev(slot[m.group(1)], slot)), e)
        e = re.sub(r"(\w+)<T, N>::(\w+)",
                   lambda m: str(cuda_layout(m.group(1), dtype, **params)[m.group(2)]), e)
        e = re.sub(r"T::(\w+)", lambda m: str(ev(t_members[m.group(1)], t_members)), e)
        e = e.replace("/", "//")
        env = {}
        for name in set(re.findall(r"\b[A-Za-z_]\w*\b", e)) - {"round_up"}:
            env[name] = (params[name] if name in params else ev(local[name], local)
                         if name in local else ev(consts[name], {}))
        return eval(e, {"round_up": lambda x, a: -(-x // a) * a}, env)

    own = members(struct)
    return {k: ev(v, own) for k, v in own.items()}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("n", blockmax.TILE_WIDTHS)
def test_walk_smem_fits_one_cta_and_aligns_the_slots(dtype, n):
    """Phase A's shared memory (csrc/blockmax.cuh WalkSmem) at every (dtype,
    tile width, stages): under the 227 KB a CTA may use, the ring's slots
    and the query tile's atom columns on the 1024-byte swizzle period, the
    bulk copies' targets on 16 bytes and the mbarriers on 8."""
    lay, slot = cuda_layout("WalkSmem", dtype, N=n), cuda_layout("Slot", dtype)
    assert lay["LAUNCH"] <= SMEM_CTA
    assert lay["S"] >= 4 and lay["QT"] == lay["S"] * slot["BYTES"]
    assert slot["BYTES"] % 1024 == 0 and lay["QT"] % 1024 == 0 and n * 128 % 1024 == 0
    assert lay["TL"] % 16 == 0 and lay["QCAP"] % 16 == 0 and lay["BAR"] % 8 == 0
    assert lay["BYTES"] == lay["BAR"] + 16 * lay["S"] == lay["LAUNCH"] - 1024


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("n", blockmax.TILE_WIDTHS)
def test_bm_gather_smem_fits_one_cta(dtype, n):
    """The pipelined kernel's shared memory (csrc/bm_gather.cu
    BmGatherSmem): phase A's WalkSmem unchanged at its start, then a
    16-row B tile a consumer on the swizzle period, the pass entries and
    the ring's 48-byte offset windows on 16 bytes (bulk copies), all under
    the 227 KB of one CTA at every tile width, N = 256 included."""
    lay, walk = cuda_layout("BmGatherSmem", dtype, N=n), cuda_layout("WalkSmem", dtype, N=n)
    row_bytes = cuda_layout("Slot", dtype)["ROWB"]
    assert lay["BT"] >= walk["BYTES"] and lay["BT"] % 1024 == 0
    assert lay["META"] == lay["BT"] + 2 * 16 * row_bytes and (16 * 128) % 1024 == 0
    assert lay["WIN"] % 16 == 0 and lay["BYTES"] == lay["WIN"] + walk["S"] * 48
    assert lay["LAUNCH"] == lay["BYTES"] + 1024 <= SMEM_CTA
    if dtype == torch.bfloat16 and n == 256:
        assert lay["LAUNCH"] == 226_752


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_phase_c_smem_fits_six_ctas_an_sm(dtype):
    """Phase C's per-query CTA (csrc/gather.cuh GatherSmem: one warpgroup,
    one selected column): six fit an SM, so a batch's columns wait on their
    reads together; its slot on the swizzle period, its barrier on 8."""
    lay = cuda_layout("GatherSmem", dtype)
    assert 6 * (lay["LAUNCH"] + 1024) <= SMEM_SM
    assert lay["BT"] % 1024 == 0 and lay["TL"] % 16 == 0 and lay["BAR"] % 8 == 0
    assert lay["BYTES"] == lay["BAR"] + 8 == lay["LAUNCH"] - 1024


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_block_major_smem_fits_its_launch_bound(dtype):
    """The block-major phase-C CTA (csrc/gather.cuh ByBlockSmem): as many
    fit an SM as its kernel's launch bound (BB_CTAS) promises ptxas."""
    lay = cuda_layout("ByBlockSmem", dtype)
    ctas = re.search(r"BB_CTAS = T::IS_INT \? (\d+) : (\d+);", _headers()).groups()
    assert int(ctas[0 if dtype == torch.int8 else 1]) * (lay["LAUNCH"] + 1024) <= SMEM_SM
    assert lay["TL"] % 16 == 0 and lay["BAR"] % 8 == 0 and lay["LAUNCH"] - 1024 == lay["BYTES"]


@pytest.mark.parametrize("nq", [1, 33, 100, 256, 257, 600])
def test_phase_a_grid_is_persistent(nq):
    """At 2^24 rows on 132 SMs the grid is at most one CTA an SM, every
    query tile walks every block once, and the ranges are as even as the
    chunk count allows."""
    nb, sms = 131072, 132
    n, bpc = blockmax.phase_a_geometry(nq, nb, sms)
    qtiles, chunks = -(-nq // n), -(-nb // bpc)
    assert n == blockmax.tile_width(nq) and qtiles * n >= nq > (qtiles - 1) * n
    assert qtiles * chunks <= sms and chunks == sms // qtiles
    assert (chunks - 1) * bpc < nb <= chunks * bpc
