"""The port's device TM-align (align/tmalign.py, align/kabsch.py) against the
JAX package's, on the CPU.

The same numpy inputs, made from seeds, go through both. The JAX functions
run jitted and vmapped over the rows, as the JAX aligner runs them; the
port's run batched over the same rows.

Equality where the port must be exact: `_dp_align`'s alignment (random S
with per-row gaps, and S of small integers, full of ties), `_assign_ss`,
`_seed_masks`, and the initial alignments of `_threading_init` and
`_fragment_init`, including chains whose n - fl is a value where
torch.linspace's start grid would differ from jnp.linspace's. `kabsch` and
`tm_score_search` agree to 1e-5. The whole aligner (`tmalign_pairs`, fast
and full): qtm and ttm within 1e-3, rmsd within 1e-2 A, len_ali equal. One
ulp of S (the SVD or d0's cube root, see below) may flip a DP near-tie and
move a pair by ~1e-3; on these inputs both agree to ~1e-6. `tm_d0` equals
JAX's for every integer length 0-2099 but 1577, where it is one ulp away
(XLA's float32 cbrt is not correctly rounded).

Then the port's twins of tests/test_tmalign.py's synthetic cases, chunking
(a chunk cap of 2 pairs changes nothing), and rescore_pairs' routing: the
near-threshold re-check and chains over MAX_BUCKET go to the native
aligner, and "auto" takes the device aligner only when g++ fails.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merizo_search_tpu.align import kabsch as jkabsch
from merizo_search_tpu.align import tmalign as J
from merizo_search_tpu_torch import align as talign
from merizo_search_tpu_torch.align import kabsch as tkabsch
from merizo_search_tpu_torch.align import native as tnative
from merizo_search_tpu_torch.align import tmalign as T
from merizo_search_tpu_torch.tools.synthetic import helical_backbone

TM_TOL = 1e-3
RMSD_TOL = 1e-2
L = 64


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _walk(rng, n):
    s = rng.normal(size=(n, 3))
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    return np.cumsum(s * 3.8, axis=0).astype(np.float32)


def _rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _padded(chains, b=L):
    x = np.zeros((len(chains), b, 3), np.float32)
    m = np.zeros((len(chains), b), np.float32)
    for i, c in enumerate(chains):
        x[i, :len(c)] = c[:b]
        m[i, :len(c)] = 1
    return x, m


# (nx, ny): random walks; (10, 40), (18, 18) and (12, 60) put n - fl at 5, 9
# and 6, where torch.linspace's start grid would differ from JAX's
LENGTHS = [(50, 60), (64, 40), (30, 64), (10, 40), (18, 18), (12, 60)]


@pytest.fixture(scope="module")
def chain_pairs():
    rng = np.random.default_rng(3)
    qs, ts = [], []
    for nx, ny in LENGTHS:
        a = _walk(rng, nx)
        qs.append(a)
        ts.append(_walk(rng, ny) if nx != ny else
                  (a @ _rotation(rng).T + rng.normal(size=a.shape)).astype(np.float32))
    hb = helical_backbone(rng, 140)[:, 1].astype(np.float32)
    qs.append(hb[:62])
    ts.append((hb[8:64] @ _rotation(rng).T + 4.0).astype(np.float32))
    x, xm = _padded(qs)
    y, ym = _padded(ts)
    return x, xm, y, ym


def test_linspace_trap_lengths_are_covered():
    """The port's start-grid fractions equal jnp.linspace(0, 1, 16) bit for
    bit; torch.linspace's would truncate to other starts at the trap values
    the chain pairs use."""
    assert np.array_equal(T._LIN16, np.asarray(jnp.linspace(0, 1, 16)))
    lin_t = torch.linspace(0, 1, 16).numpy()
    for n in (5, 6, 9):
        assert not np.array_equal((T._LIN16 * n).astype(np.int32), (lin_t * n).astype(np.int32))
    fl = [int(np.clip(min(a, b) // 2, 5, 20)) for a, b in LENGTHS]
    traps = {a - f for (a, _), f in zip(LENGTHS, fl)} | {b - f for (_, b), f in zip(LENGTHS, fl)}
    assert {5, 6, 9} <= traps


def test_tm_d0_matches_xla_cbrt():
    ln = np.arange(2100)
    want = np.asarray(J.tm_d0(jnp.asarray(ln)))
    got = T.tm_d0(ln).numpy()
    diff = np.nonzero(got != want)[0]
    assert diff.tolist() == [1577]
    assert abs(int(got[1577].view(np.int32)) - int(want[1577].view(np.int32))) == 1


@pytest.mark.parametrize("integer_s", [False, True])
def test_dp_align_bit_equal(integer_s):
    """Per-row gaps (the refine chains' -0.6 and 0, the SS init's -1) and
    per-row lengths; S of small integers makes ties everywhere."""
    rng = np.random.default_rng(11 + integer_s)
    R = 12
    S = rng.normal(size=(R, L, L)).astype(np.float32)
    if integer_s:
        S = np.round(S)
    nx = rng.integers(3, L + 1, R)
    ny = rng.integers(3, L + 1, R)
    nx[0], ny[1] = L, L
    gap = np.array([-0.6, 0.0, -1.0] * (R // 3), np.float32)
    for r in range(R):
        S[r, nx[r]:, :] = J.NEG
        S[r, :, ny[r]:] = J.NEG
    want = np.asarray(jax.jit(jax.vmap(J._dp_align))(S, nx, ny, gap))
    got = T._dp_align(_t(S), _t(nx), _t(ny), _t(gap)).numpy()
    assert np.array_equal(got, want)
    assert (got >= 0).sum() > R      # the alignments are not empty


def test_assign_ss_and_seed_masks_equal(chain_pairs):
    x, xm, y, ym = chain_pairs
    c = np.concatenate([x, y])
    n = np.concatenate([xm, ym]).sum(1).astype(np.int32)
    want = np.asarray(jax.vmap(J._assign_ss)(c, n))
    got = T._assign_ss(_t(c), _t(n).long()).numpy()
    assert np.array_equal(got, want)
    assert set(np.unique(got)) >= {0, 1, 3}    # the helical chain has helices

    rng = np.random.default_rng(4)
    w = (rng.uniform(size=(20, L)) < np.linspace(0.02, 0.9, 20)[:, None]).astype(np.float32)
    assert np.array_equal(T._seed_masks(_t(w)).numpy(),
                          np.asarray(jax.vmap(J._seed_masks)(w)))


def test_kabsch_and_tm_score_search_agree(chain_pairs):
    x, xm, y, ym = chain_pairs
    rng = np.random.default_rng(5)
    w = (rng.uniform(size=xm.shape) < 0.8) * xm
    rj, tj = jkabsch.kabsch(x, y, w)
    rt, tt = tkabsch.kabsch(_t(x), _t(y), _t(w).float())
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5 * 100)   # |t| ~ 100 A
    np.testing.assert_allclose(tkabsch.transform(rt, tt, _t(x)).numpy(),
                               np.asarray(jkabsch.transform(rj, tj, x)), atol=1e-3)

    nx = xm.sum(1).astype(np.int32)
    ny = ym.sum(1).astype(np.int32)
    ali = np.where((np.arange(L)[None] < np.minimum(nx, ny)[:, None]), np.arange(L)[None], -1)
    ali[:, ::7] = -1                      # gaps
    d0 = np.asarray(J.tm_d0(jnp.asarray(np.minimum(nx, ny))))
    lnorm = np.minimum(nx, ny).astype(np.float32)
    want = jax.vmap(lambda *a: J.tm_score_search(*a, n_iter=8))(x, y, ali, d0, lnorm)
    got = T.tm_score_search(_t(x), _t(y), _t(ali).long(), _t(d0), _t(lnorm), 8)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4)


def test_initial_alignments_equal(chain_pairs):
    x, xm, y, ym = chain_pairs
    nx = xm.sum(1).astype(np.int32)
    ny = ym.sum(1).astype(np.int32)
    lmin = np.minimum(nx, ny).astype(np.float32)
    d0 = np.asarray(J.tm_d0(jnp.asarray(lmin)))
    tx, ty, txm, tym, tnx, tny = (_t(a) for a in (x, y, xm, ym, nx, ny))
    tnx, tny = tnx.long(), tny.long()
    thr_j = np.asarray(jax.jit(jax.vmap(J._threading_init))(x, y, nx, ny, d0, lmin))
    thr_t = T._threading_init(tx, ty, tnx, tny, _t(d0), _t(lmin)).numpy()
    assert np.array_equal(thr_t, thr_j)
    frg_j = np.asarray(jax.jit(jax.vmap(J._fragment_init))(x, y, xm, ym, nx, ny, d0))
    frg_t = T._fragment_init(tx, ty, txm, tym, tnx, tny, _t(d0)).numpy()
    assert np.array_equal(frg_t, frg_j)
    ss_j = np.asarray(jax.jit(jax.vmap(J._ss_init))(x, y, xm, ym, nx, ny))
    ss_t = T._ss_init(tx, ty, txm, tym, tnx, tny).numpy()
    assert np.array_equal(ss_t, ss_j)


def _as_pairs(chain_pairs):
    x, xm, y, ym = chain_pairs
    out = []
    for i in range(len(x)):
        nq, nt = int(xm[i].sum()), int(ym[i].sum())
        out.append(({"coords": x[i, :nq], "seq": "ACDEFGHIKL"[i % 10] * nq},
                    {"coords": y[i, :nt], "seq": "ACDEFGHIKL"[(i + 3) % 10] * nt}))
    rng = np.random.default_rng(9)
    a = _walk(rng, 100)                  # one pair of bucket 128
    b = (a[5:95] @ _rotation(rng).T + rng.normal(size=(90, 3)) * 0.7).astype(np.float32)
    out.append(({"coords": a, "seq": "A" * 100}, {"coords": b, "seq": "A" * 90}))
    return out


@pytest.fixture(scope="module")
def jax_results(chain_pairs):
    pairs = _as_pairs(chain_pairs)
    return pairs, {fast: J.tmalign_pairs(pairs, fast=fast) for fast in (True, False)}


@pytest.mark.parametrize("fast", [True, False])
def test_tmalign_pairs_agree_with_jax(jax_results, fast):
    pairs, want = jax_results
    got = T.tmalign_pairs(pairs, fast=fast, device="cpu")
    for g, w in zip(got, want[fast]):
        assert g["len_ali"] == w["len_ali"]
        assert abs(g["qtm"] - w["qtm"]) <= TM_TOL
        assert abs(g["ttm"] - w["ttm"]) <= TM_TOL
        assert abs(g["rmsd"] - w["rmsd"]) <= RMSD_TOL
        assert g["seq_id"] == w["seq_id"]
    assert max(g["qtm"] for g in got) > 0.8        # the homologs align


def test_chunk_cap_changes_nothing(jax_results, monkeypatch):
    pairs, _ = jax_results
    whole = T.tmalign_pairs(pairs, fast=True, device="cpu")
    monkeypatch.setattr(T, "_dispatch_cap", lambda b: 2)
    assert T.tmalign_pairs(pairs, fast=True, device="cpu") == whole


def test_dispatch_cap_is_jax_s():
    assert [T._dispatch_cap(b) for b in T._BUCKETS] == [
        max(1, (1 << 31) // (24 * b * b)) for b in J._BUCKETS]
    assert T._dispatch_cap(2048) == 21 and T.MAX_BUCKET == J.MAX_BUCKET == 2048
    assert [T._bucket(n) for n in (1, 64, 65, 400, 2048, 3000)] == [
        J._bucket(n) for n in (1, 64, 65, 400, 2048, 3000)]


# -- the port's twins of tests/test_tmalign.py's synthetic cases ------------

def test_kabsch_recovers_rotation():
    rng = np.random.default_rng(0)
    p = _walk(rng, 50)
    R = _rotation(rng)
    t = rng.normal(size=3) * 10
    q = (p @ R.T + t).astype(np.float32)
    r, tt = tkabsch.kabsch(_t(p), _t(q), torch.ones(50))
    np.testing.assert_allclose(r.numpy(), R, atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), t, atol=1e-3)
    np.testing.assert_allclose(tkabsch.transform(r, tt, _t(p)).numpy(), q, atol=1e-3)
    assert float(tkabsch.weighted_rmsd(tkabsch.transform(r, tt, _t(p)), _t(q),
                                       torch.ones(50))) < 1e-3


@pytest.mark.parametrize("moved", [False, True])
def test_self_and_rotated_copy_align_perfectly(moved):
    rng = np.random.default_rng(1)
    c = _walk(rng, 80)
    c2 = (c @ _rotation(rng).T + rng.normal(size=3) * 20).astype(np.float32) if moved else c
    out = T.run_tmalign_pair({"coords": c, "seq": "A" * 80}, {"coords": c2, "seq": "A" * 80},
                             device="cpu")
    assert out["qtm"] > 0.999 and out["ttm"] > 0.999
    assert out["len_ali"] == 80 and out["rmsd"] < 1e-2 and out["seq_id"] == 1.0


def test_substructure_alignment():
    rng = np.random.default_rng(2)
    full = _walk(rng, 120)
    frag = (full[30:90] @ _rotation(rng).T + 5.0).astype(np.float32)
    out = T.run_tmalign_pair({"coords": frag, "seq": "A" * 60},
                             {"coords": full, "seq": "A" * 120}, device="cpu")
    assert out["len_ali"] >= 55 and out["rmsd"] < 0.5 and out["qtm"] > 0.9


@pytest.mark.parametrize("related", [False, True])
def test_unrelated_low_noisy_homolog_high(related):
    rng = np.random.default_rng(6)
    a = _walk(rng, 150)
    if related:
        b = ((a + rng.normal(size=a.shape)) @ _rotation(rng).T - 3.0).astype(np.float32)
    else:
        b = _walk(np.random.default_rng(123), 150)
    out = T.run_tmalign_pair({"coords": a, "seq": "A" * 150}, {"coords": b, "seq": "A" * 150},
                             device="cpu")
    if related:
        assert out["qtm"] > 0.8 and out["len_ali"] >= 140
    else:
        assert out["qtm"] < 0.45 and out["ttm"] < 0.45


def test_batched_matches_single():
    rng = np.random.default_rng(7)
    da, db, dc = ({"coords": _walk(rng, n), "seq": s * n} for n, s in
                  ((70, "A"), (85, "C"), (60, "D")))
    pairs = [(da, db), (da, dc), (db, dc)]
    batch = T.tmalign_pairs(pairs, device="cpu")
    for got, p in zip(batch, pairs):
        want = T.run_tmalign_pair(*p, device="cpu")
        assert abs(got["qtm"] - want["qtm"]) < 1e-5
        assert got["len_ali"] == want["len_ali"]


# -- rescore_pairs' routing ---------------------------------------------------

def _fold(rng, n=60):
    return np.cumsum(rng.normal(size=(n, 3)) * 1.5, axis=0).astype(np.float32)


def _fake(qtm):
    return {"len_ali": 10, "rmsd": 1.0, "seq_id": 0.5, "qtm": qtm, "ttm": qtm - 0.01}


@pytest.fixture
def routed(monkeypatch):
    calls = {"native": [], "device": []}

    def fake_device(pairs, fast=False, device="cuda"):
        calls["device"].append(len(pairs))
        return [_fake(s) for s in [0.51, 0.90, 0.495][:len(pairs)]]

    def fake_native(pairs, fast=False, nthreads=0):
        calls["native"].append(len(pairs))
        return [_fake(0.42)] * len(pairs)

    monkeypatch.setattr(T, "tmalign_pairs", fake_device)
    monkeypatch.setattr(tnative, "available", lambda: True)
    monkeypatch.setattr(tnative, "tmalign_pairs_native", fake_native)
    return calls


def test_near_threshold_recheck_routes_to_native(routed):
    rng = np.random.default_rng(0)
    a, b = _fold(rng), _fold(rng)
    pairs = [({"coords": a, "seq": "A" * 60}, {"coords": b, "seq": "A" * 60})] * 3
    res = talign.rescore_pairs(pairs, backend="tpu", decision_tm=0.5, device="cpu")
    assert routed["native"] == [2]            # only the two near-threshold pairs
    assert [r["qtm"] for r in res] == [0.42, 0.90, 0.42]
    routed["native"].clear()
    res = talign.rescore_pairs(pairs, backend="tpu", device="cpu")
    assert routed["native"] == []             # no decision threshold: no re-check
    assert [r["qtm"] for r in res] == [0.51, 0.90, 0.495]


def test_chains_over_max_bucket_go_native(routed):
    rng = np.random.default_rng(1)
    short = {"coords": _fold(rng), "seq": "A" * 60}
    long = {"coords": _fold(rng, T.MAX_BUCKET + 1), "seq": "A" * (T.MAX_BUCKET + 1)}
    res = talign.rescore_pairs([(short, long), (short, short), (long, short)],
                               backend="tpu", device="cpu")
    assert routed == {"native": [2], "device": [1]}
    assert [r["qtm"] for r in res] == [0.42, 0.51, 0.42]


def test_auto_prefers_native_and_takes_the_device_only_without_it(routed, monkeypatch):
    rng = np.random.default_rng(2)
    pair = [({"coords": _fold(rng), "seq": "A" * 60}, {"coords": _fold(rng), "seq": "A" * 60})]
    assert talign.rescore_pairs(pair, device="cpu")[0]["qtm"] == 0.42
    assert routed == {"native": [1], "device": []}
    monkeypatch.setattr(tnative, "available", lambda: False)
    assert talign.rescore_pairs(pair, device="cpu")[0]["qtm"] == 0.51
    with pytest.raises(RuntimeError, match="unavailable"):
        talign.rescore_pairs(pair, backend="native", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        talign.rescore_pairs(pair, backend="gpu", device="cpu")
