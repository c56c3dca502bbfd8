"""The device TM-align and the search server on the card.

- the aligner on the card against itself on the CPU, per bucket (64, 128,
  256), fast and full: qtm and ttm within 1e-3 on all but at most one pair a
  bucket, which may move by 0.05 (one ulp of the SVD's rotation can flip a
  DP near-tie), len_ali within 2 and rmsd within 0.05 A where the TM-scores
  agree to 1e-3;
- `_dp_align` on the card under torch.cuda.set_sync_debug_mode("error"):
  the wavefront and the traceback never wait on the host; and equal to the
  CPU's alignment bit for bit on the same S;
- the search server on the card (a `.pt` DB of planted walks, the native and
  the device aligner) answering /search over HTTP with the planted row at
  rank 1.

Every test here carries the `gpu` marker and skips (decided at run time)
where there is no CUDA device. The file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_tmalign_gpu.py
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from merizo_search_tpu_torch.align import tmalign as T
from merizo_search_tpu_torch.tools.synthetic import rotation

TM_TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _walk(rng, n):
    s = rng.normal(size=(n, 3))
    for i in range(1, n):
        s[i] = 0.6 * s[i - 1] + 0.4 * s[i]
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    return np.cumsum(s * 3.8, axis=0).astype(np.float32)


def _homolog(rng, a, noise=0.3):
    return ((a + rng.normal(size=a.shape) * noise) @ rotation(rng).T + 7.0).astype(np.float32)


def _pairs(rng, lo, hi, n):
    out = []
    for i in range(n):
        a = _walk(rng, int(rng.integers(lo, hi + 1)))
        b = _homolog(rng, a) if i % 2 else _walk(rng, int(rng.integers(lo, hi + 1)))
        out.append(({"coords": a, "seq": "A" * len(a)}, {"coords": b, "seq": "A" * len(b)}))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("bucket,fast", [(64, True), (64, False), (128, True), (256, True)])
def test_card_agrees_with_cpu(cuda, bucket, fast):
    rng = np.random.default_rng(bucket + fast)
    pairs = _pairs(rng, bucket // 2 + 1, bucket, 8)
    got = T.tmalign_pairs(pairs, fast=fast, device="cuda")
    want = T.tmalign_pairs(pairs, fast=fast, device="cpu")
    off = 0
    for g, w in zip(got, want):
        d = max(abs(g["qtm"] - w["qtm"]), abs(g["ttm"] - w["ttm"]))
        if d > TM_TOL:
            off += 1
            assert d <= 0.05, (g, w)
            continue
        assert abs(g["len_ali"] - w["len_ali"]) <= 2
        assert abs(g["rmsd"] - w["rmsd"]) <= 0.05
    assert off <= 1
    assert all(g["qtm"] > 0.8 for g in got[1::2])          # the homologs


@pytest.mark.gpu
def test_dp_align_runs_without_a_host_sync(cuda):
    rng = np.random.default_rng(0)
    R, L = 12, 128
    S = rng.normal(size=(R, L, L)).astype(np.float32)
    nx = rng.integers(20, L + 1, R)
    ny = rng.integers(20, L + 1, R)
    for r in range(R):
        S[r, nx[r]:, :] = T.NEG
        S[r, :, ny[r]:] = T.NEG
    gap = np.array([-0.6, 0.0, -1.0] * 4, np.float32)
    args = [torch.from_numpy(a) for a in (S, nx, ny, gap)]
    want = T._dp_align(*args)
    dev_args = [a.to(cuda) for a in args]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ali = T._dp_align(*dev_args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(ali.cpu(), want)


@pytest.mark.gpu
def test_service_on_the_card_answers_a_planted_search(cuda, tmp_path):
    from merizo_search_tpu_torch import server as srv
    from merizo_search_tpu_torch.db import codecs
    from merizo_search_tpu_torch.pipeline.embed import embed_structures, load_foldclass_params

    rng = np.random.default_rng(1)
    coords = [_walk(rng, 60 + 7 * i) for i in range(40)]
    embs = embed_structures(load_foldclass_params(None, "cuda"), coords)
    prefix = str(tmp_path / "db")
    codecs.write_pt_db(prefix, embs, [(f"t{i}", c, "A" * len(c)) for i, c in enumerate(coords)])
    for backend in ("native", "tpu"):
        svc = srv.SearchService(prefix, precision="bf16", tmalign_backend=backend)
        httpd = srv.ThreadingHTTPServer(("127.0.0.1", 0), srv.make_handler(svc))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{httpd.server_address[1]}/search",
                data=json.dumps({"coords": coords[17].tolist(), "k": 5}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req) as resp:
                hits = json.loads(resp.read())["hits"]
        finally:
            httpd.shutdown()
            httpd.server_close()
        assert hits[0]["target"] == "t17" and hits[0]["q_tm"] > 0.99, (backend, hits[0])
