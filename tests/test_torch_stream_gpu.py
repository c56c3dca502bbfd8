"""The stream mode on the card: superblocks staged through pinned buffers
and a side stream, scanned by the phase-A and phase-C kernels.

Every test here carries the `gpu` marker and skips (decided at run time)
where there is no CUDA device. The file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_stream_gpu.py

One mmap DB of 20,000 rows with int8 and bf16 sidecars; superblocks of
1,000 rows (int8: 896), so the pinned ring (threads + 2 buffers) and the
three device slots wrap many times. Stream mode against device mode on the
card: scores bit for bit, indices equal except among tied scores; each
kernel launched once a superblock.
"""

import numpy as np
import pytest
import torch

from merizo_search_tpu_torch.db import codecs
from merizo_search_tpu_torch.ops import blockmax, gather
from merizo_search_tpu_torch.search.engine import SearchEngine
from merizo_search_tpu_torch.utils.profiling import counter, reset_counters

N = 20_000
BLOCK = 1000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def db_prefix(tmp_path_factory):
    rng = np.random.default_rng(8)
    emb = rng.normal(size=(N, 128)).astype(np.float32)
    pool = [rng.normal(size=(n, 3)).astype(np.float32) for n in (60, 140, 250)]
    prefix = str(tmp_path_factory.mktemp("stream_gpu") / "db")
    w = codecs.MmapDBWriter(prefix)
    for i, e in enumerate(emb):
        w.add(f"e{i:05d}", e, pool[i % 3], "A" * len(pool[i % 3]))
    w.finalize()
    for kind in ("int8", "bf16"):
        codecs.write_quantized_sidecar(prefix, kind)
    return prefix


def _assert_same_topk(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    for va, ia, ib in zip(a[0], a[1], b[1]):
        for v in np.unique(va):
            tied = va == v
            if tied.sum() == 1:
                assert ia[tied] == ib[tied]
            elif v != va[-1]:
                assert sorted(ia[tied]) == sorted(ib[tied])


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["bf16", "int8", "fp32"])
@pytest.mark.parametrize("mincov", [0.0, 0.7])
def test_stream_equals_device_on_the_card(cuda, db_prefix, precision, mincov):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(40, 128)).astype(np.float32)
    qlen = rng.integers(50, 300, 40)
    db = codecs.FlatDB.open(db_prefix)
    dev = SearchEngine(db, precision, "cuda")
    st = SearchEngine(db, precision, "cuda", max_device_gb=1e-9, stream_block=BLOCK)
    assert st.mode == "stream"
    want = dev.search(q, 100, query_lens=qlen, mincov=mincov)
    reset_counters()
    got = st.search(q, 100, query_lens=qlen, mincov=mincov)
    nsb = st.stream_stats["superblocks"]
    assert nsb == -(-N // (896 if precision == "int8" else BLOCK))
    if precision == "fp32":
        np.testing.assert_allclose(got[0], want[0], atol=1e-6)
    else:
        _assert_same_topk(got, want)
        assert counter(blockmax.LAUNCHES) == counter(gather.LAUNCHES) == nsb
    stats = st.stream_stats
    assert stats["copy_s"] > 0 and stats["scan_s"] > 0
