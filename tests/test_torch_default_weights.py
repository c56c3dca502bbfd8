"""The port's default Foldclass weights are the JAX package's defaults.

With no `--weights`, the JAX package embeds with `init_params(PRNGKey(0))`
(its `load_foldclass_params(None)`). The port cannot draw JAX's random
numbers without JAX, so it ships them: `merizo_search_tpu_torch/models/
foldclass_default.npz` holds that init, converted by the port's
`params_from_jax`, as float32 Linear weights and biases (the positional
table is computed). `make_default_weights` below wrote the file; run

    JAX_PLATFORMS=cpu python -c "from tests.test_torch_default_weights import \\
        make_default_weights as m; m()"

from the repository root to write it again.
"""

import numpy as np
import torch

from merizo_search_tpu import cli as jcli
from merizo_search_tpu.pipeline.embed import load_foldclass_params as jax_load_params
from merizo_search_tpu_torch import cli as tcli
from merizo_search_tpu_torch.models import foldclass as tfc
from merizo_search_tpu_torch.pipeline.embed import load_foldclass_params

SCORE_TOL = 2e-4       # fp32 emb_score, as tests/test_torch_search.py


def _jax_default_state_dict():
    """The JAX default weights as the port's state dict (pe included)."""
    import jax

    params = jax.tree_util.tree_map(np.asarray, jax_load_params(None))
    return tfc.params_from_jax(params)


def make_default_weights(path=tfc.DEFAULT_WEIGHTS):
    """Write the port's default-weights file: every entry of the converted
    JAX default but the positional table, float32, compressed."""
    sd = _jax_default_state_dict()
    np.savez_compressed(path, **{k: v.numpy().astype(np.float32)
                                 for k, v in sd.items() if k != "posenc_as.pe"})


def test_stored_default_equals_the_converted_jax_init():
    want = _jax_default_state_dict()
    got = tfc.default_state_dict()
    assert sorted(got) == sorted(want) == sorted(tfc.FoldClassNet().state_dict())
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], v), k
    with np.load(tfc.DEFAULT_WEIGHTS) as z:
        assert "posenc_as.pe" not in z.files
        assert sum(z[k].size for k in z.files) == 792_330


def test_loader_without_weights_uses_the_default():
    model = load_foldclass_params(None, "cpu")
    want = tfc.default_state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def _walk(rng, n):
    steps = rng.normal(size=(n, 3))
    for i in range(1, n):
        steps[i] = 0.6 * steps[i - 1] + 0.4 * steps[i]
    steps /= np.linalg.norm(steps, axis=1, keepdims=True)
    return np.cumsum(steps * 3.8, axis=0).astype(np.float32)


def _write_pdb(path, coords):
    with open(path, "w") as fh:
        for i, (x, y, z) in enumerate(coords, start=1):
            fh.write(f"ATOM  {i:5d}  CA  ALA A{i:4d}    {x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00\n")
        fh.write("END\n")


def _tsv_rows(path):
    with open(path) as fh:
        return [ln.rstrip("\n").split("\t") for ln in fh]


def test_cli_search_without_weights_writes_the_jax_tsv(tmp_path):
    """A DB from the JAX `createdb` and a search by each package's CLI, none
    given weights: the same hits, ranks and TM-align fields, emb_score
    within SCORE_TOL. Before the port shipped the JAX default, its queries
    were embedded in another space (max |diff| 0.23 on such inputs)."""
    rng = np.random.default_rng(5)
    pdb_dir = tmp_path / "pdbs"
    pdb_dir.mkdir()
    chains = [_walk(rng, n) for n in (70, 90, 110, 130, 150, 180, 210, 240)]
    for i, c in enumerate(chains):
        _write_pdb(pdb_dir / f"t{i}.pdb", c)
    queries = []
    for i in (1, 4, 6):       # perturbed copies of three DB chains
        queries.append(str(tmp_path / f"q{i}.pdb"))
        _write_pdb(queries[-1], chains[i] + rng.normal(scale=0.5, size=chains[i].shape))
    db = str(tmp_path / "db" / "walks")
    jcli.main(["createdb", str(pdb_dir), db, "-d", "cpu"])
    flags = ["-k", "5", "--precision", "fp32", "--output_headers",
             "--report_insignificant_hits"]
    jcli.main(["search", *queries, db, str(tmp_path / "jax"), "-d", "cpu", *flags])
    tcli.main(["search", *queries, db, str(tmp_path / "port"), "-d", "cpu", *flags])
    n_hits = 0
    for suffix in ("_search.tsv", "_search_insignificant.tsv"):
        jrows = _tsv_rows(str(tmp_path / "jax") + suffix)
        trows = _tsv_rows(str(tmp_path / "port") + suffix)
        assert len(trows) == len(jrows)
        col = jrows[0].index("emb_score")
        assert trows[0] == jrows[0]
        for t, j in zip(trows[1:], jrows[1:]):
            assert t[:col] + t[col + 1:] == j[:col] + j[col + 1:]
            assert abs(float(t[col]) - float(j[col])) <= SCORE_TOL
        n_hits += len(jrows) - 1
    assert n_hits == 7           # 3 significant; the mincov filter drops the rest
    rows = _tsv_rows(str(tmp_path / "port") + "_search.tsv")
    top = {r[0]: r[rows[0].index("target")] for r in rows[1:] if r[1] == "0"}
    assert top == {"q1": "t1", "q4": "t4", "q6": "t6"}
