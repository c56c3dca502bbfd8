"""dbsearch: embed queries, scan the database, rescore top hits.

Reference: programs/Foldclass/dbsearch.py:475-551 (run_dbsearch). The port's
twin of the JAX package's `run_dbsearch`, with the same flow and filters:

  batched query embedding (bucketed)  ->  SearchEngine (device or stream
  mode)  ->
  ONE batched TM-align call (native, or the device aligner) for every
  surviving query-hit pair  ->
  per-query result dicts.

Filter parity (deliberately faithful to each reference path):
- pt DBs: mincov length prefilter in-scan (dbsearch.py:76) and the
  len_ali >= t_len * mincov post-filter (dbsearch.py:165);
- mmap DBs: no coverage filters (the reference's faiss path never implemented
  them, dbsearch.py:307-310), mincos + mintm only. `mmap_cov_filter=True`
  opts in to fixing that reference gap: the engine's length channel applies
  the same in-scan mincov mask and len_ali post-filter the pt path gets, so
  both layouts return identical hit sets.
"""

from __future__ import annotations

import logging

import numpy as np

from ..align import rescore_pairs
from ..db.codecs import FlatDB
from ..io.pdb import read_ca
from ..search.engine import SearchEngine
from ..utils import profiling
from ..utils.names import struct_basename
from .embed import embed_structures, load_foldclass_params, MAX_RES

logger = logging.getLogger(__name__)


def _query_dicts(inputs, inputs_are_ca: bool, pdb_chains: list[str]):
    """Queries as coords/seq/name dicts: read from files, or given as such
    (easy-search's segmented domains)."""
    return [q if inputs_are_ca else read_ca(q, pdb_chains[i])
            for i, q in enumerate(inputs)]


def _chains_for(inputs, pdb_chain: str | None):
    if not pdb_chain:
        return ["A"] * len(inputs)
    chains = pdb_chain.rstrip(",").split(",")
    if len(chains) == 1:
        return chains * len(inputs)
    if len(chains) != len(inputs):
        raise ValueError("Number of specified chain IDs not equal to number of input PDB files.")
    return chains


def run_dbsearch(inputs, db_name: str, topk: int = 1, fastmode: bool = False,
                 mincos: float = 0.5, mintm: float = 0.5, mincov: float = 0.7,
                 inputs_are_ca: bool = False, pdb_chain: str | None = None,
                 skip_tmalign: bool = False, search_batchsize: int = 2 ** 21,
                 model=None, weights: str | None = None,
                 engine: SearchEngine | None = None,
                 threads: int = 0, precision: str = "bf16", search_index: str = "flat",
                 nprobe: int = 32, nlist: int = 0, ivf_rerank: bool = False,
                 mmap_cov_filter: bool = False, tmalign_backend: str = "auto",
                 device: str = "cuda", mesh=None):
    """Search queries against a database.

    inputs: list of PDB/mmCIF paths, or (inputs_are_ca=True) of dicts with
    'coords'/'seq'/'name' (and dom_str/dom_conf/dom_plddt from the
    segmenter). model: a loaded FoldClassNet (else loaded from `weights`
    onto `device`). engine: a prebuilt SearchEngine over the DB (else one
    is opened at `precision`, streaming superblocks of `search_batchsize`
    rows when the DB exceeds the device budget, with the `search_index`
    "flat" or "ivf" and the IVF's nprobe, nlist and ivf_rerank, sharded
    over `mesh` (device.make_mesh) when one is given; the queries are
    embedded on `device` alone, as in JAX).
    tmalign_backend: "auto", "native" or "tpu" (the device aligner, on
    `device`; hits near `mintm` are re-checked natively). Returns (search_results,
    all_search_results): per query, a dict {rank: hit_dict} of significant
    / insignificant hits.
    """
    if len(inputs) == 0:
        raise ValueError("No inputs were provided!")
    if model is None:
        model = load_foldclass_params(weights, device)
    chains = _chains_for(inputs, pdb_chain)
    queries = _query_dicts(inputs, inputs_are_ca, chains)

    if engine is None:
        engine = SearchEngine(FlatDB.open(db_name), dtype=precision, device=device,
                              stream_block=search_batchsize, index=search_index,
                              ivf_nlist=nlist, ivf_nprobe=nprobe, ivf_rerank=ivf_rerank,
                              mesh=mesh)
    db = engine.db
    use_cov_filters = db.kind == "pt" or mmap_cov_filter

    logger.info("embedding %d queries", len(queries))
    with profiling.phase("embed_queries"):
        embs = embed_structures(model, [q["coords"][:MAX_RES] for q in queries])
    qlens = np.asarray([len(q["seq"]) for q in queries])

    with profiling.phase("db_scan"):
        vals, idxs = engine.search(
            embs, k=topk,
            query_lens=qlens if use_cov_filters else None,
            mincov=mincov if use_cov_filters else 0.0)

    # collect candidate hits passing mincos
    cand = []  # (qi, rank, score, dbindex)
    for qi in range(len(queries)):
        for rank in range(vals.shape[1]):
            i = int(idxs[qi, rank])
            v = float(vals[qi, rank])
            if i < 0 or not np.isfinite(v) or v < mincos:
                continue
            cand.append((qi, rank, v, i))

    results = [dict() for _ in queries]
    all_results = [dict() for _ in queries]
    counts = [0] * len(queries)

    def base_hit(qi, score, i, tm_output):
        q = queries[qi]
        return {
            "query": struct_basename(q["name"]),
            "target": struct_basename(db.name(i)),
            "score": score,
            "q_len": len(q["seq"]),
            "t_len": int(db.lengths()[i]),
            "tmalign_output": tm_output,
            "dom_str": q.get("dom_str"),
            "dom_conf": q.get("dom_conf"),
            "dom_plddt": q.get("dom_plddt"),
            "dbindex": i,
            "metadata": db.metadata(i),
        }

    if skip_tmalign:
        for qi, rank, v, i in cand:
            key = rank if db.kind == "pt" else counts[qi]
            results[qi][key] = base_hit(qi, v, i, None)
            counts[qi] += 1
        return results, all_results

    tms = []
    if cand:
        logger.info("TM-align %d query-hit pairs (batched)", len(cand))
        with profiling.phase("tmalign_rescore"):
            pairs = [(queries[qi], {"coords": db.coords(i), "seq": db.seq(i)})
                     for qi, _, _, i in cand]
            tms = rescore_pairs(pairs, fast=fastmode, backend=tmalign_backend,
                                nthreads=max(threads, 0), decision_tm=mintm,
                                device=device)

    n_excl = 0
    for (qi, rank, v, i), tm in zip(cand, tms):
        max_tm = max(tm["qtm"], tm["ttm"])
        t_len = int(db.lengths()[i])
        if use_cov_filters and tm["len_ali"] < t_len * mincov:
            continue  # parity: dropped entirely on the pt path (dbsearch.py:165)
        hit = base_hit(qi, v, i, tm)
        key = rank if db.kind == "pt" else counts[qi]
        if max_tm >= mintm:
            results[qi][key] = hit
            counts[qi] += 1
        else:
            # parity quirk: the reference keys insignificant hits by the
            # GLOBAL exclusion counter (dbsearch.py:454 n_tm_exclude), so
            # emb_rank in *_search_insignificant.tsv is a cross-query
            # running index — kept verbatim for byte-identical TSVs
            all_results[qi][key if db.kind == "pt" else n_excl] = hit
            n_excl += 1
    if n_excl:
        logger.info("Excluded %d hits (across all query domains) by TM-score threshold(>=%s)",
                    n_excl, mintm)
    return results, all_results
