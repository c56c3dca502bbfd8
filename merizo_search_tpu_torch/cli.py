"""Command-line interface of the port: the `segment`, `createdb`, `search`,
`easy-search`, `serve` and `dbinfo` verbs.

    python -m merizo_search_tpu_torch.cli segment input.pdb [...] output [flags]
    python -m merizo_search_tpu_torch.cli createdb input_dir out_db [flags]
    python -m merizo_search_tpu_torch.cli search query.pdb [...] db_name output [tmp] [flags]
    python -m merizo_search_tpu_torch.cli easy-search query.pdb [...] db_name output [tmp] [flags]
    python -m merizo_search_tpu_torch.cli serve db_name [--host H --port P] [flags]
    python -m merizo_search_tpu_torch.cli dbinfo db_name [flags]

The same positionals, flags, defaults and output files as the JAX package's
verbs (themselves the reference's, merizo.py:33-443), with `-d cuda|cpu`
choosing the device (default cuda; asking for cuda without a card is an
error, not a fallback; dbinfo needs no device). `--trace DIR` records a
torch.profiler trace. `--search_index ivf [--nprobe N --nlist M
--ivf_rerank]` searches through the IVF index (device or stream mode).
`--tmalign_backend tpu` rescores hits with the batched device aligner on
`-d`'s device. `serve` keeps the DB and the models resident and answers
/search and /easy-search over HTTP (server.py). `--mesh N` on `search`,
`easy-search`, `createdb` and `serve` shards the DB (createdb: the embed)
over N devices of `-d`'s type (device.make_mesh: N cards, fewer with a
warning where there are fewer; N shards on the CPU).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

logger = logging.getLogger(__name__)

USAGE = """Usage: python -m merizo_search_tpu_torch.cli <mode> <args>
    <mode> is one of: 'segment', 'createdb', 'search', 'easy-search',
    'serve', or 'dbinfo'.
    Detailed help: python -m merizo_search_tpu_torch.cli <mode> --help"""


def setup_logging():
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s | %(levelname)s | %(message)s")


def _ensure_parent(path: str):
    """Create the parent directory of an output prefix if missing."""
    parent = os.path.dirname(os.path.abspath(path))
    if parent:
        os.makedirs(parent, exist_ok=True)


def _add_device_flag(p: argparse.ArgumentParser):
    p.add_argument("-d", "--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Device to run on. 'cuda' raises when no card is present.")


def _add_trace_flag(p: argparse.ArgumentParser):
    p.add_argument("--trace", type=str, default=None, metavar="DIR",
                   help="Record a torch.profiler trace (Chrome trace JSON) into DIR.")


def _add_search_flags(p: argparse.ArgumentParser):
    _add_device_flag(p)
    p.add_argument("-k", "--topk", type=int, default=1,
                   help="Max number of domain matches to return for each query.")
    p.add_argument("-t", "--threads", type=int, default=-1,
                   help="CPU threads for native TM-align rescoring (<=0 = all cores).")
    p.add_argument("-s", "--mincos", type=float, default=0.5,
                   help="Min cosine similarity to database matches.")
    p.add_argument("-m", "--mintm", type=float, default=0.5,
                   help="Min TM-score to database matches.")
    p.add_argument("-c", "--mincov", type=float, default=0.7,
                   help="Min coverage of database matches.")
    p.add_argument("-f", "--fastmode", action="store_true",
                   help="Fast mode for TM rescoring (fewer refinement iterations).")
    p.add_argument("--search_batchsize", type=int, default=262144,
                   help="Rows per superblock of the stream mode, which scans "
                        "DBs over the 8 GB device budget (device mode ignores it).")
    p.add_argument("--search_metric", type=str, default="IP",
                   help="Only 'IP' (cosine) is supported.")
    p.add_argument("--report_insignificant_hits", action="store_true", default=False)
    p.add_argument("--metadata_json", action="store_true", default=False)
    p.add_argument("--output_headers", action="store_true", default=False)
    p.add_argument("--multi_domain_search", action="store_true", default=False,
                   help="Match the query chain's domains onto the DB's "
                        "multi-domain chains (writes <output>_search_multi_dom.tsv).")
    p.add_argument("--multi_domain_mode", type=str, default="exhaustive_tmalign",
                   choices=["exhaustive_tmalign", "embscore"])
    p.add_argument("--skip_tmalign", action="store_true", default=False,
                   help="Skip TM rescoring (embedding scores only).")
    p.add_argument("--tmalign_backend", type=str, default="auto",
                   choices=["auto", "native", "tpu"],
                   help="'auto' and 'native' run the in-process C++ TM-align "
                        "('auto' takes the device aligner only if g++ fails); "
                        "'tpu' runs the batched device aligner on -d's device, "
                        "re-checking hits near --mintm natively.")
    p.add_argument("--mesh", type=int, default=0,
                   help="Shard the DB across this many devices of -d's type "
                        "(0: no mesh).")
    p.add_argument("--precision", type=str, default="bf16",
                   choices=["fp32", "bf16", "int8"],
                   help="On-device DB storage for the scan: bf16 and int8 run the "
                        "fused CUDA scan, fp32 the plain exact scan.")
    p.add_argument("--weights", type=str, default=None,
                   help="Path to a Foldclass state dict (.pt).")
    p.add_argument("--search_index", type=str, default="flat",
                   choices=["flat", "ivf"],
                   help="'flat' = exact full scan; 'ivf' = balanced-cluster "
                        "inverted file, probing --nprobe clusters per query "
                        "(approximate, sublinear).")
    p.add_argument("--nprobe", type=int, default=32,
                   help="IVF clusters probed per query.")
    p.add_argument("--nlist", type=int, default=0,
                   help="IVF cluster count (0 = ~sqrt(N), a power of two, at least 16).")
    p.add_argument("--ivf_rerank", action="store_true", default=False,
                   help="IVF: rescore the top-(k+1) probed blocks from an f32 "
                        "copy of the DB on the device (+4 bytes a dim a row), "
                        "removing the storage precision's ranking noise.")
    p.add_argument("--mmap_cov_filter", action="store_true", default=False,
                   help="Apply the -c/--mincov coverage filters on mmap "
                        "databases too (the reference never implemented "
                        "mincov on its mmap path; this makes pt and mmap "
                        "layouts return identical hit sets).")
    _add_trace_flag(p)


def _add_merizo_flags(p: argparse.ArgumentParser):
    p.add_argument("--merizo_output", type=str, default=os.environ.get("PWD", os.getcwd()))
    p.add_argument("--save_pdf", action="store_true", default=False)
    p.add_argument("--save_pdb", action="store_true", default=False)
    p.add_argument("--save_domains", action="store_true", default=False)
    p.add_argument("--save_fasta", action="store_true", default=False)
    p.add_argument("--conf_filter", type=float, default=None)
    p.add_argument("--plddt_filter", type=float, default=None)
    p.add_argument("--iterate", action="store_true")
    p.add_argument("--length_conditional_iterate", action="store_true")
    p.add_argument("--max_iterations", type=int, default=3)
    p.add_argument("--shuffle_indices", action="store_true", default=False)
    p.add_argument("--return_indices", action="store_true", default=False)
    p.add_argument("--min_domain_size", type=int, default=50)
    p.add_argument("--min_fragment_size", type=int, default=10)
    p.add_argument("--domain_ave_size", type=int, default=200)
    p.add_argument("--conf_threshold", type=float, default=0.5)
    p.add_argument("--pdb_chain", type=str, default="A")
    p.add_argument("--merizo_weights", type=str, default=None,
                   help="Directory with the reference's Merizo weight shards (.pt). "
                        "Without it the port uses a seeded random init, not the "
                        "JAX package's default (README).")


def _merizo_kw(args):
    return dict(
        iterate=args.iterate,
        length_conditional_iterate=args.length_conditional_iterate,
        max_iterations=args.max_iterations,
        shuffle_indices=args.shuffle_indices,
        min_domain_size=args.min_domain_size,
        min_fragment_size=args.min_fragment_size,
        domain_ave_size=args.domain_ave_size,
        conf_threshold=args.conf_threshold,
        save_pdb=args.save_pdb, save_domains=args.save_domains,
        save_fasta=args.save_fasta, save_pdf=args.save_pdf,
        return_indices=args.return_indices,
        conf_filter=args.conf_filter, plddt_filter=args.plddt_filter,
    )


def _fix_positional_tail(args) -> None:
    """Disambiguate `input+ db_name output [tmp]`: argparse's greedy match
    leaves tmp=None and feeds the extra value to `input`. When that happened
    (the would-be db_name is not a database but the last 'input' is), shift
    the tail one slot right."""
    from .io.results import database_exists

    if (args.tmp is None and len(args.input) > 1
            and not database_exists(args.db_name)
            and database_exists(args.input[-1])):
        args.tmp = args.output
        args.output = args.db_name
        args.db_name = args.input.pop()
        logger.warning(
            "interpreted positionals reference-style as "
            "`input+ db_name output tmp`: db=%s output=%s tmp=%s",
            args.db_name, args.output, args.tmp)


def _do_search(args, inputs, inputs_are_ca, pdb_chain, fields_default):
    """The search stage shared by `search` and `easy-search`: scan, TM-align
    rescore, the TSVs, and the multi-domain search on request."""
    from .device import make_mesh
    from .io.results import (check_for_database, parse_output_format,
                             write_all_dom_search_results, write_search_results)
    from .pipeline.dbsearch import run_dbsearch
    from .pipeline.embed import load_foldclass_params
    from .pipeline.multidomain import multi_domain_search
    from .utils import profiling

    check_for_database(args.db_name)
    fields = parse_output_format(args.format, fields_default)
    search_output = args.output + "_search.tsv"
    insig_output = args.output + "_search_insignificant.tsv"
    for f in (search_output, insig_output):
        if os.path.exists(f):
            logger.warning("Search output file '%s' already exists. Results will be overwritten!", f)

    model = load_foldclass_params(args.weights, args.device)
    results, all_results = run_dbsearch(
        inputs, args.db_name, topk=args.topk, fastmode=args.fastmode,
        mincos=args.mincos, mintm=args.mintm, mincov=args.mincov,
        inputs_are_ca=inputs_are_ca, pdb_chain=pdb_chain,
        skip_tmalign=args.skip_tmalign, search_batchsize=args.search_batchsize,
        model=model, threads=max(args.threads, 0), precision=args.precision,
        search_index=args.search_index, nprobe=args.nprobe, nlist=args.nlist,
        ivf_rerank=args.ivf_rerank, mmap_cov_filter=args.mmap_cov_filter,
        tmalign_backend=args.tmalign_backend, device=args.device,
        mesh=make_mesh(args.mesh, args.device))

    with profiling.phase("write_results"):
        write_search_results(results, search_output, fields,
                             header=args.output_headers, metadata_json=args.metadata_json)
        if args.report_insignificant_hits:
            write_search_results(all_results, insig_output, fields,
                                 header=args.output_headers,
                                 metadata_json=args.metadata_json)
    if args.multi_domain_search:
        with profiling.phase("multi_domain"):
            fl = multi_domain_search(
                inputs, results, args.db_name, fastmode=args.fastmode,
                mintm=args.mintm, inputs_from_easy_search=inputs_are_ca,
                mode=args.multi_domain_mode, tmalign_backend=args.tmalign_backend,
                threads=max(args.threads, 0), model=model, device=args.device)
        if fl is not None:
            write_all_dom_search_results(fl, args.output + "_search_multi_dom.tsv",
                                         args.output_headers)
    return results


def search(argv):
    from .io.results import SEARCH_FIELDS
    from .utils import profiling

    p = argparse.ArgumentParser(
        prog="merizo_search_tpu_torch search",
        description="Search query PDBs against a Foldclass database.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("input", type=str, nargs="+")
    p.add_argument("db_name", type=str)
    p.add_argument("output", type=str)
    p.add_argument("tmp", type=str, nargs="?", default=None,
                   help="Accepted for reference-CLI parity; unused.")
    p.add_argument("--format", type=str, default=SEARCH_FIELDS)
    p.add_argument("--pdb_chain", type=str, default="A")
    _add_search_flags(p)
    args = p.parse_args(argv)
    _fix_positional_tail(args)
    _ensure_parent(args.output)
    t0 = time.time()
    with profiling.trace(args.trace):
        results = _do_search(args, args.input, inputs_are_ca=False,
                             pdb_chain=args.pdb_chain, fields_default=SEARCH_FIELDS)
    profiling.report(logger)
    logger.info("Finished search in %.3f seconds.", time.time() - t0)
    return results


def easy_search(argv):
    """Segment the query chains, then search their domains (parity: the
    JAX package's `easy-search`, the reference's merizo.py easy-search)."""
    from .io.results import EASY_SEARCH_FIELDS, write_segment_results
    from .models.merizo.network import load_merizo_params
    from .segment.outputs import run_merizo
    from .utils import profiling

    p = argparse.ArgumentParser(
        prog="merizo_search_tpu_torch easy-search",
        description="Segment a multidomain chain and search it against a database.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("input", type=str, nargs="+")
    p.add_argument("db_name", type=str)
    p.add_argument("output", type=str)
    p.add_argument("tmp", type=str, nargs="?", default=None,
                   help="Accepted for reference-CLI parity; unused.")
    p.add_argument("--format", type=str, default=EASY_SEARCH_FIELDS)
    _add_search_flags(p)
    _add_merizo_flags(p)
    args = p.parse_args(argv)
    _fix_positional_tail(args)
    _ensure_parent(args.output)
    t0 = time.time()
    with profiling.trace(args.trace):
        seg_out = args.output + "_segment.tsv"
        if os.path.exists(seg_out):
            logger.warning("Segment output file '%s' already exists. Results will be overwritten!", seg_out)
        chains = args.pdb_chain.rstrip(",").split(",")
        if len(chains) == 1:
            chains = chains * len(args.input)
        model = load_merizo_params(args.merizo_weights, args.device)
        domains, seg_results = run_merizo(model, args.input, pdb_chains=chains,
                                          merizo_output=args.merizo_output,
                                          **_merizo_kw(args))
        write_segment_results(seg_results, seg_out, header=args.output_headers)
        results = None
        if len(domains) == 0:
            logger.info("easy-search finished after segmentation. "
                        "Segmentation of this PDB file was not possible")
        else:
            results = _do_search(args, domains, inputs_are_ca=True, pdb_chain=None,
                                 fields_default=EASY_SEARCH_FIELDS)
    profiling.report(logger)
    logger.info("Finished easy-search in %.3f seconds.", time.time() - t0)
    return results


def segment(argv):
    from .io.results import write_segment_results
    from .models.merizo.network import load_merizo_params
    from .segment.outputs import run_merizo
    from .utils import profiling

    p = argparse.ArgumentParser(
        prog="merizo_search_tpu_torch segment",
        description="Segment multidomain proteins into domains.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("input", type=str, nargs="+")
    p.add_argument("output", type=str,
                   help="Output prefix; results land in <output>_segment.tsv.")
    _add_device_flag(p)
    p.add_argument("-t", "--threads", type=int, default=-1,
                   help="Accepted for reference-CLI parity; unused.")
    p.add_argument("--output_headers", action="store_true", default=False)
    _add_trace_flag(p)
    _add_merizo_flags(p)
    args = p.parse_args(argv)
    _ensure_parent(args.output)

    out = args.output + "_segment.tsv"
    if os.path.exists(out):
        logger.warning("Segment output file '%s' already exists. Results will be overwritten!", out)
    t0 = time.time()
    with profiling.trace(args.trace):
        model = load_merizo_params(args.merizo_weights, args.device)
        chains = args.pdb_chain.rstrip(",").split(",")
        if len(chains) == 1:
            chains = chains * len(args.input)
        _, results = run_merizo(model, args.input, pdb_chains=chains,
                                merizo_output=args.merizo_output, **_merizo_kw(args))
        write_segment_results(results, out, header=args.output_headers)
    profiling.report(logger)
    logger.info("Finished segment in %.3f seconds.", time.time() - t0)
    return results


def createdb(argv):
    from .device import make_mesh
    from .pipeline.createdb import run_createdb
    from .utils import profiling

    p = argparse.ArgumentParser(
        prog="merizo_search_tpu_torch createdb",
        description="Embed a directory of PDB files into a Foldclass database.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("input_dir", type=str)
    p.add_argument("out_db", type=str)
    _add_device_flag(p)
    p.add_argument("--db_format", type=str, default="pt", choices=["pt", "mmap"],
                   help="'pt' = reference small-DB layout; 'mmap' = large resumable layout.")
    p.add_argument("--precision", type=str, default=None, choices=["int8", "bf16"],
                   help="Also write a quantised embedding sidecar (mmap layout "
                        "only). The fp32 file stays authoritative for reference "
                        "interop.")
    p.add_argument("--resume", action="store_true", default=False)
    p.add_argument("--weights", type=str, default=None,
                   help="Path to a Foldclass state dict (.pt); default: the JAX "
                        "package's default weights.")
    p.add_argument("--mesh", type=int, default=0,
                   help="Embed data parallel across this many devices of -d's "
                        "type (0: no mesh).")
    _add_trace_flag(p)
    args = p.parse_args(argv)
    if args.precision and args.db_format != "mmap":
        p.error("--precision requires --db_format mmap")
    _ensure_parent(args.out_db)

    t0 = time.time()
    with profiling.trace(args.trace):
        n = run_createdb(args.input_dir, args.out_db, weights=args.weights,
                         fmt=args.db_format, resume=args.resume, device=args.device,
                         sidecar=args.precision, mesh=make_mesh(args.mesh, args.device))
    profiling.report(logger)
    logger.info("Finished createdb in %.3f seconds.", time.time() - t0)
    return n


def serve(argv):
    """Run the persistent search server (parity: the JAX package's `serve`:
    the same flags and defaults, with -d cuda|cpu)."""
    p = argparse.ArgumentParser(
        prog="merizo_search_tpu_torch serve",
        description="Run a persistent search server: DB resident on the card, "
                    "models loaded once, queries over HTTP.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("db_name", type=str)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8086)
    _add_device_flag(p)
    p.add_argument("--mesh", type=int, default=0,
                   help="Shard the DB across this many devices of -d's type "
                        "(0: no mesh).")
    p.add_argument("--precision", type=str, default="bf16",
                   choices=["fp32", "bf16", "int8"])
    p.add_argument("--weights", type=str, default=None)
    p.add_argument("--merizo_weights", type=str, default=None)
    p.add_argument("--tmalign_backend", type=str, default="auto",
                   choices=["auto", "native", "tpu"])
    p.add_argument("--search_index", type=str, default="flat",
                   choices=["flat", "ivf"])
    p.add_argument("--nprobe", type=int, default=32)
    p.add_argument("--nlist", type=int, default=0)
    p.add_argument("--ivf_rerank", action="store_true", default=False,
                   help="Exact f32 re-rank of the top probed blocks "
                        "(see search --help).")
    p.add_argument("--max_batch", type=int, default=64,
                   help="Dynamic micro-batching: concurrent /search requests "
                        "coalesce into batches up to this size (1 disables).")
    p.add_argument("--batch_window_ms", type=float, default=4.0,
                   help="Max time a /search request lingers for co-batched "
                        "requests.")
    args = p.parse_args(argv)

    from .device import make_mesh
    from .server import serve as run_server

    return run_server(args.db_name, host=args.host, port=args.port,
                      precision=args.precision, weights=args.weights,
                      merizo_weights=args.merizo_weights,
                      tmalign_backend=args.tmalign_backend,
                      search_index=args.search_index, nprobe=args.nprobe,
                      nlist=args.nlist, ivf_rerank=args.ivf_rerank,
                      max_batch=args.max_batch, batch_window_ms=args.batch_window_ms,
                      device=args.device, mesh=make_mesh(args.mesh, args.device))


def dbinfo(argv):
    """Inspect / verify a Foldclass database (parity: the reference's
    standalone dbutil.py harness, dbutil.py:148-205, which prints name/seq
    per id as a manual consistency check of the mmap layout)."""
    import numpy as np

    from .db.codecs import FlatDB, write_quantized_sidecar

    p = argparse.ArgumentParser(
        prog="merizo_search_tpu_torch dbinfo",
        description="Print database layout info and spot-check entries.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("db_name", type=str)
    p.add_argument("--ids", type=str, default=None,
                   help="Comma-separated entry ids to print (name, seq len, "
                        "coord shape, metadata).")
    p.add_argument("--verify", action="store_true", default=False,
                   help="Consistency-check every entry: seq/coord lengths "
                        "match, names decode, embeddings finite.")
    p.add_argument("--sample", type=int, default=1000,
                   help="With --verify: entries to check (0 = all).")
    p.add_argument("--write-sidecar", type=str, default=None,
                   choices=["int8", "bf16"], dest="write_sidecar",
                   help="Add a quantised embedding sidecar to an existing "
                        "mmap-layout DB (incl. reference-built ones).")
    args = p.parse_args(argv)

    if args.write_sidecar:
        if not os.path.exists(args.db_name + ".json"):
            p.error("--write-sidecar needs an mmap-layout DB "
                    f"({args.db_name}.json not found; .pt DBs are loaded "
                    "whole and quantised in memory, no sidecar needed)")
        write_quantized_sidecar(args.db_name, args.write_sidecar)

    db = FlatDB.open(args.db_name)
    emb = db.embeddings()
    print(f"format:     {db.kind}")
    print(f"entries:    {db.size}")
    print(f"dim:        {db.dim}")
    print(f"dtype:      {emb.dtype}")
    print(f"normalised: {db.normalised}")
    print(f"sidecars:   "
          f"{' '.join(k for k in ('int8', 'bf16') if db.has_quant(k)) or 'none'}")
    print(f"metadata:   {'yes' if getattr(db, '_meta_blob', None) else 'no'}")
    lens = db.lengths()
    print(f"lengths:    min {int(lens.min())}  median {int(np.median(lens))} "
          f" max {int(lens.max())}")

    if args.ids:
        for i in (int(x) for x in args.ids.split(",")):
            name, coords, seq = db.entry(i)
            print(f"[{i}] {name}  len={len(seq)}  coords={coords.shape}  "
                  f"meta={db.metadata(i)!r}")

    if args.verify:
        ids = np.arange(db.size)
        if args.sample and db.size > args.sample:
            ids = np.linspace(0, db.size - 1, args.sample).astype(np.int64)
        bad = 0
        for i in ids:
            try:
                name, coords, seq = db.entry(int(i))
                ok = (len(seq) == coords.shape[0] and coords.shape[1] == 3
                      and bool(np.isfinite(coords).all())
                      and bool(np.isfinite(np.asarray(emb[int(i)], np.float32)).all()))
            except Exception as e:
                logger.error("entry %d: %s", i, e)
                ok = False
            if not ok:
                bad += 1
                logger.error("entry %d (%s) failed consistency check", i, db.name(int(i)))
        print(f"verify:     {len(ids) - bad}/{len(ids)} entries OK")
        if bad:
            sys.exit(1)


def main(argv=None):
    setup_logging()
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(USAGE)
        return
    mode, rest = argv[0], argv[1:]
    if mode in ("-V", "--version"):
        from . import __version__
        print(f"merizo-search-tpu-torch {__version__}")
        return
    verbs = {"segment": segment, "createdb": createdb, "search": search,
             "easy-search": easy_search, "serve": serve, "dbinfo": dbinfo}
    if mode not in verbs:
        print(f"Mode {mode!r} is not available: the PyTorch/CUDA port runs "
              f"{', '.join(repr(v) for v in verbs)} (ROADMAP.md lists the "
              "verbs still to port).")
        sys.exit(2)
    try:
        return verbs[mode](rest)
    except FileNotFoundError as e:
        # a bad database path is a user-input error, not a crash: log and
        # exit like the reference (dbsearch.py:72)
        logger.error("missing file: %s", e)
        sys.exit(1)


if __name__ == "__main__":
    main()
