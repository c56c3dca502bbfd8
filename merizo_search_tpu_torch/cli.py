"""Command-line interface of the port: the `search` verb.

    python -m merizo_search_tpu_torch.cli search query.pdb [...] db_name output [tmp] [flags]

The same positionals, flags, defaults and output files as the JAX package's
`search` verb (itself the reference's, merizo.py:33-443), with `-d cuda|cpu`
choosing the device (default cuda; asking for cuda without a card is an
error, not a fallback). Flags of modes the port does not run yet (--mesh,
--search_index ivf, --multi_domain_search, --tmalign_backend tpu, --trace)
raise NotImplementedError; ROADMAP.md lists them in the order they come.
The other verbs (segment, createdb, easy-search, dbinfo, serve) are later
slices.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

logger = logging.getLogger(__name__)

USAGE = """usage: python -m merizo_search_tpu_torch.cli search <input.pdb> [...] <db_name> <output> [flags]

The PyTorch/CUDA port runs the `search` verb; see `search --help`."""


def setup_logging():
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s | %(levelname)s | %(message)s")


def _ensure_parent(path: str):
    """Create the parent directory of an output prefix if missing."""
    parent = os.path.dirname(os.path.abspath(path))
    if parent:
        os.makedirs(parent, exist_ok=True)


def _add_search_flags(p: argparse.ArgumentParser):
    p.add_argument("-d", "--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Device to run on. 'cuda' raises when no card is present.")
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
                   help="Stream-mode block size (the stream mode is not ported "
                        "yet; device mode ignores it).")
    p.add_argument("--search_metric", type=str, default="IP",
                   help="Only 'IP' (cosine) is supported.")
    p.add_argument("--report_insignificant_hits", action="store_true", default=False)
    p.add_argument("--metadata_json", action="store_true", default=False)
    p.add_argument("--output_headers", action="store_true", default=False)
    p.add_argument("--multi_domain_search", action="store_true", default=False,
                   help="Not ported yet.")
    p.add_argument("--multi_domain_mode", type=str, default="exhaustive_tmalign",
                   choices=["exhaustive_tmalign", "embscore"])
    p.add_argument("--skip_tmalign", action="store_true", default=False,
                   help="Skip TM rescoring (embedding scores only).")
    p.add_argument("--tmalign_backend", type=str, default="auto",
                   choices=["auto", "native", "tpu"],
                   help="'auto' and 'native' run the in-process C++ TM-align; "
                        "the batched device aligner ('tpu') is not ported yet.")
    p.add_argument("--mesh", type=int, default=0,
                   help="Shard the DB across this many devices (not ported yet).")
    p.add_argument("--precision", type=str, default="bf16",
                   choices=["fp32", "bf16", "int8"],
                   help="On-device DB storage for the scan: bf16 and int8 run the "
                        "fused CUDA scan, fp32 the plain exact scan.")
    p.add_argument("--weights", type=str, default=None,
                   help="Path to a Foldclass state dict (.pt).")
    p.add_argument("--search_index", type=str, default="flat",
                   choices=["flat", "ivf"], help="'ivf' is not ported yet.")
    p.add_argument("--nprobe", type=int, default=32)
    p.add_argument("--nlist", type=int, default=0)
    p.add_argument("--ivf_rerank", action="store_true", default=False)
    p.add_argument("--mmap_cov_filter", action="store_true", default=False,
                   help="Apply the -c/--mincov coverage filters on mmap "
                        "databases too (the reference never implemented "
                        "mincov on its mmap path; this makes pt and mmap "
                        "layouts return identical hit sets).")
    p.add_argument("--trace", type=str, default=None, metavar="DIR",
                   help="Device trace (not ported yet).")


def _reject_unported(args):
    unported = [(args.mesh, "--mesh"),
                (args.search_index != "flat", "--search_index ivf"),
                (args.multi_domain_search, "--multi_domain_search"),
                (args.tmalign_backend == "tpu", "--tmalign_backend tpu"),
                (args.trace, "--trace")]
    for given, flag in unported:
        if given:
            raise NotImplementedError(
                f"{flag} is not ported to the PyTorch package yet (ROADMAP.md, queue 1)")


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


def search(argv):
    from .io.results import (SEARCH_FIELDS, check_for_database,
                             parse_output_format, write_search_results)
    from .pipeline.dbsearch import run_dbsearch
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
    _reject_unported(args)
    _fix_positional_tail(args)
    _ensure_parent(args.output)
    t0 = time.time()

    check_for_database(args.db_name)
    fields = parse_output_format(args.format, SEARCH_FIELDS)
    search_output = args.output + "_search.tsv"
    insig_output = args.output + "_search_insignificant.tsv"
    for f in (search_output, insig_output):
        if os.path.exists(f):
            logger.warning("Search output file '%s' already exists. Results will be overwritten!", f)

    results, all_results = run_dbsearch(
        args.input, args.db_name, topk=args.topk, fastmode=args.fastmode,
        mincos=args.mincos, mintm=args.mintm, mincov=args.mincov,
        pdb_chain=args.pdb_chain, skip_tmalign=args.skip_tmalign,
        weights=args.weights, threads=max(args.threads, 0),
        precision=args.precision, mmap_cov_filter=args.mmap_cov_filter,
        device=args.device)

    with profiling.phase("write_results"):
        write_search_results(results, search_output, fields,
                             header=args.output_headers, metadata_json=args.metadata_json)
        if args.report_insignificant_hits:
            write_search_results(all_results, insig_output, fields,
                                 header=args.output_headers,
                                 metadata_json=args.metadata_json)
    profiling.report(logger)
    logger.info("Finished search in %.3f seconds.", time.time() - t0)
    return results


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
    if mode != "search":
        print(f"Mode {mode!r} is not available: the PyTorch/CUDA port runs "
              "'search' (ROADMAP.md lists the verbs still to port).")
        sys.exit(2)
    try:
        search(rest)
    except FileNotFoundError as e:
        # a bad database path is a user-input error, not a crash: log and
        # exit like the reference (dbsearch.py:72)
        logger.error("missing file: %s", e)
        sys.exit(1)


if __name__ == "__main__":
    main()
