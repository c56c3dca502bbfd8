"""Result formatting and TSV output.

Parity: programs/utils.py:8-185 — same field vocabulary, ordering, separators
and numeric formats, so downstream consumers of the reference's TSVs can
switch without changes. The writers of the `search`, `segment` and
`easy-search` verbs, and of the multi-domain search's rows.
"""

from __future__ import annotations

import ast
import json
import logging
import os

logger = logging.getLogger(__name__)

SEARCH_FIELDS = "query,emb_rank,target,emb_score,q_len,t_len,ali_len,seq_id,q_tm,t_tm,max_tm,rmsd,metadata"
EASY_SEARCH_FIELDS = "query,chopping,conf,plddt,emb_rank,target,emb_score,q_len,t_len,ali_len,seq_id,q_tm,t_tm,max_tm,rmsd,metadata"

_HEADER_NAMES = {
    "conf": "dom_conf",
    "plddt": "dom_plddt",
}


def parse_output_format(format_str: str, expected_str: str) -> list[str]:
    wanted = format_str.split(",")
    expected = set(expected_str.split(","))
    if not wanted:
        raise ValueError("No fields found in the provided format string.")
    for f in wanted:
        if f not in expected:
            raise ValueError(f"Format option '{f}' is not recognized.")
    return wanted


def database_exists(db_name: str) -> bool:
    """True if `db_name` names a complete database in either on-disk layout."""
    if os.path.exists(db_name + ".json"):
        return True
    return os.path.exists(db_name + ".pt") and os.path.exists(db_name + ".index")


def check_for_database(db_name: str) -> None:
    """Parity: programs/utils.py:23-35."""
    if os.path.exists(db_name + ".json"):
        return
    if not os.path.exists(db_name + ".pt"):
        raise FileNotFoundError(f"Cannot find database file {db_name}.pt")
    if not os.path.exists(db_name + ".index"):
        raise FileNotFoundError(f"Cannot find database file {db_name}.index")


def _fmt_field(option: str, rank, match: dict) -> str:
    tm = match.get("tmalign_output") or {}
    if option == "query":
        return str(match["query"])
    if option == "target":
        return str(match["target"])
    if option == "chopping":
        return str(match.get("dom_str"))
    if option == "conf":
        return "{:.4f}".format(match["dom_conf"])
    if option == "plddt":
        return "{:.4f}".format(match["dom_plddt"])
    if option == "emb_rank":
        return "{}".format(rank)
    if option == "emb_score":
        return "{:.4f}".format(float(match["score"]))
    if option == "q_len":
        return "{}".format(match["q_len"])
    if option == "t_len":
        return "{}".format(match["t_len"])
    if option == "ali_len":
        return "{}".format(tm.get("len_ali"))
    if option == "seq_id":
        return "{:.4f}".format(tm.get("seq_id", 0.0))
    if option == "q_tm":
        return "{:.4f}".format(tm.get("qtm", 0.0))
    if option == "t_tm":
        return "{:.4f}".format(tm.get("ttm", 0.0))
    if option == "max_tm":
        return "{:.4f}".format(max(tm.get("qtm", 0.0), tm.get("ttm", 0.0)))
    if option == "rmsd":
        return "{:.2f}".format(tm.get("rmsd", 0.0))
    if option == "metadata":
        return "{}".format(match.get("metadata", "{ }"))
    raise ValueError(f"Format option '{option}' is not recognized.")


def write_search_results(results: list[dict], output_file: str, format_list: list[str],
                         header: bool = False, metadata_json: bool = False) -> None:
    """Parity: programs/utils.py:37-158 (one row per hit, fields per
    format_list; optional side-car JSON of hit metadata)."""
    with open(output_file, "w+") as fn:
        if header:
            fn.write("\t".join(_HEADER_NAMES.get(o, o) for o in format_list) + "\n")
        for res in results:
            for rank, match in res.items():
                fn.write("\t".join(_fmt_field(o, rank, match) for o in format_list) + "\n")

    if metadata_json and results:
        md = []
        for res in results:
            for match in res.values():
                if match.get("metadata", "{ }") != "{ }":
                    try:
                        md.append(ast.literal_eval(match["metadata"]))
                    except (ValueError, SyntaxError):
                        md.append({"raw": match["metadata"]})
        jsonf = output_file + ".hit_metadata.json"
        json.dump(md, open(jsonf, "w"))
        logger.info("Metadata for hits written to %s", jsonf)


def write_segment_results(results: list[dict], output_file: str, header: bool = False) -> None:
    """Parity: programs/utils.py:161-176."""
    with open(output_file, "w+") as fn:
        if header:
            fn.write("filename\tnres\tnres_dom\tnres_ndr\tndom\tpIoU\truntime\tresult\n")
        for res in results:
            fn.write("{}\t{}\t{}\t{}\t{}\t{:.4f}\t{:.4f}\t{}\n".format(
                os.path.basename(res["name"]).replace(".pdb", ""),
                int(res["length"]), int(res["nres_domain"]),
                int(res["nres_non_domain"]), int(res["num_domains"]),
                res["conf"], res["time"], res["dom_str"]))


def write_all_dom_search_results(results, output_file: str, header: bool = False) -> None:
    """Parity: programs/utils.py:179-185 (multi-domain search rows)."""
    if results is None:
        return
    with open(output_file, "w+") as fn:
        if header:
            fn.write("query_chain\tnqd\thit_chain\tnhd\tmatch_category\tmatch_info\thit_metadata\n")
        for res in results:
            fn.write("\t".join(str(a) for a in res) + "\n")
