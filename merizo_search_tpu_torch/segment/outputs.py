"""Segmentation output generation.

Parity targets: write_pdb_predictions / write_fasta / write_domain_idx /
write_pdf_predictions (programs/Merizo/model/utils/utils.py:330-541) and
print_summary (predict.py:238-263). The occupancy column of the .pdb2 output
carries domain ids, the 'conf' values land in per-domain .dom_pdb files, and
the summary row matches the reference segment TSV schema. The port's copy
of the JAX package's module, over the port's segmenter.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from ..io.pdb import write_pdb_records, select_atoms, get_xyz, mol_to_fasta
from ..utils import profiling
from ..utils.residues import THREE_TO_ONE_EXT
from . import postprocess as pp
from .pipeline import segment_structures

logger = logging.getLogger(__name__)


def assign_atom_fields(f: dict) -> np.ndarray:
    """Copy per-residue domain ids / confidences onto the atom records
    (occupancy column <- domain id; parity utils.py:394-405)."""
    pdb = f["pdb"].copy()
    ri = f["ri"].astype(np.int64)
    id_by_resi = {int(r): int(d) for r, d in zip(ri, f["domain_ids"])}
    conf_by_resi = {int(r): float(c) for r, c in zip(ri, f["conf_res"])}
    pdb["occ"] = [id_by_resi.get(int(r), 0) for r in pdb["resi"]]
    pdb["conf"] = [conf_by_resi.get(int(r), 0.0) for r in pdb["resi"]]
    return pdb


def domains_as_list(f: dict, name_out: str) -> list[dict]:
    """Per-domain dicts consumed by the search stage (parity utils.py:409-440:
    coords/seq/name/dom_str/dom_conf/dom_plddt)."""
    pdb = assign_atom_fields(f)
    domains = []
    ids, _ = pp.get_ids(f["domain_ids"])
    for i, u in enumerate(ids):
        p = pdb[pdb["occ"] == int(u)]
        p_ca = select_atoms(p, "n", ["CA"])
        dom_str = pp.format_dom_str(p_ca["occ"].astype(np.int64), p_ca["resi"].astype(np.float64))
        domains.append({
            "coords": get_xyz(p_ca).astype(np.float32),
            "seq": "".join(THREE_TO_ONE_EXT.get(aa, "X") for aa in p_ca["resn"]),
            "name": f"{name_out}_{i + 1:02d}",
            "dom_str": dom_str,
            "dom_conf": float(np.mean(p_ca["conf"])) if len(p_ca) else 0.0,
            "dom_plddt": float(np.mean(p_ca["b"])) if len(p_ca) else 0.0,
        })
    return domains


def write_outputs(f: dict, name_dict: dict, output_dir: str,
                  save_pdb: bool = False, save_domains: bool = False,
                  save_fasta: bool = False, save_pdf: bool = False,
                  return_indices: bool = False, conf_filter=None, plddt_filter=None) -> list[dict]:
    """Generate files + the domain list (parity predict.py:199-236)."""
    os.makedirs(output_dir, exist_ok=True)
    outname = os.path.join(output_dir, name_dict["pdb_out"])
    pdb = assign_atom_fields(f)
    domains = domains_as_list(f, outname)

    if save_domains:
        domfname = outname + ".domains"
        if os.path.exists(domfname):
            logger.warning("%s exists, will be overwritten!", domfname)
            os.remove(domfname)
        ids, _ = pp.get_ids(f["domain_ids"])
        for i, (u, dom) in enumerate(zip(ids, domains)):
            keep = True
            if conf_filter is not None and dom["dom_conf"] < conf_filter:
                keep = False
            if plddt_filter is not None and dom["dom_plddt"] < plddt_filter:
                keep = False
            if keep:
                with open(domfname, "a") as fn:
                    fn.write("{}\t{:.0f}\t{}\t{:.3f}\t{:.3f}\t{:.0f}\t{}\n".format(
                        os.path.basename(outname), i + 1, len(dom["coords"]),
                        dom["dom_conf"], dom["dom_plddt"], int(u), dom["dom_str"]))
            p = pdb[pdb["occ"] == int(u)]
            write_pdb_records(p, dom["name"] + ".dom_pdb")
        write_pdb_records(pdb, outname + ".pdb2")
    elif save_pdb:
        write_pdb_records(pdb, outname + ".pdb2")

    if save_fasta:
        with open(outname + ".fasta", "w") as fh:
            fh.write(">" + os.path.basename(name_dict["pdb_name"]) + "\n")
            fh.write(mol_to_fasta(f["pdb"]) + "\n")

    if return_indices:
        with open(outname + ".idx", "w") as fh:
            fh.write(",".join("{:.0f}:{:.0f}".format(r, i)
                              for r, i in zip(f["ri"], f["domain_ids"])) + "\n")

    if save_pdf:
        _write_pdf(f, name_dict, outname)

    return domains


def _write_pdf(f: dict, name_dict: dict, outname: str) -> None:
    """Domain-map PDF plot (parity utils.py:330-365); no-op without matplotlib."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import matplotlib.colors as mc
    except ImportError:
        logger.warning("matplotlib unavailable; skipping PDF output")
        return
    dm = f["domain_map"]
    conf_map = np.sqrt(np.outer(f["conf_res"], f["conf_res"])) * dm
    hexcols = ["#e6e6f3", "#cccce6", "#9999cc", "#6666b3", "#33339a", "#000080"]
    steps = [0.0, 0.2, 0.4, 0.6, 0.8, 1.0]
    cdict = {"red": (), "green": (), "blue": ()}
    for s, hx in zip(steps, hexcols):
        rgb = mc.hex2color(hx)
        for ch, v in zip(("red", "green", "blue"), rgb):
            cdict[ch] = cdict[ch] + ((s, v, v),)
    cm = mc.LinearSegmentedColormap("merizo", cdict)
    _, ax = plt.subplots(1, 2, figsize=(10, 5))
    plt.gcf().suptitle("{} | {} predicted domains".format(
        name_dict["pdb_name"], f["ndom"]), fontsize=18)
    ax[0].matshow(dm, cmap=cm)
    ax[1].matshow(conf_map, cmap=cm)
    ax[0].set(xlabel="Predicted Domain Map")
    ax[1].set(xlabel="Domain Confidence")
    plt.tight_layout()
    plt.savefig(outname + ".pdf", format="pdf")
    plt.close()


def summary_row(f: dict, name_dict: dict) -> dict:
    """Per-structure summary (parity predict.py:238-263)."""
    nres_domain = int(np.count_nonzero(f["domain_ids"]))
    return {
        "name": name_dict["pdb_name"],
        "length": f["nres"],
        "nres_domain": nres_domain,
        "nres_non_domain": f["nres"] - nres_domain,
        "num_domains": f["ndom"],
        "conf": f["conf_global"],
        "time": f["runtime"],
        "dom_str": pp.format_dom_str(f["domain_ids"], f["ri"]),
    }


def run_merizo(model, input_paths: list[str], pdb_chains: list[str] | None = None,
               merizo_output: str | None = None, **kw):
    """Segment many structures with the MerizoNet `model` (parity
    predict.py:265-355).

    kw: iterate, length_conditional_iterate, max_iterations, shuffle_indices,
    min_domain_size, min_fragment_size, domain_ave_size, conf_threshold,
    save_pdb, save_domains, save_fasta, save_pdf, return_indices,
    conf_filter, plddt_filter.

    Returns (segment_domains, segment_results).
    """
    out_kw = {k: kw.pop(k) for k in ("save_pdb", "save_domains", "save_fasta",
                                     "save_pdf", "return_indices", "conf_filter",
                                     "plddt_filter") if k in kw}
    if pdb_chains is None:
        pdb_chains = ["A"] * len(input_paths)
    elif len(pdb_chains) != len(input_paths):
        # zip() would silently drop the unmatched tail of input_paths
        raise ValueError(
            "Number of specified chain IDs not equal to number of input "
            f"PDB files ({len(pdb_chains)} vs {len(input_paths)}).")
    merizo_output = merizo_output or os.getcwd()

    paths, chains = [], []
    for path, chain in zip(input_paths, pdb_chains):
        if not os.path.exists(path):
            logger.warning("input %s does not exist; skipping", path)
            continue
        paths.append(path)
        chains.append(chain)

    with profiling.phase("segment"):
        feats = segment_structures(model, paths, chains, **kw)

    segment_domains, segment_results = [], []
    for path, f in zip(paths, feats):
        if f is None:
            continue
        pdb_name = os.path.basename(path)
        pdb_bn = os.path.splitext(pdb_name)[0]
        name_dict = {"pdb_name": pdb_name, "pdb_path": path,
                     "pdb_bn": pdb_bn, "pdb_out": pdb_bn + "_merizo"}
        domains = write_outputs(f, name_dict, merizo_output, **out_kw)
        segment_domains.extend(domains)
        segment_results.append(summary_row(f, name_dict))
    return segment_domains, segment_results
