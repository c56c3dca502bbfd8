"""Segmentation pipeline: the run_merizo equivalent.

Reference flow (programs/Merizo/predict.py:142-197,34-114): feature
generation -> network forward -> in-forward cleanups -> optional iterative
re-segmentation of oversized domains -> graph component separation -> size
cleanups -> renumbering.

The network runs on the model's device; every sequential heuristic runs on
the host between calls. Each structure (and each residue subset of the
iterative mode) runs at its exact length, as the reference does: the JAX
package pads to length buckets and power-of-two batches only so that its jit
compiles few shapes, and eager PyTorch compiles nothing. So the batched
call returns per structure exactly what the single call returns. The
phases `segment.features` and `segment.network` are timed by
utils.profiling.
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..models.merizo.decoder import compact_domain_selection
from ..models.merizo.features import generate_features
from ..utils import bucketing, profiling
from . import postprocess as pp

logger = logging.getLogger(__name__)

N_CLASSES = 20
# the longest chain segmented: the last length bucket of both packages (the
# N^2 pair tensors; AFDB chains cap at 2700)
MAX_RES = bucketing.DEFAULT_BUCKETS[-1]


def _ids_from_network(dm: np.ndarray, bg: np.ndarray) -> np.ndarray:
    """Domain ids from one structure's network outputs (in-decoder cleanups
    with the reference's hardcoded thresholds, mask_decoder.py:191-195)."""
    pred = dm.argmax(-1).astype(np.int64)
    pred = pp.clean_domains(pred, 50)
    pred = pp.clean_singletons(pred, 10)
    return pred * bg.argmax(-1)


def _forward_subset(model, f: dict, sel: np.ndarray | None = None):
    """Run the network on (a subset of) the features at its exact length.

    Mirrors the reference's mask-cropped forward (network.py:35-40) plus the
    decoder tail (mask_decoder.py:186-214). Returns (dom_ids [n], conf [n])
    for the selected residues.
    """
    dev = next(model.parameters()).device
    if sel is None:
        sel = np.arange(f["nres"])
        z = f["z"]
    else:
        z = f["z"][np.ix_(sel, sel)]
    n = len(sel)

    def dev_t(x):
        return torch.from_numpy(np.ascontiguousarray(x))[None].to(dev)

    with profiling.phase("segment.network"):
        dm, bg = model.forward_features(dev_t(f["s"][sel]), dev_t(z[..., None]),
                                        dev_t(f["r"][sel]), dev_t(f["t"][sel]),
                                        dev_t(f["ri"][sel]))
        dom_ids = _ids_from_network(dm[0].cpu().numpy(), bg[0].cpu().numpy())
        conf = np.zeros(n, np.float32)
        ids, k = pp.get_ids(dom_ids)
        if k:
            sel_idx, sel_mask = compact_domain_selection(dom_ids, ids)
            c = model.domain_confidence(dm, torch.from_numpy(sel_idx).to(dev),
                                        torch.from_numpy(sel_mask).to(dev)).cpu().numpy()
            for j, d in enumerate(ids):
                conf[dom_ids == d] = c[j]
    return dom_ids, conf


def _iterative_segmentation(model, f, dom_ids, conf_res, max_iterations: int,
                            domain_ave_size: int):
    """Re-segment oversized domains (parity: predict.py:34-114)."""
    ignore: set[int] = set()
    for _ in range(max_iterations):
        candidates = {}
        for d in pp.get_ids(dom_ids)[0]:
            d = int(d)
            if d in ignore:
                continue
            n_d = int((dom_ids == d).sum())
            if n_d > domain_ave_size:
                candidates[d] = n_d
            else:
                ignore.add(d)
        if not candidates:
            break
        # counter restarts at 1 every outer iteration, faithful to the
        # reference (predict.py:78,101: `counter = 1` inside `while
        # iterate`), including its quirk that ids minted in iteration i+1
        # can collide with ids that survived iteration i (merging those
        # domains). Kept verbatim: chopping parity requires the same ids.
        counter = 1
        for d in candidates:
            sel = np.nonzero(dom_ids == d)[0]
            sub_ids, sub_conf = _forward_subset(model, f, sel)
            _, ndoms_ = pp.get_ids(sub_ids)
            if ndoms_ <= 1:
                ignore.add(d)
            else:
                dd = sub_ids + counter * N_CLASSES
                dd[sub_ids == 0] = 0
                dom_ids[sel] = dd
                conf_res[sel] = sub_conf
                counter += 1
    return dom_ids, conf_res


def _finalize(model, f: dict, dom_ids, conf_res, t0, iterate: bool,
              length_conditional_iterate: bool, max_iterations: int,
              min_domain_size: int, min_fragment_size: int,
              domain_ave_size: int, shuffle_indices: bool) -> dict:
    """Post-network tail (parity: predict.py:160-197)."""
    if length_conditional_iterate and f["nres"] > 512:
        iterate = True
    if iterate and f["nres"] > domain_ave_size * 2:
        dom_ids, conf_res = _iterative_segmentation(
            model, f, dom_ids, conf_res, max_iterations, domain_ave_size)

    domain_map = pp.instance_matrix(dom_ids)
    dom_ids = pp.separate_components(domain_map, f["z"], dom_ids)

    if len(np.unique(dom_ids)) > 1:
        dom_ids = pp.clean_domains(dom_ids, min_domain_size)
        dom_ids = pp.clean_singletons(dom_ids, min_fragment_size)

    f["domain_map"] = pp.instance_matrix(dom_ids)
    f["conf_res"] = conf_res
    f["conf_global"] = float(conf_res.mean()) if len(conf_res) else 0.0
    f["ndom"] = pp.get_ids(dom_ids)[1]
    f["domain_ids"] = (pp.shuffle_ids(dom_ids) if shuffle_indices
                       else pp.remap_ids(dom_ids))
    f["runtime"] = time.time() - t0
    return f


def _check_len(f: dict, path: str) -> dict:
    if f["nres"] > MAX_RES:
        raise ValueError(
            f"{path}: {f['nres']} residues exceeds the {MAX_RES}-residue "
            "segmentation limit (the attention pair tensors scale as "
            "N^2; AFDB chains cap at 2700)")
    return f


def _segment_features(model, f: dict, t0: float, iterate: bool = False,
                      length_conditional_iterate: bool = False,
                      max_iterations: int = 3, min_domain_size: int = 50,
                      min_fragment_size: int = 10, domain_ave_size: int = 200,
                      conf_threshold: float = 0.5,
                      shuffle_indices: bool = False) -> dict:
    dom_ids, conf_res = _forward_subset(model, f)
    return _finalize(model, f, dom_ids, conf_res, t0, iterate,
                     length_conditional_iterate, max_iterations,
                     min_domain_size, min_fragment_size, domain_ave_size,
                     shuffle_indices)


def segment_structure(model, path: str, chain: str = "A", **kw) -> dict:
    """Segment one structure. Returns the feature dict extended with
    domain_ids, conf_res, conf_global, ndom, domain_map, runtime (parity:
    predict.py:142-197).

    kw: iterate, length_conditional_iterate, max_iterations,
    min_domain_size, min_fragment_size, domain_ave_size, conf_threshold,
    shuffle_indices.
    """
    t0 = time.time()
    with profiling.phase("segment.features"):
        f = _check_len(generate_features(path, chain), path)
    return _segment_features(model, f, t0, **kw)


def segment_structures(model, paths: list[str], chains: list[str],
                       **kw) -> list[dict | None]:
    """Segment many structures: featurised on a host thread pool, then each
    through the network at its own length.

    Returns one finalised feature dict per input, or None for a file that
    could not be featurised when there are several inputs (logged and
    skipped, as run_merizo does). With a single input the error propagates:
    a wrong --pdb_chain must be a hard failure, not an empty result.
    kw: as segment_structure.
    """
    if not paths:
        raise ValueError("no input structures to segment (check the input "
                         "path exists and matches .pdb/.cif files)")

    with profiling.phase("segment.features"):
        if len(paths) == 1:
            feats = [_check_len(generate_features(paths[0], chains[0]), paths[0])]
        else:
            def featurise(args):
                path, chain = args
                try:
                    return _check_len(generate_features(path, chain), path)
                except (ValueError, KeyError, OSError) as e:
                    logger.warning("could not featurise %s: %s", path, e)
                    return None

            # PDB parsing, distance maps and frames are numpy kernels that
            # release the GIL
            with ThreadPoolExecutor(max_workers=min(8, len(paths))) as ex:
                feats = list(ex.map(featurise, zip(paths, chains)))
            if not any(f is not None for f in feats):
                raise ValueError("none of the input structures could be featurised")

    return [None if f is None else _segment_features(model, f, time.time(), **kw)
            for f in feats]
