"""Segmentation pipeline: the run_merizo equivalent.

Reference flow (programs/Merizo/predict.py:142-197,34-114): feature
generation -> network forward -> in-forward cleanups -> optional iterative
re-segmentation of oversized domains -> graph component separation -> size
cleanups -> renumbering.

The network runs on the model's device; every sequential heuristic runs on
the host between calls. Structures are grouped by length bucket (the JAX
package's buckets and batch sizes, so both batch the same structures
together) and each batch runs as one forward, padded to its longest
structure and masked. On the card a forward at batch 1 is bound by
launches, not work: the GRUs step one launch at a time and the attention
at a few hundred residues fills a fraction of the card, so a batch shares
every launch among up to 16 structures. (The JAX package batches so that
its jit compiles few shapes; eager PyTorch compiles nothing, so the batch
is padded to its longest member, not to the bucket, and not to a power of
two.) A single structure, and each residue subset of the iterative mode,
runs alone at its exact length, as the reference does. The phases
`segment.features` and `segment.network` are timed by utils.profiling.
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
# [B, L, L] pair elements of one batched forward, and the most structures a
# forward: the JAX segmenter's (its z dominates a batch's memory)
PAIR_BUDGET = 1 << 24
MAX_BATCH = 16


def _ids_from_network(dm: np.ndarray, bg: np.ndarray) -> np.ndarray:
    """Domain ids from one structure's network outputs (in-decoder cleanups
    with the reference's hardcoded thresholds, mask_decoder.py:191-195)."""
    pred = dm.argmax(-1).astype(np.int64)
    pred = pp.clean_domains(pred, 50)
    pred = pp.clean_singletons(pred, 10)
    return pred * bg.argmax(-1)


def _padded_features(feats: list[dict], width: int):
    """Stack whole structures' features into one batch of `width` rows:
    (s [B,L,20], z [B,L,L,1], r [B,L,3,3], t [B,L,3], ri [B,L],
    mask [B,L]). Padding rows get identity frames, zero translation and a
    zero residue index, as the JAX segmenter pads."""
    b = len(feats)
    s = np.zeros((b, width, 20), np.float32)
    z = np.zeros((b, width, width, 1), np.float32)
    r = np.tile(np.eye(3, dtype=np.float32), (b, width, 1, 1))
    t = np.zeros((b, width, 3), np.float32)
    ri = np.zeros((b, width), np.float32)
    mask = np.zeros((b, width), np.float32)
    for i, f in enumerate(feats):
        n = f["nres"]
        s[i, :n], z[i, :n, :n, 0], r[i, :n] = f["s"], f["z"], f["r"]
        t[i, :n], ri[i, :n], mask[i, :n] = f["t"], f["ri"], 1.0
    return s, z, r, t, ri, mask


def _forward_batch(model, feats: list[dict]) -> list[tuple[np.ndarray, np.ndarray]]:
    """One network forward over whole structures, padded to the longest of
    them, plus the decoder tail (reference: the mask-cropped forward,
    network.py:35-40, and mask_decoder.py:186-214). Returns (dom_ids [n],
    conf [n]) per structure.

    The lengths go to the network from the host, so its GRUs never ask the
    card; the batch is ordered longest first, so packing needs no sort
    order on the card either. The confidence heads of every domain of every
    structure run as one call.
    """
    dev = next(model.parameters()).device
    order = sorted(range(len(feats)), key=lambda i: -feats[i]["nres"])
    lens = [feats[i]["nres"] for i in order]
    width = lens[0]
    inputs = _padded_features([feats[i] for i in order], width)

    with profiling.phase("segment.network"):
        arrays = [torch.from_numpy(a).to(dev) for a in inputs]
        mask, lengths = (None, None) if lens[-1] == width else (arrays[5], torch.tensor(lens))
        dm, bg = model.forward_features(*arrays[:5], mask, lengths)
        dm_h, bg_h = dm.cpu().numpy(), bg.cpu().numpy()
        dom_ids = [_ids_from_network(dm_h[b, :n], bg_h[b, :n]) for b, n in enumerate(lens)]
        conf = [np.zeros(n, np.float32) for n in lens]
        sel_idx, sel_mask, owner = [], [], []
        for b, ids_b in enumerate(dom_ids):
            ids, k = pp.get_ids(ids_b)
            if k:
                si, sm = compact_domain_selection(ids_b, ids, width)
                sel_idx.append(si + b * width)    # rows of the flattened batch
                sel_mask.append(sm)
                owner += [(b, d) for d in ids]
        if owner:
            c = model.domain_confidence(dm.reshape(1, -1, N_CLASSES),
                                        torch.from_numpy(np.concatenate(sel_idx)).to(dev),
                                        torch.from_numpy(np.concatenate(sel_mask)).to(dev))
            for (b, d), cj in zip(owner, c.cpu().numpy()):
                conf[b][dom_ids[b] == d] = cj
    out = [None] * len(feats)
    for b, i in enumerate(order):
        out[i] = (dom_ids[b], conf[b])
    return out


def _forward_subset(model, f: dict, sel: np.ndarray | None = None):
    """Run the network on (a subset of) one structure at its exact length.
    Returns (dom_ids [n], conf [n]) for the selected residues."""
    if sel is not None:
        f = {"s": f["s"][sel], "z": f["z"][np.ix_(sel, sel)], "r": f["r"][sel],
             "t": f["t"][sel], "ri": f["ri"][sel], "nres": len(sel)}
    return _forward_batch(model, [f])[0]


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


def _finalize(model, f: dict, dom_ids, conf_res, t0: float, iterate: bool = False,
              length_conditional_iterate: bool = False, max_iterations: int = 3,
              min_domain_size: int = 50, min_fragment_size: int = 10,
              domain_ave_size: int = 200, conf_threshold: float = 0.5,
              shuffle_indices: bool = False) -> dict:
    """Post-network tail (parity: predict.py:160-197). conf_threshold is
    the CLI's and unused here, as in the reference."""
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
    return _finalize(model, f, *_forward_subset(model, f), t0, **kw)


def batch_size(bucket: int) -> int:
    """Structures of one length bucket a forward: the JAX segmenter's
    min(16, PAIR_BUDGET / bucket^2), so both packages batch alike."""
    return max(1, min(MAX_BATCH, PAIR_BUDGET // (bucket * bucket)))


def segment_structures(model, paths: list[str], chains: list[str],
                       **kw) -> list[dict | None]:
    """Segment many structures: featurised on a host thread pool, grouped by
    length bucket, and run `batch_size(bucket)` at a time through one
    network forward (the JAX segment_structures; the reference segments
    strictly one by one, predict.py:321-353). Iterative re-segmentation
    runs per structure. Each structure's runtime is its batch's wall time
    over the batch's size.

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

    live = [i for i, f in enumerate(feats) if f is not None]
    groups = bucketing.group_by_bucket([feats[i]["nres"] for i in live])
    results: list[dict | None] = [None] * len(feats)
    for bucket, pos in sorted(groups.items()):
        idxs = [live[p] for p in pos]
        bsz = batch_size(bucket)
        for c0 in range(0, len(idxs), bsz):
            t0 = time.time()
            sel = idxs[c0:c0 + bsz]
            for i, out in zip(sel, _forward_batch(model, [feats[i] for i in sel])):
                results[i] = _finalize(model, feats[i], *out, t0, **kw)
            dt = (time.time() - t0) / len(sel)
            for i in sel:
                results[i]["runtime"] = dt
    return results
