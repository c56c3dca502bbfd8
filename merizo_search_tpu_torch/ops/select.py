"""Phase B of the fused scan: the blocks each query's phase C rescores.

`phase_b` launches the CUDA kernel in csrc/select.cu for CUDA tensors (its
header says what bounds it and how it is built) and runs `phase_b_plain`,
the plain PyTorch version of the same contract, for CPU tensors. The
kernel replaces no TPU kernel: the JAX package left this selection to XLA.
`selected_scales` is the scale half alone, for a selection made elsewhere.

Contract (both versions), for BM [Q, NB] float32 (phase A's block maxima),
n_valid and k, with K = min(k + 1, NB) and KB = K + 1:
- bidx [Q, KB] int32: columns 0..K-1 the K blocks of largest BM, by value
  descending, ties by lower block id, on an order-preserving uint32 key of
  the float's bits (so -0.0 < +0.0); column K the block that straddles
  n_valid, min(n_valid // 128, NB - 1), which is -1 in columns 0..K-1;
- scale_sel [Q, KB] float32, with the int8 DB's block-uniform per-row
  `scales` [NB * 128]: each selected block's scale, 1.0 where bidx is -1.

Both versions take the same steps (`plan`): the K largest 64-bit
composites (`composite`: key, then ~id) of each slice of at most WMAX
entries of BM, then of slices of at most PCAP of those candidates, until
one slice a query is left, whose K winners are sorted. K above SORT_K
sorts whole rows instead. The composites of a row are distinct, so every
level's candidate set, and the result, is exact and the same in both.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from .topk import BLOCK

LAUNCHES = profiling.declare("select.launches")   # kernel launches (plain runs not counted)

WMAX = 20_480       # BM entries a slice of the first level (80 KB of shared memory)
PCAP = 8_192        # candidate pairs a slice of a later level (64 KB)
SORT_K = 2_048      # the largest K one CTA sorts (csrc/select.cu SORT_CAP)
SORT_TILE = 4_096   # entries a shared-memory tile of the sort path
PAD = -(1 << 63)    # a slice's pad: below every composite of a real entry


def plan(nb: int, k: int):
    """(K, levels) of a selection over NB blocks: levels is a list of
    (pairs, n, width, slices), one a launch, where a launch reads n entries
    a row (BM's, or with `pairs` the previous level's candidates) in
    `slices` slices of `width` (the last one ragged) and keeps K of each;
    the last level has one slice a query. None where K > SORT_K."""
    kk = min(k + 1, nb)
    if kk > SORT_K:
        return kk, None
    levels, n, cap = [], nb, WMAX
    while True:
        width = -(-n // -(-n // cap))
        slices = -(-n // width)
        levels.append((bool(levels), n, width, slices))
        if slices == 1:
            return kk, levels
        n, cap = slices * kk, PCAP


def sort_launches(nb: int) -> int:
    """Kernel launches of the sort path over NB blocks: the tiles sorted,
    then for each merge size above a tile its wide strides and a tile
    pass, then the output."""
    p = 1 << max(nb - 1, 0).bit_length()
    t = min(p, SORT_TILE)
    return 2 + sum(s.bit_length() - t.bit_length() + 1
                   for s in (t << i for i in range(1, (p // t).bit_length())))


def launches(nb: int, k: int) -> int:
    """Kernel launches `phase_b` makes on a card for NB blocks and k."""
    kk, levels = plan(nb, k)
    return sort_launches(nb) if levels is None else len(levels)


def composite(bm):
    """int64 [Q, NB]: the order-preserving key of each float's bits (as a
    signed 32-bit number) times 2^32, plus 2^32 - 1 - the block id; the
    kernel's uint64 composite less 2^63, so in the same order."""
    bits = bm.contiguous().view(torch.int32).to(torch.int64)
    key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    ids = torch.arange(bm.shape[1], dtype=torch.int64, device=bm.device)
    return key * (1 << 32) + (0xFFFFFFFF - ids)


def _slice_top(comp, width: int, slices: int, kk: int):
    """A level: the kk largest composites of each slice of `width`, pads
    where a slice holds fewer -> [Q, slices * kk]."""
    nq, n = comp.shape
    padded = comp.new_full((nq, slices * width), PAD)
    padded[:, :n] = comp
    top = torch.topk(padded.view(nq, slices, width), min(kk, width), dim=2,
                     sorted=False).values
    if kk > width:
        top = torch.cat([top, top.new_full((nq, slices, kk - width), PAD)], dim=2)
    return top.reshape(nq, slices * kk)


def _validate(bm, scales):
    if bm.dim() != 2 or bm.dtype != torch.float32:
        raise TypeError(f"bm must be float32 [Q, NB], got {bm.dtype} {tuple(bm.shape)}")
    if scales is not None and tuple(scales.shape) != (bm.shape[1] * BLOCK,):
        raise ValueError(f"scales must be [{bm.shape[1] * BLOCK}], got {tuple(scales.shape)}")


def _straddle(n_valid: int, nb: int) -> int:
    return min(n_valid // BLOCK, nb - 1)


def _empty(bm, n_valid: int, k: int, scales):
    """The result where Q or NB is 0: no block to select, the straddle
    column alone where NB is 0."""
    nq, nb = bm.shape
    bidx = torch.full((nq, min(k + 1, nb) + 1), _straddle(n_valid, nb), dtype=torch.int32,
                      device=bm.device)
    return bidx, None if scales is None else torch.ones(bidx.shape, device=bm.device)


def phase_b_plain(bm, n_valid: int, k: int, scales=None):
    """Plain PyTorch phase B: (bidx, scale_sel or None) (module docstring),
    by the kernel's levels."""
    _validate(bm, scales)
    nq, nb = bm.shape
    if nq == 0 or nb == 0:
        return _empty(bm, n_valid, k, scales)
    kk, levels = plan(nb, k)
    comp = composite(bm)
    if levels is None:
        top = torch.sort(comp, dim=1, descending=True).values[:, :kk]
    else:
        for _, _, width, slices in levels[:-1]:
            comp = _slice_top(comp, width, slices, kk)
        top = torch.topk(comp, kk, dim=1).values
    ids = 0xFFFFFFFF - (top & 0xFFFFFFFF)
    straddle = _straddle(n_valid, nb)
    ids = torch.where(ids == straddle, -1, ids)
    bidx = torch.cat([ids, ids.new_full((nq, 1), straddle)], dim=1).to(torch.int32)
    return bidx, None if scales is None else scales_plain(scales, bidx)


def phase_b(bm, n_valid: int, k: int, scales=None):
    """Phase B: (bidx [Q, KB] int32, scale_sel [Q, KB] float32 or None
    without scales) (module docstring). CUDA tensors launch the kernel (or
    raise); CPU tensors run the plain version."""
    _validate(bm, scales)
    if bm.device.type == "cpu":
        return phase_b_plain(bm, n_valid, k, scales)
    from . import _build

    dev = bm.device
    nq, nb = bm.shape
    bm_p = _build.ptr(bm, "bm", torch.float32, device=dev)
    sc_p = _build.ptr(scales, "scales", torch.float32, device=dev)
    if nq == 0 or nb == 0:
        return _empty(bm, n_valid, k, scales)
    kk, levels = plan(nb, k)
    straddle = _straddle(n_valid, nb)
    bidx = torch.empty((nq, kk + 1), dtype=torch.int32, device=dev)
    ss = None if scales is None else torch.empty((nq, kk + 1), dtype=torch.float32, device=dev)
    ss_p = None if ss is None else ss.data_ptr()
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if levels is None:
            p = 1 << (nb - 1).bit_length()
            buf = torch.empty((nq, p), dtype=torch.int64, device=dev)
            _build.check_launch(lib.mst_select_sort(bm_p, nq, nb, kk, buf.data_ptr(), p,
                                                    bidx.data_ptr(), ss_p, sc_p, straddle,
                                                    stream), "select (sort)")
            for _ in range(sort_launches(nb)):
                profiling.count(LAUNCHES)
            return bidx, ss
        cands = []   # the previous level's candidates (keys, ids), held while read
        for pairs, n, width, slices in levels:
            last = slices == 1
            nxt = [] if last else [torch.empty((nq, slices * kk), dtype=torch.int32, device=dev)
                                   for _ in range(2)]
            inp = [t.data_ptr() for t in cands] or [bm_p, None]
            out = [t.data_ptr() for t in nxt] or [None, None]
            rc = lib.mst_select_level(int(pairs), int(last), *inp, nq, n, width, slices, kk,
                                      *out, bidx.data_ptr() if last else None,
                                      ss_p if last else None, sc_p, straddle, stream)
            _build.check_launch(rc, "select")
            profiling.count(LAUNCHES)
            cands = nxt
    return bidx, ss


def scales_plain(scales, bidx):
    """scale_sel [Q, KB] float32 of a selection: the block scale of each
    selected block (from the block-uniform per-row `scales`), 1.0 where
    bidx is -1."""
    block_scale = scales.view(-1, BLOCK)[:, 0]
    return torch.where(bidx >= 0, block_scale[bidx.clamp(min=0).long()],
                       1.0).contiguous()


def selected_scales(scales, bidx):
    """scales_plain's result: a kernel for CUDA tensors, the plain version
    for CPU ones."""
    if bidx.device.type == "cpu":
        return scales_plain(scales, bidx)
    from . import _build

    dev = bidx.device
    args = (_build.ptr(bidx, "bidx", torch.int32, device=dev),
            _build.ptr(scales, "scales", torch.float32, device=dev))
    out = torch.empty(bidx.shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.library().mst_selected_scales(*args, out.data_ptr(), bidx.numel(),
                                                  torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "selected_scales")
    profiling.count(LAUNCHES)
    return out
