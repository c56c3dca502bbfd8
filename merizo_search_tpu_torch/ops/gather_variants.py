"""The phase-C gather variants: `gather_variant`, four modes of one kernel.

Launches the CUDA kernel in csrc/gather_variants.cu for CUDA tensors and
runs `gather_variant_plain`, the plain PyTorch version of the same
contract, for CPU tensors. The kernel replaces two Pallas kernels of the
JAX package's measurement tool tools/perf_gather_int8.py: the kernel of
`gather_variant` (modes dma_only, concat_only, full) and that of
`gather_int32view` (mode int32view). The port's tool of the same name runs
them.

Contract (both versions), for q [Q, 128] and db [NB*128, 128] of one dtype
(bf16 or int8; int32view: int8), bidx [Q, KB] int32 (a negative index
reads block 0) and groups of g selected blocks (KB % g == 0): out float32
[Q, KB/g, g, 128], for query i and group j (blocks bidx[i, j*g + 0..g-1]):
- dma_only:    the f32 sum of row 0 of each block, in block order, at every g;
- concat_only: row 0 of the first block as f32, at every g;
- full:        the exact scores of query i against every row of the group
               (phase C: gather_block_scores with no scales);
- int32view:   the int8 DB read as int32 [NB, 128, 32]: lanes 0..31 the f32
               sum, in block order, of the words of row 0 of each block
               (int32 -> f32 rounds, so the order matters), lanes 32..127 0,
               at every g.
The sums run acc = 0, then acc + block g for g = 0..g-1, as the JAX kernels
add. Beside out, every mode but full returns a sink: the XOR of every
32-bit word of every block the call selects (a block selected twice cancels
itself), as a 0-dim int64 in [0, 2^32), so the kernel provably read whole
blocks, as the TPU kernels moved them; full returns None.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from .blockmax import _DTYPE_CODE
from .gather import gather_plain
from .probes import xor_words
from .topk import BLOCK

MODES = ("dma_only", "concat_only", "full", "int32view")
G = 34                 # the JAX tool's group and selection width
KB = 102

# kernel launches a mode (plain runs not counted)
LAUNCHES = {m: profiling.declare(f"gather_variants.{m}.launches") for m in MODES}


def _validate(q, db, bidx, mode, g):
    if q.dim() != 2 or db.dim() != 2 or q.shape[1] != 128 or db.shape[1] != 128:
        raise ValueError(f"q and db must be [*, 128], got {tuple(q.shape)}, {tuple(db.shape)}")
    if db.shape[0] % BLOCK or db.shape[0] == 0:
        raise ValueError(f"db rows must be a positive multiple of {BLOCK}, got {db.shape[0]}")
    if q.dtype != db.dtype:
        raise TypeError(f"q and db dtypes differ: {q.dtype} vs {db.dtype}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "int32view" and db.dtype != torch.int8:
        raise TypeError(f"int32view reads an int8 DB, got {db.dtype}")
    if bidx.dim() != 2 or bidx.shape[0] != q.shape[0] or bidx.dtype != torch.int32:
        raise ValueError(f"bidx must be int32 [Q, KB], got {bidx.dtype} {tuple(bidx.shape)}")
    if g < 1 or bidx.shape[1] % g:
        raise ValueError(f"KB ({bidx.shape[1]}) must be a multiple of g ({g})")


def selected_xor(db, bidx):
    """XOR of every 32-bit word of the blocks bidx selects (negative: block
    0), one selection at a time, 16 queries a piece: 0-dim int64."""
    blocks = db.view(-1, BLOCK, db.shape[1])
    sel = bidx.clamp(min=0).long()
    sink = torch.zeros((), dtype=torch.int64, device=db.device)
    for q0 in range(0, sel.shape[0], 16):
        sink ^= xor_words(blocks[sel[q0:q0 + 16].reshape(-1)])
    return sink


def gather_variant_plain(q, db, bidx, mode: str, g: int = G):
    """Plain PyTorch gather_variant: (out, sink)."""
    _validate(q, db, bidx, mode, g)
    nq, kb = bidx.shape
    if mode == "full":
        out = gather_plain(q, db, bidx.clamp(min=0), db.shape[0])
        return out.view(nq, kb // g, g, BLOCK), None
    row0 = db.view(-1, BLOCK, db.shape[1])[:, 0]                # [NB, 128]
    if mode == "int32view":
        row0 = row0.view(torch.int32)                           # [NB, 32]
    grp = bidx.clamp(min=0).long().view(nq, kb // g, g)
    if mode == "concat_only":
        acc = row0[grp[:, :, 0]].to(torch.float32)
    else:
        acc = torch.zeros((nq, kb // g, row0.shape[1]), dtype=torch.float32, device=db.device)
        for gg in range(g):
            acc = acc + row0[grp[:, :, gg]].to(torch.float32)
    if mode == "int32view":
        acc = torch.cat([acc, acc.new_zeros((nq, kb // g, BLOCK - acc.shape[2]))], dim=2)
    out = acc[:, :, None, :].expand(nq, kb // g, g, BLOCK).contiguous()
    return out, selected_xor(db, bidx)


def gather_variant(q, db, bidx, mode: str, g: int = G):
    """(out, sink) of the module docstring. CUDA tensors launch the kernel
    (or raise); CPU tensors run the plain version."""
    _validate(q, db, bidx, mode, g)
    if q.device.type == "cpu":
        return gather_variant_plain(q, db, bidx, mode, g)
    from . import _build

    if db.dtype not in _DTYPE_CODE:
        raise TypeError(f"gather_variant kernel takes bf16 or int8, got {db.dtype}")
    dev = q.device
    nq, kb = bidx.shape
    args = [_build.ptr(q, "q", db.dtype, device=dev),
            _build.ptr(db, "db", db.dtype, device=dev), db.shape[0] // BLOCK,
            _build.ptr(bidx, "bidx", torch.int32, (nq, kb), dev)]
    out = torch.empty((nq, kb // g, g, BLOCK), dtype=torch.float32, device=dev)
    sink = torch.zeros((1,), dtype=torch.int32, device=dev)
    if nq and kb:
        with torch.cuda.device(dev):   # the launch and its smem attribute: q's card
            rc = _build.library().mst_gather_variant(
                _DTYPE_CODE[db.dtype], MODES.index(mode), *args, out.data_ptr(),
                sink.data_ptr(), nq, kb, g, torch.cuda.current_stream(dev).cuda_stream)
        _build.check_launch(rc, "gather_variant")
        profiling.count(LAUNCHES[mode])
    if mode == "full":
        return out, None
    return out, sink[0].to(torch.int64) & 0xFFFFFFFF
