"""Phase A in slabs, with superblock maxima: `slab_scan`.

Launches the CUDA kernel in csrc/slab_interleave.cu for CUDA tensors and
runs `slab_scan_plain`, the plain PyTorch version of the same contract, for
CPU tensors. The kernel replaces the Pallas `_kernel` of the JAX package's
measurement tool tools/perf_slab_interleave.py (its `scan_v2`); the port's
tool of the same name runs it. The kernel's header says what `nslab` shapes
on a GPU.

Contract (both versions), for q [Q, 128] and db [Npad, 128] of one dtype
(bf16 or int8), Npad a multiple of `tile`, tile/nslab a multiple of 128:
- bm float32 [Q, Npad/128]: the block maxima of the scores with no length
  channel (int8: the int32 block max times the block's scale `scales[b*128]`,
  `scales` [Npad] required for int8 and only for int8), floored at NEG_CAP,
  and NEG_CAP for every block whose first row is >= n_valid: blockmax_scan's
  BM with the channel off;
- sbm float32 [Q, Npad/tile]: the max of bm over each tile.
Neither depends on nslab. The JAX tool reads its global N (2^24) for
n_valid; here it is an argument. With sbm=False the kernel is built without
the superblock output and sbm is None: phase A as the search path uses it
(BM alone), with the length channel compiled out, for measurement.
"""

from __future__ import annotations

import torch

from .blockmax import _DTYPE_CODE, blockmax_plain, query_groups
from .topk import BLOCK

TILE = 32768            # the JAX tool's default (the JAX DEFAULT_TILE)
NSLABS = (1, 2, 4, 8)   # the values the kernel takes
PLAIN_ROWS = 1 << 20    # DB rows per piece of slab_scan_plain

launches = 0   # kernel launches since the last reset (plain runs not counted)


def _validate(q, db, tile, nslab, scales):
    if q.dim() != 2 or db.dim() != 2 or q.shape[1] != 128 or db.shape[1] != 128:
        raise ValueError(f"q and db must be [*, 128], got {tuple(q.shape)}, {tuple(db.shape)}")
    if q.dtype != db.dtype:
        raise TypeError(f"q and db dtypes differ: {q.dtype} vs {db.dtype}")
    if nslab not in NSLABS:
        raise ValueError(f"nslab must be one of {NSLABS}, got {nslab}")
    if tile < BLOCK or tile % (BLOCK * nslab):
        raise ValueError(f"tile/nslab must be a multiple of {BLOCK}: tile={tile}, nslab={nslab}")
    if db.shape[0] % tile:
        raise ValueError(f"db rows ({db.shape[0]}) must be a multiple of the tile ({tile})")
    if (db.dtype == torch.int8) != (scales is not None):
        raise ValueError("scales are required for int8 and only for int8")
    if scales is not None and tuple(scales.shape) != (db.shape[0],):
        raise ValueError(f"scales must be [{db.shape[0]}], got {tuple(scales.shape)}")


def slab_scan_plain(q, db, n_valid: int, tile: int = TILE, nslab: int = 2, scales=None,
                    sbm: bool = True):
    """Plain PyTorch slab_scan: (bm, sbm). bm is blockmax_plain with no
    length channel, over the DB in pieces of about PLAIN_ROWS rows; sbm the
    max of bm over each tile. nslab is validated and changes nothing."""
    _validate(q, db, tile, nslab, scales)
    npad = db.shape[0]
    per = max(tile, PLAIN_ROWS // tile * tile)
    bm = torch.cat([blockmax_plain(q, db[r0:r0 + per], n_valid - r0,
                                   scales=None if scales is None else scales[r0:r0 + per])
                    for r0 in range(0, npad, per)], dim=1)
    if not sbm:
        return bm, None
    return bm, bm.view(q.shape[0], npad // tile, tile // BLOCK).amax(dim=2)


def slab_scan(q, db, n_valid: int, tile: int = TILE, nslab: int = 2, scales=None,
              sbm: bool = True):
    """(bm, sbm) of the module docstring. CUDA tensors launch the kernel
    (or raise): it writes bm and each slab's max, and one amax folds the
    nslab slab maxima of a tile into sbm. CPU tensors run the plain
    version."""
    global launches
    _validate(q, db, tile, nslab, scales)
    if q.device.type == "cpu":
        return slab_scan_plain(q, db, n_valid, tile, nslab, scales, sbm)
    from . import _build

    if db.dtype not in _DTYPE_CODE:
        raise TypeError(f"slab_scan kernel takes bf16 or int8, got {db.dtype}")
    dev = q.device
    nq, npad = q.shape[0], db.shape[0]
    args = [_build.ptr(q, "q", db.dtype, device=dev),
            _build.ptr(db, "db", db.dtype, device=dev),
            _build.ptr(scales, "scales", torch.float32, (npad,), dev)]
    bm = torch.empty((nq, npad // BLOCK), dtype=torch.float32, device=dev)
    part = torch.empty((nq, npad // tile, nslab), dtype=torch.float32, device=dev) if sbm else None
    if nq == 0:
        return bm, None if part is None else part.amax(dim=2)
    rc = _build.library().mst_slab_scan(
        _DTYPE_CODE[db.dtype], nslab, *args, bm.data_ptr(),
        None if part is None else part.data_ptr(), nq, npad // BLOCK, int(n_valid),
        query_groups(nq), tile // BLOCK, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "slab_scan")
    launches += 1
    return bm, None if part is None else part.amax(dim=2)
