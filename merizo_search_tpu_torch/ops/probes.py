"""Floor probes of the scan: `mini_scan` (the dot alone, or the dot with
the block-max reduce) and `stream_probe` (the read of the DB alone).

Each launches its CUDA kernel in csrc/probes.cu for CUDA tensors and runs
its plain PyTorch version for CPU tensors. The kernels replace the Pallas
probes of the JAX package's measurement tools: `_mini_kernel` of
tools/perf_floor2.py and tools/perf_int8_floor.py (one function here, whose
`tile` defaults to the latter's fixed 32768) and `_probe_kernel` of
tools/perf_hbm.py. The tools in `merizo_search_tpu_torch.tools` run them.
mini_scan's kernel runs phase A's walk (TMA ring, wgmma consumers) at
phase A's launch geometry (`geometry`), so its two modes and
`blockmax_scan` differ only in what each does per block once the scores
exist.

Both return a sink beside their output: a value that depends on all of the
probe's work, so that a GPU kernel (where a dot whose result is unused is
dropped, and a byte never loaded never moves) provably did the work the TPU
probe did. mini_scan's sink is the max of every score; stream_probe's the
XOR of every 32-bit word read.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from .blockmax import _DTYPE_CODE, phase_a_geometry
from .topk import BLOCK

TILE = 32768         # perf_int8_floor's fixed tile (the JAX DEFAULT_TILE)
MODES = ("none", "reduce")

# kernel launches (plain runs not counted)
MINI_SCAN_LAUNCHES = profiling.declare("probes.mini_scan.launches")
STREAM_PROBE_LAUNCHES = profiling.declare("probes.stream_probe.launches")
PLAIN_STEPS = 1 << 20   # DB rows per piece of mini_scan_plain


def geometry(nq: int, nsteps: int, nbt: int, sms: int):
    """(N, blocks_per_cta, chunks) of a mini_scan launch: phase A's
    (`phase_a_geometry`) over the nsteps * nbt blocks, so mini_scan walks
    as phase A does: query tiles of N queries and a persistent grid of
    query tiles x chunks, about one CTA an SM, each CTA a contiguous range
    of blocks_per_cta blocks. The ranges ignore the steps: one may span two
    or more. "reduce" stores each block's maxima at its own step, and
    "none" sends each slab-start block's head scores to its own step by
    atomicMax, so neither holds anything across a step boundary."""
    nb = nsteps * nbt
    n, bpc = phase_a_geometry(nq, nb, sms)
    return n, bpc, -(-nb // bpc)


def _validate_mini(q, db, tile, nslab, reduce_mode):
    if q.dim() != 2 or db.dim() != 2 or q.shape[1] != 128 or db.shape[1] != 128:
        raise ValueError(f"q and db must be [*, 128], got {tuple(q.shape)}, {tuple(db.shape)}")
    if q.dtype != db.dtype:
        raise TypeError(f"q and db dtypes differ: {q.dtype} vs {db.dtype}")
    if reduce_mode not in MODES:
        raise ValueError(f"reduce_mode must be one of {MODES}, got {reduce_mode!r}")
    if tile % BLOCK or tile < BLOCK or nslab < 1 or (tile // nslab) % BLOCK or tile % nslab:
        raise ValueError(f"tile must be a multiple of {BLOCK} and tile/nslab a "
                         f"multiple of {BLOCK}: tile={tile}, nslab={nslab}")
    if db.shape[0] < tile:
        raise ValueError(f"db has fewer rows ({db.shape[0]}) than one tile ({tile})")


def mini_scan_plain(q, db, tile: int = TILE, nslab: int = 1, reduce_mode: str = "reduce"):
    """Plain PyTorch mini_scan: (out, sink). Scores in float64 (exact for
    int8) rounded to float32; the DB goes through in pieces of about
    PLAIN_STEPS rows."""
    _validate_mini(q, db, tile, nslab, reduce_mode)
    nsteps, qn = db.shape[0] // tile, q.shape[0]
    slab = tile // nslab
    per = max(1, PLAIN_STEPS // tile)
    outs, sink = [], None
    qd = q.to(torch.float64)
    for s0 in range(0, nsteps, per):
        ns = min(per, nsteps - s0)
        x = db[s0 * tile:(s0 + ns) * tile].to(torch.float64)
        s = (qd @ x.T).to(torch.float32).view(qn, ns, tile)
        m = s.max()
        sink = m if sink is None else torch.maximum(sink, m)
        if reduce_mode == "reduce":
            outs.append(s.view(qn, ns, tile // BLOCK, BLOCK).amax(dim=3))
        else:
            outs.append(s.view(qn, ns, nslab, slab)[..., :8].amax(dim=2))
    return torch.cat(outs, dim=1).permute(1, 0, 2).contiguous(), sink


def _key_to_float(keys):
    """Inverse of the kernel's order_key: int32 keys back to float32."""
    return torch.where(keys >= 0, keys, keys ^ 0x7FFFFFFF).view(torch.float32)


def _kernel_call(q, db, tile, nslab, reduce_mode):
    """(out, parts, launch) for CUDA tensors: the kernel's outputs ("none":
    int32 keys preset to -inf's), one sink value a CTA, and a callable that
    launches the kernel into them (None for an empty batch)."""
    from . import _build

    if db.dtype not in _DTYPE_CODE:
        raise TypeError(f"mini_scan kernel takes bf16 or int8, got {db.dtype}")
    dev = q.device
    nq, nsteps, nbt = q.shape[0], db.shape[0] // tile, tile // BLOCK
    args = [_build.ptr(q, "q", db.dtype, device=dev),
            _build.ptr(db, "db", db.dtype, device=dev)]
    if reduce_mode == "reduce":
        out = torch.empty((nsteps, nq, nbt), dtype=torch.float32, device=dev)
    else:   # int32 keys of -inf (0xff800000 ^ 0x7fffffff), raised by atomicMax
        out = torch.full((nsteps, nq, 8), -2139095041, dtype=torch.int32, device=dev)
    if nq == 0:
        return out, torch.full((1,), float("-inf"), device=dev), None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n, bpc, chunks = geometry(nq, nsteps, nbt, sms)
    parts = torch.empty((chunks, -(-nq // n)), dtype=torch.float32, device=dev)
    lib, stream = _build.library(), torch.cuda.current_stream(dev).cuda_stream

    def launch():
        with torch.cuda.device(dev):   # the launch and its smem attribute: q's card
            rc = lib.mst_mini_scan(_DTYPE_CODE[db.dtype], *args, out.data_ptr(),
                                   parts.data_ptr(), nq, nsteps, nbt, (tile // nslab) // BLOCK,
                                   int(reduce_mode == "reduce"), n, bpc, stream)
        _build.check_launch(rc, "mini_scan")
        profiling.count(MINI_SCAN_LAUNCHES)

    return out, parts, launch


def mini_scan(q, db, tile: int = TILE, nslab: int = 1, reduce_mode: str = "reduce"):
    """The scan's floor probe: (out, sink) for q [Q, 128] and db [N, 128]
    of one dtype (bf16 or int8), over nsteps = N // tile steps.

    out float32 [nsteps, Q, tile/128] ("reduce": the raw block maxima of
    each step, int8 as int32 values) or [nsteps, Q, 8] ("none": the max over
    the step's nslab slabs of the scores of each slab's first 8 rows). sink:
    0-dim float32, the max of every score of the nsteps*tile rows. CUDA
    tensors launch the kernel (or raise); CPU tensors run the plain version.
    """
    _validate_mini(q, db, tile, nslab, reduce_mode)
    if q.device.type == "cpu":
        return mini_scan_plain(q, db, tile, nslab, reduce_mode)
    out, parts, launch = _kernel_call(q, db, tile, nslab, reduce_mode)
    if launch is not None:
        launch()
    if reduce_mode == "none":
        out = _key_to_float(out)
    return out, parts.max()


def kernel_alone(q, db, tile: int = TILE, nslab: int = 1, reduce_mode: str = "reduce"):
    """A callable that runs mini_scan's kernel alone, into outputs allocated
    (and preset) here once, for timing the kernel without the wrapper's
    preset, key conversion and sink fold: a few small launches that weigh
    at the search shape (0.06 ms) though not at 2^24 rows. What it writes is
    not meant to be read. CPU tensors: the plain version."""
    _validate_mini(q, db, tile, nslab, reduce_mode)
    if q.device.type == "cpu":
        return lambda: mini_scan_plain(q, db, tile, nslab, reduce_mode)
    launch = _kernel_call(q, db, tile, nslab, reduce_mode)[2]
    return launch if launch is not None else (lambda: None)


def _validate_stream(x, tile):
    if x.dim() != 2 or x.dtype != torch.int8:
        raise TypeError(f"x must be a 2-D int8 tensor, got {x.dtype} {tuple(x.shape)}")
    if x.shape[1] % 16:
        raise ValueError(f"x rows must be a multiple of 16 bytes, got {x.shape[1]}")
    if tile < 8 or x.shape[0] < tile:
        raise ValueError(f"tile must be >= 8 rows and at most x's {x.shape[0]}, got {tile}")


def xor_words(x):
    """XOR of all 32-bit words of a contiguous tensor, as a 0-dim int64 in
    [0, 2^32): a fold by halves, so it runs on the card too."""
    w = x.reshape(-1).view(torch.int32)
    while w.numel() > 1:
        if w.numel() % 2:
            w = torch.cat([w, w.new_zeros(1)])
        h = w.numel() // 2
        w = w[:h] ^ w[h:]
    return w[0].to(torch.int64) & 0xFFFFFFFF


def stream_probe_plain(x, i: float, tile: int):
    """Plain PyTorch stream_probe: (o, sink)."""
    _validate_stream(x, tile)
    nsteps, d = x.shape[0] // tile, x.shape[1]
    head = x[:nsteps * tile].view(nsteps, tile, d)[:, :8].to(torch.int64).sum(dim=0)
    o = torch.tensor(i, dtype=torch.float32, device=x.device) + head.to(torch.float32)
    return o, xor_words(x[:nsteps * tile])


def stream_probe(x, i: float, tile: int):
    """The read-rate probe: for x int8 [n, d] (d % 16 == 0), nsteps =
    n // tile, o float32 [8, d] = i + sum over steps s of x[s*tile : s*tile
    + 8] (exact while nsteps*127 < 2^24), and sink, the XOR of every 32-bit
    word of x[:nsteps*tile] as a 0-dim int64. CUDA tensors launch the kernel
    (or raise); CPU tensors run the plain version."""
    _validate_stream(x, tile)
    if x.device.type == "cpu":
        return stream_probe_plain(x, i, tile)
    from . import _build

    dev = x.device
    nsteps, d = x.shape[0] // tile, x.shape[1]
    o = torch.full((8, d), float(i), dtype=torch.float32, device=dev)
    sink = torch.zeros((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.library().mst_stream_probe(
            _build.ptr(x, "x", torch.int8, device=dev), o.data_ptr(), sink.data_ptr(),
            d, tile, nsteps, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, "stream_probe")
    profiling.count(STREAM_PROBE_LAUNCHES)
    return o, sink[0].to(torch.int64) & 0xFFFFFFFF
