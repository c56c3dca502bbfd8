"""The device-memory read rate the card reaches: stream_probe over a 2 GiB
int8 buffer, each byte read once a call.

  stream[T]   one CTA reads each tile of T rows of 128 bytes and adds its
              first 8 rows into the output; every 32-bit word goes into the
              XOR sink, so every byte is loaded. Sweeping T shows how the
              rate depends on the work a CTA is given.
  wide[T]     the same bytes viewed [n/8, 1024]: rows 8x wider.
  torch.sum   x.sum(dtype=torch.int32) over the same bytes: the read rate a
              plain PyTorch reduction reaches, as a yardstick.

The best of these is the reachable read rate, printed as a share of the
3.35 TB/s of the H100 SXM's data sheet.

    python -m merizo_search_tpu_torch.tools.perf_hbm [--gib 2]
        [--tiles 16384,32768,65536,131072,262144]
        [--wide-tiles 4096,8192,16384,32768] [--iters 10] [--device cuda|cpu]
"""

from __future__ import annotations

import torch

from ..ops.probes import stream_probe
from . import _bench_util as bu


def main(argv=None, x=None):
    """Runs the sweep over `x` (an int8 [n, 128] buffer, e.g. a DB already
    on the card; --gib is then ignored) or over a new --gib buffer. Returns
    {"bytes", "rows", "best"}."""
    p = bu.parser(__doc__)
    p.add_argument("--gib", type=float, default=2.0)
    p.add_argument("--tiles", type=bu.ints, default=[16384, 32768, 65536, 131072, 262144])
    p.add_argument("--wide-tiles", type=bu.ints, default=[4096, 8192, 16384, 32768])
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args(argv)
    dev, gen = bu.setup(args)
    if x is None:
        nbytes = int(args.gib * (1 << 30)) // 1024 * 1024
        x = torch.randint(-127, 128, (nbytes // 128, 128), generator=gen, device=dev,
                          dtype=torch.int8)
    elif x.dtype != torch.int8 or x.dim() != 2 or x.shape[1] != 128 or x.shape[0] % 8:
        raise ValueError(f"x must be int8 [8m, 128], got {x.dtype} {tuple(x.shape)}")
    nbytes = x.numel()
    flush = bu.flush_buffer(dev)
    rows = []

    def share(gbps):   # of the card's rate: only for times taken on the card
        return "" if dev.type == "cpu" else f" ({gbps * 1e9 / bu.HBM_BPS * 100:.1f}% of 3.35 TB/s)"

    def report(tag, view, tile, ms):
        done = view.shape[0] // tile * tile * view.shape[1] if tile else nbytes
        gbps = done / ms / 1e6
        rows.append({"probe": tag, "d": view.shape[1], "tile": tile, "bytes": done,
                     "ms": ms, "gbps": gbps})
        print(f"{tag:28s} {ms:9.4f} ms  {gbps:8.1f} GB/s{share(gbps)}", flush=True)

    for view, tiles, name in ((x, args.tiles, "stream"),
                              (x.view(-1, 1024), args.wide_tiles, "wide(1024)")):
        for tile in tiles:
            if tile <= view.shape[0]:
                report(f"{name} tile={tile}", view, tile, bu.time_ms(
                    lambda v=view, t=tile: stream_probe(v, 1.0, t), dev, args.iters, flush))
    report("torch.sum int32", x, 0, bu.time_ms(lambda: x.sum(dtype=torch.int32), dev,
                                                 args.iters, flush))
    best = max(rows, key=lambda r: r["gbps"])
    print(f"# best reached read: {best['gbps']:.1f} GB/s{share(best['gbps'])}, "
          f"{best['probe']}", flush=True)
    return {"bytes": nbytes, "rows": rows, "best": best}


if __name__ == "__main__":
    main()
