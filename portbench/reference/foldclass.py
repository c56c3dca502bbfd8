"""A frozen copy of the Foldclass forward, in its published form.

FoldClassNet of merizo-search (programs/Foldclass/nndef_fold_egnn_embed.py
and my_egnn_nocoords.py): a fixed sinusoidal positional encoding as the
node features, two EGNN layers without coordinate updates whose edge
feature is the squared CA-CA distance, and a mean over residues. Each edge
message is the published one, the edge MLP over the concatenation
[h_i, h_j, d2_ij] of every pair (i, j), self-pairs included; only rows of i
are taken in blocks so that the pair tensors fit. Structures of one call
share one length: no padding and no mask.

Float32 throughout. `tf32=True` rounds both operands of every Linear to
TF32 (10 mantissa bits, to nearest even) in the arithmetic itself, so the
lower-precision control reads the same on the CPU as on the card. With
`tf32=False` the card's TF32 matmul switches must be off (`embed` checks).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

DIM = 128
M_DIM = 2 * DIM
HIDDEN = 2 * (2 * DIM + 1)
PE_LEN = 3000
LAYERS = 2

# (name, out, in) of each layer's Linear maps, in the published module names
LINEARS = (("edge_mlp.0", HIDDEN, 2 * DIM + 1), ("edge_mlp.2", M_DIM, HIDDEN),
           ("edge_gate.0", 1, M_DIM), ("node_mlp.0", 2 * DIM, DIM + M_DIM),
           ("node_mlp.2", DIM, 2 * DIM))


def weight_shapes() -> dict[str, tuple[int, ...]]:
    """Every learned tensor of the network by its state-dict name."""
    out = {}
    for layer in range(LAYERS):
        for name, o, i in LINEARS:
            out[f"encode_ca_egnn.{layer}.{name}.weight"] = (o, i)
            out[f"encode_ca_egnn.{layer}.{name}.bias"] = (o,)
    return out


def seeded_weights(seed: int, device) -> dict[str, torch.Tensor]:
    """Weights from `seed` in one draw on `device`: each Linear's weight and
    bias uniform in +-1/sqrt(fan_in), as torch's default initialisation."""
    shapes = weight_shapes()
    sizes = [math.prod(s) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out, off = {}, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        fan_in = shape[1] if len(shape) == 2 else shapes[name[:-len("bias")] + "weight"][1]
        out[name] = (flat[off:off + size] / math.sqrt(fan_in)).view(shape).contiguous()
        off += size
    return out


def sinusoidal_pe(length: int, dim: int = DIM) -> np.ndarray:
    """The fixed positional encoding [length, dim] (nndef_fold_egnn_embed.py)."""
    pos = np.arange(length, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32) * (-math.log(10000.0) / dim))
    pe = np.zeros((length, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32's 10 mantissa bits, to nearest even."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0xFFF + ((u >> 13) & 1)) & ~0x1FFF
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32).view(torch.float32)


def _linear(x, w, b, tf32: bool):
    if tf32:
        x, w = round_tf32(x), round_tf32(w)
    return x @ w.T + b


@torch.no_grad()
def embed(weights: dict, coords: torch.Tensor, tf32: bool = False,
          row_block: int = 32) -> torch.Tensor:
    """Embeddings [B, 128] float32 of B structures of one length L, CA
    coordinates [B, L, 3], on the coordinates' device."""
    if (not tf32 and coords.device.type == "cuda"
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError("the f32 reference needs torch.backends.cuda.matmul.allow_tf32 off")
    x = coords.to(torch.float32)
    b, n, _ = x.shape
    h = torch.from_numpy(sinusoidal_pe(n)).to(x.device)[None].expand(b, n, DIM)
    d2 = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
    for layer in range(LAYERS):
        w = {name: (weights[f"encode_ca_egnn.{layer}.{name}.weight"],
                    weights[f"encode_ca_egnn.{layer}.{name}.bias"])
             for name, _, _ in LINEARS}
        m_i = torch.empty(b, n, M_DIM, device=x.device)
        for i0 in range(0, n, row_block):
            hi = h[:, i0:i0 + row_block]
            r = hi.shape[1]
            e = torch.cat([hi[:, :, None, :].expand(b, r, n, DIM),
                           h[:, None, :, :].expand(b, r, n, DIM),
                           d2[:, i0:i0 + r, :, None]], dim=-1)
            m = F.silu(_linear(F.silu(_linear(e, *w["edge_mlp.0"], tf32)),
                               *w["edge_mlp.2"], tf32))
            m = m * torch.sigmoid(_linear(m, *w["edge_gate.0"], tf32))
            m_i[:, i0:i0 + r] = m.sum(dim=2)
        upd = _linear(F.silu(_linear(torch.cat([h, m_i], dim=-1), *w["node_mlp.0"], tf32)),
                      *w["node_mlp.2"], tf32)
        h = h + upd
    return h.mean(dim=1)
