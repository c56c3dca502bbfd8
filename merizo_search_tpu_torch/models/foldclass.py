"""Foldclass EGNN embedder in PyTorch.

The network of the reference FoldClassNet (programs/Foldclass/
nndef_fold_egnn_embed.py:34-62 and my_egnn_nocoords.py:10-74): a fixed
sinusoidal positional encoding as the node features, two EGNN layers whose
edge feature is the squared CA-CA distance (coordinates are never updated),
and a mean-pool over residues producing a 128-d embedding.

Parameter names are the reference's, so its state dict (`posenc_as.pe`,
`encode_ca_egnn.{0,1}.{edge_mlp.{0,2},edge_gate.0,node_mlp.{0,2}}.*`) loads
as is. The forward pass computes what the JAX package's `embed` computes,
with the same two changes from the reference:

- **Batched and masked.** `forward` takes [B, N, 3] coordinates with a
  validity mask, so structures are bucketed by length and batched.
- **Split edge projection, row-blocked pair stage.** The first edge Linear
  is block-separable, so per-node projections A = F @ W[:, :d]^T and
  B = F @ W[:, d:2d]^T are formed once and the pair hidden is
  A_i + B_j + w_d * d2_ij + b. The pair stage runs over blocks of rows i,
  so the [B, N, N, 514] f32 hidden (8.6 GB per structure at N = 2048) is
  never materialised: peak memory is [B, block, N, 514].

TF32 is switched off for matmuls and cuDNN when this module is imported:
the embedder computes in full float32 on the card, as on the CPU, so that
its embeddings match the JAX package's to 1e-4.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EMBED_DIM = 128
PE_MAX_LEN = 3000
N_LAYERS = 2
DEFAULT_WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "foldclass_default.npz")


def sinusoidal_pe(max_len: int = PE_MAX_LEN, d_model: int = EMBED_DIM) -> np.ndarray:
    """Fixed sinusoidal positional encoding table [max_len, d_model].

    Parity: nndef_fold_egnn_embed.py:10-30 (PositionalEncoder, learned=False).
    """
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class PositionalEncoder(nn.Module):
    def __init__(self, max_len: int = PE_MAX_LEN, dim: int = EMBED_DIM):
        super().__init__()
        self.register_buffer("pe", torch.from_numpy(sinusoidal_pe(max_len, dim))[None])


class EGNNLayer(nn.Module):
    """One EGNN layer without coordinate updates (my_egnn_nocoords.py)."""

    def __init__(self, dim: int = EMBED_DIM):
        super().__init__()
        e_in = 2 * dim + 1
        m_dim = 2 * dim
        self.dim = dim
        self.edge_mlp = nn.Sequential(nn.Linear(e_in, e_in * 2), nn.SiLU(),
                                      nn.Linear(e_in * 2, m_dim), nn.SiLU())
        self.edge_gate = nn.Sequential(nn.Linear(m_dim, 1), nn.Sigmoid())
        self.node_mlp = nn.Sequential(nn.Linear(dim + m_dim, dim * 2), nn.SiLU(),
                                      nn.Linear(dim * 2, dim))

    def forward(self, feats, d2, mask, block: int):
        """feats [B,N,D], d2 [B,N,N], mask [B,N] -> [B,N,D]."""
        dim = self.dim
        lin0 = self.edge_mlp[0]
        w0 = lin0.weight                          # [2e, 2D+1] (out, in)
        a_i = feats @ w0[:, :dim].T               # [B,N,2e]
        b_j = feats @ w0[:, dim:2 * dim].T        # [B,N,2e]
        w_d = w0[:, 2 * dim]                      # [2e]
        mask_j = mask[:, None, :, None]           # [B,1,N,1]
        rows = []
        for i0 in range(0, feats.shape[1], block):
            a_blk = a_i[:, i0:i0 + block]
            d2_blk = d2[:, i0:i0 + block]
            hidden = F.silu(a_blk[:, :, None, :] + b_j[:, None, :, :]
                            + d2_blk[..., None] * w_d + lin0.bias)
            m = self.edge_mlp[3](self.edge_mlp[2](hidden))   # [B,blk,N,m]
            m = m * self.edge_gate(m)                         # edge gate
            rows.append(torch.sum(m * mask_j, dim=2))         # [B,blk,m]
        m_i = torch.cat(rows, dim=1)
        out = self.node_mlp(torch.cat([feats, m_i], dim=-1))
        return out + feats


def choose_block(n: int) -> int:
    """Row-block size: bound the [B, block, N, 2e] pair tile to ~64M floats
    per structure (the JAX package's `_choose_block`)."""
    target = max(1, (1 << 26) // max(1, n * 514))
    blk = 1
    while blk * 2 <= target and n % (blk * 2) == 0:
        blk *= 2
    return blk


class FoldClassNet(nn.Module):
    """Foldclass embedder: CA coordinates [B,N,3] (+ mask [B,N]) -> [B,128]."""

    def __init__(self, dim: int = EMBED_DIM, n_layers: int = N_LAYERS):
        super().__init__()
        self.posenc_as = PositionalEncoder(PE_MAX_LEN, dim)
        self.encode_ca_egnn = nn.ModuleList(EGNNLayer(dim) for _ in range(n_layers))

    def forward(self, coords, mask=None):
        coords = coords.to(torch.float32)
        b, n, _ = coords.shape
        if mask is None:
            mask = torch.ones(b, n, dtype=torch.float32, device=coords.device)
        mask = mask.to(torch.float32)
        pe = self.posenc_as.pe[0, :n]
        feats = pe[None].expand(b, n, pe.shape[-1])
        rel = coords[:, :, None, :] - coords[:, None, :, :]
        d2 = torch.sum(rel * rel, dim=-1)        # squared distance edge feature
        block = choose_block(n)
        for layer in self.encode_ca_egnn:
            feats = layer(feats, d2, mask, block)
        msum = torch.sum(mask, dim=1, keepdim=True)
        return torch.sum(feats * mask[..., None], dim=1) / torch.clamp(msum, min=1.0)


def default_state_dict() -> dict:
    """The default weights, used when no checkpoint is given: the JAX
    package's default (`init_params(PRNGKey(0))`, converted by
    `params_from_jax`), stored in DEFAULT_WEIGHTS as float32 Linear weights
    and biases; `posenc_as.pe` is the fixed sinusoidal table. So a DB built
    by either package without weights is searched by the other in the same
    embedding space."""
    with np.load(DEFAULT_WEIGHTS) as z:
        sd = {k: torch.from_numpy(z[k]) for k in z.files}
    sd["posenc_as.pe"] = torch.from_numpy(sinusoidal_pe())[None]
    return sd


def params_from_jax(params: dict) -> dict:
    """Convert the JAX package's Foldclass pytree, passed in as numpy
    ({"layers": [{"edge0": {"w", "b"}, ...}, ...], "pe": [L, D]}, Linear
    weights stored [in, out]) into this module's state dict ([out, in])."""
    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    names = {"edge0": "edge_mlp.0", "edge1": "edge_mlp.2", "gate": "edge_gate.0",
             "node0": "node_mlp.0", "node1": "node_mlp.2"}
    sd = {"posenc_as.pe": t(params["pe"])[None]}
    for i, layer in enumerate(params["layers"]):
        for key, mod in names.items():
            sd[f"encode_ca_egnn.{i}.{mod}.weight"] = t(layer[key]["w"]).T.contiguous()
            sd[f"encode_ca_egnn.{i}.{mod}.bias"] = t(layer[key]["b"])
    return sd
