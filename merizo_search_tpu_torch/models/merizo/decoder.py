"""Mask-transformer decoder head.

Reimplements the behaviour of the reference MaskTransformer
(programs/Merizo/model/decoders/mask_decoder.py:91-214), as the JAX package
does: 10 pre-norm blocks over residue tokens concatenated with 20 learned
class embeddings, ALiBi bias zero-padded over the class tokens, normalised
patch/class projections into per-residue domain masks, a bi-GRU background
head, and a bi-GRU per-domain confidence head.

Split in two with a host step between them, because the reference inlines
sequential cleanup heuristics (clean_domains / clean_singletons,
mask_decoder.py:191-195) in the middle of its forward:

  `forward` -> (domain_masks [B,N,20], bg_logits [B,N,2]): all the FLOPs;
  host: argmax + cleanup + background masking (segment/postprocess.py);
  `domain_confidence`: the confidence GRU over every domain's residues at
  once, each domain packed at its own length (the reference loops over
  domains, mask_decoder.py:203-212).

The reference quirk is kept: attention logits are NOT scaled by
1/sqrt(head_dim) (mask_decoder.py:57).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .gru import BiGRU

N_CLS = 20
N_LAYERS = 10
N_HEADS_DEC = 16
D_MODEL = 512


class Attention(nn.Module):
    def __init__(self):
        super().__init__()
        self.qkv = nn.Linear(D_MODEL, 3 * D_MODEL)
        self.proj = nn.Linear(D_MODEL, D_MODEL)

    def forward(self, x, bias, mask_1d):
        b, t, d = x.shape
        h = N_HEADS_DEC
        qkv = self.qkv(x).reshape(b, t, 3, h, d // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                        # [B,H,T,hd]
        a = q @ k.transpose(-1, -2)                             # no 1/sqrt(d) scale
        if bias is not None:
            a = a + bias
        if mask_1d is not None:
            a = a + 1e9 * (mask_1d[:, None, None, :] - 1.0)
        o = torch.softmax(a, dim=-1) @ v                        # [B,H,T,hd]
        return self.proj(o.transpose(1, 2).reshape(b, t, d))


class Mlp(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(D_MODEL, D_MODEL)
        self.fc2 = nn.Linear(D_MODEL, D_MODEL)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """One pre-norm decoder block."""

    def __init__(self):
        super().__init__()
        self.norm1 = nn.LayerNorm(D_MODEL)
        self.attn = Attention()
        self.norm2 = nn.LayerNorm(D_MODEL)
        self.mlp = Mlp()

    def forward(self, x, bias, mask_1d):
        x = x + self.attn(self.norm1(x), bias, mask_1d)
        return x + self.mlp(self.norm2(x))


class MaskTransformer(nn.Module):
    def __init__(self):
        super().__init__()
        d = D_MODEL
        self.blocks = nn.ModuleList([Block() for _ in range(N_LAYERS)])
        self.cls_emb = nn.Parameter(torch.zeros(1, N_CLS, d))
        self.proj_patch = nn.Parameter(torch.zeros(d, d))
        self.proj_classes = nn.Parameter(torch.zeros(d, d))
        self.decoder_norm = nn.LayerNorm(d)
        self.class_norm = nn.LayerNorm(N_CLS)
        self.bg_gru = BiGRU(d, d // 2)
        self.bg_out = nn.Linear(d, 2)
        self.conf_gru = BiGRU(N_CLS, d)
        self.conf_out = nn.Linear(d, 1)

    def forward(self, s, bias, mask=None):
        """s [B,N,D] encoder output; bias [B,H,N,N] ALiBi (zero-padded over
        the class tokens here); mask [B,N] residue validity or None (all
        valid). Returns (domain_masks [B,N,N_CLS], bg_logits [B,N,2])."""
        b, n, d = s.shape
        x = torch.cat([s, self.cls_emb.expand(b, N_CLS, d)], dim=1)
        full_mask = None
        if mask is not None:
            full_mask = torch.cat([mask, mask.new_ones((b, N_CLS))], dim=1)
        bias = F.pad(bias, (0, N_CLS, 0, N_CLS))
        for blk in self.blocks:
            x = blk(x, bias, full_mask)
        x = self.decoder_norm(x)

        features = x[:, :n] @ self.proj_patch
        classes = x[:, n:] @ self.proj_classes
        features = features / torch.linalg.norm(features, dim=-1, keepdim=True)
        classes = classes / torch.linalg.norm(classes, dim=-1, keepdim=True)
        domain_masks = self.class_norm(features @ classes.transpose(1, 2))
        lengths = None if mask is None else mask.sum(dim=1).round().long()
        bg_out, _ = self.bg_gru.run(features, lengths)
        return domain_masks, self.bg_out(bg_out)

    def domain_confidence(self, domain_masks, sel_idx, sel_mask):
        """Per-domain confidence, one batch over the domains.

        domain_masks [1,N,N_CLS]; sel_idx [K,N] int: for domain k, the
        residue indices of its members compacted to the front (arbitrary
        beyond sel_mask); sel_mask [K,N]: 1 for valid member slots.

        Returns conf [K] in [0,1]. Parity: mask_decoder.py:203-212: the
        confidence GRU's top-layer reverse final state over the domain's
        residues -> Linear -> clamp.
        """
        seqs = domain_masks[0][sel_idx.long()]                  # [K,N,C]
        _, h_last = self.conf_gru.run(seqs, sel_mask.sum(dim=1).round().long())
        return self.conf_out(h_last)[:, 0].clamp(0.0, 1.0)


def compact_domain_selection(dom_ids: np.ndarray, ids: np.ndarray, n_pad: int | None = None):
    """Host helper: (sel_idx [K,Npad], sel_mask [K,Npad]) for
    domain_confidence from an id vector [N] and the unique ids to score."""
    n = len(dom_ids)
    n_pad = n_pad or n
    k = len(ids)
    sel_idx = np.zeros((k, n_pad), np.int32)
    sel_mask = np.zeros((k, n_pad), np.float32)
    for j, d in enumerate(ids):
        pos = np.nonzero(dom_ids == d)[0]
        sel_idx[j, :len(pos)] = pos
        sel_mask[j, :len(pos)] = 1.0
    return sel_idx, sel_mask
