"""Invariant Point Attention encoder.

Reimplements the behaviour of the reference IPA stack
(programs/Merizo/model/ipa/nndef_ipa.py:37-278 and ipa_encoder.py:6-62), as
the JAX package does (models/merizo/ipa.py there): 6 weight-shared IPA
iterations with c_s=512, c_z=32, 16 heads, 4 query/8 value points, rotary
embeddings on the scalar q/k, an extra pair-value output path, and a
bidirectional-GRU transition. Module and parameter names are the
reference's, so its state dict loads as is.

Numerics follow the JAX package so that the two agree:
- the point-attention term by norm expansion,
  sum_p |q_ip - k_jp|^2 = |q_i|^2 + |k_j|^2 - 2 q_i.k_j, one product
  instead of the reference's [N, N, H, P, 3] displacement tensor. In
  float32 the expansion cancels when coordinates are large (|t| ~ 1e2 A
  gives |q|^2 ~ 1e4-1e5 per head, so logits carry ~1e-3 absolute error
  before the head weight); the reference's difference form does not;
- the rotary quirk: the reference applies rotary_embedding_torch's
  rotate_queries_or_keys to [B, N, H, C] tensors whose dim -2 is the head
  axis, so the rotary "positions" are the 16 head indices, identical for
  every residue (nndef_ipa.py:111,184-185). The 16 fixed rotations are
  baked into tables;
- float32 throughout with TF32 off (set in models/merizo/network.py):
  bf16 rounding moves domain boundaries.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import rigid
from .gru import BiGRU

C_S = 512
C_Z = 32
C_HIDDEN = 512
N_HEADS = 16
N_QK_POINTS = 4
N_V_POINTS = 8
N_BLOCKS = 6
INF = 1e5
EPS = 1e-8


def rotary_tables(n_pos: int = N_HEADS, dim: int = C_HIDDEN // 2):
    """cos/sin tables [n_pos, dim] matching rotary_embedding_torch defaults
    (theta=10000, interleaved pairs)."""
    inv = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    freqs = np.einsum("i,j->ij", np.arange(n_pos, dtype=np.float32), inv)
    freqs = np.repeat(freqs, 2, axis=-1)  # [n_pos, dim]
    return np.cos(freqs), np.sin(freqs)


_ROT_COS, _ROT_SIN = (torch.from_numpy(a) for a in rotary_tables())


@functools.cache
def _rot_tables(device: torch.device):
    """The rotary tables on `device`, copied there once: a copy from
    pageable host memory waits for the card's queue."""
    return _ROT_COS.to(device), _ROT_SIN.to(device)


def rotary(x: torch.Tensor) -> torch.Tensor:
    """Rotate the first C_HIDDEN//2 channels of x [B,N,H,C] with per-head
    angles (see the module docstring's quirk)."""
    cos, sin = _rot_tables(x.device)
    rot_dim = cos.shape[-1]
    t_rot, t_pass = x[..., :rot_dim], x[..., rot_dim:]
    x1 = t_rot[..., 0::2]
    x2 = t_rot[..., 1::2]
    half = torch.stack([-x2, x1], dim=-1).reshape(t_rot.shape)
    return torch.cat([t_rot * cos + half * sin, t_pass], dim=-1)


def _to_points(flat: torch.Tensor, R: torch.Tensor, t: torch.Tensor, npts: int):
    """[B,N,H*P*3] whose thirds are x, y, z (nndef_ipa.py:153-156) ->
    global-frame points [B,N,H,P,3]."""
    b, n, _ = flat.shape
    pts = torch.stack(torch.chunk(flat, 3, dim=-1), dim=-1)          # [B,N,H*P,3]
    pts = rigid.apply(R[:, :, None], t[:, :, None], pts)
    return pts.reshape(b, n, N_HEADS, npts, 3)


class InvariantPointAttention(nn.Module):
    def __init__(self):
        super().__init__()
        h, c = N_HEADS, C_HIDDEN
        self.linear_q = nn.Linear(C_S, h * c)
        self.linear_kv = nn.Linear(C_S, 2 * h * c)
        self.linear_q_points = nn.Linear(C_S, h * N_QK_POINTS * 3)
        self.linear_kv_points = nn.Linear(C_S, h * (N_QK_POINTS + N_V_POINTS) * 3)
        self.linear_b = nn.Linear(C_Z, h)
        self.head_weights = nn.Parameter(torch.zeros(h))
        self.pair_out = nn.Linear(h * C_Z, C_S)
        self.hidden_out = nn.Linear(h * c, C_S)
        self.points_out = nn.Linear(h * N_V_POINTS * 3, C_S)
        self.points_norm_out = nn.Linear(h * N_V_POINTS, C_S)

    def forward(self, s, z, R, t, mask=None):
        """One IPA iteration. s [B,N,C_S], z [B,N,N,C_Z], R [B,N,3,3],
        t [B,N,3], mask [B,N] or None (all valid). Returns the residual
        update [B,N,C_S]."""
        b, n, _ = s.shape
        h, c = N_HEADS, C_HIDDEN

        q = self.linear_q(s).reshape(b, n, h, c)
        k, v = self.linear_kv(s).reshape(b, n, h, 2 * c).split(c, dim=-1)
        q_pts = _to_points(self.linear_q_points(s), R, t, N_QK_POINTS)
        kv_pts = _to_points(self.linear_kv_points(s), R, t, N_QK_POINTS + N_V_POINTS)
        k_pts, v_pts = kv_pts.split([N_QK_POINTS, N_V_POINTS], dim=-2)

        q, k = rotary(q), rotary(k)
        a = q.permute(0, 2, 1, 3) @ k.permute(0, 2, 3, 1)            # [B,H,N,N]
        a = a * math.sqrt(1.0 / (3 * c))
        a = a + math.sqrt(1.0 / 3) * self.linear_b(z).permute(0, 3, 1, 2)

        # point attention by norm expansion (no [N,N,H,P,3] tensor)
        qn = (q_pts ** 2).sum(dim=(-1, -2)).transpose(1, 2)          # [B,H,N]
        kn = (k_pts ** 2).sum(dim=(-1, -2)).transpose(1, 2)
        cross = (q_pts.permute(0, 2, 1, 3, 4).reshape(b, h, n, -1)
                 @ k_pts.permute(0, 2, 1, 3, 4).reshape(b, h, n, -1).transpose(-1, -2))
        pt_att = qn[:, :, :, None] + kn[:, :, None, :] - 2.0 * cross
        head_w = F.softplus(self.head_weights) * math.sqrt(
            1.0 / (3 * (N_QK_POINTS * 9.0 / 2)))
        a = a + (-0.5) * head_w[None, :, None, None] * pt_att
        if mask is not None:
            a = a + (INF * (mask[:, :, None] * mask[:, None, :] - 1.0))[:, None]
        a = torch.softmax(a, dim=-1)

        o = (a @ v.permute(0, 2, 1, 3)).permute(0, 2, 1, 3).reshape(b, n, h * c)
        s_out = self.hidden_out(o)

        # o_pair[b,i,h,:] = sum_j a[b,h,i,j] z[b,i,j,:]
        o_pair = (a.permute(0, 2, 1, 3) @ z).reshape(b, n, h * C_Z)
        s_out = s_out + self.pair_out(o_pair)

        vp = v_pts.permute(0, 2, 1, 3, 4).reshape(b, h, n, N_V_POINTS * 3)
        o_pt = (a @ vp).reshape(b, h, n, N_V_POINTS, 3).permute(0, 2, 1, 3, 4)
        o_pt = rigid.invert_apply(R[:, :, None, None], t[:, :, None, None], o_pt)
        o_pt_norm = torch.sqrt((o_pt ** 2).sum(dim=-1) + EPS).reshape(b, n, h * N_V_POINTS)
        # reference flattening: [B,N,H*Pv,3] -> concat of x, y, z blocks
        o_pt = o_pt.reshape(b, n, h * N_V_POINTS, 3)
        o_pt_flat = torch.cat([o_pt[..., 0], o_pt[..., 1], o_pt[..., 2]], dim=-1)
        s_out = s_out + self.points_out(o_pt_flat)
        return s_out + self.points_norm_out(o_pt_norm)


class StructureModuleTransition(nn.Module):
    """One 2-layer bidirectional GRU + LayerNorm (nndef_ipa.py:7-34)."""

    def __init__(self):
        super().__init__()
        self.layers = nn.ModuleList([BiGRU(C_S, C_S // 2)])
        self.layer_norm = nn.LayerNorm(C_S)

    def forward(self, s, lengths=None):
        out, _ = self.layers[0].run(s, lengths)
        return self.layer_norm(out)


class IPAEncoder(nn.Module):
    """Input norms + the weight-shared IPA loop (ipa_encoder.py:44-62)."""

    def __init__(self):
        super().__init__()
        self.layer_norm_s = nn.LayerNorm(C_S)
        self.layer_norm_z = nn.LayerNorm(C_Z)
        self.linear_in = nn.Linear(C_S, C_S)
        self.ipa = InvariantPointAttention()
        self.layer_norm_ipa = nn.LayerNorm(C_S)
        self.transition = StructureModuleTransition()

    def forward(self, s, z, R, t, mask=None, lengths=None):
        """Returns s [B,N,C_S]. mask [B,N] on the device for the attention;
        lengths [B], its row sums on the host, for the GRU (None: all
        valid)."""
        s = self.linear_in(self.layer_norm_s(s))
        z = self.layer_norm_z(z)
        for _ in range(N_BLOCKS):
            s = self.layer_norm_ipa(s + self.ipa(s, z, R, t, mask))
            s = self.transition(s, lengths)
        return s
