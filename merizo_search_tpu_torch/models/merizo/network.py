"""Merizo segmentation network: assembly, ALiBi, weights.

Reference top model: programs/Merizo/model/network.py:9-53: s/z input
projections, the IPA encoder, symmetric ALiBi bias
(programs/Merizo/model/posenc/alibi.py:7-39, clip 32), and the mask decoder.
Module and parameter names are the reference's (the names the JAX package's
`params_from_torch_state_dict` reads), so a reference checkpoint loads with
`load_state_dict`.

The compute-heavy forward is `MerizoNet.forward_features`; the sequential
cleanups and the per-domain confidence of the reference forward run in
segment/pipeline.py and `MerizoNet.domain_confidence` (see decoder.py).

Weights: `load_merizo_params(dir)` merges the reference's split `.pt`
files; with no directory it returns a seeded init (`init_state_dict`). The
JAX package's default, `init_params(PRNGKey(0))`, is ~172 MB of float32 that
the port cannot draw without JAX and does not ship, so the two packages'
defaults differ: pass the same `--merizo_weights` to both to compare them.
"""

from __future__ import annotations

import logging
import math
import os

import numpy as np
import torch
from torch import nn

from . import decoder as dec_mod
from . import ipa as ipa_mod

logger = logging.getLogger(__name__)

# float32 matmuls, as the JAX package's Precision.HIGHEST: bf16 or TF32
# rounding moves domain boundaries
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N_CLASSES = 20
DEFAULT_SEED = 0


def alibi_slopes(heads: int = 16) -> np.ndarray:
    """Power-of-two ALiBi slope schedule (alibi.py:19-29)."""
    start = 2.0 ** (-(2.0 ** -(math.log2(heads) - 3)))
    return np.asarray([start ** (i + 1) for i in range(heads)], np.float32)


_SLOPES = torch.from_numpy(alibi_slopes(16))


def alibi_bias(ri: torch.Tensor, clip: int = 32) -> torch.Tensor:
    """Symmetric ALiBi bias [B,H,N,N] from residue indices ri [B,N]
    (alibi.py:31-39; slope_factor=1, clip at 32 as used by network.py:50)."""
    rel = (ri[:, None, :] - ri[:, :, None]).abs().clamp(max=clip)
    return -rel[:, None, :, :] * _SLOPES.to(ri.device)[None, :, None, None]


class MerizoNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.linear_s_in = nn.Linear(20, ipa_mod.C_S, bias=False)
        self.linear_z_in = nn.Linear(1, ipa_mod.C_Z, bias=False)
        self.ipa = ipa_mod.IPAEncoder()
        self.decoder_head = dec_mod.MaskTransformer()

    @torch.no_grad()
    def forward_features(self, s, z, r, t, ri, mask=None):
        """Heavy forward: projections + IPA encoder + decoder transformer.

        s [B,N,20] one-hot, z [B,N,N,1] CA distance map, r [B,N,3,3],
        t [B,N,3], ri [B,N] residue indices, mask [B,N] (1 valid, trailing
        padding) or None when every row is valid.

        Returns (domain_masks [B,N,20], bg_logits [B,N,2]).
        """
        enc = self.ipa(self.linear_s_in(s), self.linear_z_in(z), r, t, mask)
        return self.decoder_head(enc, alibi_bias(ri), mask)

    @torch.no_grad()
    def domain_confidence(self, domain_masks, sel_idx, sel_mask):
        return self.decoder_head.domain_confidence(domain_masks, sel_idx, sel_mask)


def _reference_state_dict(sd: dict, model: MerizoNet) -> dict:
    """The entries of a reference state dict that MerizoNet holds, as float32
    tensors. The reference also saves modules its forward never runs
    (conf_gru_all, conf_out_all, the rotary module's inv_freq); they are
    dropped. A missing entry raises."""
    want = model.state_dict()
    missing = sorted(set(want) - set(sd))
    if missing:
        raise KeyError(f"Merizo weights lack {len(missing)} entries, e.g. {missing[:4]}")
    return {k: torch.as_tensor(sd[k], dtype=torch.float32) for k in want}


def model_from_state_dict(sd: dict, device="cuda") -> MerizoNet:
    """MerizoNet with the weights of a reference-named state dict, on
    `device` (cuda raises without a card), in eval mode."""
    from ...device import resolve_device

    model = MerizoNet()
    model.load_state_dict(_reference_state_dict(sd, model))
    return model.to(resolve_device(device)).eval()


def params_from_jax(params: dict) -> dict:
    """The JAX package's Merizo pytree (numpy leaves) -> a state dict of the
    reference's names: the inverse of its `params_from_torch_state_dict`
    (Linear and GRU weights back to [out, in], cls_emb with its leading
    axis)."""
    sd = {}

    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    def lin(prefix, p):
        sd[prefix + ".weight"] = t(p["w"]).T.contiguous()
        if "b" in p:
            sd[prefix + ".bias"] = t(p["b"])

    def ln(prefix, p):
        sd[prefix + ".weight"], sd[prefix + ".bias"] = t(p["w"]), t(p["b"])

    def gru(prefix, layers):
        for k, layer in enumerate(layers):
            for d, suf in (("f", ""), ("b", "_reverse")):
                sd[f"{prefix}.weight_ih_l{k}{suf}"] = t(layer[f"wi_{d}"]).T.contiguous()
                sd[f"{prefix}.weight_hh_l{k}{suf}"] = t(layer[f"wh_{d}"]).T.contiguous()
                sd[f"{prefix}.bias_ih_l{k}{suf}"] = t(layer[f"bi_{d}"])
                sd[f"{prefix}.bias_hh_l{k}{suf}"] = t(layer[f"bh_{d}"])

    lin("linear_s_in", params["linear_s_in"])
    lin("linear_z_in", params["linear_z_in"])
    enc = params["ipa"]
    ln("ipa.layer_norm_s", enc["ln_s"])
    ln("ipa.layer_norm_z", enc["ln_z"])
    lin("ipa.linear_in", enc["linear_in"])
    ln("ipa.layer_norm_ipa", enc["ln_ipa"])
    p = enc["ipa"]
    for name, key in (("linear_q", "q"), ("linear_kv", "kv"), ("linear_q_points", "q_pts"),
                      ("linear_kv_points", "kv_pts"), ("linear_b", "b"),
                      ("pair_out", "pair_out"), ("hidden_out", "hidden_out"),
                      ("points_out", "points_out"), ("points_norm_out", "points_norm_out")):
        lin("ipa.ipa." + name, p[key])
    sd["ipa.ipa.head_weights"] = t(p["head_weights"])
    gru("ipa.transition.layers.0", enc["transition"]["gru"])
    ln("ipa.transition.layer_norm", enc["transition"]["ln"])
    dec = params["decoder"]
    for i, blk in enumerate(dec["blocks"]):
        pre = f"decoder_head.blocks.{i}"
        ln(pre + ".norm1", blk["norm1"])
        ln(pre + ".norm2", blk["norm2"])
        lin(pre + ".attn.qkv", blk["qkv"])
        lin(pre + ".attn.proj", blk["proj"])
        lin(pre + ".mlp.fc1", blk["fc1"])
        lin(pre + ".mlp.fc2", blk["fc2"])
    sd["decoder_head.cls_emb"] = t(dec["cls_emb"])[None]
    sd["decoder_head.proj_patch"] = t(dec["proj_patch"])
    sd["decoder_head.proj_classes"] = t(dec["proj_classes"])
    ln("decoder_head.decoder_norm", dec["decoder_norm"])
    ln("decoder_head.class_norm", dec["class_norm"])
    gru("decoder_head.bg_gru", dec["bg_gru"])
    lin("decoder_head.bg_out", dec["bg_out"])
    gru("decoder_head.conf_gru", dec["conf_gru"])
    lin("decoder_head.conf_out", dec["conf_out"])
    return sd


def init_state_dict(seed: int = DEFAULT_SEED) -> dict:
    """A seeded random init of every MerizoNet entry, drawn on the CPU from
    one torch.Generator (the same numbers on every machine).

    The scheme is the JAX package's `init_params` (Linear weights
    N(0, 1/in), zero biases, LayerNorms at 1/0, GRUs U(-1/sqrt(H), 1/sqrt(H)),
    head weights 0.5413, the projections and class embeddings as there),
    except that the IPA's four output projections are N(0, 1/in) and not
    zero, so the default weights run every path of the encoder.
    """
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in MerizoNet().state_dict().items():
        mod, leaf = k.rsplit(".", 1)
        if leaf.startswith(("weight_ih", "weight_hh", "bias_ih", "bias_hh")):   # GRU
            bound = 1.0 / math.sqrt(v.shape[0] // 3)
            sd[k] = torch.empty(v.shape).uniform_(-bound, bound, generator=g)
        elif leaf == "head_weights":
            sd[k] = torch.full(v.shape, 0.541324854612918)
        elif leaf == "cls_emb":
            sd[k] = torch.randn(v.shape, generator=g)
        elif leaf in ("proj_patch", "proj_classes"):
            sd[k] = torch.randn(v.shape, generator=g) * v.shape[0] ** -0.5
        elif v.dim() == 1:       # LayerNorm weight/bias, Linear bias
            sd[k] = torch.ones(v.shape) if ("norm" in mod and leaf == "weight") \
                else torch.zeros(v.shape)
        elif k == "linear_s_in.weight":
            sd[k] = torch.randn(v.shape, generator=g) * 0.05
        elif k == "linear_z_in.weight":
            sd[k] = torch.randn(v.shape, generator=g) * 0.5
        else:                    # Linear weight [out, in]
            sd[k] = torch.randn(v.shape, generator=g) / math.sqrt(v.shape[1])
    return sd


def load_merizo_params(weights_dir: str | None = None, device="cuda") -> MerizoNet:
    """MerizoNet on `device`, in eval mode: the reference's split weight files
    (every `.pt` in `weights_dir`, merged, predict.py:117-140), or the
    seeded init when no directory is given or it holds no `.pt`."""
    from ...device import resolve_device

    dev = resolve_device(device)      # before the weights: no card, no work
    sd = {}
    if weights_dir:
        for f in sorted(os.listdir(weights_dir)):
            if f.endswith(".pt"):
                part = torch.load(os.path.join(weights_dir, f), map_location="cpu")
                sd.update(part.state_dict() if hasattr(part, "state_dict") else part)
        if not sd:
            logger.warning("no .pt files in %s; using the seeded default weights",
                           weights_dir)
    return model_from_state_dict(sd or init_state_dict(), dev)
