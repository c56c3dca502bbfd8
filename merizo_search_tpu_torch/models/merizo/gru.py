"""The bidirectional two-layer GRU of Merizo's three recurrent heads.

The reference runs torch's nn.GRU (bidirectional, batch_first) in the IPA
transition (nndef_ipa.py:7-34, hidden c/2), the decoder's background head
(mask_decoder.py:123-132) and the per-domain confidence head
(mask_decoder.py:135-154), each on sequences of their exact length. The JAX
package runs padded sequences with a mask (ops/gru.py); here the recurrence
is nn.GRU itself (cuDNN on the card), and sequences shorter than the padded
width are packed, so the reverse direction starts at each sequence's own
last step and never inside the padding.

The lengths decide on the host whether and how to pack. Given as a CPU
tensor (the segmenter knows every chain's length), they cost the card no
sync; sorted longest first, packing also needs no host-to-device copy of a
sort order (a pageable copy waits for the card's queue).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence


class BiGRU(nn.GRU):
    """nn.GRU(bidirectional, 2 layers, batch_first) under the reference's
    parameter names (weight_ih_l0, weight_hh_l1_reverse, ...)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size, num_layers=2, bidirectional=True,
                         batch_first=True)

    def run(self, x: torch.Tensor, lengths: torch.Tensor | None = None):
        """x [B,T,I] -> (out [B,T,2H], h_last_reverse [B,H]).

        `lengths` [B] (each >= 1) gives each row's valid prefix, best on the
        host (one on the card is copied back once: a sync); None means every
        row is T long. The second value is the top layer's reverse final
        state (torch's h_n[-1]), in the rows' own order, which the
        confidence head reads. Output rows past a sequence's length are
        zero.
        """
        if lengths is not None:
            lengths = lengths.cpu().long()
        if lengths is None or bool((lengths == x.shape[1]).all()):
            out, h = self(x)
            return out, h[-1]
        packed = pack_padded_sequence(x, lengths, batch_first=True,
                                      enforce_sorted=bool((lengths[:-1] >= lengths[1:]).all()))
        out, h = self(packed)
        out, _ = pad_packed_sequence(out, batch_first=True, total_length=x.shape[1])
        return out, h[-1]
