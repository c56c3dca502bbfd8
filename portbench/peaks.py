"""The yardstick's peaks and its roofline arithmetic.

The H100 SXM data-sheet figures (dense, no sparsity, at the card's full
700 W): HBM at 3.35 TB/s, 989 TFLOP/s bf16, 1,979 TOP/s int8 on the
tensor cores, and 67 TFLOP/s f32 on the CUDA cores (TF32 off). A copy of
the port's `tools/_bench_util.bound` arithmetic, kept here so that the
yardstick does not move with the program.
"""

from __future__ import annotations

HBM_BPS = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def bound_s(nbytes: float, ops: float, dtype: str) -> float:
    """The least seconds the card could take for `nbytes` of device-memory
    traffic and `ops` operations of `dtype`: the larger of the two."""
    return max(nbytes / HBM_BPS, ops / PEAK_OPS[dtype])


def foldclass_flops(lengths, dim: int = 128, m_dim: int = 256, layers: int = 2) -> float:
    """Multiply-add operations (two a product) of the Foldclass forward over
    structures of the given lengths, at its published widths, over all
    L^2 pairs of each structure. Counted in the split form, the least the
    network needs: the first edge Linear (2*dim+1 -> 2*(2*dim+1)) is
    separable, so its node parts run once a residue, and a pair pays the
    second edge Linear (hidden -> m_dim) and the gate (m_dim -> 1).
    Elementwise work (SiLU, sums) is not counted."""
    hidden = 2 * (2 * dim + 1)
    per_pair = 2 * (hidden * m_dim + m_dim)
    per_node = 2 * (2 * dim * hidden + (dim + m_dim) * 2 * dim + 2 * dim * dim)
    total = 0.0
    for n in lengths:
        total += layers * (n * n * per_pair + n * per_node)
    return total
