"""Attention constants shared by the ported kernels.

Own copies of ``devt_tpu/ops/flash_attention.py``'s constants.  The flash
and packed-qkv attention kernels themselves are not ported yet (ROADMAP.md,
queue 2).
"""

from __future__ import annotations

# additive key-padding mask value: -1e30, not -inf, keeps a fully masked
# row NaN-free, and exp() turns it into an exact zero next to a real score
NEG_INF = -1e30
_LANES = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def fits_single_block(s: int) -> bool:
    """True when a sequence fits one kv block of the single-block
    kernels (the fused ViT block): S rounded up to 128 is at most 512."""
    return _round_up(s, _LANES) <= 512
