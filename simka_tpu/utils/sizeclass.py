"""Padded size classes for device program shapes.

Dynamic row counts are padded UP to static power-of-two classes so
recompiles stay bounded. Power-of-two classes were chosen on the
system's earlier accelerator, where half-octave classes ran no
faster; on the GPU, where sort cost may grow linearly with rows, the
classes can pad by up to 2x. Not yet measured here (ROADMAP.md,
design item 7).
"""

from __future__ import annotations


def pad_size_class(n: int, min_bits: int = 10) -> int:
    """Smallest power-of-two class >= max(n, 2^min_bits)."""
    n = max(int(n), 1 << min_bits)
    return 1 << (n - 1).bit_length()
