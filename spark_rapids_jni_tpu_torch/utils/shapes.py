"""Power-of-two slot counts for the fused plan's static shapes (the JAX
package's utils/shapes.py).

The fused program keeps every intermediate at a size known before it runs:
a GroupBy pads its group slots to ``bucket_size(...)``. The same rounding
as the JAX package keeps the two packages' slot counts, and so their
overflow decisions, equal.
"""

from __future__ import annotations


def bucket_size(n: int, floor: int = 1024) -> int:
    """Smallest power of two >= n (>= floor). n == 0 stays 0."""
    if n <= 0:
        return 0
    if n <= floor:
        return floor
    return 1 << (n - 1).bit_length()
