"""The shuffle's partition route (the JAX package's parallel/exchange.py).

Only ``partition_ids`` is ported: the destination partition of each row of
a map-side batch. The all-to-all exchange itself is ROADMAP A15.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..columnar.column import Table
from ..ops.hashing import murmur_hash3_32


def partition_ids(table: Table, key_indices: Sequence[int],
                  num_partitions: int) -> torch.Tensor:
    """int32 destination partition per row: the murmur3 row hash of the key
    columns (kernel B1), taken as unsigned, mod ``num_partitions``.

    This is the JAX package's rule. Spark's HashPartitioning takes pmod of
    the SIGNED hash, which differs for a negative hash whenever
    2**32 % num_partitions != 0 (200 partitions, say) — a recorded gap of
    the reference (ROADMAP "Reference caveats"), reproduced here."""
    h = murmur_hash3_32(Table(tuple(table.columns[i] for i in key_indices)))
    return ((h.data.to(torch.int64) & 0xFFFFFFFF) % num_partitions).to(
        torch.int32)
