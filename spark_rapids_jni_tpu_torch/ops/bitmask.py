"""Validity bitmasks (the JAX package's ops/bitmask.py).

The OR of masks (the reference's ``bitmask_bitwise_or``) and the pack and
unpack between the engine's ``bool[n]`` masks and cudf-layout packed words
(bit i of word w = row 32w + i). Words are ``uint32`` values held in
int64 tensors, as the row hashes hold theirs (torch has no uint32 shift or
add). The JAX package tags pack and unpack as plan cores; the port's fused
lowering composes neither, so they are plain functions here.
"""

from __future__ import annotations

from typing import Sequence

import torch


def bitmask_bitwise_or(masks: Sequence[torch.Tensor]) -> torch.Tensor:
    """OR of equal-length bool masks."""
    if not masks:
        raise ValueError("need at least one mask")
    out = masks[0]
    for m in masks[1:]:
        if m.shape != out.shape:
            raise ValueError("mismatched mask lengths")
        out = out | m
    return out


def pack_bool_mask(mask: torch.Tensor) -> torch.Tensor:
    """bool[n] -> the ceil(n/32) packed validity words (u32 values in
    int64)."""
    n = mask.shape[0]
    nwords = (n + 31) // 32
    bits = torch.zeros(nwords * 32, dtype=torch.int64, device=mask.device)
    bits[:n] = mask.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    return (bits.view(nwords, 32) << shifts).sum(dim=1)


def unpack_bool_mask(words: torch.Tensor, n: int) -> torch.Tensor:
    """Packed validity words -> bool[n]."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words.to(torch.int64)[:, None] >> shifts) & 1
    return bits.reshape(-1)[:n].to(torch.bool)
