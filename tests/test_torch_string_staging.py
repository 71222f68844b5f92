"""Kernel B2's staged STRING path (csrc/row_hash.cu,
xxhash64_staged_rows_kernel) on the CPU, through its plain emulation
(spark_rapids_jni_tpu_torch.ops.kernels ``xxhash64_tile_plan``,
``xxhash64_staged_emulation``).

The tile plan is checked on its own: every row of a 32-row tile is staged
in exactly one window or hashed from device memory, a window is a
16-byte-aligned span within the stage budget that covers its rows, a row
goes to device memory exactly when its own cover exceeds the budget, and
each window takes every row that fits. The emulation copies each window
into a stage, builds each row's words from aligned 32-bit words as the
kernel does (checking that the device path reads no word outside the row
and the stage no word past its end) and hashes; it must equal the plain
version (``xxhash64_fixed_rows_plain``) and the JAX package's byte hash
(``ops/hashing.py::_xx_bytes``) bit for bit. Inputs, from numpy seeds:
characters at every address residue mod 16, offsets not starting at 0,
lengths 0-300 around a small stage budget, empty tiles, null rows, a
ragged last tile, and STRING columns among fixed-width ones."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.ops import hashing as JH
from spark_rapids_jni_tpu_torch.columnar.strings import densify_offsets
from spark_rapids_jni_tpu_torch.ops import kernels as K

from torch_parity import quick_jax_reference  # noqa: F401


def _strings(n, max_len, seed, p_null=0.1, start=0, empty_tile=None):
    """A STRING schema entry: ``n`` random strings of 0-``max_len`` bytes
    whose offsets start at ``start``; the rows of tile ``empty_tile``
    empty."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, max_len + 1, n)
    if empty_tile is not None:
        lengths[32 * empty_tile:32 * empty_tile + 32] = 0
    offs = np.full(n + 1, start, dtype=np.int64)
    offs[1:] += np.cumsum(lengths)
    chars = rng.integers(0, 256, int(offs[-1]), dtype=np.uint8)
    valid = torch.from_numpy(rng.random(n) >= p_null)
    return ("str", (torch.from_numpy(offs.astype(np.int32)),
                    torch.from_numpy(chars)), valid)


def _covers(offs, residue):
    """Each row's 16-byte-aligned cover [lo, hi) from the aligned base."""
    offs = np.asarray(offs, dtype=np.int64)
    return (offs[:-1] + residue) & ~15, (offs[1:] + residue + 15) & ~15


@pytest.mark.parametrize("budget, tile_rows",
                         [(64, 32), (256, 128),
                          (K.XX_STAGE_BYTES, K.XX_TILE_ROWS)])
def test_tile_plan_stages_every_row_once(budget, tile_rows):
    for residue in range(16):
        offs = _strings(32 * 9 + 7, 300, seed=residue, start=residue * 7,
                        empty_tile=3)[1][0].numpy()
        lo, hi = _covers(offs, residue)
        n = len(offs) - 1
        tiles = K.xxhash64_tile_plan(offs, residue, budget, tile_rows)
        assert len(tiles) == -(-n // tile_rows)
        for t, tile in enumerate(tiles):
            r0, rows = tile_rows * t, min(tile_rows, n - tile_rows * t)
            whole = hi[r0 + rows - 1] - lo[r0] <= budget
            assert whole == (tile.windows == ((0, rows, lo[r0],
                                               hi[r0 + rows - 1]),))
            seen = sorted(tile.device_rows)
            for j0, j1, w0, w1 in tile.windows:
                assert 0 <= j0 < j1 <= rows
                assert whole or j0 // 32 == (j1 - 1) // 32  # 32-row runs
                assert w0 % 16 == 0 and w1 % 16 == 0
                assert 0 <= w1 - w0 <= budget
                assert w0 == lo[r0 + j0] and w1 == hi[r0 + j1 - 1]
                if j1 % 32 and j1 < rows and j1 not in tile.device_rows:
                    assert hi[r0 + j1] - w0 > budget  # it took all that fit
                seen += range(j0, j1)
            assert sorted(seen) == list(range(rows))
            assert set(tile.device_rows) == {
                j for j in range(rows)
                if hi[r0 + j] - lo[r0 + j] > budget}


def test_plan_constants_mirror_the_kernel():
    """XX_STAGE_BYTES and XX_TILE_ROWS are csrc/row_hash.cu's kXxStage and
    32 * kXxRowsPerLane."""
    src = (K._CSRC / "row_hash.cu").read_text()
    const = dict(re.findall(r"constexpr int (kXx\w+) = (\d+);", src))
    assert int(const["kXxStage"]) == K.XX_STAGE_BYTES
    assert 32 * int(const["kXxRowsPerLane"]) == K.XX_TILE_ROWS


CASES = {
    # (the schema, a function of the residue; stage budget; tile rows)
    "residues, lengths 0-300 around the budget": (
        lambda r: [_strings(32 * 5 + 3, 300, seed=10 + r, start=r + 5)],
        256, 32),
    "an empty tile, ragged last tile": (
        lambda r: [_strings(32 * 4 + 1, 100, seed=20 + r, empty_tile=1)],
        K.XX_STAGE_BYTES, K.XX_TILE_ROWS),
    "all rows past the budget": (
        lambda r: [_strings(40, 300, seed=30 + r, p_null=0.0)], 64, 32),
    "strings among fixed-width columns": (
        lambda r: [("u64", torch.from_numpy(np.random.default_rng(r)
                                            .integers(-2**62, 2**62, 70)),
                    None),
                   _strings(70, 120, seed=40 + r),
                   ("u32", torch.from_numpy(np.random.default_rng(r)
                                            .integers(-2**31, 2**31, 70)
                                            .astype(np.int32)),
                    torch.from_numpy(np.random.default_rng(r)
                                     .random(70) > 0.3)),
                   _strings(70, 300, seed=50 + r, start=3)],
        1024, 64),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulation_matches_plain(case):
    build, budget, tile_rows = CASES[case]
    for residue in range(16):
        schema = build(residue)
        n = len(schema[0][1][0]) - 1 if schema[0][0] == "str" \
            else len(schema[0][1])
        seed = (42, 0)[residue % 2]
        got = K.xxhash64_staged_emulation(schema, seed, n,
                                          [residue] * len(schema), budget,
                                          tile_rows)
        assert torch.equal(got, K.xxhash64_fixed_rows_plain(schema, seed, n))


def test_emulation_matches_jax_byte_hash(quick_jax_reference):  # noqa: F811
    """One STRING column of 0-300 bytes, null rows among them, stage
    budget 256: the emulation at several address residues against the JAX
    package's _xx_bytes over the same bytes padded to 512 (a null row
    keeps the seed)."""
    n, seed = 200, 42
    kind, (offsets, chars), valid = _strings(n, 300, seed=60, start=11)
    mat, lengths = densify_offsets(chars, offsets, 512)
    seeds = np.full(n, seed, dtype=np.uint64)
    want = np.asarray(JH._xx_bytes(jnp.asarray(seeds),
                                   jnp.asarray(mat.numpy()),
                                   jnp.asarray(lengths.numpy())))
    want = np.where(valid.numpy(), want, seeds).view(np.int64)
    for residue in (0, 5, 15):
        got = K.xxhash64_staged_emulation([(kind, (offsets, chars), valid)],
                                          seed, n, [residue], 256, 32)
        np.testing.assert_array_equal(got.numpy(), want)
