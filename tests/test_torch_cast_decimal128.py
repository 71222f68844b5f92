"""The port's string -> decimal cast against the JAX package's at every
precision 19-38 (DECIMAL128, 4 x 32-bit limb lanes) and the golden
vectors at those precisions, over ``test_torch_cast_decimal.py``'s
column, bit for bit (tolerance 0)."""

import pytest

from test_torch_cast_decimal import GOLDEN, J, check
from torch_parity import jax_decimal_any_scale  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_decimal_any_scale")

WIDE = [g for g in GOLDEN if g[1] > 18]


@pytest.mark.parametrize("precision", range(19, 39))
def test_every_precision_matches(precision):
    check(precision, (0, -2, -(precision // 2) - 1)[precision % 3])


@pytest.mark.parametrize("strs,precision,scale", WIDE,
                         ids=[f"{p}_{s}" for _, p, s in WIDE])
def test_golden_vectors_match(strs, precision, scale):
    assert set(strs) <= set(J.to_pylist())
    check(precision, scale)
