"""The port's string -> decimal cast against the JAX package's at every
precision 10-18 (DECIMAL64), the golden vectors at those precisions and
the ANSI error, over ``test_torch_cast_decimal.py``'s column, bit for bit
(tolerance 0), and the engine bridge's ``cast.string_to_decimal`` through
both packages' ``bridge.call`` (``test_torch_bridge.py``'s case; here its
JAX compile is this module's). ``test_torch_cast_decimal128.py`` takes
19-38."""

import pytest

from spark_rapids_jni_tpu.ops import cast_string as JC
from spark_rapids_jni_tpu_torch.ops import cast_string as PC
from test_torch_bridge import IN, S2D_CASE, assert_same, both
from test_torch_cast_decimal import GOLDEN, J, P, check
from torch_parity import jax_decimal_any_scale  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_decimal_any_scale")

WIDE = [g for g in GOLDEN if 9 < g[1] <= 18]


@pytest.mark.parametrize("precision", range(10, 19))
def test_every_precision_matches(precision):
    check(precision, (0, -2, -(precision // 2) - 1)[precision % 3])


@pytest.mark.parametrize("strs,precision,scale", WIDE,
                         ids=[f"{p}_{s}" for _, p, s in WIDE])
def test_golden_vectors_match(strs, precision, scale):
    assert set(strs) <= set(J.to_pylist())
    check(precision, scale)


def test_ansi_error_matches():
    outcomes = []
    for C, col in ((JC, J), (PC, P)):
        try:
            C.string_to_decimal(col, 12, -2, ansi_mode=True)
            outcomes.append(None)
        except Exception as e:  # noqa: BLE001 - the outcome is compared
            outcomes.append((type(e).__name__, e.row_number,
                             e.string_with_error))
    assert outcomes[0] is not None and outcomes[1] == outcomes[0]


def test_bridge_string_to_decimal_matches_wire_bytes():
    op, args, names = S2D_CASE
    assert_same(*both(op, args, [IN[n] for n in names]))
