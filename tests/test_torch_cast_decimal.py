"""The port's string -> decimal cast (``ops/cast_string.string_to_decimal``)
against the JAX package's, bit for bit (tolerance 0): values and validity
at every precision 1-9 (DECIMAL32), the golden vectors at those
precisions, positive scales included. ``test_torch_cast_decimal_wide.py``
takes precisions 10-38 over the same column.

Inputs: every rounding, exponent and edge vector of
``tests/test_cast_string.py`` (the reference's cast_string.cpp) in one
column, with seeded random decimal strings of up to 40 digits and
exponents. The JAX package runs under ``torch_parity.
jax_decimal_any_scale``: one compile per storage class and sign of the
scale, not one per (precision, scale).
"""

import numpy as np
import pytest

from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.ops import cast_string as JC
from spark_rapids_jni_tpu_torch.ops import cast_string as PC
from torch_parity import jax_decimal_any_scale  # noqa: F401
from torch_parity import assert_col_equal, to_port


pytestmark = pytest.mark.usefixtures("jax_decimal_any_scale")

# (strings, precision, cudf scale) of tests/test_cast_string.py
GOLDEN = [
    (["1", "0", "-1"], 1, 0),
    (["123456", "999999", "-123456", "-999999"], 5, 0),
    (["1.23456", "9.99999", "-1.23456", "-9.99999"], 5, -4),
    (["1.234", "0.12345", "-1.034", "-0.001234567890123456"], 6, -5),
    (["1.234e-1", "0.12345e1", "-1.034e-2", "-0.001234567890123456e2"], 6,
     -5),
    (["1234e-1", "12345e1", "-1234.5678", "-0.001234567890123456e6"], 6, 2),
    (["813847339", "043469773", "548977048", "null", "957413342"], 8, 3),
    (["123456789012345678901234567890123456.01"], 38, -2),
    (["8.483315330475049E-4", "8.483315330475049E-2", "-1.0E14",
      "8.575859E8"], 15, -1),
    (["-1.0E14"], 16, -1),
    (["10.0"], 3, -1),
    (["1.7142857343", "1.71428573437482136712623", "12.345678901"], 9, -8),
    (["1.71428573437482136712623"], 9, -9),
    (["0.12345678901", "1.2345678901"], 6, -6),
    (["NaN", "inf", "-inf", "0"], 6, 0),
    (["1234567809"], 8, 3),
    (["4347202159", "4347802159"], 4, 6),
]


def _strings():
    vals = sorted({s for strs, _, _ in GOLDEN for s in strs})
    rng = np.random.default_rng(17)
    for _ in range(120):
        digits = "".join(rng.choice(list("0123456789"), rng.integers(1, 41)))
        cut = int(rng.integers(0, len(digits) + 1))
        s = digits[:cut] + ("." + digits[cut:] if cut < len(digits) else "")
        if rng.random() < 0.3:
            s += f"e{int(rng.integers(-45, 46))}"
        if rng.random() < 0.5:
            s = "-" + s
        if rng.random() < 0.1:
            s = f" {s}\t"
        vals.append(s)
    vals += ["9" * 38, "-" + "9" * 38, "9" * 39, "0.5", "-0.5", "9.5", "99.5",
             "1e-1", "5e-1", ".5", "5.", "1e", "1e+", "--1", "1..2", "1 2",
             "  ", "", None, "0e999999999999999999", "1e9223372036854775807"]
    return vals


J, P = (lambda j: (j, to_port(j)))(JColumn.from_pylist(_strings(),
                                                       jdt.STRING))


NARROW = [g for g in GOLDEN if g[1] <= 9]


def check(precision, scale):
    assert_col_equal(JC.string_to_decimal(J, precision, scale),
                     PC.string_to_decimal(P, precision, scale),
                     f"precision {precision} scale {scale}")


@pytest.mark.parametrize("precision", range(1, 10))
def test_every_precision_matches(precision):
    check(precision, (0, -2, -(precision // 2) - 1)[precision % 3])


@pytest.mark.parametrize("strs,precision,scale", NARROW,
                         ids=[f"{p}_{s}" for _, p, s in NARROW])
def test_golden_vectors_match(strs, precision, scale):
    """Each golden (precision, scale) over the column that holds its
    strings (and all the others)."""
    assert set(strs) <= set(J.to_pylist())
    check(precision, scale)
