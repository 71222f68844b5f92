"""The port's string -> integer and string -> float casts
(``ops/cast_string.py``) against the JAX package's, bit for bit
(tolerance 0): values, validity and, in ANSI mode, the exception's type,
row and string.

Inputs are the golden vectors of ``tests/test_cast_string.py`` (from the
reference's cast_string.cpp), ``tests/test_float_bits.py``'s string
corpus, the JAX package's own cast cell (``benchmarks/bench_ops.py``:
standard normal x 10^[-5, 5] formatted "%.6f", seed 0) and the float
probe inputs. Each cast runs over one column holding all its vectors, so
the JAX package compiles once per target type. FLOAT32 results compare
as bits (XLA:CPU flushes subnormal float32 values read as values).
"""

from fractions import Fraction

import numpy as np
import pytest

from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.ops import cast_string as JC
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.columnar.column import Column
from spark_rapids_jni_tpu_torch.ops import cast_string as PC
from test_cast_string import ANSI_STRINGS, ANSI_VALIDITY, OVERFLOW_STRINGS
from test_float_bits import _oracle32
from torch_parity import assert_col_equal, to_port

INT_TYPES = ["INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16", "UINT32",
             "UINT64"]

# the probe of ROADMAP A12.2: subnormals of both widths, signed zero, an
# exponent past the range, a padded NaN, a signed infinity, a float suffix
PROBE = ["4.9e-324", "1e-310", "1.4e-45", "1e-40", "-0", "0e5", "1e400",
         " NaN ", "-Infinity", "1.0f"]


def _pair(strs):
    j = JColumn.from_pylist(strs, jdt.STRING)
    return j, to_port(j)


def _int_strings():
    extra = ["1", "0", "42", None, " -17 ", "+", "-", "00000000000000000001",
             "12a", "\t9\n", "1.99"]
    vals = [v if ok else None for v, ok in zip(ANSI_STRINGS, ANSI_VALIDITY)]
    return vals + OVERFLOW_STRINGS + extra


INTS = _pair(_int_strings())


@pytest.mark.parametrize("t", INT_TYPES)
def test_string_to_integer_matches(t):
    j, p = INTS
    assert_col_equal(JC.string_to_integer(j, getattr(jdt, t)),
                     PC.string_to_integer(p, getattr(pdt, t)), t)


@pytest.mark.parametrize("t", ["INT32", "UINT64"])
def test_string_to_integer_unstripped_matches(t):
    j, p = INTS
    assert_col_equal(JC.string_to_integer(j, getattr(jdt, t), strip=False),
                     PC.string_to_integer(p, getattr(pdt, t), strip=False), t)


def _ansi_outcome(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return type(e).__name__, e.row_number, e.string_with_error, str(e)
    return None


@pytest.mark.parametrize("t", INT_TYPES)
def test_string_to_integer_ansi_matches(t):
    j, p = INTS
    jo = _ansi_outcome(lambda: JC.string_to_integer(j, getattr(jdt, t),
                                                    ansi_mode=True))
    po = _ansi_outcome(lambda: PC.string_to_integer(p, getattr(pdt, t),
                                                    ansi_mode=True))
    assert jo is not None and po == jo


def test_empty_columns():
    empty = Column.from_pylist([], pdt.STRING, device="cpu")
    for out, want in ((PC.string_to_integer(empty, pdt.UINT16), pdt.UINT16),
                      (PC.string_to_float(empty, pdt.FLOAT64), pdt.FLOAT64),
                      (PC.string_to_decimal(empty, 8, 2), pdt.decimal32(-2))):
        assert out.size == 0 and out.dtype == want


def _float_strings():
    simple = ["-1.8946e-10", "0001", "0000.123", "123", "123.45", "45.123",
              "-45.123", "0.45123", "-0.45123", "999999999999999999999",
              "99999999999999999999", "9999999999999999999",
              "18446744073709551609", "18446744073709551610",
              "18446744073709551619999999999999", "-18446744073709551609",
              "-18446744073709551610", "-184467440737095516199999999999997"]
    literals = ["NaN", "-Infinity", "inf", "Infinity", "-inf", "-nan",
                "infx", "nan ", "InFiNiTy"]
    invalid = ["A", "null", "na7.62", "e", ".", "", "f", "E15", None]
    tricky = ["7f", "\riNf", "1.3e5ef", "1.3e+7f", "9\n", "46037e\t", "8d",
              "0\n", ".\r", "2F.", "                                    7d",
              "                            98392.5e-1f",
              "-1.6721969836937668E-304", "-2.21363921575273728E17", "0",
              "00000000000000000000", "-0000000000000000000E0",
              "0000000000000000000E0", "0000000000000000000000000000000017",
              "0.01234567890123456789", "0.00123456789012345678",
              "1e12345", "1.5e-99999", "0f", "0e5f"]
    rng = np.random.default_rng(1)
    vals = rng.standard_normal(300) * 10.0 ** rng.integers(-300, 300, 300)
    corpus = [f"{v:.17e}" for v in vals] + [
        "5e-324", "2.47e-324", "2.5e-324", "1.7976931348623157e308",
        "1.8e308", "-1.7976931348623157e+308", "9007199254740993",
        "0.000000000000000000000000000000000000000000001e45"]
    rng = np.random.default_rng(0)
    cell = rng.standard_normal(200) * 10.0 ** rng.integers(-5, 6, 200)
    return (simple + literals + invalid + tricky + corpus + PROBE
            + [f"{v:.6f}" for v in cell])


FLOATS = _pair(_float_strings())


@pytest.mark.parametrize("t", ["FLOAT32", "FLOAT64"])
def test_string_to_float_matches(t):
    j, p = FLOATS
    assert_col_equal(JC.string_to_float(j, getattr(jdt, t)),
                     PC.string_to_float(p, getattr(pdt, t)), t)


@pytest.mark.parametrize("is64", [False, True])
def test_string_to_float_core_matches(is64):
    """Bits, validity and the ANSI error flag of every row (inf with
    trailing garbage nulls without an error)."""
    from spark_rapids_jni_tpu.columnar.strings import padded_bytes as jpad
    from spark_rapids_jni_tpu_torch.columnar.strings import padded_bytes
    j, p = FLOATS
    jmat, jlen = jpad(j)
    want = JC._string_to_float_core(jmat, jlen, j.valid_mask(), is64=is64)
    pmat, plen = padded_bytes(p)
    got = PC._string_to_float_core(pmat, plen.long(), p.valid_mask(),
                                   is64=is64)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(
            g.numpy().dtype))


@pytest.mark.parametrize("t", ["FLOAT32", "FLOAT64"])
def test_string_to_float_ansi_matches(t):
    j, p = FLOATS
    jo = _ansi_outcome(lambda: JC.string_to_float(j, getattr(jdt, t),
                                                  ansi_mode=True))
    po = _ansi_outcome(lambda: PC.string_to_float(p, getattr(pdt, t),
                                                  ansi_mode=True))
    assert jo is not None and po == jo


def test_probe_bits():
    """The probe's bits against Python's float() (binary64) and the exact
    single rounding (binary32); " NaN " is null in both packages (only the
    bare 3-character "nan" is valid: cast_string_to_float.cu)."""
    col = Column.from_pylist(PROBE, pdt.STRING, device="cpu")
    o64 = PC.string_to_float(col, pdt.FLOAT64)
    o32 = PC.string_to_float(col, pdt.FLOAT32)
    b64 = o64.data.numpy().view(np.uint64)
    b32 = o32.data.numpy().view(np.uint32)
    valid = o64.validity.numpy().tolist()
    assert valid == o32.validity.numpy().tolist()
    assert valid == [s != " NaN " for s in PROBE]
    for i, s in enumerate(PROBE):
        if s == " NaN ":
            continue
        text = s.rstrip("f")
        assert b64[i] == np.float64(float(text)).view(np.uint64), s
        if "inf" in text.lower():
            want32 = 0xFF800000 if text.startswith("-") else 0x7F800000
        else:
            x = Fraction(text)
            mant, exp, neg = abs(x), 0, text.startswith("-")
            while mant.denominator != 1:
                mant, exp = mant * 10, exp - 1
            want32 = int(_oracle32(int(mant), exp, neg))
        assert int(b32[i]) == want32, s
