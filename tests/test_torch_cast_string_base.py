"""The port's base-10/16 casts (``ops/cast_string_base.py``) against the
JAX package's, bit for bit: ``to_integers_with_base`` for every integer
type in both bases over the vectors of ``tests/test_cast_string_base.py``
(the reference's CastStringsTest) and seeded random strings, and
``from_integers_with_base`` over seeded integers of every width, nulls
included (a null row renders its value too)."""

import numpy as np
import pytest

from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.ops import cast_string_base as JB
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.columnar.column import Column
from spark_rapids_jni_tpu_torch.ops import cast_string_base as PB
from torch_parity import assert_col_equal, to_port

INT_TYPES = ["INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16", "UINT32",
             "UINT64"]


def _strings():
    golden = ["1A", "ff", "-1f", "  beef", "12xyz", "xyz", "", "  ", None,
              "0", "123", "-45", "  7 ", "9.5", "abc", "-", "4294967296",
              "FFFFFFFFFF", "510", "00510", "00-510", " ", "junk-510junk510",
              "--510", "   -510junk510", "  510junk510", "junk", "f",
              "junk-5Ajunk5A", "--5A", "   -5Ajunk5A", "  5Ajunk5A", "5a",
              "05a", "005a", "00-5a", "NzGGImWNRh", "\x0b12", "\x0c-3",
              "18446744073709551615", "18446744073709551616",
              "FFFFFFFFFFFFFFFFF", "-FFFFFFFFFFFFFFFF"]
    rng = np.random.default_rng(4)
    alphabet = list("0123456789abcdefABCDEFxyz- \t")
    rand = ["".join(rng.choice(alphabet, rng.integers(0, 24)))
            for _ in range(150)]
    return golden + rand


J = JColumn.from_pylist(_strings(), jdt.STRING)
P = to_port(J)


@pytest.mark.parametrize("base", [10, 16])
@pytest.mark.parametrize("t", INT_TYPES)
def test_to_integers_with_base_matches(base, t):
    assert_col_equal(JB.to_integers_with_base(J, base, getattr(jdt, t)),
                     PB.to_integers_with_base(P, base, getattr(pdt, t)),
                     f"{t} base {base}")


@pytest.mark.parametrize("base", [10, 16])
@pytest.mark.parametrize("t", INT_TYPES)
def test_from_integers_with_base_matches(base, t):
    rng = np.random.default_rng(5)
    info = np.iinfo(getattr(jdt, t).np_dtype)
    vals = rng.integers(info.min, info.max, 120, dtype=info.dtype,
                        endpoint=True)
    vals[:3] = [info.min, info.max, 0]
    valid = rng.random(120) > 0.2
    j = JColumn.from_numpy(vals, getattr(jdt, t), validity=valid)
    assert_col_equal(JB.from_integers_with_base(j, base),
                     PB.from_integers_with_base(to_port(j), base))


def test_unsupported_base_raises():
    col = Column.from_pylist(["1"], pdt.STRING, device="cpu")
    for fn in (lambda: PB.to_integers_with_base(col, 8, pdt.INT32),
               lambda: PB.from_integers_with_base(
                   Column.from_pylist([1], pdt.INT32, device="cpu"), 2)):
        with pytest.raises(ValueError, match="Bases supported 10, 16"):
            fn()


def test_conv_round_trip():
    """CastStringsTest's conv pipeline: parse as UINT64, render in base 10
    and 16, both packages."""
    for base in (10, 16):
        ji = JB.to_integers_with_base(J, base, jdt.UINT64)
        pi = PB.to_integers_with_base(P, base, pdt.UINT64)
        for out in (10, 16):
            assert_col_equal(JB.from_integers_with_base(ji, out),
                             PB.from_integers_with_base(pi, out))
