"""Port parity: ``decimal_to_string`` (spark_rapids_jni_tpu_torch.ops
.decimal_to_string) against the JAX package's, bit-exact: each row's bytes
and the validity, for DECIMAL32/64/128 at the scales where
BigDecimal.toString switches between plain and scientific notation."""

from decimal import Decimal

import numpy as np
import pytest

from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.ops import decimal_to_string as JDS
from spark_rapids_jni_tpu_torch.ops import decimal_to_string as DS

from torch_parity import assert_col_equal, to_port

EDGES = [0, 1, -1, 7, -7, 10, 100, 12345, -12345, 999999, 10**6]


def _column(kind, scale, seed):
    r = np.random.default_rng(seed)
    n = 64
    if kind == "decimal128":
        top = 10**38 - 1
        ints = [int(x) for x in r.integers(-2**62, 2**62, n)]
        ints[:4] = [top, -top, 2**64 + 5, -(2**96)]
        vals = [None if i % 9 == 4 else Decimal(v).scaleb(-scale)
                for i, v in enumerate(ints + EDGES)]
        return JColumn.from_pylist(vals, jdt.decimal128(scale))
    bits = 31 if kind == "decimal32" else 63
    v = np.concatenate([r.integers(-2**bits, 2**bits - 1, n), EDGES])
    d = jdt.decimal32(scale) if kind == "decimal32" else jdt.decimal64(scale)
    return JColumn.from_numpy(v.astype(d.np_dtype), d,
                              validity=r.random(v.size) > 0.1)


@pytest.mark.parametrize("kind", ["decimal32", "decimal64", "decimal128"])
def test_decimal_to_string_matches(kind):
    for i, scale in enumerate((0, 2, 6, 7, 12, -3)):
        if kind == "decimal128" and scale < 0:
            continue
        jc = _column(kind, scale, i)
        assert_col_equal(JDS.decimal_to_string(jc),
                         DS.decimal_to_string(to_port(jc)))
    with pytest.raises(TypeError, match="not a decimal"):
        DS.decimal_to_string(to_port(JColumn.from_pylist([1], jdt.INT64)))
