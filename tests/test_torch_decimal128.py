"""DECIMAL128 arithmetic of the port (ops/int128.py, ops/int256.py,
ops/decimal128.py; on the CPU the plain version of kernel H2) against the
JAX package's, bit for bit: limbs, overflow and validity.

The inputs are every vector of tests/test_decimal128.py (the reference's
DecimalUtilsTest.java constants), grouped by operation and scales so that
each group is one call of each package, and one seeded fuzz column per
operation. Every column has ROWS rows (a group is padded with zeros), so
the JAX package's ops compile once for the module; its long division and
precision10 run under ``jax.jit`` here, which changes how long their first
calls take, not what they compute.
"""

import decimal
from decimal import Decimal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import Column as JColumn
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.ops import decimal128 as jd128
from spark_rapids_jni_tpu.ops import int128 as ji128
from spark_rapids_jni_tpu.ops import int256 as ji256
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.columnar.column import (Column,
                                                        decimal128_literal)
from spark_rapids_jni_tpu_torch.ops import decimal128 as pd128
from spark_rapids_jni_tpu_torch.ops import int128 as pi128
from spark_rapids_jni_tpu_torch.ops import int256 as pi256
from spark_rapids_jni_tpu_torch.utils import datagen
import h2_host
from torch_parity import (assert_col_equal, jitted_jax_decimal,  # noqa: F401
                          quick_jax_reference, to_port)

decimal.getcontext().prec = 80
ROWS = 64
M256 = 1 << 256


pytestmark = pytest.mark.usefixtures("quick_jax_reference",
                                     "jitted_jax_decimal")


def _scale(values) -> int:
    """The JAX tests' rule (cudf's fromDecimals): the largest count of
    fractional digits, negative for E+NN forms."""
    s = [-Decimal(v).as_tuple().exponent for v in values if v is not None]
    return max(s) if s else 0


def _jcol(values, scale=None, pad="0"):
    values = list(values) + [pad] * (ROWS - len(values))
    scale = _scale(values) if scale is None else scale
    return JColumn.from_pylist([None if v is None else Decimal(v)
                                for v in values], jdt.decimal128(scale))


def _run_both(op, ja, jb, scale, cast=True):
    kw = {"cast_interim_result": cast} if op == "multiply" else {}
    args = () if op == "integer_divide" else (scale,)
    jt = getattr(jd128, f"{op}_decimal128")(ja, jb, *args, **kw)
    pt = getattr(pd128, f"{op}_decimal128")(to_port(ja), to_port(jb),
                                            *args, **kw)
    assert_col_equal(jt[0], pt[0], f"{op} overflow")
    assert_col_equal(jt[1], pt[1], f"{op} result")
    return pt


def _lanes(values, nlimbs):
    return np.stack([pi128.limbs_const(v, nlimbs) for v in values])


def _signed(v):
    v &= M256 - 1
    return v - M256 if v >> 255 else v


# ---------------------------------------------------------------------------
# the limb vocabulary
# ---------------------------------------------------------------------------

def test_int256_vocabulary_matches_jax_and_python():
    rng = np.random.default_rng(0)
    a_vals, b_vals = [], []
    for _ in range(ROWS):
        a = int(rng.integers(1, 2**62)) << int(rng.integers(0, 190))
        b = int(rng.integers(1, 2**62)) << int(rng.integers(0, 64))
        a_vals.append(-a if rng.random() < 0.5 else a)
        b_vals.append(-b if rng.random() < 0.5 else b)
    b_vals[:2] = [0, 1]
    la, lb = _lanes(a_vals, 8), _lanes(b_vals, 8)
    ja, jb = jnp.asarray(la.astype(np.uint32)), jnp.asarray(
        lb.astype(np.uint32))
    pa, pb = torch.from_numpy(la), torch.from_numpy(lb)

    def same(p, j):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j).astype(
            np.int64))

    same(pi256.add(pa, pb), ji256.add(ja, jb))
    same(pi256.multiply(pa, pb), ji256.multiply(ja, jb))
    same(pi256.negate(pa), ji256.negate(ja))
    same(pi256.shift_left_1(pa), ji256.shift_left_1(ja))
    same(pi256.sub_unsigned(pa, pb), ji256.sub_unsigned(ja, jb))
    np.testing.assert_array_equal(pi256.lt_unsigned(pa, pb).numpy(),
                                  np.asarray(ji256.lt_unsigned(ja, jb)))
    for fn in ("divmod_unsigned", "divmod_signed"):
        pq, pr = getattr(pi256, fn)(pa, pb)
        jq, jr = getattr(ji256, fn)(ja, jb)
        same(pq, jq)
        same(pr, jr)
    assert pi256.to_int_py(pi256.multiply(pa, pb)) == [
        _signed(a * b) for a, b in zip(a_vals, b_vals)]
    q, r = pi256.divmod_signed(pa, pb)
    for a, b, gq, gr in zip(a_vals[2:], b_vals[2:], pi256.to_int_py(q)[2:],
                            pi256.to_int_py(r)[2:]):
        want = abs(a) // abs(b) * (1 if (a < 0) == (b < 0) else -1)
        assert (gq, gr) == (want, a - want * b)


def test_int128_vocabulary_matches_jax():
    rng = np.random.default_rng(1)
    vals = [int(v) for v in rng.integers(-2**62, 2**62, ROWS)]
    vals = [v << int(s) for v, s in zip(vals, rng.integers(0, 64, ROWS))]
    vals[:4] = [0, -1, (1 << 127) - 1, -(1 << 127)]
    la = _lanes(vals, 4)
    ja, pa = jnp.asarray(la.astype(np.uint32)), torch.from_numpy(la)
    lb = np.roll(la, 1, axis=0)
    jb, pb = jnp.asarray(lb.astype(np.uint32)), torch.from_numpy(lb)
    small = rng.integers(-1000, 1000, ROWS)

    def same(p, j):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j).astype(
            p.numpy().dtype))

    same(pi128.negate(pa), ji128.negate(ja))
    same(pi128.abs_(pa), ji128.abs_(ja))
    same(pi128.mul10(pa), ji128.mul10(ja))
    same(pi128.add_small(pa, torch.from_numpy(small)),
         ji128.add_small(ja, jnp.asarray(small)))
    same(pi128.lt_unsigned(pa, pb), ji128.lt_unsigned(ja, jb))
    same(pi128.lt_signed(pa, pb), ji128.lt_signed(ja, jb))
    same(pi128.gt_signed(pa, pb), ji128.gt_signed(ja, jb))
    same(pi128.ndigits(pa), ji128.ndigits(ja))
    same(pi128.is_zero(pa), ji128.is_zero(ja))
    same(pi128.is_negative(pa), ji128.is_negative(ja))
    same(pi128.to_int64(pa), ji128.to_int64(ja))
    v64 = rng.integers(-2**63, 2**63 - 1, ROWS, dtype=np.int64)
    same(pi128.from_int64(torch.from_numpy(v64)),
         ji128.from_int64(jnp.asarray(v64)))
    u = rng.integers(0, 2**63, (2, ROWS), dtype=np.int64)
    u[:, :3] = [[-1, -1, 2**62], [-1, 1, 2**62]]  # u64 bits past 2^63
    hi, lo = pi128.umul128(torch.from_numpy(u[0]), torch.from_numpy(u[1]))
    jhi, jlo = ji128.umul128(jnp.asarray(u[0].astype(np.uint64)),
                             jnp.asarray(u[1].astype(np.uint64)))
    same(hi, np.asarray(jhi).view(np.int64))
    same(lo, np.asarray(jlo).view(np.int64))


def test_precision10_matches_jax():
    vals = [0, 1, 9, 10, 99, 10**38 - 1, 10**38, -(10**20), 10**76,
            10**76 + 1, -(1 << 255)]
    vals += datagen.decimal128_draws(ROWS - len(vals),
                                     np.random.default_rng(2))
    la = _lanes(vals, 8)
    got = pd128.precision10(torch.from_numpy(la)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jd128.precision10(jnp.asarray(la.astype(
            np.uint32)))))
    assert list(got[:9]) == [0, 0, 1, 1, 2, 38, 38, 20, 76]
    assert list(got[9:11]) == [77, 77]


# ---------------------------------------------------------------------------
# every vector of tests/test_decimal128.py, by op and scales
# ---------------------------------------------------------------------------

_A1 = ["9191008513307131620269245301.1615457290",
       "-9191008513307131620269245301.1615457290",
       "577694938495380589068894346.7625198736",
       "-7949989536398283250841565918.6123449781",
       "-569260079419403643627836417.1451349695",
       "4268696962649098725873162852.3422176564",
       "948521076935839001259204571.1574829065",
       "-9299778357834801251892834048.0026057082",
       "8127384240098008972235509102.7063990819",
       "-1012433127481465711031073593.0625063701"]
_B1 = ["451635271134476686911387864.48",
       "-9037370400215680718822505020.06",
       "-200173438757934601210092407.67",
       "3022290197578200820919308997.64",
       "388221337108432989001879408.73",
       "-9119163961520067341639997328.82",
       "7732813484881363300406806463.83",
       "5941454871287785414686091453.79",
       "-357209139972312354271434821.33",
       "-857448828702886587693936536.21"]
_REM_V = "2775750723350045263458396405825339066"
_REM_D = "4890990637589340307512622401149178814.1"
_BIG = "577694940161436285811555447.3103121126"

# (test id, op, out scale, cast_interim_result, a values, b values)
VECTORS = [
    ("mul_one_by_zero", "multiply", 1, True,
     ["1.0", "10.0", "1000000000000000000000000000000000000.0"],
     ["1", "1", "1"]),
    ("mul_by_one_neg_nulls", "multiply", 1, True,
     ["1.0", "3.7", "1.0", "-1.0", "3.7", "1.0", None],
     ["1.0", "1.5", "-1.0", "-1.0", "-1.5", "2.0", "3.0"]),
    ("mul_zero_by_neg_one_scale", "multiply", 1, True, ["1"], ["1e1"]),
    ("mul_ten_by_ten_overflow_interim", "multiply", 6, True,
     [_BIG, "577694938495380589068894346.7625198736",
      "3358377338823096511784947656.4650294583",
      "7161021785186010157110137546.5940777916",
      "9173594185998001607642838421.5479932913"],
     ["100.0000000000", "-1258508260891400005608241690.1564700995",
      "-12.0000000000", "-12.0000000000", "-12.0000000000"]),
    ("mul_overflow_scale0", "multiply", 0, True,
     ["50000000000000000000000000000000000000"], ["2"]),
    ("mul_without_interim_cast", "multiply", 6, False,
     ["-8533444864753048107770677711.1312637916", _BIG],
     ["-12.0000000000", "100.0000000000"]),
    ("div_by_zero", "divide", 1, True,
     ["1.0", "10.0", "1.0", "1000000000000000000000000000000000000.0"],
     ["1", "2", "0", "5"]),
    ("div_simple_neg", "divide", 1, True,
     ["1.0", "3.7", "99.9", "1.0", "-3.7", "-99.9"],
     ["1.0", "1.5", "4.5", "-1.0", "1.5", "-4.5"]),
    ("div_complex", "divide", 6, True,
     ["100000000000000000000000000000000"],
     ["3.0000000000000000000000000000000000000"]),
    ("div17", "divide", 17, True,
     ["1454.48287885760884146", "3655.54438423288356646"],
     ["100.00000000000000000"] * 2),
    ("div17_pos_scale", "divide", 17, True, ["1454.48287885760884146"],
     ["1e2"]),
    ("div21_pos_scale", "divide", 6, True,
     ["5776949401614362.858115554473103121126"], ["1e2"]),
    ("div21", "divide", 6, True,
     ["60250054953505368.439892586764888491018",
      "91910085134512953.335347579448489062875",
      "51312633107598808.869351260608653423886"],
     ["97982875273794447.385070145919990343867",
      "94478503341597285.814104936062234698349",
      "92266075543848323.800466593082956765923"]),
    ("int_divide", "integer_divide", 0, True,
     ["3396191716868766147341919609.06",
      "-6893798181986328848375556144.67"],
     ["7317548469.64", "98565515088.44"]),
    ("int_divide_not_overflow", "integer_divide", 0, True,
     ["451635271134476686911387864.48",
      "5313675970270560086329837153.18"], ["-961.110", "181.958"]),
    ("int_divide_by_zero", "integer_divide", 0, True,
     ["-999999999999999999999999999999999999.99",
      "999999999999999999999999999999999999.99"], ["0", "0"]),
    ("remainder1", "remainder", 1, True,
     [_REM_V, _REM_V, "-" + _REM_V, "-" + _REM_V],
     ["-" + _REM_D, _REM_D, "-" + _REM_D, _REM_D]),
    ("remainder2", "remainder", 2, True,
     ["-80968577325845461854951721352418610.13",
      "-80968577325845461854951721352418610.13",
      "-66686472768705331734321352506496901.71"],
     ["6749200345857154099505910298895800952.1",
      "-6749200345857154099505910298895800952.1",
      "-43880265997097383351377368851255372.5"]),
    ("remainder7", "remainder", 7, True,
     ["5776949384953805890688943467625198736"],
     ["-67337920196996830.354487679299"]),
    ("remainder10", "remainder", 10, True,
     ["5776949384953805890688943467625198736"],
     ["-6733792019699683035.4487679299"]),
    ("add_overflow_scale_neg10", "add", 10, True, _A1[:2],
     ["9447850332473678680446404122.5624623187",
      "-9447850332473678680446404122.5624623187"]),
    ("add_precision38_full", "add", 9, True,
     _A1 + ["-3008128675386495592846447084.0906874636"],
     ["9447850332473678680446404122.5624623187",
      "-9447850332473678680446404122.5624623187",
      "-1258508260891400005608241690.1564700995", "0E-10",
      "4506903505351346531188531230.8104179784",
      "8289592062844478064245294937.3714242072",
      "475827447078875704758652459.0564660621",
      "960510811873374359477931158.7077642783",
      "7213672086663445017824298126.4525607205",
      "2346189245818456940830953479.5847958897",
      "449885491907950809374133839.5150485453"]),
    ("add_different_scales", "add", 9, True, _A1, _B1),
    ("add_precision38_scale_minus5_null", "add", -5, True,
     ["4.2701861951571908374098848594277520E+39",
      "-9.51477182371612065851896242097995638E+40",
      "-2.0167866914929483784509827485383359E+39",
      "3.09186385410128070998385426348594484E+40",
      "7.1672663199631946247197119155144713E+39",
      "-9.32396355260007858810554960112006290E+40",
      "8.24190234828859904475261796305602287E+40",
      "6.10646349654220618869425418121505315E+40",
      "-5.4790787707639406411507823776332565E+39", None],
     ["-7.4015414116488076297669800353634627E+39",
      "8.26223612055178995785348949126553327E+40",
      "3.27796298399180383738215644697505864E+40",
      "6.23318861108302118457923491160201752E+40",
      "1.2868445730284429449720988121912717E+39",
      "-9.89573762074541324330058371364880604E+40",
      "1.83583924726137822744760302018523424E+40",
      "5.39262612260712860406222466457256229E+40",
      "-1.0688816822936864401341690563696501E+39",
      "-1.0688816822936864401341690563696501E+39"]),
    ("add_overflow_scale0", "add", 0, True,
     ["99999999999999999999999999999999999999"], ["1"]),
    ("sub_overflow_scale0", "sub", 0, True,
     ["-99999999999999999999999999999999999999"], ["1"]),
    ("sub_different_scales", "sub", 9, True, _A1, _B1),
    ("sub_simple", "sub", 2, True, ["5.00", "1.23"], ["1.50", "0.03"]),
]


@pytest.mark.parametrize("name,op,scale,cast,a,b", VECTORS,
                         ids=[v[0] for v in VECTORS])
def test_reference_vectors_match_jax(name, op, scale, cast, a, b):
    # each side's scale from its non-padding values, as the JAX tests
    ja = _jcol(a, _scale(a))
    jb = _jcol(b, _scale(b))
    _run_both(op, ja, jb, scale, cast)


def test_expected_values_of_the_reference():
    """A few of the reference's expected values, read from the port."""
    pt = _run_both("multiply", _jcol(VECTORS[3][4]), _jcol(VECTORS[3][5]),
                   6)
    assert pt[1].to_pylist()[2:5] == [
        Decimal("-40300528065877158141419371877.580354"),
        Decimal("-85932261422232121885321650559.128933"),
        Decimal("-110083130231976019291714061058.575920")]
    assert pt[0].to_pylist()[:2] == [False, True]
    pt = _run_both("integer_divide", _jcol(VECTORS[14][4]),
                   _jcol(VECTORS[14][5]), 0)
    assert pt[1].dtype.id is pdt.TypeId.INT64
    assert pt[1].to_pylist()[:2] == [2284624887606872042,
                                     -2928582767902049472]
    pt = _run_both("remainder", _jcol(VECTORS[18][4]),
                   _jcol(VECTORS[18][5]), 7)
    assert pt[1].to_pylist()[0] == Decimal("16310460742282291.8108019")


# ---------------------------------------------------------------------------
# seeded fuzz, one column per op
# ---------------------------------------------------------------------------

FUZZ = [("add", (10, 2, 9), True), ("sub", (3, -4, 0), True),
        ("multiply", (10, 10, 6), True), ("multiply", (2, 5, 3), False),
        ("divide", (4, 8, 6), True), ("integer_divide", (2, 0, 0), True),
        ("remainder", (3, 1, 2), True)]


@pytest.mark.parametrize("op,scales,cast", FUZZ,
                         ids=[f"{op}{'' if c else '_no_cast'}"
                              for op, _, c in FUZZ])
def test_fuzz_matches_jax(op, scales, cast):
    rng = np.random.default_rng(hash(op) % 1000 + scales[0])
    a = datagen.decimal128_draws(ROWS, rng)
    b = datagen.decimal128_draws(ROWS, rng, 20)
    b[5] = 0
    valid_a = rng.random(ROWS) > 0.1

    def jcol(vals, scale, valid=None):
        from spark_rapids_jni_tpu.columnar.column import int128_to_limbs
        limbs = np.stack([int128_to_limbs(v) for v in vals])
        return JColumn(jdt.decimal128(scale), ROWS, data=jnp.asarray(limbs),
                       validity=None if valid is None
                       else jnp.asarray(valid))

    _run_both(op, jcol(a, scales[0], valid_a), jcol(b, scales[1]),
              scales[2], cast)


def test_literal_operand_equals_its_column():
    """A stride-0 literal (Spark's 1.00 in 1 - l_discount) gives what the
    same value as a full column gives."""
    disc = datagen.decimal128_column(list(range(11)) * 4, 2, device="cpu")
    lit = decimal128_literal("1.00", 2, disc.size, "cpu")
    full = Column(lit.dtype, lit.size, data=lit.data.contiguous())
    for op in ("sub", "multiply"):
        fn = getattr(pd128, f"{op}_decimal128")
        a, b = fn(lit, disc, 2), fn(full, disc, 2)
        assert torch.equal(a[1].data, b[1].data)
        assert torch.equal(a[0].data, b[0].data)


def test_errors_match_jax():
    c = Column.from_pylist([1], pdt.INT64, device="cpu")
    with pytest.raises(TypeError, match="DECIMAL128"):
        pd128.multiply_decimal128(c, c, 0)
    one = datagen.decimal128_column([1], 0, device="cpu")
    two = datagen.decimal128_column([1, 2], 0, device="cpu")
    with pytest.raises(ValueError, match="mismatched"):
        pd128.add_decimal128(one, two, 0)
    # a product 40 digits coarser than its operands: "divisor too big"
    ja = JColumn.from_pylist([Decimal(1)] * ROWS, jdt.decimal128(20))
    pa = datagen.decimal128_column([10 ** 20], 20, device="cpu")
    for fn, x in ((jd128.multiply_decimal128, ja),
                  (pd128.multiply_decimal128, pa)):
        with pytest.raises(ValueError, match="divisor too big"):
            fn(x, x, 0)
    # a power of ten past 10^76 that a row's value asks for (ROWS rows:
    # the JAX package's ops are compiled at that shape already)
    big = [10 ** 37] + [1] * (ROWS - 1)
    jbig = JColumn.from_pylist([Decimal(v).scaleb(10) for v in big],
                               jdt.decimal128(-10))
    pbig = datagen.decimal128_column(big, -10, device="cpu")
    for fn, x in ((jd128.multiply_decimal128, jbig),
                  (pd128.multiply_decimal128, pbig)):
        with pytest.raises(ValueError, match="pow10"):
            fn(x, x, 38)


# ---------------------------------------------------------------------------
# the division table: the plain version against the JAX package, and
# kernel H2's source built for the host (tests/h2_host.py) against the
# plain version
# ---------------------------------------------------------------------------

DIVISION = datagen.decimal128_division_cases(ROWS, 0, "cpu")
_DIV_IDS = [f"{i}-{op}-{a.dtype.scale}_{b.dtype.scale}_{s}"
            for i, (op, a, b, s, _) in enumerate(DIVISION)]


@pytest.fixture(scope="module")
def division_port():
    """The port's result of each division case, computed once (on the
    CPU, the plain version)."""
    return {}


def _division_port(cache, i):
    if i not in cache:
        op, a, b, scale, cast = DIVISION[i]
        fn = getattr(pd128, f"{op}_decimal128")
        kw = {"cast_interim_result": cast} if op == "multiply" else {}
        cache[i] = fn(a, b, **kw) if op == "integer_divide" else fn(
            a, b, scale, **kw)
    return cache[i]


def _jax_decimal(col):
    return JColumn(jdt.decimal128(col.dtype.scale), col.size,
                   data=jnp.asarray(col.data.numpy().view(np.uint32)),
                   validity=jnp.asarray(col.valid_mask().numpy()))


@pytest.mark.parametrize("i", range(len(DIVISION)), ids=_DIV_IDS)
def test_division_table_matches_jax(i, division_port):
    op, a, b, scale, cast = DIVISION[i]
    kw = {"cast_interim_result": cast} if op == "multiply" else {}
    fn = getattr(jd128, f"{op}_decimal128")
    ja, jb = _jax_decimal(a), _jax_decimal(b)
    jt = fn(ja, jb, **kw) if op == "integer_divide" else fn(ja, jb, scale,
                                                            **kw)
    pt = _division_port(division_port, i)
    assert_col_equal(jt[0], pt[0], f"{op} overflow", presence=False)
    assert_col_equal(jt[1], pt[1], f"{op} result", presence=False)


@pytest.mark.parametrize("i", range(len(DIVISION)), ids=_DIV_IDS)
def test_h2_host_build_matches_plain_on_division_table(i, division_port):
    """H2's per-row arithmetic, built for the host, equals the plain
    version bit for bit on each case."""
    op, a, b, scale, cast = DIVISION[i]
    pt = _division_port(division_port, i)
    over, res, err = h2_host.op(op, a.data, b.data, -a.dtype.scale,
                                -b.dtype.scale, -scale, cast)
    assert not err
    assert torch.equal(over.to(torch.uint8), pt[0].data), op
    assert torch.equal(res, pt[1].data), op


def test_h2_host_build_reaches_every_division_branch(division_port):
    """The division table takes every branch of H2's long division (by
    the host build's counts): zero divisors, the hardware's short path,
    n shorter than d, both corrections of the 2-by-1 and 3-by-2 steps,
    Algorithm D's digit of 2^64 - 1 and its add-back, the three
    adjustments of the 3-by-2 reciprocal, the powers of ten, and every
    pair of word counts of n (0-4) and d (1-4); and never the bit-serial
    loop, which no entry point reaches."""
    h2_host.take_counts()
    for op, a, b, scale, cast in DIVISION:
        h2_host.op(op, a.data, b.data, -a.dtype.scale, -b.dtype.scale,
                   -scale, cast)
    branches, pairs = h2_host.take_counts()
    assert branches.pop("bit_serial") == 0
    assert all(c > 0 for c in branches.values()), branches
    assert sorted(pairs) == [(n, d) for n in range(5)
                             for d in range(1, 5)], pairs


def test_h2_host_divmod_matches_python_and_bit_serial():
    """divmod_u equals the plain bit-serial loop for every divisor (its
    wrap past 2^255 included, which no entry point reaches), and Python's
    divmod for every divisor below 2^128."""
    rng = np.random.default_rng(11)
    n_vals, d_vals = [], []
    for i in range(512):
        db = int(rng.integers(1, 257))
        d = (int.from_bytes(rng.bytes(32), "little") % (1 << db)) | (
            1 << (db - 1))
        q = int.from_bytes(rng.bytes(32), "little") % (1 << max(
            1, 256 - db))
        n = [d * q % M256, (d * q + d - 1) % M256,
             int.from_bytes(rng.bytes(32), "little") >> int(
                 rng.integers(0, 256))][i % 3]
        n_vals.append(n)
        d_vals.append(d)
    d_vals[:4] = [0, 1 << 255, M256 - 1, (1 << 128) + 1]
    q, r = h2_host.divmod(n_vals, d_vals)
    want_q, want_r = pi256.divmod_unsigned(
        torch.from_numpy(_lanes(n_vals, 8)), torch.from_numpy(
            _lanes(d_vals, 8)))
    assert [v % M256 for v in pi256.to_int_py(want_q)] == q
    assert [v % M256 for v in pi256.to_int_py(want_r)] == r
    for n, d, gq, gr in zip(n_vals, d_vals, q, r):
        if 0 < d < 1 << 128:
            assert (gq, gr) == divmod(n, d)


def test_h2_reciprocals_and_pow10_table():
    """The 2-by-1 and 3-by-2 reciprocals equal their definitions on random
    and edge divisors, and the source's table of powers of ten and of
    their reciprocals and shifts equals the values computed here."""
    import re
    B = 1 << 64
    rng = np.random.default_rng(12)
    pairs = [(B - 1, B - 1), (1 << 63, 0), (1 << 63, B - 1),
             ((1 << 63) + 1, 1), (B - 1, 0)] + [
        (int(rng.integers(0, 1 << 63, dtype=np.uint64)) | (1 << 63),
         int(rng.integers(0, 1 << 63, dtype=np.uint64)) * 2 + i % 2)
        for i in range(2000)]
    v2, v3 = h2_host.reciprocals(pairs)
    assert v2 == [(B * B - 1) // d1 - B for d1, _ in pairs]
    assert v3 == [(B ** 3 - 1) // (d1 * B + d0) - B for d1, d0 in pairs]
    src = h2_host.SOURCE.read_text()
    body = src[src.index("kPow10[77][4] = {"):]
    words = re.findall(r"0x([0-9a-f]{16})ull", body[:body.index("};")])
    assert [sum(int(w, 16) << (64 * k) for k, w in enumerate(
        words[4 * e:4 * e + 4])) for e in range(77)] == [
        10 ** e for e in range(77)]
    body = src[src.index("kPow10Inv[77] = {"):]
    rows = re.findall(r"\{0x([0-9a-f]{16})ull,\s*(\d+)\}",
                      body[:body.index("};")])
    assert len(rows) == 77
    for e, (v, s) in enumerate(rows):
        p = 10 ** e
        nwords = (p.bit_length() + 63) // 64
        assert int(s) == 64 * nwords - p.bit_length(), e
        top = p << int(s) >> (64 * (nwords - 2)) if nwords > 1 else (
            p << int(s)) * B
        assert int(v, 16) == (B ** 3 - 1) // top - B if nwords > 1 else \
            int(v, 16) == (B * B - 1) // (p << int(s)) - B, e
