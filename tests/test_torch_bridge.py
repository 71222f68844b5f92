"""The port's engine bridge (``spark_rapids_jni_tpu_torch/bridge.py``)
against the JAX package's (``spark_rapids_jni_tpu/bridge.py``).

Every op the port runs goes through both packages' ``bridge.call`` with
the same wire columns, made with numpy from a seed (the shapes of
``tests/test_engine_bridge.py``), and the outputs must be equal byte for
byte: dtype strings, row counts, data, offsets and validity bytes, and
the meta JSON (the DECIMAL128 ops in ``test_torch_bridge_decimal.py``,
the decimal cast in ``test_torch_cast_decimal_wide.py``); all 31 ops
run. The LIST results of ``histogram.create``, ``histogram.percentile``,
``zorder.interleave`` and ``json.from_json_map`` cross decomposed, as the
JAX package decomposes them; the json ops on both tiers. A fault config that
names an op fires inside both packages' ``call``, with the same guard
metrics.
"""

import json

import numpy as np
import pytest

from spark_rapids_jni_tpu import bridge as JB
from spark_rapids_jni_tpu.faultinj import guard as JG
from spark_rapids_jni_tpu.faultinj import injector as JI
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch import bridge as PB
from spark_rapids_jni_tpu_torch.faultinj import guard as PG
from spark_rapids_jni_tpu_torch.faultinj import injector as PI
from spark_rapids_jni_tpu_torch.utils import config as pconfig
from torch_parity import one_torch_thread, quick_jax_reference  # noqa: F401

pytestmark = pytest.mark.usefixtures("quick_jax_reference",
                                     "one_torch_thread")

N = 48  # rows of every column: the JAX package compiles once per shape


def w_i64(vals, validity=None, name="int64"):
    a = np.asarray(vals, np.int64)
    v = None if validity is None else np.asarray(validity, np.uint8).tobytes()
    return (name, len(a), a.tobytes(), None, v)


def w_i32(vals, name="int32"):
    a = np.asarray(vals, np.int32)
    return (name, len(a), a.tobytes(), None, None)


def w_f64(vals, validity=None):
    a = np.asarray(vals, np.float64)
    v = None if validity is None else np.asarray(validity, np.uint8).tobytes()
    return ("float64", len(a), a.view(np.uint64).tobytes(), None, v)


def w_str(strs, validity=None):
    blobs = [s.encode() for s in strs]
    offs = np.zeros(len(strs) + 1, np.int64)
    offs[1:] = np.cumsum([len(b) for b in blobs])
    v = None if validity is None else np.asarray(validity, np.uint8).tobytes()
    return ("string", len(strs), b"".join(blobs), offs.tobytes(), v)


def w_dec128(unscaled, scale, validity=None):
    limbs = np.array([[(int(u) >> (32 * k)) & 0xFFFFFFFF for k in range(4)]
                      for u in unscaled], np.uint32)
    v = None if validity is None else np.asarray(validity, np.uint8).tobytes()
    return (f"decimal128:{scale}", len(unscaled), limbs.tobytes(), None, v)


def _inputs():
    rng = np.random.default_rng(13)
    valid = rng.random(N) > 0.15
    ints = rng.integers(-10 ** 6, 10 ** 6, N)
    keys = rng.integers(0, 1000, N)
    floats = rng.standard_normal(N) * 10.0 ** rng.integers(-5, 6, N)
    floats[:4] = [0.0, -0.0, np.inf, np.nan]
    words = ["42", "-7", " 12 ", "bogus", "1.5", "99999999999", "", "+3",
             "0x1F", "ff", "1e3", "-0.25"]
    strs = [words[i % len(words)] for i in range(N)]
    dec_a = rng.integers(-10 ** 12, 10 ** 12, N)
    dec_b = rng.integers(1, 10 ** 6, N) * rng.choice([-1, 1], N)
    days = rng.integers(-200_000, 50_000, N)
    micros = rng.integers(-10 ** 16, 2 * 10 ** 15, N)
    docs = ['{"a":%d,"b":{"c":"x%d"},"t":[1,2]}' % (i, i) for i in ints]
    docs[1:8] = ['{"a": 1.5e3, "b": {"c": "y"}}', '[1,2]', '{"a":"q\\"r"}',
                 '{"a":1', "", '{"b":{"c":[true,null]}}', '{"a":{"z":1}}']
    return dict(
        json=w_str(docs, valid),
        i64=w_i64(ints, valid), keys=w_i64(keys), i32=w_i32(ints // 7),
        f64=w_f64(floats, valid), str=w_str(strs, valid),
        dec_a=w_dec128(dec_a, 2, valid), dec_b=w_dec128(dec_b, 2),
        days=w_i32(days, "timestamp_days"),
        micros=w_i64(micros, name="timestamp_us"),
        h32=w_i32(rng.integers(0, 1 << 12, N)),
        h32b=w_i32(rng.integers(0, 1 << 12, N)))


IN = _inputs()
BLOOM = {"num_hashes": 3, "num_longs": 64}

# (op, args, input names): every op the port runs
CASES = [
    ("engine.echo", {}, ["i64", "str", "dec_a", "f64"]),
    ("hash.murmur3", {"seed": 42}, ["i64", "i32", "f64"]),
    ("hash.xxhash64", {}, ["i64", "i32", "f64"]),
    ("bloom.build", BLOOM, ["keys"]),
    ("cast.string_to_integer", {"type": "int32"}, ["str"]),
    ("cast.string_to_float", {"type": "float64"}, ["str"]),
    ("cast.string_to_integer_base", {"base": 16, "type": "int64"}, ["str"]),
    ("cast.integer_to_string_base", {"base": 16}, ["i32"]),
    ("cast.float_to_string", {}, ["f64"]),
    ("cast.format_number", {"digits": 2}, ["f64"]),
    ("cast.decimal_to_string", {}, ["dec_a"]),
    ("rowconv.to_rows", {}, ["i64", "i32", "f64"]),
    ("zorder.hilbert", {"num_bits": 12}, ["h32", "h32b"]),
    ("zorder.interleave", {}, ["h32", "h32b"]),
    ("histogram.create", {"as_lists": True}, ["f64", "keys"]),
    ("histogram.create", {"as_lists": False}, ["i64", "keys"]),
    ("datetime.rebase", {"direction": "gregorian_to_julian"}, ["days"]),
    ("tz.to_utc", {"zone": "Asia/Shanghai"}, ["micros"]),
    ("tz.from_utc", {"zone": "Asia/Shanghai"}, ["micros"]),
    ("json.get_json_object", {"path": "$.b.c"}, ["json"]),
    ("json.from_json_map", {}, ["json"]),
]
# the decimal ones: the JAX package compiles its decimal ops at first use
# (test_torch_bridge_decimal.py) and its decimal cast ~4 s per (precision,
# scale) (test_torch_cast_decimal_wide.py, under its one-jit fixture)
S2D_CASE = ("cast.string_to_decimal", {"precision": 12, "scale": -2},
            ["str"])
DECIMAL_CASES = [
    ("decimal.add", {"scale": 2}, ["dec_a", "dec_b"]),
    ("decimal.subtract", {"scale": 2}, ["dec_a", "dec_b"]),
    ("decimal.multiply", {"scale": 4}, ["dec_a", "dec_b"]),
    ("decimal.divide", {"scale": 4}, ["dec_a", "dec_b"]),
    ("decimal.integer_divide", {}, ["dec_a", "dec_b"]),
    ("decimal.remainder", {"scale": 2}, ["dec_a", "dec_b"]),
]
# ops whose inputs are another op's outputs (on the JAX side)
CHAINED = ["bloom.probe", "bloom.merge", "rowconv.from_rows",
           "histogram.percentile"]
# the ops that raised naming their ROADMAP item until it was ported
ONCE_UNPORTED = {"json.get_json_object": {"path": "$.a"},
                 "json.from_json_map": {}}


def both(op, args, wires):
    aj = json.dumps(args)
    j = JB.call(op, aj, wires)
    p = PB.call(op, aj, wires, device="cpu")
    return j, p


def assert_same(j, p):
    (jout, jmeta), (pout, pmeta) = j, p
    assert pmeta == jmeta
    assert len(pout) == len(jout)
    for k, (a, b) in enumerate(zip(jout, pout)):
        assert tuple(b) == tuple(a), f"output {k}: {b[0]} vs {a[0]}"


def test_ops_match():
    assert PB.ops() == JB.ops()
    assert len(PB.ops()) == 31
    ported = {c[0] for c in CASES + DECIMAL_CASES + [S2D_CASE]} | set(
        CHAINED)
    assert ported == set(JB.ops())
    assert len(ported) == 31


@pytest.mark.parametrize("op,args,names", CASES, ids=[c[0] for c in CASES])
def test_op_matches_wire_bytes(op, args, names):
    assert_same(*both(op, args, [IN[n] for n in names]))


def test_rebase_julian_to_gregorian_matches():
    assert_same(*both("datetime.rebase", {"direction": "julian_to_gregorian"},
                      [IN["days"]]))


def test_chained_ops_match():
    """bloom.probe and bloom.merge over filters built by bloom.build, and
    rowconv.from_rows over rowconv.to_rows' output."""
    (b1, _), _ = both("bloom.build", BLOOM, [IN["keys"]])
    (b2, _), _ = both("bloom.build", BLOOM, [IN["i64"]])
    merged = both("bloom.merge", {}, [b1[0], b2[0]])
    assert_same(*merged)
    assert_same(*both("bloom.probe", {}, [IN["keys"], merged[0][0][0]]))
    (rows, _), _ = both("rowconv.to_rows", {}, [IN["i64"], IN["i32"],
                                                IN["f64"]])
    assert_same(*both("rowconv.from_rows",
                      {"types": ["int64", "int32", "float64"]}, rows))


@pytest.mark.parametrize("as_list", [True, False])
def test_histogram_percentile_matches(as_list):
    """histogram.percentile over histogram.create's decomposed output,
    one list a row and one list of every row."""
    for as_lists in (True, False):
        (h, _), _ = both("histogram.create", {"as_lists": as_lists},
                         [IN["f64"], IN["keys"]])
        assert_same(*both("histogram.percentile",
                          {"percentages": [0.0, 0.3, 0.5, 1.0],
                           "as_list": as_list}, h[:3]))


def test_zorder_interleave_without_columns_matches():
    """interleaveBits(numRows): the row count rides the arguments."""
    assert_same(*both("zorder.interleave", {"num_rows": 5}, []))


@pytest.mark.parametrize("op", sorted(ONCE_UNPORTED))
def test_unported_ops_raise_naming_their_item(op):
    """No op raises any more: the json ops (ROADMAP A13) run, and give
    the JAX package's bytes, on its host tier and on its device tier."""
    args = json.dumps(ONCE_UNPORTED[op])
    for key in ("get_json.tier", "from_json.tier"):
        assert pconfig.get(key) == jconfig.get(key) == "auto"
    assert_same(JB.call(op, args, [IN["json"]]),
                PB.call(op, args, [IN["json"]], device="cpu"))
    with jconfig.override("get_json.tier", "device"), \
            jconfig.override("from_json.tier", "device"), \
            pconfig.override("get_json.tier", "device"), \
            pconfig.override("from_json.tier", "device"):
        assert_same(JB.call(op, args, [IN["json"]]),
                    PB.call(op, args, [IN["json"]], device="cpu"))


def test_unknown_op_raises():
    for B in (JB, PB):
        with pytest.raises(KeyError):
            B.call("nope.nothing", "{}", [])


def test_cast_ansi_error_matches():
    """An ANSI cast failure leaves both bridges as the same exception."""
    errs = []
    for call in (lambda a: JB.call("cast.string_to_integer", a,
                                   [IN["str"]]),
                 lambda a: PB.call("cast.string_to_integer", a, [IN["str"]],
                                   device="cpu")):
        with pytest.raises(Exception) as ei:
            call(json.dumps({"type": "int32", "ansi": True}))
        errs.append((type(ei.value).__name__, str(ei.value),
                     ei.value.row_number))
    assert errs[0] == errs[1]


def test_fault_config_naming_an_op_fires_in_call(tmp_path):
    """A transient fault at "hash.murmur3" fires inside each package's
    bridge.call, retries in place and returns the same bytes, with the
    same guard metrics."""
    cfg = tmp_path / "fault.json"
    cfg.write_text(json.dumps({"xlaRuntimeFaults": {"hash.murmur3": {
        "percent": 100, "injectionType": 2, "substituteReturnCode": 7,
        "interceptionCount": 2}}}))
    fast = {"faultinj.backoff_base_s": 0.0002, "faultinj.backoff_max_s":
            0.002}
    got = []
    for I, G, C, run in (
            (JI, JG, jconfig, lambda: JB.call("hash.murmur3", "{}",
                                              [IN["i64"]])),
            (PI, PG, pconfig, lambda: PB.call("hash.murmur3", "{}",
                                              [IN["i64"]], device="cpu"))):
        G.metrics.reset()
        I.install(str(cfg), seed=0)
        try:
            with C.override("faultinj.backoff_base_s",
                            fast["faultinj.backoff_base_s"]), \
                    C.override("faultinj.backoff_max_s",
                               fast["faultinj.backoff_max_s"]):
                out = run()
        finally:
            I.uninstall()
        snap = G.metrics.snapshot()
        snap.pop("backoff_time_ns")
        G.metrics.reset()
        got.append((out, snap))
    assert_same(got[0][0], got[1][0])
    assert got[1][1] == got[0][1]
    assert got[1][1]["transient_retries"] == 2
