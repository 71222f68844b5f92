"""The port's ``get_json_object`` (spark_rapids_jni_tpu_torch/ops/
get_json_object.py, get_json_device.py) against the JAX package's, bit for
bit: Spark's path parser; the result column (values, offsets, validity)
on both tiers, each package's tier forced by its ``get_json.tier``; the
device tier's masks (the grammar DFA's verdicts, the navigation's found,
certified and span, the canonical mask); the routes: uncertified rows
re-run alone on the host PDA, wildcards on the host PDA, depth past 30.

Inputs: the JAX tests' documents and paths (tests/test_get_json_device.py,
test_get_json_object.py), a seeded fuzz of documents, and seeded rows of
``datagen.weblog_docs``, one column of them all (the JAX device tier
compiles once per padded shape).
"""

import json
import random

import numpy as np
import pytest

from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar import strings as JS
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.ops import get_json_device as JGD
from spark_rapids_jni_tpu.ops import get_json_object as JG
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.columnar import strings as PS
from spark_rapids_jni_tpu_torch.columnar.column import Column
from spark_rapids_jni_tpu_torch.ops import get_json_device as PGD
from spark_rapids_jni_tpu_torch.ops import get_json_object as PG
from spark_rapids_jni_tpu_torch.utils import config as pconfig
from spark_rapids_jni_tpu_torch.utils import datagen
from spark_rapids_jni_tpu_torch.utils.backend import string_routes
from test_get_json_device import DOCS, PATHS
from test_get_json_object import BASIC, INDEX_WILDCARD
from torch_parity import (assert_col_equal, byte_rows,  # noqa: F401
                          one_torch_thread, to_port)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TIERS = {"device": "device", "host": "native"}
DEEP = '{"a":' + "[" * 34 + "1" + "]" * 34 + ',"b":{"c":2}}'
WEBLOG_PATHS = ["$.user.id", "$.event.items[0].sku", "$.ts", "$.tags[1]"]
CASE_PATHS = (PATHS + WEBLOG_PATHS
              + ["$.b", "$.b.c", "$['k.q']", "$.中", "$.a.x[1]", "$[2]"])


def _fuzz():
    r = random.Random(555)
    keys = ["a", "b", "key", "k.q", "中"]

    def rand_json(depth):
        roll = r.random()
        if depth <= 0 or roll < 0.35:
            return r.choice([None, True, False, r.randint(-10**12, 10**12),
                             r.random() * 10**r.randint(-6, 6),
                             "s" * r.randint(0, 4), "e\t\"p\\q", "é中", 0,
                             -0.5, [], {}])
        if roll < 0.7:
            return {r.choice(keys): rand_json(depth - 1)
                    for _ in range(r.randint(0, 3))}
        return [rand_json(depth - 1) for _ in range(r.randint(0, 3))]

    docs = []
    for _ in range(200):
        s = json.dumps(rand_json(3), ensure_ascii=r.random() < 0.5)
        if r.random() < 0.4:
            s = s.replace(",", " , ").replace(":", " :  ")
        if r.random() < 0.3 and s:
            i = r.randrange(len(s))
            s = s[:i] + r.choice(["", "}", "{", ",", '"', "x", "]", "[",
                                  ":", "\\"]) + s[i + 1:]
        docs.append(s)
    return docs


def _rows():
    golden = [c[0] for c in BASIC + INDEX_WILDCARD]
    seeded = datagen.weblog_docs(200, seed=5, device="cpu")[0]
    return DOCS + golden + _fuzz() + [DEEP] + byte_rows(seeded)


@pytest.fixture(scope="module")
def docs():
    """(JAX column, port column) of the same rows."""
    jc = JColumn.from_pylist(_rows(), jdt.STRING)
    return jc, to_port(jc)


@pytest.fixture(autouse=True)
def _clean():
    string_routes.reset()
    yield


def test_parse_path_matches():
    paths = CASE_PATHS + [c[1] for c in BASIC + INDEX_WILDCARD] + [
        "", "a", "$.", "$..a", "$[", "$[-1]", "$[x]", "$['a']['b']",
        "$['a]b']", "$.*", "$[*].a", "$.a[01]", "$[' x ']", "$.a b"]
    for p in paths:
        assert PG.parse_path(p) == JG.parse_path(p), p
        assert PG._encode_ops(PG.parse_path(p) or []) == JG._encode_ops(
            JG.parse_path(p) or [])


def test_validation_masks_match(docs):
    jc, pc = docs
    jm, jl = JS.padded_bytes(jc)
    pm, pl = PS.padded_bytes(pc)
    want = np.asarray(JGD._validate(jm, jl))
    got = PGD._validate(pm, pl).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[_rows().index(DEEP)]  # nested past the cap


@pytest.mark.parametrize("path", CASE_PATHS)
def test_tiers_match_jax(docs, path):
    """Both tiers' columns, and the device tier's masks: found and
    certified for every row, the span and the canonical verdict where
    found."""
    jc, pc = docs
    for tier in TIERS.values():
        with jconfig.override("get_json.tier", tier), \
                pconfig.override("get_json.tier", tier):
            assert_col_equal(JG.get_json_object(jc, path),
                             PG.get_json_object(pc, path), f"{path} {tier}")
    steps = PGD.supported_steps(PG.parse_path(path))
    assert steps == JGD.supported_steps(JG.parse_path(path))
    jm, jl = JS.padded_bytes(jc)
    pm, pl = PS.padded_bytes(pc)
    jf, jcert, js, je, jtok = JGD._navigate(jm, jl, steps)
    pf, pcert, ps, pe, ptok = PGD._navigate(pm, pl, steps)
    found = np.asarray(jf)
    np.testing.assert_array_equal(pf.numpy(), found)
    np.testing.assert_array_equal(pcert.numpy(), np.asarray(jcert))
    np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(ps.numpy()[found], np.asarray(js)[found])
    np.testing.assert_array_equal(pe.numpy()[found], np.asarray(je)[found])
    jcan = np.asarray(JGD._span_is_canonical(jm, jl, js, je, jtok))
    pcan = PGD._span_is_canonical(pm, pl, ps, pe, ptok).numpy()
    np.testing.assert_array_equal(pcan[found], jcan[found])


def test_uncertified_rows_rerun_alone(monkeypatch):
    """An invalid document (and only it) re-runs its whole document on
    the host PDA: one finishing call over the spans, one over the row."""
    rows = ['{"a": %d}' % i for i in range(50)] + ['{"a": \\bad}']
    pc = Column.from_pylist(rows, pdt.STRING, device="cpu")
    calls = []
    real = PG.get_json_object_with_instructions
    monkeypatch.setattr(PG, "get_json_object_with_instructions",
                        lambda c, ops: calls.append(c.size) or real(c, ops))
    got = PGD.get_json_object_device(pc, PG.parse_path("$.a"))
    assert got.to_pylist() == [str(i) for i in range(50)] + [None]
    assert sorted(calls) == [1, 51]
    assert string_routes.snapshot()["get_json_host_uncertified"] == 1


def test_escape_in_a_candidate_key_uncertifies(docs):
    """A backslash inside a candidate key's bytes: the row takes the host
    PDA, with the JAX package's certification mask."""
    rows = ['{"a\\nb":1,"ab":2}', '{"x":"\\n","ab":3}', '{"ab":4}']
    jc = JColumn.from_pylist(rows, jdt.STRING)
    pc = to_port(jc)
    steps = PGD.supported_steps(PG.parse_path("$.ab"))
    pcert = PGD._navigate(*PS.padded_bytes(pc), steps)[1].numpy()
    jcert = np.asarray(JGD._navigate(*JS.padded_bytes(jc), steps)[1])
    np.testing.assert_array_equal(pcert, jcert)
    assert pcert.tolist() == [False, False, True]
    assert_col_equal(JGD.get_json_object_device(jc, JG.parse_path("$.ab")),
                     PGD.get_json_object_device(pc, PG.parse_path("$.ab")))


def test_wildcard_paths_take_the_host_tier(docs):
    jc, pc = docs
    for path in ("$.a[*]", "$.*", "$.event.items[*].sku", "$[*].a"):
        assert PGD.supported_steps(PG.parse_path(path)) is None
        with jconfig.override("get_json.tier", "device"), \
                pconfig.override("get_json.tier", "device"):
            assert_col_equal(JG.get_json_object(jc, path),
                             PG.get_json_object(pc, path), path)
    assert string_routes.snapshot()["get_json_host_path"] == 4 * pc.size
    assert string_routes.snapshot()["get_json_device"] == 0


def test_depth_past_the_cap_takes_the_host_tier(docs):
    """A document nested past _DEPTH_CAP fails the DFA, so its row is
    uncertified and the host PDA (64 levels) answers it."""
    jc, pc = docs
    i = _rows().index(DEEP)
    with pconfig.override("get_json.tier", "device"):
        got = PG.get_json_object(pc, "$.b.c").to_pylist()[i]
        assert PG.get_json_object(pc, "$.a[0][0]").to_pylist()[i] == \
            "[" * 32 + "1" + "]" * 32
    assert got == "2"
    assert string_routes.snapshot()["get_json_host_uncertified"] >= 2


def test_bytes_that_are_not_utf8_stay_bytes():
    """ROADMAP C: where any row is uncertified, the JAX package's device
    tier rebuilds the whole column through Python strings, and a result
    that is not UTF-8 comes back with U+FFFD in place of its bytes; its
    host tier keeps them. The port's device tier keeps the bytes: it
    equals the JAX package's host tier on such a column."""
    rows = [b'{"a":"\xff","b":1}', '{"a": \\bad}', '{"a":"x"}']
    jc = JColumn.from_pylist(rows, jdt.STRING)
    pc = to_port(jc)
    for path in ("$", "$.a", "$.b"):
        ops = PG.parse_path(path)
        got = PGD.get_json_object_device(pc, ops)
        assert_col_equal(JG.get_json_object_with_instructions(
            jc, JG.parse_path(path)), got, path)
    assert byte_rows(got)[0] == b"1"
    assert byte_rows(PGD.get_json_object_device(
        pc, PG.parse_path("$")))[0] == b'{"a":"\xff","b":1}'
    jdev = JGD.get_json_object_device(jc, JG.parse_path("$"))
    assert "\ufffd" in jdev.to_pylist()[0]


def test_invalid_path_gives_an_all_null_column(docs):
    jc, pc = docs
    for path in ("", "$..a", "a.b", "$[-1]"):
        for tier in TIERS.values():
            with jconfig.override("get_json.tier", tier), \
                    pconfig.override("get_json.tier", tier):
                want = JG.get_json_object(jc, path)
                got = PG.get_json_object(pc, path)
            assert got.valid_mask().sum() == 0
            assert_col_equal(want, got, path)


def test_weblog_route_counts_follow_the_draw():
    """Over ``weblog_docs``' rows, the device tier's routes are the ones
    the draw fixes: the uncertified rows are the malformed and the deep
    ones; on ``$.ts`` the rows normalized on the host are the exponent
    ones, on the other paths none; the column equals the host tier's."""
    col, d = datagen.weblog_docs(600, seed=9, device="cpu")
    live = d["valid"]
    kind = np.asarray(datagen.DOC_KINDS)[d["kind"]]
    bad = int((live & np.isin(kind, ["malformed", "deep"])).sum())
    ts_exp = live & (kind == "exponent")
    with pconfig.override("get_json.tier", "device"):
        for path in WEBLOG_PATHS:
            string_routes.reset()
            got = PG.get_json_object(col, path)
            snap = string_routes.snapshot()
            assert snap["get_json_host_uncertified"] == bad, path
            present = got.valid_mask().numpy()
            want_norm = int((present & ts_exp).sum()) if path == "$.ts" \
                else 0
            assert snap["get_json_span_normalized"] == want_norm, path
            assert snap["get_json_canonical"] + want_norm == int(
                (present & ~np.isin(kind, ["malformed", "deep"])).sum())
            with pconfig.override("get_json.tier", "native"):
                host = PG.get_json_object(col, path)
            assert_col_equal(host, got, path)


def test_empty_column():
    e = Column.from_pylist([], pdt.STRING, device="cpu")
    with pconfig.override("get_json.tier", "device"):
        assert PG.get_json_object(e, "$.a").size == 0


def test_dfa_table_matches_jax_on_byte_soup_and_depth():
    """The DFA's transition table (built from the JAX package's step) gives
    the JAX package's verdicts on random bytes of the JSON alphabet and on
    documents nested around the cap of 30."""
    rng = np.random.default_rng(4)
    alphabet = np.frombuffer(b'{}[]",:0123456789-+.eEtrufalsn \\u\t', np.uint8)
    rows = [rng.choice(alphabet, int(rng.integers(0, 40))).tobytes()
            for _ in range(500)]
    rows += [b'{"a":' * d + b"1" + b"}" * d for d in range(27, 34)]
    rows += [b"[" * d + b"]" * d for d in range(28, 33)]
    rows += [b'{"k":"' + bytes([b]) + b'"}' for b in range(256)]
    jc = JColumn.from_pylist(rows, jdt.STRING)
    pc = to_port(jc)
    want = np.asarray(JGD._validate(*JS.padded_bytes(jc)))
    np.testing.assert_array_equal(PGD._validate(*PS.padded_bytes(pc)).numpy(),
                                  want)
    assert want[500 + 3] and not want[500 + 4]  # 30 deep passes, 31 fails
