"""The port's ``from_json`` raw map (spark_rapids_jni_tpu_torch/ops/
map_utils.py, from_json_device.py) against the JAX package's, bit for
bit: the LIST<STRUCT<key, value>> column (list offsets and validity, the
keys' and values' characters and offsets) on both tiers, each package's
tier forced by its ``from_json.tier``; escapes (the backslash route to
the host tier), nulls, non-object and invalid rows; and two repairs: a
row nested past the device DFA's cap (ROADMAP C4), and a row the DFA
rejects but the host PDA parses under Spark's tolerances (single quotes,
raw control characters in strings; ROADMAP C6). The JAX package's device
tier returns such rows as null and its host tier parses them; the port's
device tier sends them to the host tier.

Inputs: the JAX tests' documents (tests/test_from_json_device.py,
test_map_utils.py), its seeded fuzz, and seeded rows of
``datagen.weblog_docs``.
"""

import json
import random

import numpy as np
import pytest

from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.ops import from_json_device as JFD
from spark_rapids_jni_tpu.ops import map_utils as JM
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.columnar.column import Column
from spark_rapids_jni_tpu_torch.ops import from_json_device as PFD
from spark_rapids_jni_tpu_torch.ops import map_utils as PM
from spark_rapids_jni_tpu_torch.utils import config as pconfig
from spark_rapids_jni_tpu_torch.utils import datagen
from spark_rapids_jni_tpu_torch.utils.backend import string_routes
from test_from_json_device import EDGES, _rand_value
from torch_parity import (assert_col_equal, byte_rows,  # noqa: F401
                          one_torch_thread, to_port)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TIERS = {"device": "device", "host": "native"}
MAP_UTILS = [
    ('{"Zipcode" : 704 , "ZipCodeType" : "STANDARD" , '
     '"City" : "PARC PARQUE" , "State" : "PR"}'),
    ('{"category": "reference", "index": [4,{},null,{"a":[{ }, {}] } ], '
     '"author": "Nigel Rees", "title": "{}[], <=semantic-symbols-string", '
     '"price": 8.95}'),
    '{"Zipcóde" : 704 , "ZípCodeTypé" : "\U00029e3d" , "City" : "\U0001f3f3"}',
    '{"a\\nb": "x\\/y"}', '{"a": null, "b": {"c": [1, 2]}}', '{"a": true}',
]
DEEP = ['{"a":' + "[" * 34 + "1" + "]" * 34 + ',"b":2}',
        '{"a":' + "[" * 70 + "1" + "]" * 70 + "}",
        '{"s":"\\n","d":' + "{\"x\":" * 31 + "0" + "}" * 31 + "}"]


def _fuzz():
    rng = random.Random(3)
    docs = []
    for _ in range(150):
        r = rng.random()
        if r < 0.08:
            docs.append(None)
        elif r < 0.16:
            docs.append(rng.choice(
                ["[1]", "12", '"s"', "tru", "{", "", "{]", '{"a":}']))
        else:
            obj = {f"k{j}" + ("ß" if rng.random() < 0.1 else ""):
                   _rand_value(rng, 0, rng.random() < 0.5)
                   for j in range(rng.randrange(6))}
            sep = rng.choice([(",", ":"), (", ", " : "), (",\n", ":\t")])
            docs.append(json.dumps(obj, ensure_ascii=False, separators=sep))
    return docs


def _rows():
    seeded = datagen.weblog_docs(200, seed=7, device="cpu")[0]
    return EDGES + MAP_UTILS + _fuzz() + byte_rows(seeded)


@pytest.fixture(scope="module")
def docs():
    jc = JColumn.from_pylist(_rows(), jdt.STRING)
    return jc, to_port(jc)


@pytest.fixture(autouse=True)
def _clean():
    string_routes.reset()
    yield


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_tier_matches_jax(docs, tier):
    jc, pc = docs
    with jconfig.override("from_json.tier", TIERS[tier]), \
            pconfig.override("from_json.tier", TIERS[tier]):
        want = JM.extract_raw_map_from_json_string(jc)
        got = PM.extract_raw_map_from_json_string(pc)
    if tier == "device":
        # ROADMAP C6: the JAX device tier nulls the rows its host tier
        # parses under Spark's tolerances (a seeded weblog row here); the
        # port follows the JAX host tier, which equals the JAX device tier
        # on every other row
        host = JM._extract_raw_map_host(jc)
        w, h = want.to_pylist(), host.to_pylist()
        c6 = [i for i, (a, b) in enumerate(zip(w, h)) if a != b]
        assert c6 and all(w[i] is None for i in c6)
        want = host
    assert_col_equal(want, got, tier)


def test_device_tier_equals_host_tier(docs):
    _, pc = docs
    assert_col_equal(PM.extract_raw_map_host(pc),
                     PFD.extract_raw_map_device(pc), "tiers")


def test_backslash_rows_take_the_host_tier(docs):
    """Every valid object row with a backslash re-runs on the host tier;
    the others' pairs come from device spans."""
    jc, pc = docs
    PFD.extract_raw_map_device(pc)
    snap = string_routes.snapshot()
    rows = _rows()
    host = PM.extract_raw_map_host(pc).valid_mask().numpy()
    has_bs = np.array([r is not None and b"\\" in (
        r if isinstance(r, bytes) else r.encode()) for r in rows])
    assert snap["from_json_host_backslash"] == int((host & has_bs).sum())
    assert snap["from_json_device"] == pc.size
    assert snap["from_json_host_deep"] == 0


def test_rows_nested_past_the_cap_take_the_host_tier():
    """ROADMAP C: the JAX package's device tier returns a valid document
    nested 31-64 deep as a null row, its host tier returns its pairs. The
    port's device tier routes such a row to the host tier, so it equals
    the JAX package's host tier, here and on every other row."""
    rows = DEEP + ['{"x":1}', None, '{"y":[[2]]}']
    jc = JColumn.from_pylist(rows, jdt.STRING)
    pc = to_port(jc)
    got = PFD.extract_raw_map_device(pc)
    assert_col_equal(JM._extract_raw_map_host(jc), got, "deep")
    assert JFD.extract_raw_map_device(jc).to_pylist()[0] is None
    assert got.to_pylist()[0] == [("a", "[" * 34 + "1" + "]" * 34),
                                  ("b", "2")]
    assert got.to_pylist()[1] is None  # past the host PDA's 64 levels
    snap = string_routes.snapshot()
    assert snap["from_json_host_deep"] == 3
    assert snap["from_json_host_backslash"] == 0


C6_ROWS = ["{'a':1}", '{"a":\'x\'}', "{'a':'b','c':[1,'2']}",
           "  {'k' : 2 }  ", '{"a":"\tb"}']


def test_rows_the_dfa_rejects_take_the_host_tier():
    """ROADMAP C6: over its five rows (and beside a plain, a null and a
    malformed row) the port's device tier equals the JAX package's host
    tier, row for row, where the JAX device tier returns nulls; the DFA's
    rejects are counted, the malformed row among them and still null."""
    rows = C6_ROWS + ['{"x":1}', None, '{"y":']
    jc = JColumn.from_pylist(rows, jdt.STRING)
    pc = to_port(jc)
    got = PFD.extract_raw_map_device(pc)
    assert_col_equal(JM._extract_raw_map_host(jc), got, "c6")
    assert JFD.extract_raw_map_device(jc).to_pylist()[:5] == [None] * 5
    assert got.to_pylist()[:5] == [[("a", "1")], [("a", "x")],
                                   [("a", "b"), ("c", "[1,'2']")],
                                   [("k", "2")], [("a", "\tb")]]
    assert got.to_pylist()[7] is None
    snap = string_routes.snapshot()
    assert snap["from_json_host_rejected"] == 6
    assert snap["from_json_host_deep"] == 0
    assert snap["from_json_host_backslash"] == 0
    with pconfig.override("from_json.tier", "device"):
        assert_col_equal(got, PM.extract_raw_map_from_json_string(pc), "auto")


def test_row_chunks_give_the_same_map(docs, monkeypatch):
    _, pc = docs
    want = PFD.extract_raw_map_device(pc)
    monkeypatch.setattr(PFD, "CHUNK_ELEMENTS", 37 * 512)
    fresh = Column(pc.dtype, pc.size, data=pc.data, validity=pc.validity,
                   offsets=pc.offsets)
    assert_col_equal(want, PFD.extract_raw_map_device(fresh), "chunked")


def test_weblog_routes_follow_the_draw():
    """Over ``weblog_docs``' rows: the backslash route takes exactly the
    escaped rows, the deep route the deep ones, the rejected route the
    malformed, single-quoted and control-byte ones, and the map equals
    the host tier's."""
    col, d = datagen.weblog_docs(800, seed=13, device="cpu")
    kind = np.asarray(datagen.DOC_KINDS)[d["kind"]]
    live = d["valid"]
    with pconfig.override("from_json.tier", "device"):
        got = PM.extract_raw_map_from_json_string(col)
    snap = string_routes.snapshot()
    assert snap["from_json_host_backslash"] == int(
        (live & (kind == "escaped")).sum())
    assert snap["from_json_host_deep"] == int((live & (kind == "deep")).sum())
    tolerated = np.isin(kind, ["single_quoted", "control"])
    assert (live & tolerated).sum() > 0
    assert snap["from_json_host_rejected"] == int(
        (live & (tolerated | (kind == "malformed"))).sum())
    assert_col_equal(PM.extract_raw_map_host(col), got, "weblog")
    valid = got.valid_mask().numpy()
    np.testing.assert_array_equal(valid, live & (kind != "malformed"))


def test_all_null_and_empty_columns():
    for rows in ([], [None, None], ["[]", "1"]):
        jc = JColumn.from_pylist(rows, jdt.STRING)
        pc = to_port(jc)
        assert_col_equal(JFD.extract_raw_map_device(jc),
                         PFD.extract_raw_map_device(pc), repr(rows))
    with pytest.raises(TypeError):
        PFD.extract_raw_map_device(Column.from_pylist([1], pdt.INT32,
                                                      device="cpu"))


def test_host_tier_in_row_chunks_matches_jax(docs, monkeypatch):
    """The host tier calls the native PDA a chunk of rows at a time and
    joins the chunks: the same column as the JAX package's one call."""
    jc, pc = docs
    monkeypatch.setattr(PM, "HOST_CHUNK_ROWS", 37)
    assert_col_equal(JM._extract_raw_map_host(jc),
                     PM.extract_raw_map_host(pc), "chunks")
