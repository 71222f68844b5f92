"""The port's ``parse_url`` (spark_rapids_jni_tpu_torch/ops/parse_uri.py,
parse_uri_device.py) against the JAX package's, bit for bit: values,
offsets and validity (presence too) of PROTOCOL, HOST and QUERY on both
tiers, each package's tier forced by its ``parse_uri.tier``; the query
with a literal and a column key (the host tier on either); the sandboxed
native call against the in-process one; the route counts.

Inputs: the JAX tests' golden URLs (tests/test_parse_uri.py, java.net.URI
expectations) and fuzz fragments (tests/test_parse_uri_device.py), and
seeded rows of ``datagen.weblog_urls``, one column of them all (the JAX
device tier compiles once per padded shape).
"""

import random

import numpy as np
import pytest

from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.ops import parse_uri as JP
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.columnar.column import Column
from spark_rapids_jni_tpu_torch.faultinj import guard as pguard
from spark_rapids_jni_tpu_torch.faultinj import sandbox as psandbox
from spark_rapids_jni_tpu_torch.ops import parse_uri as PP
from spark_rapids_jni_tpu_torch.ops import parse_uri_device as PPD
from spark_rapids_jni_tpu_torch.utils import config as pconfig
from spark_rapids_jni_tpu_torch.utils import datagen
from spark_rapids_jni_tpu_torch.utils.backend import string_routes
from test_parse_uri import (CASES, IP4_CASES, IP6_CASES, QUERY_KEY_CASES,
                            UTF8_CASES)
from torch_parity import (assert_col_equal, byte_rows,  # noqa: F401
                          one_torch_thread, to_port)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TIERS = {"device": "device", "host": "native"}
PARTS = ("PROTOCOL", "HOST", "QUERY")
_J = {"PROTOCOL": JP.parse_uri_to_protocol, "HOST": JP.parse_uri_to_host,
      "QUERY": JP.parse_uri_to_query}
_P = {"PROTOCOL": PP.parse_uri_to_protocol, "HOST": PP.parse_uri_to_host,
      "QUERY": PP.parse_uri_to_query}
_ORACLE = {"PROTOCOL": PP.py_parse_uri_to_protocol,
           "HOST": PP.py_parse_uri_to_host,
           "QUERY": PP.py_parse_uri_to_query}
SEEDED = 300


def _fuzz():
    rng = random.Random(20260731)
    frags = ["http", "https", "://", ":", "/", "//", "?", "#", "@",
             "%41", "%zz", "%", "[", "]", "::", "a.b.com", "1.2.3.4",
             "256.1.1.1", "[::1]", "[2001:db8::1%eth0]", "host", "-bad-",
             "a_b", "q=1&r=2", "=v", "k=", "user:pw", ":8080", "path/p2",
             "é", " ", "\x7f", " ", "\\", "~", "e", "8", "%%",
             "%4", "0x1.2.3.4", "%e2%80%a8", "\u0080", "　",
             "f„⁈", "..", "a-.b", "1.2.3.4.5", "999",
             "[fe80::7:8%25en0]", "%C3%A9"]
    return ["".join(rng.choice(frags) for _ in range(rng.randint(0, 10)))
            for _ in range(400)]


def _rows():
    golden = [c[0] for c in CASES + UTF8_CASES + IP4_CASES + IP6_CASES]
    seeded = datagen.weblog_urls(SEEDED, seed=3, device="cpu")[0]
    return (golden + _fuzz() + [None, "", "https://u@h.com:1/p?k=v#f",
                                b"http://h.com/caf\xe9"]
            + byte_rows(seeded))


@pytest.fixture(scope="module")
def urls():
    """(JAX column, port column) of the same rows."""
    jc = JColumn.from_pylist(_rows(), jdt.STRING)
    return jc, to_port(jc)


@pytest.fixture(autouse=True)
def _clean():
    string_routes.reset()
    yield
    psandbox.shutdown_all()
    psandbox.reset_quarantine()
    pguard.metrics.reset()


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("part", PARTS)
def test_part_matches_jax(urls, part, tier):
    jc, pc = urls
    with jconfig.override("parse_uri.tier", TIERS[tier]), \
            pconfig.override("parse_uri.tier", TIERS[tier]):
        want = _J[part](jc)
        got = _P[part](pc)
    assert_col_equal(want, got, f"{part} {tier}")
    # both tiers give the oracle's strings
    assert got.to_pylist() == _ORACLE[part](pc).to_pylist()


def test_device_tier_equals_host_tier_bit_for_bit(urls):
    """The two tiers of the port over one column: characters, offsets and
    validity bits (presence differs: the host tier drops an all-valid
    mask, as the JAX package's does)."""
    _, pc = urls
    for part in PARTS:
        dev = PPD.parse_uri_device(pc, part)
        host = PP._native_parse(pc, PP._PARTS[part])
        assert_col_equal(host, dev, part, presence=False)


def test_parts_share_one_parse(urls, monkeypatch):
    """The span memo: the three parts of one column run the core once."""
    _, pc = urls
    fresh = Column(pc.dtype, pc.size, data=pc.data, validity=pc.validity,
                   offsets=pc.offsets)
    calls = []
    real = PPD._parse_core
    monkeypatch.setattr(PPD, "_parse_core",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(PPD, "CHUNK_ELEMENTS", 1 << 40)
    for part in PARTS:
        PPD.parse_uri_device(fresh, part)
    assert len(calls) == 1


def test_row_chunks_give_the_same_spans(urls, monkeypatch):
    """Row chunks of a few rows each give the whole column's result."""
    _, pc = urls
    want = PPD.parse_uri_device(pc, "HOST")
    monkeypatch.setattr(PPD, "CHUNK_ELEMENTS", 97 * 256)
    fresh = Column(pc.dtype, pc.size, data=pc.data, validity=pc.validity,
                   offsets=pc.offsets)
    assert_col_equal(want, PPD.parse_uri_device(fresh, "HOST"), "chunked")


@pytest.mark.parametrize("how", ["literal", "column"])
def test_query_with_key_matches_jax(how):
    rows = [c[0] for c in QUERY_KEY_CASES] + _fuzz()[:60] + [None]
    rng = random.Random(7)
    keys = [c[1] for c in QUERY_KEY_CASES] + [
        rng.choice(["q", "r", "k", "", None, "absent"]) for _ in rows[
            len(QUERY_KEY_CASES):]]
    jc, jk = (JColumn.from_pylist(v, jdt.STRING) for v in (rows, keys))
    pc, pk = to_port(jc), to_port(jk)
    if how == "literal":
        want = JP.parse_uri_to_query_with_literal(jc, "q")
        got = PP.parse_uri_to_query_with_literal(pc, "q")
        oracle = PP.py_parse_uri_to_query_with_literal(pc, "q")
    else:
        want = JP.parse_uri_to_query_with_column(jc, jk)
        got = PP.parse_uri_to_query_with_column(pc, pk)
        oracle = PP.py_parse_uri_to_query_with_column(pc, pk)
    assert_col_equal(want, got, how)
    assert got.to_pylist() == oracle.to_pylist()
    assert string_routes.snapshot()["parse_uri_host_key"] == len(rows)
    with pytest.raises(ValueError):
        PP.parse_uri_to_query_with_column(pc, to_port(JColumn.from_pylist(
            ["q"], jdt.STRING)))


def test_sandboxed_native_equals_in_process(urls):
    """The host tier in a sandbox worker (``sandbox.active("parse_uri")``)
    returns the in-process bytes; consecutive calls share one worker."""
    _, pc = urls
    with pconfig.override("parse_uri.tier", "native"):
        want = [PP.parse_uri_to_host(pc), PP.parse_uri_to_query(pc)]
        with pconfig.override("sandbox.enabled", True):
            got = [PP.parse_uri_to_host(pc)]
            pid = psandbox.get_worker().pid()
            got.append(PP.parse_uri_to_query(pc))
            assert psandbox.get_worker().pid() == pid
    assert pid is not None
    for w, g in zip(want, got):
        assert_col_equal(w, g, "sandboxed")
    assert pguard.metrics.snapshot()["crash_detected"] == 0


def test_auto_routes_a_cpu_column_to_the_host_tier(urls):
    """Under ``auto`` a CPU column takes the native tier, counted by
    config; a forced device tier counts its rows as device rows."""
    _, pc = urls
    assert pconfig.get("parse_uri.tier") == "auto"
    PP.parse_uri_to_host(pc)
    with pconfig.override("parse_uri.tier", "device"):
        PP.parse_uri_to_protocol(pc)
    snap = string_routes.snapshot()
    assert snap["parse_uri_host_by_config"] == pc.size
    assert snap["parse_uri_device"] == pc.size


def test_weblog_draw_fixes_the_null_counts():
    """Over ``weblog_urls``' rows the non-null count of each part is what
    the draw fixes: every valid row has a host; its scheme, query and
    utm_source where drawn; an invalid row has none."""
    col, d = datagen.weblog_urls(2_000, seed=11, device="cpu")
    ok = d["valid"] & (d["invalid"] < 0)
    with pconfig.override("parse_uri.tier", "device"):
        counts = {p: int(_P[p](col).valid_mask().sum()) for p in PARTS}
    utm = PP.parse_uri_to_query_with_literal(col, "utm_source")
    assert counts == {"PROTOCOL": int((ok & d["scheme"]).sum()),
                      "HOST": int(ok.sum()),
                      "QUERY": int((ok & d["query"]).sum())}
    assert int(utm.valid_mask().sum()) == int((ok & d["utm"]).sum())
    assert set(np.flatnonzero(d["invalid"] >= 0)) <= set(
        np.flatnonzero(~PP.parse_uri_to_host(col).valid_mask().numpy()))
    lens = np.diff(col.host_offsets())[d["valid"]]
    assert lens.min() >= 60 and lens.max() <= 200


def test_empty_column_and_wrong_type():
    e = Column.from_pylist([], pdt.STRING, device="cpu")
    out = PPD.parse_uri_device(e, "HOST")
    assert out.size == 0 and out.offsets.tolist() == [0]
    with pytest.raises(ValueError):
        PPD.parse_uri_device(e, "PATH")
    with pytest.raises(TypeError):
        PPD.parse_uri_device(Column.from_pylist([1], pdt.INT32,
                                                device="cpu"), "HOST")


def test_marks_find_the_first_and_last_mark_in_a_window():
    """``strings.Marks`` against a direct scan, windows past both ends
    and empty ones included."""
    from spark_rapids_jni_tpu_torch.columnar.strings import Marks
    rng = np.random.default_rng(8)
    import torch
    mask = torch.from_numpy(rng.random((300, 24)) < 0.2)
    lo = torch.from_numpy(rng.integers(-3, 27, 300).astype(np.int32))
    hi = torch.from_numpy(rng.integers(-3, 27, 300).astype(np.int32))
    m = Marks(mask)
    (f, ff), (la, lf) = m.first(lo, hi), m.last(lo, hi)
    for r in range(300):
        hits = [j for j in range(24) if mask[r, j] and lo[r] <= j < hi[r]]
        assert bool(ff[r]) == bool(hits) == bool(lf[r])
        assert int(f[r]) == (hits[0] if hits else int(hi[r]))
        assert int(la[r]) == (hits[-1] if hits else int(lo[r]) - 1)
