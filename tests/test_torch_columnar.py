"""Port parity: the column model, the wire-format interop and table ops
(spark_rapids_jni_tpu_torch.columnar) against the JAX package, plus the
port's import and device rules."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import bridge
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.columnar import table_ops as jops
from spark_rapids_jni_tpu.columnar.column import Column as JColumn
from spark_rapids_jni_tpu.columnar.column import Table as JTable
from spark_rapids_jni_tpu_torch.columnar import dtype as dt
from spark_rapids_jni_tpu_torch.columnar import interop
from spark_rapids_jni_tpu_torch.columnar import table_ops as pops
from spark_rapids_jni_tpu_torch.columnar.column import Column

from torch_parity import assert_col_equal, assert_table_equal
from torch_parity import table_to_port, to_port

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "spark_rapids_jni_tpu_torch"

# (JAX dtype, numpy values generator) for every type the port stores
_TYPES = {
    "bool8": (jdt.BOOL8, lambda r, n: r.integers(0, 3, n).astype(np.uint8)),
    "int8": (jdt.INT8, lambda r, n: r.integers(-128, 128, n).astype(np.int8)),
    "int16": (jdt.INT16, lambda r, n: r.integers(-2**15, 2**15, n)
              .astype(np.int16)),
    "int32": (jdt.INT32, lambda r, n: r.integers(-2**31, 2**31, n)
              .astype(np.int32)),
    "int64": (jdt.INT64, lambda r, n: r.integers(-2**63, 2**63 - 1, n)),
    "uint8": (jdt.UINT8, lambda r, n: r.integers(0, 256, n).astype(np.uint8)),
    "uint16": (jdt.UINT16, lambda r, n: r.integers(0, 2**16, n)
               .astype(np.uint16)),
    "uint32": (jdt.UINT32, lambda r, n: r.integers(0, 2**32, n)
               .astype(np.uint32)),
    "uint64": (jdt.UINT64, lambda r, n: r.integers(0, 2**64, n,
                                                   dtype=np.uint64)),
    "float32": (jdt.FLOAT32, lambda r, n: np.concatenate(
        [[np.nan, -0.0, np.inf], r.standard_normal(n - 3)]).astype(np.float32)),
    "float64": (jdt.FLOAT64, lambda r, n: np.concatenate(
        [[np.nan, -0.0, -np.inf], r.standard_normal(n - 3)])),
    "timestamp_days": (jdt.TIMESTAMP_DAYS, lambda r, n: r.integers(
        -10**6, 10**6, n).astype(np.int32)),
    "timestamp_us": (jdt.TIMESTAMP_MICROSECONDS, lambda r, n: r.integers(
        -2**62, 2**62, n)),
    "decimal64": (jdt.decimal64(3), lambda r, n: r.integers(-10**17, 10**17,
                                                           n)),
}


def _jcol(name, n=97, seed=0, nulls=True):
    jd, gen = _TYPES[name]
    r = np.random.default_rng(seed)
    v = r.random(n) > 0.3 if nulls else None
    return JColumn.from_numpy(gen(r, n), jd, validity=v)


@pytest.mark.parametrize("name", sorted(_TYPES))
def test_wire_round_trip_is_bit_exact(name):
    """JAX column -> wire -> port column -> wire gives the same tuple, and
    the port column holds the same values and validity."""
    jc = _jcol(name)
    w = bridge.col_to_wire(jc)
    pc = interop.wire_to_col(w, "cpu")
    assert interop.col_to_wire(pc) == w
    assert_col_equal(jc, pc, name)
    jl, pl = jc.to_pylist(), pc.to_pylist()
    assert [x is None for x in jl] == [x is None for x in pl]
    back = bridge.wire_to_col(interop.col_to_wire(pc))
    assert np.asarray(back.data).tobytes() == np.asarray(jc.data).tobytes()


def test_float64_storage_keeps_nan_payload_bits():
    bits = np.array([0x7FF8000000000001, 0xFFF0000000000001, 0x8000000000000000],
                    dtype=np.uint64)
    w = ("float64", 3, bits.tobytes(), None, None)
    pc = interop.wire_to_col(w, "cpu")
    assert pc.data.dtype == torch.float64
    assert interop.col_to_wire(pc)[2] == bits.tobytes()


def test_unported_types_raise_with_queue_item():
    jc = JColumn.from_pylist(["a", None], jdt.STRING)
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        interop.wire_to_col(bridge.col_to_wire(jc), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        dt.DType(dt.TypeId.DECIMAL128, 2).itemsize


def test_device_nbytes_and_valid_mask():
    jc = _jcol("int64")
    pc = to_port(jc)
    assert pc.device_nbytes() == jc.device_nbytes()
    assert pc.valid_mask().dtype == torch.bool
    nn = to_port(_jcol("int32", nulls=False))
    assert nn.validity is None and bool(nn.valid_mask().all())


def test_constructors_default_to_the_card():
    """Entry points put their tensors on the card unless asked for the CPU;
    with no card they raise instead of carrying on on the CPU."""
    arr = np.arange(5, dtype=np.int64)
    if torch.cuda.is_available():
        assert Column.from_numpy(arr).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Column.from_numpy(arr)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            interop.wire_to_col(("int64", 5, arr.tobytes(), None, None))
    assert Column.from_numpy(arr, device="cpu").device.type == "cpu"


def _mixed(n=61, seed=3):
    names = ("int32", "int64", "float64", "bool8", "int16")
    return JTable(tuple(_jcol(nm, n, seed + i, nulls=i % 2 == 0)
                        for i, nm in enumerate(names)))


@pytest.mark.parametrize("oob_null", [False, True])
def test_gather_table_matches(oob_null):
    jt = _mixed()
    pt = table_to_port(jt)
    idx = np.random.default_rng(1).integers(0, jt.num_rows, 40)
    if oob_null:
        idx[[3, 7]] = [-1, jt.num_rows]
    assert_table_equal(jops.gather_table(jt, idx, oob_null),
                       pops.gather_table(pt, torch.from_numpy(idx),
                                         oob_null))


def test_slice_and_filter_match():
    jt = _mixed()
    pt = table_to_port(jt)
    assert_table_equal(jops.slice_table(jt, 5, 33),
                       pops.slice_table(pt, 5, 33))
    mask = np.random.default_rng(2).random(jt.num_rows) > 0.5
    assert_table_equal(jops.filter_table(jt, mask),
                       pops.filter_table(pt, torch.from_numpy(mask)))
    got = pops.mask_indices_core(torch.from_numpy(mask), int(mask.sum()))
    want = np.asarray(jops.mask_indices_core(mask, int(mask.sum())))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        pops.filter_table(pt, torch.ones(3, dtype=torch.bool))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted(PACKAGE.rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "test_torch_gpu.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "spark_rapids_jni_tpu"), \
                f"{f.relative_to(REPO)} imports {mod}"


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """chip_smoke.py, alone in a directory, exits non-zero and prints no
    result line where there is no CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
