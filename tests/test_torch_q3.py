"""Port parity: the slice as a whole — TPC-H q3's eager stage
(spark_rapids_jni_tpu_torch.tpch) against the JAX package's
benchmarks/tpch.py, with the shuffle write and read in front of it."""

import pytest

from benchmarks import tpch as jtpch
from spark_rapids_jni_tpu_torch import tpch
from spark_rapids_jni_tpu_torch.ops.row_conversion import (convert_from_rows,
                                                           convert_to_rows)
from spark_rapids_jni_tpu_torch.parallel.exchange import partition_ids

from torch_parity import assert_table_equal
from torch_parity import table_to_port

ROWS = 4096


@pytest.fixture(scope="module")
def jax_q3():
    """The JAX package's tables and its eager q3 through the accelerator
    branch of _plan_ops (masks pushed into the joins), as the port runs."""
    tables = jtpch.generate_q3_tables(ROWS, 0)
    saved = jtpch._backend
    jtpch._backend = lambda: "gpu"
    try:
        top = jtpch.run_q3(*tables, engine="eager")
    finally:
        jtpch._backend = saved
    return tables, top


def test_generate_q3_tables_same_data_as_jax(jax_q3):
    tables, _ = jax_q3
    mine = tpch.generate_q3_tables(ROWS, 0, device="cpu")
    for jt, pt in zip(tables, mine):
        assert_table_equal(jt, pt)
    assert [t.num_rows for t in mine] == [ROWS // 40, ROWS // 4, ROWS]


def test_run_q3_eager_matches_jax(jax_q3):
    tables, want = jax_q3
    got = tpch.run_q3(*(table_to_port(t) for t in tables))
    assert got.num_rows == 10
    assert_table_equal(want, got)


def test_shuffle_round_trip_then_q3(jax_q3):
    """Shuffle write (partition route + JCUDF rows), shuffle read, then q3
    on the read-back lineitem: bit-identical to q3 on the original."""
    tables, want = jax_q3
    cust, orders, lineitem = (table_to_port(t) for t in tables)
    pids = partition_ids(lineitem, [0], 200)
    assert pids.shape == (ROWS,) and int(pids.max()) < 200
    rows = convert_to_rows(lineitem)
    assert len(rows) == 1 and rows[0].children[0].size == 32 * ROWS
    back = convert_from_rows(rows[0], [c.dtype for c in lineitem])
    assert_table_equal(tables[2], back)
    assert_table_equal(want, tpch.run_q3(cust, orders, back))
