"""TPC-H q3's join-aggregate stage, eager (the JAX package's
benchmarks/tpch.py: ``generate_q3_tables`` and the eager branch of
``run_q3``).

The query: filter customer by market segment and orders/lineitem by date,
join orders to customer and lineitem to orders, sum revenue per
(orderkey, orderdate, shippriority), sort by revenue descending and
orderdate ascending, take the top 10. Money is int64 cents.

Filters ride the joins as pushed-down masks (the accelerator branch of the
JAX package's ``_plan_ops``), so the gather maps index the original
tables. The eager path reaches kernel B2 through every join's row hash.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .columnar import dtype as dt
from .columnar.column import Column, Table, resolve_device
from .columnar.table_ops import gather_table, slice_table
from .ops.groupby import groupby_aggregate
from .ops.join import inner_join
from .ops.sort import sort_table

CUTOFF_DAYS = 1200  # "1995-03-15" as days into the generated date range


def q3_arrays(rows: int, seed: int) -> Dict[str, np.ndarray]:
    """The q3 columns as numpy arrays at ``rows`` lineitem rows, with TPC-H's
    row ratios (orders = rows/4, customer = rows/40). The same generator
    calls, in the same order, as the JAX package's generate_q3_tables, so
    one seed gives the same data in both packages."""
    ncust = max(rows // 40, 16)
    nord = max(rows // 4, 16)
    rng = np.random.default_rng(seed)
    a = {}
    a["c_custkey"] = np.arange(ncust, dtype=np.int64)
    a["c_mktsegment"] = rng.integers(0, 5, ncust).astype(np.int32)
    a["o_orderkey"] = np.arange(nord, dtype=np.int64)
    a["o_custkey"] = rng.integers(0, ncust, nord)
    a["o_orderdate"] = rng.integers(0, 2400, nord).astype(np.int32)
    a["o_shippriority"] = rng.integers(0, 3, nord).astype(np.int32)
    a["l_orderkey"] = rng.integers(0, nord, rows)
    a["l_shipdate"] = rng.integers(0, 2400, rows).astype(np.int32)
    a["l_extendedprice"] = rng.integers(90000, 10500000, rows)
    a["l_discount"] = rng.integers(0, 11, rows).astype(np.int32)
    return a


_SCHEMA = {
    "customer": (("c_custkey", dt.INT64), ("c_mktsegment", dt.INT32)),
    "orders": (("o_orderkey", dt.INT64), ("o_custkey", dt.INT64),
               ("o_orderdate", dt.INT32), ("o_shippriority", dt.INT32)),
    "lineitem": (("l_orderkey", dt.INT64), ("l_shipdate", dt.INT32),
                 ("l_extendedprice", dt.INT64), ("l_discount", dt.INT32)),
}


def generate_q3_tables(rows: int, seed: int, device="cuda"):
    """(customer, orders, lineitem) Tables on ``device``:

    customer: (c_custkey i64, c_mktsegment-code i32)
    orders:   (o_orderkey i64, o_custkey i64, o_orderdate-days i32,
               o_shippriority i32)
    lineitem: (l_orderkey i64, l_shipdate-days i32,
               l_extendedprice-cents i64, l_discount-pct i32)
    """
    dev = resolve_device(device)
    a = q3_arrays(rows, seed)
    return tuple(
        Table(tuple(Column.from_numpy(a[name], d, device=dev)
                    for name, d in _SCHEMA[t]))
        for t in ("customer", "orders", "lineitem"))


def run_q3(cust: Table, orders: Table, lineitem: Table,
           cutoff: int = CUTOFF_DAYS, segment_code: int = 1,
           top_k: int = 10) -> Table:
    """The eager q3 stage; returns the top-k Table of (l_orderkey,
    o_orderdate, o_shippriority, revenue) on the tables' device."""
    oi, _ = inner_join([orders.columns[1]], [cust.columns[0]],
                       left_mask=orders.columns[2].data < cutoff,
                       right_mask=cust.columns[1].data == segment_code)
    ord_j = gather_table(orders, oi)
    lii, ori = inner_join([lineitem.columns[0]], [ord_j.columns[0]],
                          left_mask=lineitem.columns[1].data > cutoff)
    li_j = gather_table(lineitem, lii)
    ord_jj = gather_table(ord_j, ori)
    rev = (li_j.columns[2].data.to(torch.int64)
           * (100 - li_j.columns[3].data.to(torch.int64)))
    gt = Table((li_j.columns[0], ord_jj.columns[2], ord_jj.columns[3],
                Column(dt.INT64, int(rev.shape[0]), data=rev)))
    g = groupby_aggregate(gt, [0, 1, 2], [(3, "sum")])
    top = sort_table(g, [3, 1], ascending=[False, True])
    return slice_table(top, 0, min(top_k, g.num_rows))
