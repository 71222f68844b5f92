"""TPC-H q1, q3, q5 and q6 (the JAX package's benchmarks/tpch.py).

Each query has two engines, chosen by ``engine``:

  * ``"plan"``: the plan engine (plan/) — the query as one logical plan,
    fused by the planner into one program of torch ops with one host sync
    (falling back to the eager interpreter where a device re-check trips);
  * ``"eager"``: the op-by-op pipeline, with the filters pushed into the
    joins and groupbys as masks (the accelerator branch of the JAX
    package's ``_plan_ops``). Every join goes through the xxhash64 row
    hash, kernel B2;
  * ``"auto"`` (the default): ``"plan"`` at or above ``plan.min_rows``
    input rows, ``"eager"`` below, as the JAX package decides.

Money is int64 cents; averages are float64. The generators make the same
numpy calls in the same order as the JAX package's, so one seed gives the
same data in both packages, and attach honest ColumnStats where the JAX
package does (the planner reads them). Tables are built on ``device``
("cuda" unless the caller asks for "cpu").

Not ported: the distributed queries (``mesh=``, ``engine="sharded"``;
ROADMAP A15b).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .columnar import dtype as dt
from .columnar.column import Column, ColumnStats, Table, resolve_device
from .columnar.table_ops import gather_table, slice_table
from .ops.groupby import groupby_aggregate
from .ops.join import inner_join
from .ops.sort import sort_table
from .plan import (Filter, GroupBy, Join, Limit, Project, Scan, Sort, col,
                   execute_plan, i64, lit)
from .utils import config

CUTOFF_DAYS = 1200  # "1995-03-15" as days into the generated date range


def _use_plan(engine: str, rows: int, mesh) -> bool:
    """Engine selection: "plan" forces the fused plan engine, "eager"
    the op-by-op pipeline, "auto" fuses at or above ``plan.min_rows``."""
    if mesh is not None or engine == "sharded":
        raise dt.not_ported("distributed TPC-H queries (mesh=, "
                            "engine=\"sharded\")", "A15b, parallel")
    if engine not in ("auto", "plan", "eager"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "auto":
        return rows >= int(config.get("plan.min_rows"))
    return engine == "plan"


def _tables(arrays: Dict[str, np.ndarray], schema, dev: torch.device,
            stats: bool):
    """Tables of ``schema`` ((table, ((column, dtype), ...)), ...) from the
    arrays, on ``dev``, with honest stats where ``stats``."""
    out = []
    for _, cols in schema:
        tcols = []
        for name, d in cols:
            c = Column.from_numpy(arrays[name], d, device=dev)
            if stats:
                c.with_stats(ColumnStats.from_numpy(arrays[name]))
            tcols.append(c)
        out.append(Table(tuple(tcols)))
    return tuple(out)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def q3_arrays(rows: int, seed: int) -> Dict[str, np.ndarray]:
    """The q3 columns as numpy arrays at ``rows`` lineitem rows, with TPC-H's
    row ratios (orders = rows/4, customer = rows/40)."""
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


_Q3_SCHEMA = (
    ("customer", (("c_custkey", dt.INT64), ("c_mktsegment", dt.INT32))),
    ("orders", (("o_orderkey", dt.INT64), ("o_custkey", dt.INT64),
                ("o_orderdate", dt.INT32), ("o_shippriority", dt.INT32))),
    ("lineitem", (("l_orderkey", dt.INT64), ("l_shipdate", dt.INT32),
                  ("l_extendedprice", dt.INT64), ("l_discount", dt.INT32))),
)


def generate_q3_tables(rows: int, seed: int, device="cuda"):
    """(customer, orders, lineitem) Tables on ``device``, with stats:

    customer: (c_custkey i64, c_mktsegment-code i32)
    orders:   (o_orderkey i64, o_custkey i64, o_orderdate-days i32,
               o_shippriority i32)
    lineitem: (l_orderkey i64, l_shipdate-days i32,
               l_extendedprice-cents i64, l_discount-pct i32)
    """
    return _tables(q3_arrays(rows, seed), _Q3_SCHEMA,
                   resolve_device(device), stats=True)


def q5_arrays(rows: int, seed: int) -> Dict[str, np.ndarray]:
    """The q5 columns as numpy arrays at ``rows`` lineitem rows, TPC-H
    ratios (orders = rows/4, customer = rows/40, supplier = rows/600, 25
    nations); the JAX package's generate_q5_tables calls."""
    ncust = max(rows // 40, 16)
    nord = max(rows // 4, 16)
    nsupp = max(rows // 600, 8)
    rng = np.random.default_rng(seed)
    a = {}
    a["c_custkey"] = np.arange(ncust, dtype=np.int64)
    a["c_nationkey"] = rng.integers(0, 25, ncust).astype(np.int32)
    a["o_orderkey"] = np.arange(nord, dtype=np.int64)
    a["o_custkey"] = rng.integers(0, ncust, nord)
    a["o_orderdate"] = rng.integers(0, 2400, nord).astype(np.int32)
    a["l_orderkey"] = rng.integers(0, nord, rows)
    a["l_suppkey"] = rng.integers(0, nsupp, rows)
    a["l_extendedprice"] = rng.integers(90000, 10500000, rows)
    a["l_discount"] = rng.integers(0, 11, rows).astype(np.int32)
    a["s_suppkey"] = np.arange(nsupp, dtype=np.int64)
    a["s_nationkey"] = rng.integers(0, 25, nsupp).astype(np.int32)
    a["n_nationkey"] = np.arange(25, dtype=np.int64)
    a["n_regionkey"] = rng.integers(0, 5, 25).astype(np.int32)
    return a


_Q5_SCHEMA = (
    ("customer", (("c_custkey", dt.INT64), ("c_nationkey", dt.INT32))),
    ("orders", (("o_orderkey", dt.INT64), ("o_custkey", dt.INT64),
                ("o_orderdate", dt.INT32))),
    ("lineitem", (("l_orderkey", dt.INT64), ("l_suppkey", dt.INT64),
                  ("l_extendedprice", dt.INT64), ("l_discount", dt.INT32))),
    ("supplier", (("s_suppkey", dt.INT64), ("s_nationkey", dt.INT32))),
    ("nation", (("n_nationkey", dt.INT64), ("n_regionkey", dt.INT32))),
)


def generate_q5_tables(rows: int, seed: int, device="cuda"):
    """(customer, orders, lineitem, supplier, nation) Tables on
    ``device``, with stats (columns in ``_Q5_SCHEMA`` order)."""
    return _tables(q5_arrays(rows, seed), _Q5_SCHEMA,
                   resolve_device(device), stats=True)


def q1_arrays(rows: int, seed: int) -> Dict[str, np.ndarray]:
    """The q1/q6 lineitem columns as numpy arrays; the JAX package's
    generate_q1_lineitem calls."""
    rng = np.random.default_rng(seed)
    a = {}
    a["l_quantity"] = rng.integers(1, 51, rows)
    a["l_extendedprice"] = rng.integers(90000, 10500000, rows)
    a["l_discount"] = rng.integers(0, 11, rows).astype(np.int32)
    a["l_tax"] = rng.integers(0, 9, rows).astype(np.int32)
    a["l_returnflag"] = rng.integers(0, 3, rows).astype(np.int32)
    a["l_linestatus"] = rng.integers(0, 2, rows).astype(np.int32)
    a["l_shipdate"] = rng.integers(0, 2500, rows).astype(np.int32)
    return a


_Q1_SCHEMA = (
    ("lineitem", (("l_quantity", dt.INT64), ("l_extendedprice", dt.INT64),
                  ("l_discount", dt.INT32), ("l_tax", dt.INT32),
                  ("l_returnflag", dt.INT32), ("l_linestatus", dt.INT32),
                  ("l_shipdate", dt.INT32))),
)


def generate_q1_lineitem(rows: int, seed: int, device="cuda") -> Table:
    """lineitem for q1/q6 on ``device``, without stats (as the JAX
    package): (l_quantity i64, l_extendedprice-cents i64, l_discount-pct
    i32, l_tax-pct i32, l_returnflag-code i32, l_linestatus-code i32,
    l_shipdate-days i32)."""
    return _tables(q1_arrays(rows, seed), _Q1_SCHEMA,
                   resolve_device(device), stats=False)[0]


# ---------------------------------------------------------------------------
# q3
# ---------------------------------------------------------------------------

def _q3_plan(cutoff: int, segment_code: int, top_k: int):
    """q3 as a three-input plan DAG (cust=0, orders=1, lineitem=2):
    date-filtered orders semi-join segment-filtered customers (c_custkey
    is unique, so semi equals the eager inner join that drops the customer
    columns), then shipdate-filtered lineitem inner-joins those orders on
    the dense o_orderkey. The (l_orderkey, o_orderdate, o_shippriority)
    key FD-reduces onto l_orderkey, and Sort+Limit fuse to top-k."""
    cust_f = Filter(Scan(2, input_index=0), col(1) == lit(segment_code))
    ord_f = Filter(Scan(4, input_index=1), col(2) < lit(cutoff))
    ord_seg = Join(ord_f, cust_f, (1,), (0,), "semi")
    li_f = Filter(Scan(4, input_index=2), col(1) > lit(cutoff))
    j = Join(li_f, ord_seg, (0,), (0,), "inner")
    # j columns: l_orderkey0 l_shipdate1 l_price2 l_disc3 | o_orderkey4
    #   o_custkey5 o_orderdate6 o_shippriority7
    rev = i64(col(2)) * (lit(100) - i64(col(3)))
    proj = Project(j, (col(0), col(6), col(7), rev))
    gb = GroupBy(proj, (0, 1, 2), ((3, "sum"),))
    return Limit(Sort(gb, (3, 1), ascending=(False, True)), top_k)


def run_q3(cust: Table, orders: Table, lineitem: Table,
           cutoff: int = CUTOFF_DAYS, segment_code: int = 1,
           top_k: int = 10, mesh=None, engine: str = "auto") -> Table:
    """TPC-H q3 on the tables' device; returns the top-k Table of
    (l_orderkey, o_orderdate, o_shippriority, revenue)."""
    if _use_plan(engine, lineitem.num_rows, mesh):
        return execute_plan(_q3_plan(cutoff, segment_code, top_k),
                            [cust, orders, lineitem])
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


# ---------------------------------------------------------------------------
# q5
# ---------------------------------------------------------------------------

def _q5_plan(region_code: int, date_lo: int, date_hi: int):
    """q5 as a five-input plan DAG (cust=0, orders=1, lineitem=2,
    supplier=3, nation=4): lineitem probes (date-filtered orders ⋈
    customer) on l_orderkey and (supplier ⋈ region-filtered nation) on
    l_suppkey; the co-nation predicate is a Filter on the joined row;
    revenue sums per supplier nation, sorted descending. Every build key
    is a dense ascending key, so every join is a direct probe."""
    ord_f = Filter(Scan(3, input_index=1),
                   (col(2) >= lit(date_lo)) & (col(2) < lit(date_hi)))
    oc = Join(ord_f, Scan(2, input_index=0), (1,), (0,), "inner")
    nat_f = Filter(Scan(2, input_index=4), col(1) == lit(region_code))
    sn = Join(Scan(2, input_index=3), nat_f, (1,), (0,), "inner")
    lo = Join(Scan(4, input_index=2), oc, (0,), (0,), "inner")
    ls = Join(lo, sn, (1,), (0,), "inner")
    # ls columns: l_orderkey0 l_suppkey1 l_price2 l_disc3 | o_orderkey4
    #   o_custkey5 o_orderdate6 | c_custkey7 c_nationkey8 | s_suppkey9
    #   s_nationkey10 | n_nationkey11 n_regionkey12
    conat = Filter(ls, col(8) == col(10))
    rev = i64(col(2)) * (lit(100) - i64(col(3)))
    proj = Project(conat, (col(10), rev))
    return Sort(GroupBy(proj, (0,), ((1, "sum"),)), (1,),
                ascending=(False,))


def run_q5(cust: Table, orders: Table, lineitem: Table, supplier: Table,
           nation: Table, region_code: int = 2, date_lo: int = 700,
           date_hi: int = 1065, mesh=None, engine: str = "auto") -> Table:
    """TPC-H q5 (local supplier volume) on the tables' device; returns
    (s_nationkey, revenue) sorted by revenue descending."""
    if _use_plan(engine, lineitem.num_rows, mesh):
        return execute_plan(_q5_plan(region_code, date_lo, date_hi),
                            [cust, orders, lineitem, supplier, nation])
    od = orders.columns[2].data
    # nations in the region; suppliers in those nations
    snat_key = Column(dt.INT64, supplier.num_rows,
                      data=supplier.columns[1].data.to(torch.int64))
    si, _ = inner_join([snat_key], [nation.columns[0]],
                       right_mask=nation.columns[1].data == region_code)
    supp_f = gather_table(supplier, si)
    # orders in the date window, joined to customers (carry c_nationkey)
    oi, ci = inner_join([orders.columns[1]], [cust.columns[0]],
                        left_mask=(od >= date_lo) & (od < date_hi))
    ord_j = gather_table(orders, oi)
    cust_j = gather_table(cust, ci)
    # lineitem to its order (carry the customer's nation), then its supplier
    lii, ori = inner_join([lineitem.columns[0]], [ord_j.columns[0]])
    li_j = gather_table(lineitem, lii)
    cnat = gather_table(Table((cust_j.columns[1],)), ori)
    si2, spi = inner_join([li_j.columns[1]], [supp_f.columns[0]])
    li_jj = gather_table(li_j, si2)
    cnat_j = gather_table(cnat, si2)
    snat = gather_table(Table((supp_f.columns[1],)), spi)
    # local-supplier predicate: customer and supplier share a nation
    same = cnat_j.columns[0].data == snat.columns[0].data
    rev = (li_jj.columns[2].data.to(torch.int64)
           * (100 - li_jj.columns[3].data.to(torch.int64)))
    gt = Table((snat.columns[0], Column(dt.INT64, int(rev.shape[0]),
                                        data=rev)))
    g = groupby_aggregate(gt, [0], [(1, "sum")], row_mask=same)
    return sort_table(g, [1], ascending=[False])


# ---------------------------------------------------------------------------
# q1 and q6
# ---------------------------------------------------------------------------

def _q1_plan(cutoff: int):
    """q1 as a logical plan: filter -> project -> groupby -> sort, with the
    eager pipeline's int64 cents/pct math expression for expression."""
    filt = Filter(Scan(7), col(6) <= lit(cutoff))
    disc_price = i64(col(1)) * (lit(100) - i64(col(2)))
    charge = disc_price * (lit(100) + i64(col(3)))
    proj = Project(filt, (
        col(4), col(5),                  # returnflag, linestatus keys
        i64(col(0)),                     # qty
        i64(col(1)),                     # price
        disc_price, charge,
        i64(col(2)),                     # disc
    ))
    gb = GroupBy(proj, (0, 1),
                 ((2, "sum"), (3, "sum"), (4, "sum"), (5, "sum"),
                  (2, "mean"), (3, "mean"), (6, "mean"), (2, "count")))
    return Sort(gb, (0, 1))


def run_q1(lineitem: Table, cutoff: int = 2400, mesh=None,
           engine: str = "auto") -> Table:
    """TPC-H q1 (pricing summary report) on the table's device: filter
    shipdate <= cutoff, group by (returnflag, linestatus): sum qty, sum
    base price, sum discounted price, sum charge (exact int64), avg qty,
    avg price, avg discount (float64), count; sorted by the keys."""
    if _use_plan(engine, lineitem.num_rows, mesh):
        return execute_plan(_q1_plan(cutoff), lineitem)
    keep = lineitem.columns[6].data <= cutoff
    qty = lineitem.columns[0].data.to(torch.int64)
    price = lineitem.columns[1].data.to(torch.int64)
    disc = lineitem.columns[2].data.to(torch.int64)
    tax = lineitem.columns[3].data.to(torch.int64)
    disc_price = price * (100 - disc)            # cents·pct
    charge = disc_price * (100 + tax)            # cents·pct²
    n = lineitem.num_rows
    gt = Table((lineitem.columns[4], lineitem.columns[5],
                Column(dt.INT64, n, data=qty),
                Column(dt.INT64, n, data=price),
                Column(dt.INT64, n, data=disc_price),
                Column(dt.INT64, n, data=charge),
                Column(dt.INT64, n, data=disc)))
    aggs = [(2, "sum"), (3, "sum"), (4, "sum"), (5, "sum"),
            (2, "mean"), (3, "mean"), (6, "mean"), (2, "count")]
    g = groupby_aggregate(gt, [0, 1], aggs, row_mask=keep)
    return sort_table(g, [0, 1])


def _q6_plan(date_lo: int, date_hi: int, disc_lo: int, disc_hi: int,
             qty_max: int):
    """q6 as a constant-key plan: filter -> project a literal key and the
    revenue -> single-group sum."""
    return GroupBy(
        Project(Filter(Scan(7),
                       (col(6) >= lit(date_lo)) & (col(6) < lit(date_hi))
                       & (col(2) >= lit(disc_lo))
                       & (col(2) <= lit(disc_hi))
                       & (col(0) < lit(qty_max))),
                (i64(lit(0)), i64(col(1)) * i64(col(2)))),
        (0,), ((1, "sum"),))


def run_q6(lineitem: Table, date_lo: int = 365, date_hi: int = 730,
           disc_lo: int = 5, disc_hi: int = 7, qty_max: int = 24,
           mesh=None, engine: str = "auto") -> int:
    """TPC-H q6 (forecast revenue change): one filtered sum, returned in
    cents·pct as an exact Python int."""
    if _use_plan(engine, lineitem.num_rows, mesh):
        g = execute_plan(
            _q6_plan(date_lo, date_hi, disc_lo, disc_hi, qty_max), lineitem)
        return int(g.columns[1].data[0]) if g.num_rows else 0
    sd = lineitem.columns[6].data
    disc = lineitem.columns[2].data
    qty = lineitem.columns[0].data
    keep = ((sd >= date_lo) & (sd < date_hi)
            & (disc >= disc_lo) & (disc <= disc_hi)
            & (qty < qty_max))
    rev = (lineitem.columns[1].data.to(torch.int64)
           * lineitem.columns[2].data.to(torch.int64))
    return int(torch.where(keep, rev, 0).sum())
