"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (spark_rapids_jni_tpu_torch) once on the card
at TPC-H SF10 scale and checks it, in phases; any failure raises and the
run exits non-zero:

  1. the card: its name and power limit (nvidia-smi);
  2. builds the CUDA kernels from the checkout (one nvcc per source, all
     at once) and prints each kernel's registers and spills;
  3. generates the q3 tables at 60M lineitem rows on the card and holds
     every kernel (B1 murmur3, B2 xxhash64, B3 JCUDF rows) bit-exact
     against its plain PyTorch version at the main path's shapes; B3 also
     at a 1M-row mixed nullable schema, at a 600-column schema whose rows
     are split into several word windows, and at column views whose data
     does not start on 16 bytes;
  4. the main path with the launch counts set to 0: shuffle write
     (partition route for 200 partitions + JCUDF rows), shuffle read (must
     equal the input bit for bit), then q3's eager stage on the read-back
     tables; the top 10 must equal an independent numpy q3 over the same
     arrays, and every kernel must have launched; at 1M rows the card and
     the CPU must give identical q3 tables;
  5. timings by CUDA events around repeated wrapper calls (kernel, plain
     version, bound), each kernel's own device time by torch.profiler
     (``kernel_ms``), and wall times;
     B3 at each of its schemas, with the byte bound of that schema, beside
     a device-to-device copy_ that moves as many bytes (the rate this card
     reaches);
  6. the plan engine: TPC-H q1, q6, q3 and q5 at SF10 through their entry
     points on both engines ("auto", fused at this size, and "eager"):
     first pass and warm median of 5 each, bit for bit fused == eager ==
     an independent numpy version of the query, no fallback, every fused
     program run with host syncs made errors, the planner's decisions,
     kernel launches per engine (the fused programs launch none; the
     eager joins launch B2), peak memory, and one warm run of each engine
     under torch.profiler (``plan_profile_sf10``); q3 once with the default
     knobs (its groupby overflows at SF10 and replays eagerly); and a
     GroupBy plan at 1M rows forced to overflow its slot budget, which
     must replay eagerly and equal the eager engine.

Prints JSON lines (timings, then the {"kernels": [...]} line, whose
entries give each kernel's launches by path) and, last,
{"ok": true, "device": {...}}. Without a CUDA device it exits 2 and prints
no result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
ALU_OPS_PER_S = 67e12       # H100 SXM non-tensor-core fp32 rate, used as
#                             the rate of the kernels' 32-bit integer ops
SF10_ROWS = 60_000_000      # lineitem rows; orders 15M, customer 1.5M
PARTITIONS = 200            # spark.sql.shuffle.partitions default


def log(msg):
    print(msg, flush=True)


def jline(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps=10, warm=2):
    """Mean device time of fn() in ms, by CUDA events over ``reps`` calls
    after ``warm`` warm-up calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(calls, reps=5):
    """Mean device time per call of each (fn, kernel) in ``calls``: the
    CUDA kernel whose name holds ``kernel``, which fn() launches once, timed
    by torch.profiler — the kernel alone, without the host gaps that cuda_ms
    counts when the wrapper's host work is the longer. One profiler session
    for all calls; the kernels are attributed in launch order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for fn, _ in calls:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn, _ in calls:
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    names = {k for _, k in calls}
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and any(k in e.name for k in names)),
                    key=lambda e: e.time_range.start)
    out = []
    for _, kernel in calls:
        mine, events = events[:reps], events[reps:]
        if len(mine) < reps or any(kernel not in e.name for e in mine):
            raise AssertionError(f"the profiler did not see {reps} "
                                 f"launches of {kernel}")
        out.append(sum(e.time_range.elapsed_us() for e in mine) / 1e3 / reps)
    return out


# the CUDA kernel of each wrapper, by the name the profiler shows
DEVICE_KERNEL = {"murmur3_fixed_rows": "murmur3_rows_kernel",
                 "xxhash64_fixed_rows": "xxhash64_rows_kernel",
                 "rowconv_fixed_words": "rowconv_tiles_kernel"}


def bound_ms(nbytes, nops):
    """Least time for the work: the larger of its bytes over the memory
    rate and its operations over the ALU rate, and which one bounds it."""
    b = nbytes / HBM_BYTES_PER_S * 1e3
    o = nops / ALU_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def wall(fn, dev):
    """(fn(), host milliseconds) with the device drained on both sides."""
    _sync(dev)
    t = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, (time.perf_counter() - t) * 1e3


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from spark_rapids_jni_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    # ---- phase 1: the card ----------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    card = {"card": smi}

    # ---- phase 2: build -------------------------------------------------
    t = time.perf_counter()
    reports = K.build_all()
    log(f"built {sorted(reports) or 'nothing (up to date)'} in "
        f"{time.perf_counter() - t:.1f} s")
    for src, rep in reports.items():
        for line in rep.splitlines():
            if "Compiling entry function" in line or "registers" in line \
                    or "spill" in line:
                log(f"  {src}.cu: {line.strip()}")

    # ---- phases 3 and 4 ---------------------------------------------------
    state = check_kernels(dev, SF10_ROWS)
    launches, summary = main_path(dev, state)
    for wrapper, count in launches.items():
        if count < 1:
            raise AssertionError(f"the SF10 main path never launched "
                                 f"{wrapper}")
    jline({"phase": "main_path_sf10", **card, **summary})

    # ---- phase 5: timings -------------------------------------------------
    entries = timings(state, launches, card)
    breakdown(state, card)

    # ---- phase 6: the plan engine -----------------------------------------
    paths = {"main_path_sf10": launches, **plan_engine(dev, state, card)}
    for entry, (_, wrapper, _, _) in zip(entries, K.KERNELS):
        entry["launches_by_path"] = {p: c[wrapper] for p, c in paths.items()}
    jline({"kernels": entries})
    jline({"ok": True, "device": {"platform": "gpu", "kind": name,
                                  "count": torch.cuda.device_count()}})
    return 0


def _schema(cols, for_xx):
    from spark_rapids_jni_tpu_torch.ops import hashing as H
    return [(*H._fixed_element_words(c.dtype, c.data, for_xx), c.validity)
            for c in cols]


def _rowconv_args(table):
    from spark_rapids_jni_tpu_torch.ops import row_conversion as R
    info = R.compute_column_information([c.dtype for c in table])
    cols, valids, plan = R._word_plan(table, info)
    nwords = R._round_up(info.size_per_row, 8) // 4
    return cols, valids, plan, nwords, table.num_rows


def _rowconv_bytes(args):
    """B3's device bytes: each element and validity byte read once, each
    row's words written once."""
    cols, valids, _, nwords, n = args
    return (sum(c.element_size() * n for c in cols)
            + sum(n for v in valids if v is not None) + 4 * nwords * n)


def _wide_table(n, dev, rng):
    """600 columns cycling through 11 fixed-width types, every third
    nullable: rows of about 2.5 KB, split into several word windows."""
    from spark_rapids_jni_tpu_torch.columnar import dtype as dt
    from spark_rapids_jni_tpu_torch.columnar.column import Column, Table
    types = [(np.int8, dt.INT8), (np.int64, dt.INT64), (np.int16, dt.INT16),
             (np.float32, dt.FLOAT32), (np.uint8, dt.BOOL8),
             (np.float64, dt.FLOAT64), (np.int32, dt.INT32),
             (np.uint16, dt.UINT16), (np.int8, dt.INT8),
             (np.uint64, dt.UINT64), (np.int32, dt.INT32)]
    cols = []
    for i in range(600):
        npt, d = types[i % len(types)]
        vals = torch.randint(0, 256, (n * np.dtype(npt).itemsize,),
                             dtype=torch.uint8, device=dev)
        data = vals.view(d.torch_dtype)
        v = (torch.rand(n, device=dev) > 0.3) if i % 3 == 0 else None
        cols.append(Column(d, n, data=data, validity=v))
    return Table(tuple(cols))


def _views_from(table, starts=(1, 3)):
    """Column views starting at element 1 or 3 (alternately) of each column:
    their data pointers are not 16-byte aligned."""
    from spark_rapids_jni_tpu_torch.columnar.column import Column, Table
    n = table.num_rows - max(starts)
    cols = []
    for i, c in enumerate(table):
        s = starts[i % len(starts)]
        v = None if c.validity is None else c.validity[s:s + n]
        cols.append(Column(c.dtype, n, data=c.data[s:s + n], validity=v))
    return Table(tuple(cols))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def check_kernels(dev, rows):
    """Phase 3: the q3 tables at ``rows`` lineitem rows on ``dev``, and every
    kernel against its plain version at the main path's shapes."""
    from spark_rapids_jni_tpu_torch import tpch
    from spark_rapids_jni_tpu_torch.columnar import dtype as dt
    from spark_rapids_jni_tpu_torch.columnar.column import Column, Table
    from spark_rapids_jni_tpu_torch.ops import kernels as K

    t = time.perf_counter()
    arrays = tpch.q3_arrays(rows, 0)
    cust, orders, lineitem = tpch.generate_q3_tables(rows, 0, dev)
    _sync(dev)
    log(f"generated q3 tables ({lineitem.num_rows} lineitem, "
        f"{orders.num_rows} orders, {cust.num_rows} customer rows; "
        f"lineitem {lineitem.device_nbytes() / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t:.1f} s")

    def check_hash(label, fn, plain, sch, n, seed=42):
        got = fn(sch, seed, n)
        _sync(dev)
        want = plain(sch, seed, n)
        _sync(dev)
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"{label}: {bad} of {n} rows differ")
        log(f"check {label}: bit-exact over {n} rows")

    rng = np.random.default_rng(0)
    n4 = min(1 << 22, rows)  # the JAX package's bench.py headline: 4M rows
    head = [Column.from_numpy(rng.integers(-2**31, 2**31, n4)
                              .astype(np.int32), device=dev),
            Column.from_numpy(rng.integers(-2**62, 2**62, n4), device=dev),
            Column.from_numpy(rng.random(n4, dtype=np.float32), device=dev),
            Column.from_numpy(rng.random(n4), device=dev)]
    head_nulls = [c.with_validity(torch.from_numpy(rng.random(n4) > 0.1)
                                  .to(dev)) for c in head]
    for label, cols in (("B1 headline 4M x4", head),
                        ("B1 headline 4M x4 nullable", head_nulls)):
        check_hash(label, K.murmur3_fixed_rows, K.murmur3_fixed_rows_plain,
                   _schema(cols, False), n4)
    check_hash("B1 SF10 l_orderkey", K.murmur3_fixed_rows,
               K.murmur3_fixed_rows_plain, _schema([lineitem[0]], False),
               rows)
    for label, col in (("B2 SF10 l_orderkey", lineitem[0]),
                       ("B2 SF10 o_orderkey", orders[0])):
        check_hash(label, K.xxhash64_fixed_rows, K.xxhash64_fixed_rows_plain,
                   _schema([col], True), col.size)

    mixed_gen = [(np.int8, dt.INT8), (np.int64, dt.INT64),
                 (np.int16, dt.INT16), (np.float32, dt.FLOAT32),
                 (np.uint8, dt.BOOL8), (np.float64, dt.FLOAT64),
                 (np.int32, dt.INT32), (np.uint16, dt.UINT16),
                 (np.int8, dt.INT8), (np.int64, dt.INT64),
                 (np.int32, dt.INT32)]
    n1 = min(1 << 20, rows)
    mixed = Table(tuple(
        Column.from_numpy(rng.integers(0, 2**62, n1).astype(npt), d,
                          validity=(rng.random(n1) > 0.2) if i % 3 else None,
                          device=dev)
        for i, (npt, d) in enumerate(mixed_gen)))
    torch.manual_seed(0)
    wide = _wide_table(min(250_000, rows), dev, rng)
    views = _views_from(mixed)
    if not any(c.data.data_ptr() % 16 for c in views):
        raise AssertionError("the misaligned views are aligned")
    for label, table in (("B3 SF10 lineitem", lineitem),
                         ("B3 1M mixed 11 columns", mixed),
                         ("B3 600-column wide", wide),
                         ("B3 1M mixed, misaligned views", views)):
        args = _rowconv_args(table)
        tiles = K.rowconv_tile_plan(
            args[2], [c.element_size() for c in args[0]],
            [v is not None for v in args[1]], args[3])
        got = K.rowconv_fixed_words(*args)
        _sync(dev)
        want = K.rowconv_fixed_words_plain(*args)
        _sync(dev)
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: words differ")
        log(f"check {label}: bit-exact, {args[3]} words x {args[4]} rows, "
            f"R {tiles.rows}, {len(tiles.windows)} word window(s)")
        del got, want
    return {"arrays": arrays, "cust": cust, "orders": orders,
            "lineitem": lineitem, "head": head, "rows": rows,
            "mixed": mixed, "wide": wide}


def main_path(dev, state):
    """Phase 4: the main path with the launch counts set to 0 just before
    and read just after; then its checks. Returns (launches, summary)."""
    from spark_rapids_jni_tpu_torch import tpch
    from spark_rapids_jni_tpu_torch.ops import kernels as K
    from spark_rapids_jni_tpu_torch.ops import row_conversion as R
    from spark_rapids_jni_tpu_torch.parallel.exchange import partition_ids

    rows = state["rows"]
    tables = {"customer": state["cust"], "orders": state["orders"],
              "lineitem": state["lineitem"]}
    K.reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    def shuffle_write():
        return {tn: (partition_ids(tab, [0], PARTITIONS),
                     R.convert_to_rows(tab)) for tn, tab in tables.items()}

    def shuffle_read():
        return {tn: R.convert_from_rows(written[tn][1][0],
                                        [c.dtype for c in tab])
                for tn, tab in tables.items()}

    written, write_ms = wall(shuffle_write, dev)
    read, read_ms = wall(shuffle_read, dev)
    top, q3_ms = wall(lambda: tpch.run_q3(read["customer"], read["orders"],
                                          read["lineitem"], engine="eager"),
                      dev)
    launches = {"murmur3_fixed_rows": K.murmur3_fixed_rows.launches,
                "xxhash64_fixed_rows": K.xxhash64_fixed_rows.launches,
                "rowconv_fixed_words": K.rowconv_fixed_words.launches}
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if dev.type == "cuda" else None)
    log(f"main path launches: {launches}")

    li_rows = written["lineitem"][1]
    if len(li_rows) != 1 or li_rows[0].children[0].size != 32 * rows:
        raise AssertionError("lineitem rows: expected one batch of 32-byte "
                             "rows")
    for tn, tab in tables.items():
        pids = written[tn][0]
        if int(pids.min()) < 0 or int(pids.max()) >= PARTITIONS:
            raise AssertionError(f"{tn}: partition id out of range")
        for a, b in zip(tab, read[tn]):
            if b.validity is not None or not torch.equal(
                    a.data.view(torch.uint8), b.data.view(torch.uint8)):
                raise AssertionError(f"{tn}: shuffle read differs")
    log("check shuffle round trip: bit-identical for customer, orders, "
        "lineitem")
    got = [c.to_numpy() for c in top.columns]
    want = numpy_q3(state["arrays"])
    for i, (g, w) in enumerate(zip(got, want)):
        if not np.array_equal(g, w):
            raise AssertionError(f"q3 top-10 column {i}: {g} != {w}")
    if top.num_rows != 10 or not bool(top.columns[3].valid_mask().all()):
        raise AssertionError("q3: expected 10 rows of non-null revenue")
    log(f"check q3 top-10 == numpy q3: orderkeys {got[0].tolist()}")

    small_rows = min(1_000_000, rows)
    small = [tpch.run_q3(*tpch.generate_q3_tables(small_rows, 1, d),
                         engine="eager") for d in (dev, "cpu")]
    for a, b in zip(*(t.columns for t in small)):
        if not (torch.equal(a.data.cpu(), b.data)
                and torch.equal(a.valid_mask().cpu(), b.valid_mask())):
            raise AssertionError(f"q3 at {small_rows} rows: card != CPU")
    log(f"check q3 at {small_rows} rows: {dev.type} == cpu")
    return launches, {"rows": rows, "shuffle_write_ms": write_ms,
                      "shuffle_read_ms": read_ms, "q3_eager_ms": q3_ms,
                      "max_memory_allocated_gb": peak_gb,
                      "launches": launches}


def timings(state, launches, card):
    """Phase 5: each kernel's device time at the main path's SF10 shape,
    its plain version's, and its bound. Returns the kernel entries."""
    from spark_rapids_jni_tpu_torch.ops import kernels as K

    n = state["rows"]
    lineitem = state["lineitem"]
    li_mm = _schema([lineitem[0]], False)
    li_xx = _schema([lineitem[0]], True)
    li_args = _rowconv_args(lineitem)
    # bytes: each input read once, each output written once; operations:
    # the integer ops per row of the mixing (murmur3: 2 blocks + fmix of an
    # 8-byte key; xxhash64: one 8-byte round + final, a 64-bit multiply as
    # 4 32-bit ops; rowconv: a load, shift and OR per piece)
    work = {
        "murmur3_fixed_rows": (
            lambda: K.murmur3_fixed_rows(li_mm, 42, n),
            lambda: K.murmur3_fixed_rows_plain(li_mm, 42, n),
            n * (8 + 4), n * 30),
        "xxhash64_fixed_rows": (
            lambda: K.xxhash64_fixed_rows(li_xx, 42, n),
            lambda: K.xxhash64_fixed_rows_plain(li_xx, 42, n),
            n * (8 + 8), n * 40),
        "rowconv_fixed_words": (
            lambda: K.rowconv_fixed_words(*li_args),
            lambda: K.rowconv_fixed_words_plain(*li_args),
            _rowconv_bytes(li_args), n * 3 * len(li_args[2])),
    }
    b3 = {label: _rowconv_args(state[label]) for label in ("mixed", "wide")}
    k_ms = kernel_ms(
        [(work[w][0], DEVICE_KERNEL[w]) for _, w, _, _ in K.KERNELS]
        + [((lambda a=a: K.rowconv_fixed_words(*a)),
            DEVICE_KERNEL["rowconv_fixed_words"]) for a in b3.values()])
    entries = []
    for i, (kname, wrapper, source, replaces) in enumerate(K.KERNELS):
        run, plain, nbytes, nops = work[wrapper]
        b_ms, b_by = bound_ms(nbytes, nops)
        entry = {"name": kname, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[wrapper],
                 "bit_exact": True, "max_abs_err": 0, "ms": cuda_ms(run),
                 "kernel_ms": k_ms[i],
                 "plain_ms": cuda_ms(plain, reps=3, warm=1),
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        jline({"phase": "kernel_time", "rows": n, **card, **entry})
        entries.append(entry)
    for i, (label, args) in enumerate(b3.items(), len(K.KERNELS)):
        nbytes = _rowconv_bytes(args)
        b_ms, b_by = bound_ms(nbytes, args[4] * 3 * len(args[2]))
        jline({"phase": f"rowconv_time_{label}", **card, "rows": args[4],
               "columns": len(args[0]), "row_bytes": 4 * args[3],
               "bytes": nbytes,
               "ms": cuda_ms(lambda: K.rowconv_fixed_words(*args)),
               "kernel_ms": k_ms[i],
               "plain_ms": cuda_ms(lambda: K.rowconv_fixed_words_plain(
                   *args), reps=3, warm=1),
               "bound_ms": b_ms, "bound_by": b_by})
    copy_yardstick(_rowconv_bytes(li_args), card)
    head = _schema(state["head"], False)
    n4 = state["head"][0].size
    hb, hby = bound_ms(n4 * (4 + 8 + 4 + 8 + 4), n4 * 4 * 30)
    jline({"phase": "headline_murmur3_4M_x4", **card, "rows": n4,
           "ms": cuda_ms(lambda: K.murmur3_fixed_rows(head, 42, n4)),
           "plain_ms": cuda_ms(lambda: K.murmur3_fixed_rows_plain(
               head, 42, n4), reps=3, warm=1),
           "bound_ms": hb, "bound_by": hby})
    return entries


def copy_yardstick(nbytes, card):
    """A device-to-device copy_ that moves ``nbytes`` (reads and writes
    half each): the memory rate this card reaches, beside B3's times."""
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src))
    jline({"phase": "copy_yardstick", **card, "bytes_moved": 2 * src.numel(),
           "ms": ms, "tb_per_s": 2 * src.numel() / ms / 1e9,
           "bound_ms": 2 * src.numel() / HBM_BYTES_PER_S * 1e3})
    del src, dst


def breakdown(state, card):
    """Phase 5, warm: the main path's steps on lineitem, and q3, timed on
    the device timeline (CUDA events around warm repeats; host gaps
    included), then one warm q3 under torch.profiler: the device's busy
    share and the aten ops that hold it."""
    from spark_rapids_jni_tpu_torch import tpch
    from spark_rapids_jni_tpu_torch.ops import row_conversion as R
    from spark_rapids_jni_tpu_torch.parallel.exchange import partition_ids

    li, cust, orders = state["lineitem"], state["cust"], state["orders"]
    rows = R.convert_to_rows(li)[0]
    dtypes = [c.dtype for c in li]
    q3 = lambda: tpch.run_q3(cust, orders, li, engine="eager")  # noqa: E731
    jline({"phase": "warm_breakdown_sf10", **card, "rows": li.num_rows,
           "partition_ids_lineitem_ms": cuda_ms(
               lambda: partition_ids(li, [0], PARTITIONS), reps=5),
           "convert_to_rows_lineitem_ms": cuda_ms(
               lambda: R.convert_to_rows(li), reps=5),
           "convert_from_rows_lineitem_ms": cuda_ms(
               lambda: R.convert_from_rows(rows, dtypes), reps=5),
           "q3_eager_ms": cuda_ms(q3, reps=3, warm=1)})
    jline({"phase": "q3_profile_sf10", **card, **profile_once(q3)})


def profile_once(fn):
    """One warm call of fn() under torch.profiler: its wall time, the
    device's busy time and idle share, and the aten ops that hold the
    device (inclusive device ms, top 10)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        span_ms = (time.perf_counter() - t) * 1e3
    ev = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in ev
                  if e.device_type == DeviceType.CUDA) / 1e3
    ops = sorted((e for e in ev if e.key.startswith("aten::")
                  and e.device_time_total > 0),
                 key=lambda e: -e.device_time_total)[:10]
    return {"wall_ms": span_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / span_ms,
            "top_aten_ops_inclusive_device_ms": {
                e.key: e.device_time_total / 1e3 for e in ops}}


# q3's groupby key (l_orderkey) spans the 15M orders at SF10, above the
# default plan.groupby_wide_span (2^21, the JAX package's value): with it
# the planner keeps the generic sorted groupby, whose 4096-slot budget the
# ~1.4M live groups overflow, and the query replays eagerly. Phase 6 runs
# q3 once with the defaults (to record that) and otherwise with this span.
Q3_WIDE_SPAN = 1 << 24


def plan_engine(dev, state, card):
    """Phase 6: TPC-H q1, q6, q3 and q5 at SF10 through their entry points
    on both engines ("auto" = fused at this size, and "eager"), each held
    bit for bit against the other and against a numpy version of the query
    over the same arrays. Returns the kernel launches of each run, by
    path."""
    from spark_rapids_jni_tpu_torch import tpch
    from spark_rapids_jni_tpu_torch.utils import config

    for key in ("mixed", "wide", "head"):
        state.pop(key, None)
    rows = state["rows"]
    paths = {}
    q3_tabs = [state.pop(k) for k in ("cust", "orders", "lineitem")]
    q3_want = numpy_q3(state.pop("arrays"))
    q3_plan = tpch._q3_plan(tpch.CUTOFF_DAYS, 1, 10)
    default = default_knobs_q3(dev, q3_tabs, q3_want, q3_plan)
    with config.override("plan.groupby_wide_span", Q3_WIDE_SPAN):
        paths.update(query_line(
            dev, card, "q3", lambda e: tpch.run_q3(*q3_tabs, engine=e),
            q3_want, q3_plan, q3_tabs,
            {"knobs": {"plan.groupby_wide_span": Q3_WIDE_SPAN},
             "default_knobs_fused": default}))
    del q3_tabs

    a1 = tpch.q1_arrays(rows, 0)
    li = tpch.generate_q1_lineitem(rows, 0, dev)
    paths.update(query_line(
        dev, card, "q1", lambda e: tpch.run_q1(li, engine=e), numpy_q1(a1),
        tpch._q1_plan(2400), li))
    paths.update(query_line(
        dev, card, "q6", lambda e: tpch.run_q6(li, engine=e), numpy_q6(a1),
        tpch._q6_plan(365, 730, 5, 7, 24), li))
    del li, a1

    q5_tabs = list(tpch.generate_q5_tables(rows, 0, dev))
    paths.update(query_line(
        dev, card, "q5", lambda e: tpch.run_q5(*q5_tabs, engine=e),
        numpy_q5(tpch.q5_arrays(rows, 0)), tpch._q5_plan(2, 700, 1065),
        q5_tabs))
    del q5_tabs
    forced_fallback(dev, card)
    return paths


def _kernel_counts():
    from spark_rapids_jni_tpu_torch.ops import kernels as K
    return {w: getattr(K, w).launches for _, w, _, _ in K.KERNELS}


def _tables_equal(a, b) -> bool:
    """Same rows, dtypes, value bytes and validity bits (validity presence
    may differ: the engines agree on the bits)."""
    if isinstance(a, int) or isinstance(b, int):
        return a == b
    return a.num_rows == b.num_rows and all(
        x.dtype == y.dtype
        and x.data.cpu().numpy().tobytes() == y.data.cpu().numpy().tobytes()
        and torch.equal(x.valid_mask().cpu(), y.valid_mask().cpu())
        for x, y in zip(a.columns, b.columns))


def _equals_numpy(got, want) -> bool:
    if isinstance(want, int):
        return got == want
    return (got.num_rows == len(want[0]) and all(
        np.array_equal(c.to_numpy(), w) and bool(c.valid_mask().all())
        for c, w in zip(got.columns, want)))


def _decisions(plan, tables):
    """The planner's choice for each node of the optimized DAG plan."""
    from spark_rapids_jni_tpu_torch.plan import (optimize, plan_decisions,
                                                 walk)
    opt = optimize(plan, tables)
    dec = plan_decisions(opt, tables)
    out = []
    for n in walk(opt):
        d = dec.of(n)
        if d is not None:
            f = dict(vars(d))
            if "fd_drop" in f:
                f["fd_drop"] = len(f["fd_drop"])
            out.append({"node": type(n).__name__, **f})
    return out


def sync_free(plan, tables) -> str:
    """Run the fused program of (plan, tables) with every host sync an
    error, up to (not including) the executor's read of its head."""
    from spark_rapids_jni_tpu_torch.plan.executor import fused_program
    prog, args, reason = fused_program(plan, tables)
    if prog is None:
        return f"not fused ({reason})"
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        prog(*args)
    except RuntimeError as err:
        return f"raised: {err}"
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return "passed"


def query_line(dev, card, name, run, want, plan, tables, extra=None):
    """One query on both engines: first pass and warm median of 5 each,
    plan metrics, kernel launches, peak memory, the planner's decisions
    (DAG plans), the sync check; prints its line and raises on any failed
    check. Returns {f"{name}_{engine}": launches}."""
    from spark_rapids_jni_tpu_torch.ops import kernels as K
    from spark_rapids_jni_tpu_torch.plan import plan_metrics

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    line = {"phase": "plan_engine_sf10", **card, "query": name,
            "lineitem_rows": (tables.num_rows if hasattr(tables, "num_rows")
                              else tables[2].num_rows), **(extra or {})}
    outs, launches = {}, {}
    for engine in ("auto", "eager"):
        K.reset_launches()
        plan_metrics.reset()
        outs[engine], first = wall(lambda: run(engine), dev)
        launches[f"{name}_{'fused' if engine == 'auto' else 'eager'}"] = \
            _kernel_counts()
        warm = sorted(wall(lambda: run(engine), dev)[1] for _ in range(5))
        snap = plan_metrics.snapshot()
        tag = "fused" if engine == "auto" else "eager"
        if cuda:
            jline({"phase": "plan_profile_sf10", **card, "query": name,
                   "engine": tag, **profile_once(lambda: run(engine))})
        line[f"{tag}_first_ms"] = first
        line[f"{tag}_warm_median_ms"] = warm[2]
        line[f"{tag}_warm_ms"] = warm
        if engine == "auto":
            line["plan_metrics"] = {k: snap[k] for k in (
                "plan_executes", "plan_fallbacks", "plan_join_fallbacks",
                "plan_overflows", "plan_fallback_reasons")}
    line["max_memory_allocated_gb"] = (
        torch.cuda.max_memory_allocated() / 1e9 if cuda else None)
    line["launches"] = launches
    if isinstance(tables, list):
        line["decisions"] = _decisions(plan, tables)
    line["sync_check"] = (sync_free(plan, tables) if cuda
                          else "not checked on the cpu")
    line["fused_equals_eager"] = _tables_equal(outs["auto"], outs["eager"])
    line["fused_equals_numpy"] = _equals_numpy(outs["auto"], want)
    line["eager_equals_numpy"] = _equals_numpy(outs["eager"], want)
    jline(line)
    m = line["plan_metrics"]
    failed = [k for k in ("fused_equals_eager", "fused_equals_numpy",
                          "eager_equals_numpy") if not line[k]]
    if m["plan_executes"] != 6 or m["plan_fallbacks"] or \
            m["plan_join_fallbacks"]:
        failed.append(f"plan metrics {m}")
    if cuda and line["sync_check"] != "passed":
        failed.append(f"sync check: {line['sync_check']}")
    if cuda and name in ("q3", "q5") and \
            launches[f"{name}_eager"]["xxhash64_fixed_rows"] < 1:
        failed.append("the eager joins never launched B2")
    if failed:
        raise AssertionError(f"plan engine {name}: {failed}")
    log(f"check plan engine {name}: fused == eager == numpy, 0 fallbacks, "
        f"no sync inside the fused program")
    return launches


def default_knobs_q3(dev, tables, want, plan):
    """q3 fused once with the default knobs: the generic groupby overflows
    at SF10 and the query replays eagerly (one overflow fallback); the
    answer must still be right."""
    from spark_rapids_jni_tpu_torch import tpch
    from spark_rapids_jni_tpu_torch.plan import plan_metrics
    plan_metrics.reset()
    out, ms = wall(lambda: tpch.run_q3(*tables), dev)
    snap = plan_metrics.snapshot()
    res = {"first_ms": ms, "decisions": _decisions(plan, tables),
           "plan_fallbacks": snap["plan_fallbacks"],
           "plan_fallback_reasons": snap["plan_fallback_reasons"],
           "equals_numpy": _equals_numpy(out, want)}
    if not res["equals_numpy"]:
        raise AssertionError(f"q3 with the default knobs: {res}")
    return res


def forced_fallback(dev, card):
    """A GroupBy plan whose groups (2,500 ship dates) outnumber the slot
    budget (max_groups 16 gives the 1,024-slot floor) at 1M rows: the fused
    program must flag the overflow, the executor replay the query eagerly
    (one overflow fallback), and the answer equal the eager engine's."""
    from spark_rapids_jni_tpu_torch import tpch
    from spark_rapids_jni_tpu_torch.plan import (GroupBy, Scan, Sort,
                                                 execute_plan, plan_metrics,
                                                 run_eager)
    from spark_rapids_jni_tpu_torch.utils import config
    li = tpch.generate_q1_lineitem(1_000_000, 2, dev)
    plan = Sort(GroupBy(Scan(7), (6,), ((0, "sum"), (0, "count"))), (0,))
    plan_metrics.reset()
    with config.override("plan.max_groups", 16):
        got = execute_plan(plan, li)
    snap = plan_metrics.snapshot()
    want = run_eager(plan, li)
    line = {"phase": "forced_fallback_1m", **card, "rows": li.num_rows,
            "groups": got.num_rows, "plan_overflows": snap["plan_overflows"],
            "plan_fallback_reasons": snap["plan_fallback_reasons"],
            "equals_eager": _tables_equal(got, want)}
    jline(line)
    if (snap["plan_overflows"], snap["plan_fallback_reasons"]) != (
            1, {"overflow": 1}) or not line["equals_eager"]:
        raise AssertionError(f"forced fallback: {line}")
    log("check forced overflow at 1M rows: one overflow fallback, "
        "== eager")


def numpy_q1(a, cutoff=2400):
    """q1 over the generator's arrays, independent of the port: per
    (returnflag, linestatus) in ascending order, the four int64 sums, the
    three means (float64 sum / count) and the count."""
    keep = a["l_shipdate"] <= cutoff
    rf, ls = a["l_returnflag"][keep], a["l_linestatus"][keep]
    qty = a["l_quantity"][keep]
    price = a["l_extendedprice"][keep]
    disc = a["l_discount"][keep].astype(np.int64)
    tax = a["l_tax"][keep].astype(np.int64)
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    cols = [[] for _ in range(10)]
    for f in np.unique(rf):
        for s in np.unique(ls):
            g = (rf == f) & (ls == s)
            n = int(g.sum())
            if n == 0:
                continue
            sums = [v[g].sum() for v in (qty, price, disc_price, charge)]
            means = [np.float64(v[g].sum()) / np.float64(n)
                     for v in (qty, price, disc)]
            for i, v in enumerate([f, s] + sums + means + [n]):
                cols[i].append(v)
    types = [np.int32, np.int32] + [np.int64] * 4 + [np.float64] * 3 \
        + [np.int64]
    return [np.array(c, dtype=t) for c, t in zip(cols, types)]


def numpy_q6(a, date_lo=365, date_hi=730, disc_lo=5, disc_hi=7, qty=24):
    """q6 over the generator's arrays: one filtered int64 sum."""
    sd, disc = a["l_shipdate"], a["l_discount"]
    keep = ((sd >= date_lo) & (sd < date_hi) & (disc >= disc_lo)
            & (disc <= disc_hi) & (a["l_quantity"] < qty))
    return int((a["l_extendedprice"][keep]
                * disc[keep].astype(np.int64)).sum())


def numpy_q5(a, region=2, date_lo=700, date_hi=1065):
    """q5 over the generator's arrays: every key is an arange, so the
    joins are index lookups. Revenue per supplier nation, by revenue
    descending, then nation ascending."""
    od = a["o_orderdate"]
    ord_ok = (od >= date_lo) & (od < date_hi)
    lk, sk = a["l_orderkey"], a["l_suppkey"]
    snat = a["s_nationkey"][sk]
    cnat = a["c_nationkey"][a["o_custkey"][lk]]
    keep = (ord_ok[lk] & (a["n_regionkey"][snat] == region)
            & (cnat == snat))
    rev = a["l_extendedprice"][keep] * (
        100 - a["l_discount"][keep].astype(np.int64))
    nat = snat[keep]
    nations = np.unique(nat)
    sums = np.array([rev[nat == n].sum() for n in nations], np.int64)
    order = np.lexsort((nations, -sums))
    return [nations[order].astype(np.int32), sums[order]]


def numpy_q3(a, cutoff=1200, segment=1, k=10):
    """q3 over the generator's numpy arrays, independent of the port:
    c_custkey and o_orderkey are arange, so both joins are index lookups.
    Returns (orderkey, orderdate, shippriority, revenue) of the top k, by
    revenue descending, orderdate ascending, then orderkey."""
    cust_ok = a["c_mktsegment"] == segment
    ord_ok = (a["o_orderdate"] < cutoff) & cust_ok[a["o_custkey"]]
    lk = a["l_orderkey"]
    li_ok = (a["l_shipdate"] > cutoff) & ord_ok[lk]
    keys = lk[li_ok]
    rev = a["l_extendedprice"][li_ok] * (
        100 - a["l_discount"][li_ok].astype(np.int64))
    order = np.argsort(keys, kind="stable")
    ks, rs = keys[order], rev[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    sums = np.add.reduceat(rs, starts)
    uk = ks[starts]
    odate = a["o_orderdate"][uk]
    prio = a["o_shippriority"][uk]
    top = np.lexsort((uk, odate, -sums))[:k]
    return uk[top], odate[top], prio[top], sums[top]


if __name__ == "__main__":
    sys.exit(main())
