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
     does not start on 16 bytes; B1 and B2 over a 1M-row STRING column of
     random bytes 0-255 and lengths 0-100 (1% null) alone and first,
     middle and last among fixed-width columns, seeds 42 and 0; B3 with
     1-3 string slots; B2 at the edges of its staged STRING path
     (characters at every address residue mod 16, 1/31/33/1000 rows,
     all-empty and all-null columns, 2 and 3 STRING columns among
     fixed-width ones, 1M rows with ~1% strings of 2-8 KB, whose tiles
     take both the staged and the device-memory path: logged as
     ``b2_staging_tiles``);
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
     reaches); a profiler reading above its event time prints as a null
     ``kernel_ms`` (the reading stays as ``profiler_ms``); B1, B2 and B3
     at phase 7's string schema, each first held bit for bit against its
     plain version there, and B2 at a second string shape (16M strings of
     random bytes, lengths 0-100); the variable-width byte copies of the
     string table's first batch against their byte bounds, among them the
     window copy of a lone string column beside the general masked
     gather it stands in for (both must agree); and S1's batch
     boundaries by the device search beside a host read of the row sizes
     with the JAX package's rule (both must agree);
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
     must replay eagerly and equal the eager engine;
  7. ``strings_60m``: STRING columns through the Spark shuffle, a
     string-keyed aggregation and a string-keyed join, at 60M rows of the
     JAX package's string row-conversion table (utils/datagen
     .string_rows_table; bench_ops.py:109-137), launch counts set to 0
     just before and read just after the first pass: S1 map side
     (partition route on the STRING key, JCUDF rows in two batches whose
     boundaries follow the JAX package's rule), S2 reduce side (each batch
     back to columns, concatenated: the table bit for bit), S3 groupby on
     the STRING key (equal to numpy grouping by the strings' bytes), S4
     inner join to a dimension table of the distinct keys (60M pairs, each
     row to its key; B2 on the dimension key bit-exact against its plain
     version); per stage the first and warm (median of 5) wall ms,
     launches, peak memory, and one warm run under torch.profiler;
  8. float aggregates (kernel H1) and encoded columns over the same
     table, counted the same way: S5 float sum/mean/min/max over the
     STRING key (== numpy's sequential sum per group, bit for bit), S6
     S3's aggregates over the key as DICT32 (== S3), S7 S5 over the DICT32
     key (== S5), S8 the DICT32 key joined to the dimension on its
     dictionary (== S4's pairs), S9 a fused Filter -> GroupBy with a
     string literal over the DICT32 table (== eager, no fallback, no host
     sync), S10 the codes RLE-encoded as key with a FOR32 value (== the
     plain columns), and H1's worst case, two groups of ~30M (== numpy;
     timed against its chain bound and torch.segment_reduce); H1 against
     its plain version at S5's shape (timed there against its bound and
     torch.segment_reduce, with ns per row of the longest segment and the
     chain share) and on a 1M-row edge table of NaN payloads, ±0, ±inf and
     subnormals, its count of chunks folded on the flushed path against
     the rule (kernels.flushed_chunks_plain) at each; encode_strings at
     1M rows;
  9. ``memory_sf10``: the memory and fault domains at SF10 (RmmSpark
     reservations, the executor's OOM split rung, the governed shuffle and
     q3 stage with its reservation audit, a real CUDA OOM recovered by
     spill rollback);
 10. ``parquet_sf10``: the Parquet read path. Writes file A (the q1/q6
     lineitem, 60M rows) and file B (phase 7's string table, its key as
     dictionary codes, the last row's key a needle) with the port's
     parquet-mr-style writer (utils/datagen_parquet.py); reads both with
     ``read_parquet(path, device="cuda")`` on the device tier (the
     default) with the launch counts set to 0, runs the read tables
     through q1, q6, the shuffle write (B1, B3) and, the key read as
     DICT32, S6-S9 (H1, B2), and reads the counts; then holds every column
     of both tiers against the generated tables and each stage against
     the same stage over them, requires every column to take the device
     tier, checks iter_chunks against read_all, pushdown on the needle
     (every other row group pruned, the answer unchanged with pushdown
     off), a flipped bit at ``parquet_page`` (recovered and counted) and
     one column chunk decoded in a sandbox worker; times each file on
     each tier (first and warm median of 3, the read split into host
     extract, run walk, copy, device decode and reservation, peak device
     memory, one read under torch.profiler) beside a pinned copy of file
     A's bytes; and prunes file A's footer with ``read_and_filter`` (the
     plugin's ParquetFooter), whole and split at its midpoint;
 11. ``decimal_sf10``: DECIMAL128 end to end. Writes file C, lineitem at
     60M rows with TPC-H's DECIMAL(12, 2) money columns as
     FIXED_LEN_BYTE_ARRAY (the q1 draws, and l_orderkey); with the
     launch counts set to 0 reads it with a CUDA reader (the money
     columns on the host tier, counted ``host_columns_unsupported``, the
     rest on the device tier), runs q1 in Spark's decimal types on the
     eager ops (price * (1.00 - discount) and * (1.00 + tax) in kernel
     H2, DECIMAL128 sums and means by (returnflag, linestatus)), the
     decimal shuffle (B1 route, B3 rows with 16-byte slots, back and
     concatenated), both hashes over the charge column and a join on the
     discount (B2), and reads the counts; checks the read == the
     generated table, q1 == numpy (exact in int64; the means HALF_UP in
     Python ints), the round trip == its input, B1/B2 over DECIMAL128 ==
     plain, and H2 == plain, bit for bit, on 1M seeded rows per op, on
     the edge table and on the division table; then times the read
     (first, warm median of 3, the split), q1 and the shuffle (first,
     warm, peak, profile), the hashes over the decimal bytes, and H2's
     six ops at 60M rows (events, profiler, bound; operations bounds
     from the SASS at the card's instruction issue rate: the per-row
     reciprocals, 2-by-1 digit steps and hardware 64-bit divisions that
     this data takes in H2's long division, each at the fewest
     instructions the SASS gives it; the ptxas account and the SASS's
     local-memory loads and stores of each op's kernel);
 12. ``spark_features_sf10``: the slice's path at SF10, the launch counts
     set to 0 just before and read just after: Spark's runtime bloom
     filter on q3 (the o_orderkey values that pass q3's customer and
     order-date filters, their XxHash64 longs (B2) put into 8 partial
     filters with Spark's numBits and numHashes through B1's h1/h2 and
     OR-merged, every l_orderkey probed, q3 over the kept lineitem rows),
     the full join of late lineitem with early orders, fused q1 over a
     donated lineitem, hilbert_index of three lineitem columns, the
     LEGACY calendar rebase both ways over 60M microsecond and day
     values, both Asia/Kolkata conversions, and decimal_to_string of
     phase 11's q1 and of 1M of file C's prices; checks the merged filter
     == one put == plain (serialized bytes), every build key hits, the
     false-positive share in [2%, 4%], q3 over the kept rows == q3 ==
     numpy, the full join == left join + right anti rows, donated q1 ==
     undonated and the donated table raises, and each module == plain on
     1M rows; then times each (CUDA events, byte bounds) and the peaks of
     donated and undonated q1.

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
# The operations yardstick: instructions a card can issue, in thread
# instructions a second. Each SM's four warp schedulers issue at most one
# warp instruction (32 lanes) a clock (the Hopper SM: 4 partitions, one
# dispatch unit each; NVIDIA H100 architecture white paper), so the rate
# is SMs x 4 x 32 x the SM clock. main() sets it from the SM count and
# nvidia-smi's clocks.max.sm; until then the H100 SXM's 132 SMs at
# 1980 MHz. (The FP32 rate, 67e12, counts an FMA as two operations and
# is no bound on integer instructions.)
INSTRUCTION_RATE = {"per_s": 132 * 4 * 32 * 1.98e9, "sms": 132,
                    "mhz": 1980.0, "source": "H100 SXM data sheet"}
SF10_ROWS = 60_000_000      # lineitem rows; orders 15M, customer 1.5M
PARTITIONS = 200            # spark.sql.shuffle.partitions default


STRING_ROWS = 60_000_000    # phase 7: TPC-H SF10's lineitem count
# phase 10: a key value only file B's last row group holds (its bytes sort
# after every string of the generator's alphabet)
NEEDLE = "~phase-10-needle"
# the kernels of the SF10 main path and of phase 7 (H1 runs in phase 8)
ROW_KERNELS = ("murmur3_fixed_rows", "xxhash64_fixed_rows",
               "rowconv_fixed_words")
PHASE_SECONDS = {}
_PHASE_T0 = [time.perf_counter()]
BUILD_REPORTS = {}  # phase 2's nvcc -Xptxas -v report of each source


def phase_end(name):
    """Record the seconds since the last phase ended."""
    now = time.perf_counter()
    PHASE_SECONDS[name] = now - _PHASE_T0[0]
    _PHASE_T0[0] = now
    log(f"phase {name}: {PHASE_SECONDS[name]:.1f} s")


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
    for all calls; the kernels are attributed in launch order. A session
    that misses launches is run once more; a kernel it still misses reads
    None (not measured: the CUDA-event time ``ms`` stands)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for fn, _ in calls:
        fn()
    torch.cuda.synchronize()
    names = {k for _, k in calls}
    events = []
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn, _ in calls:
                for _ in range(reps):
                    fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA
                         and any(k in e.name for k in names)),
                        key=lambda e: e.time_range.start)
        if len(events) == reps * len(calls):
            break
        log(f"the profiler saw {len(events)} of {reps * len(calls)} "
            f"kernel launches (session {attempt + 1})")
    if len(events) != reps * len(calls):
        return [None] * len(calls)  # launch order no longer attributes
    out = []
    for _, kernel in calls:
        mine, events = events[:reps], events[reps:]
        if any(kernel not in e.name for e in mine):
            raise AssertionError(f"the profiler saw another kernel where "
                                 f"{kernel} launched")
        out.append(sum(e.time_range.elapsed_us() for e in mine) / 1e3 / reps)
    return out


def profiler_fields(kms, ms):
    """``kernel_ms`` from a profiler reading ``kms`` of a kernel whose
    launches take ``ms`` by CUDA events: null where the reading exceeds
    the event time (the kernel alone cannot take longer than its calls),
    and the reading itself as ``profiler_ms``."""
    return {"kernel_ms": kms if kms is not None and kms <= ms else None,
            "profiler_ms": kms}


# the CUDA kernel of each wrapper, by the name the profiler shows
# (B2: xxhash64_rows_kernel for fixed-width rows,
# xxhash64_staged_rows_kernel for rows with a STRING column)
DEVICE_KERNEL = {"murmur3_fixed_rows": "murmur3_rows_kernel",
                 "xxhash64_fixed_rows": "xxhash64_",
                 "rowconv_fixed_words": "rowconv_tiles_kernel"}


def bound_ms(nbytes, nops):
    """Least time for the work: the larger of its bytes over the memory
    rate and its operations (thread instructions) over the issue rate,
    and which one bounds it."""
    b = nbytes / HBM_BYTES_PER_S * 1e3
    o = nops / INSTRUCTION_RATE["per_s"] * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def read_instruction_rate(dev_index=0):
    """Set INSTRUCTION_RATE from this card: its SM count (torch) and its
    maximum SM clock (nvidia-smi clocks.max.sm, MHz)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[dev_index])
    sms = torch.cuda.get_device_properties(dev_index).multi_processor_count
    INSTRUCTION_RATE.update(
        per_s=sms * 4 * 32 * mhz * 1e6, sms=sms, mhz=mhz,
        source="this card: SM count x 4 x 32 x clocks.max.sm")


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
    from spark_rapids_jni_tpu_torch.utils import datagen

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
    read_instruction_rate()
    jline({"phase": "card", **card, "instruction_rate": INSTRUCTION_RATE})
    phase_end("card")

    # ---- phase 2: build -------------------------------------------------
    t = time.perf_counter()
    reports = K.build_all()
    BUILD_REPORTS.update(reports)
    log(f"built {sorted(reports) or 'nothing (up to date)'} in "
        f"{time.perf_counter() - t:.1f} s")
    for src, rep in reports.items():
        for line in rep.splitlines():
            if "Compiling entry function" in line or "registers" in line \
                    or "spill" in line:
                log(f"  {src}.cu: {line.strip()}")

    phase_end("build")

    # ---- phases 3 and 4 ---------------------------------------------------
    state = check_kernels(dev, SF10_ROWS)
    check_string_kernels(dev, 1 << 20)
    t = time.perf_counter()
    strings = datagen.string_rows_table(STRING_ROWS, 0, device=dev)
    _sync(dev)
    strings_gen_s = time.perf_counter() - t
    phase_end("check_kernels")
    launches, summary = main_path(dev, state)
    for wrapper, count in launches.items():
        if wrapper in ROW_KERNELS and count < 1:
            raise AssertionError(f"the SF10 main path never launched "
                                 f"{wrapper}")
    jline({"phase": "main_path_sf10", **card, **summary})
    phase_end("main_path")

    # ---- phase 5: timings -------------------------------------------------
    entries = timings(state, launches, card, strings)
    breakdown(state, card)
    variable_width_copy_times(card, strings)
    batch_boundary_times(card, strings)
    phase_end("timings")

    # ---- phase 6: the plan engine -----------------------------------------
    paths = {"main_path_sf10": launches, **plan_engine(dev, state, card)}
    phase_end("plan_engine")
    del state

    # ---- phase 7: strings -------------------------------------------------
    paths["strings_60m"] = strings_phase(dev, card, strings, strings_gen_s)
    phase_end("strings_60m")

    # ---- phase 8: float aggregates and encoded columns --------------------
    paths["strings_60m_encoded"], h1 = encoded_phase(dev, card, strings)
    entries.append(h1)
    del strings
    phase_end("encoded")

    # ---- phase 9: the memory and fault domains ----------------------------
    paths["memory_sf10_governed"] = memory_phase(dev, card, SF10_ROWS)
    phase_end("memory_sf10")

    # ---- phase 10: the Parquet read path ----------------------------------
    paths["parquet_sf10"] = parquet_phase(dev, card, SF10_ROWS)
    phase_end("parquet_sf10")

    # ---- phase 11: DECIMAL128 ----------------------------------------------
    paths["decimal_sf10"], h2, decimal_keep = decimal_phase(dev, card,
                                                            SF10_ROWS)
    entries.append(h2)
    phase_end("decimal_sf10")

    # ---- phase 12: Spark's runtime filter and the slice's features --------
    paths["spark_features_sf10"] = features_phase(dev, card, SF10_ROWS,
                                                  decimal_keep)
    del decimal_keep
    phase_end("spark_features_sf10")
    for entry, (_, wrapper, _, _) in zip(entries, K.KERNELS):
        entry["launches_by_path"] = {p: c[wrapper] for p, c in paths.items()}
    jline({"phase_seconds": PHASE_SECONDS})
    jline({"kernels": entries})
    jline({"ok": True, "device": {"platform": "gpu", "kind": name,
                                  "count": torch.cuda.device_count()}})
    return 0


def _schema(cols, for_xx):
    """The B1/B2 schema of columns, as ops/hashing._hash_rows builds it."""
    from spark_rapids_jni_tpu_torch.columnar.dtype import TypeId
    from spark_rapids_jni_tpu_torch.ops import hashing as H
    return [(("str", (c.offsets, c.data)) if c.dtype.id is TypeId.STRING
             else H._fixed_element_words(c.dtype, c.data, for_xx))
            + (c.validity,) for c in cols]


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


def check_string_kernels(dev, n):
    """Phase 3, strings: B1 and B2 over a STRING column of random bytes
    0-255, lengths 0-100, 1% null, alone and first, middle and last among
    fixed-width columns, seeds 42 and 0; B3 with 1-3 string slots; B2 at
    its staging edges (check_b2_staging). Every kernel bit-exact against
    its plain version."""
    from spark_rapids_jni_tpu_torch.columnar import dtype as dt
    from spark_rapids_jni_tpu_torch.columnar.column import Column, Table
    from spark_rapids_jni_tpu_torch.ops import kernels as K
    from spark_rapids_jni_tpu_torch.utils import datagen

    rng = np.random.default_rng(7)
    s = datagen.random_bytes_column(n, 100, 0.01, seed=1, device=dev)
    fixed = [Column.from_numpy(rng.integers(-2**62, 2**62, n), dt.INT64,
                               validity=rng.random(n) > 0.1, device=dev),
             Column.from_numpy(rng.standard_normal(n).astype(np.float32),
                               device=dev),
             Column.from_numpy(rng.integers(0, 2, n).astype(np.uint8),
                               dt.BOOL8, device=dev)]
    layouts = {"only": [s], "first": [s, *fixed],
               "middle": [fixed[0], s, *fixed[1:]], "last": [*fixed, s]}
    for algo, fn, plain in (
            ("B1", K.murmur3_fixed_rows, K.murmur3_fixed_rows_plain),
            ("B2", K.xxhash64_fixed_rows, K.xxhash64_fixed_rows_plain)):
        for where, cols in layouts.items():
            sch = _schema(cols, algo == "B2")
            for seed in (42, 0):
                got = fn(sch, seed, n)
                _sync(dev)
                if not torch.equal(got, plain(sch, seed, n)):
                    raise AssertionError(f"{algo} string {where} seed "
                                         f"{seed}: differs")
        log(f"check {algo} STRING (bytes 0-255, lengths 0-100, 1% null) "
            f"alone/first/middle/last, seeds 42 and 0: bit-exact over {n} "
            f"rows")
    for nstr in (1, 2, 3):
        cols = []
        for i in range(nstr):
            cols += [fixed[i], datagen.random_bytes_column(
                n, 40, 0.1, seed=10 + i, device=dev)]
        args = _rowconv_args(Table(tuple(cols)))
        got = K.rowconv_fixed_words(*args)
        _sync(dev)
        if not torch.equal(got, K.rowconv_fixed_words_plain(*args)):
            raise AssertionError(f"B3 with {nstr} string slot(s): differs")
        log(f"check B3 with {nstr} string slot(s): bit-exact, {args[3]} "
            f"words x {n} rows")
    check_b2_staging(dev, n)


def at_residue(col, r, row0):
    """STRING column ``col`` from row ``row0`` on (its offsets no longer
    start at 0), its characters copied to an address that is r mod 16."""
    from spark_rapids_jni_tpu_torch.columnar import dtype as dt
    from spark_rapids_jni_tpu_torch.columnar.column import Column
    buf = torch.empty(col.data.numel() + 32, dtype=torch.uint8,
                      device=col.data.device)
    start = (r - buf.data_ptr()) % 16
    data = buf[start:start + col.data.numel()]
    data.copy_(col.data)
    v = None if col.validity is None else col.validity[row0:]
    return Column(dt.STRING, col.size - row0, data=data, validity=v,
                  offsets=col.offsets[row0:])


def long_strings_column(n, seed, device):
    """A STRING column of ``n`` rows, lengths 0-100 but ~1% of 2-8 KB,
    bytes 0-255, 1% null: B2 stages most tiles whole, splits the tiles
    that hold a long string, and hashes the long strings from device
    memory."""
    from spark_rapids_jni_tpu_torch.columnar import dtype as dt
    from spark_rapids_jni_tpu_torch.columnar.column import Column
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 101, n)
    long = rng.random(n) < 0.01
    lengths[long] = rng.integers(2048, 8001, int(long.sum()))
    offs = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(lengths, out=offs[1:])
    chars = rng.integers(0, 256, int(offs[-1]), dtype=np.uint8)
    return Column(dt.STRING, n, data=torch.from_numpy(chars).to(device),
                  validity=torch.from_numpy(rng.random(n) > 0.01).to(device),
                  offsets=torch.from_numpy(offs).to(device))


def b2_staging_cases(dev, n_long):
    """{label: columns} of B2's staging edges: characters at every
    address residue mod 16 with offsets not starting at 0; 1, 31, 33 and
    1000 rows (ragged tiles); all-empty and all-null columns; two and three
    STRING columns among fixed-width ones; ``n_long`` rows with ~1% long
    strings (both the staged and the device-memory path in one launch)."""
    from spark_rapids_jni_tpu_torch.columnar import dtype as dt
    from spark_rapids_jni_tpu_torch.columnar.column import Column
    from spark_rapids_jni_tpu_torch.utils import datagen

    rng = np.random.default_rng(21)
    base = datagen.random_bytes_column(4099, 100, 0.05, seed=20, device=dev)
    cases = {f"residue {r}": [at_residue(base, r, r + 1)] for r in range(16)}
    for n in (1, 31, 33, 1000):
        cases[f"n {n}"] = [datagen.random_bytes_column(n, 100, 0.1, seed=n,
                                                       device=dev)]
    cases["all empty"] = [datagen.random_bytes_column(1000, 0, seed=2,
                                                      device=dev)]
    cases["all null"] = [datagen.random_bytes_column(1000, 100, 1.0, seed=3,
                                                     device=dev)]
    m = 5003
    fixed = [Column.from_numpy(rng.integers(-2**62, 2**62, m), dt.INT64,
                               validity=rng.random(m) > 0.1, device=dev),
             Column.from_numpy(rng.integers(-2**31, 2**31, m)
                               .astype(np.int32), device=dev)]
    strs = [datagen.random_bytes_column(m, 60 * (i + 1), 0.1, seed=30 + i,
                                        device=dev) for i in range(3)]
    cases["2 strings among fixed"] = [fixed[0], strs[0], fixed[1], strs[1]]
    cases["3 strings among fixed"] = [strs[0], fixed[0], strs[1], fixed[1],
                                      strs[2]]
    cases["1% long strings"] = [long_strings_column(n_long, 5, dev)]
    return cases


def check_b2_staging(dev, n_long):
    """Phase 3: B2 bit-exact against its plain version at its staging
    edges (b2_staging_cases); logs how the tiles of the long-string case
    split between the staged and the device-memory path (by the tile plan,
    ops/kernels.xxhash64_tile_plan)."""
    from spark_rapids_jni_tpu_torch.ops import kernels as K

    cases = b2_staging_cases(dev, n_long)
    for label, cols in cases.items():
        sch = _schema(cols, True)
        n = cols[0].size
        for seed in (42, 0):
            got = K.xxhash64_fixed_rows(sch, seed, n)
            _sync(dev)
            if not torch.equal(got, K.xxhash64_fixed_rows_plain(sch, seed,
                                                                 n)):
                raise AssertionError(f"B2 staging, {label}, seed {seed}: "
                                     f"differs")
    log(f"check B2 staging edges (residues 0-15, n 1/31/33/1000, all "
        f"empty, all null, 2 and 3 strings among fixed, {n_long} rows with "
        f"1% long strings), seeds 42 and 0: bit-exact")
    col = cases["1% long strings"][0]
    tiles = K.xxhash64_tile_plan(col.offsets.cpu().numpy(),
                                 col.data.data_ptr() % 16)
    one = sum(len(t.windows) == 1 and not t.device_rows for t in tiles)
    with_dev = sum(bool(t.device_rows) for t in tiles)
    windows = sum(len(t.windows) for t in tiles)
    dev_rows = sum(len(t.device_rows) for t in tiles)
    jline({"phase": "b2_staging_tiles", "rows": col.size,
           "stage_bytes": K.XX_STAGE_BYTES, "tiles": len(tiles),
           "staged_in_one_window": one,
           "staged_in_several_windows": len(tiles) - one - with_dev,
           "with_device_rows": with_dev, "windows": windows,
           "device_rows": dev_rows})
    if not windows or not dev_rows:
        raise AssertionError("the long-string case ran only one B2 path")


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
    launches = _kernel_counts()
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


def timings(state, launches, card, strings):
    """Phase 5: each kernel's device time at the main path's SF10 shape,
    its plain version's, and its bound; then at the string schema of
    phase 7 (``strings``). Returns the kernel entries (SF10 shapes)."""
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
    # one profiler session for the SF10 shapes and one for the string
    # schema's (string_kernel_lines): torch.profiler drops kernel events
    # once a process has run many sessions
    hashes_rowconv = [k for k in K.KERNELS if k[1] in work]  # H1: phase 8
    k_ms = kernel_ms(
        [(work[w][0], DEVICE_KERNEL[w]) for _, w, _, _ in hashes_rowconv]
        + [((lambda a=a: K.rowconv_fixed_words(*a)),
            DEVICE_KERNEL["rowconv_fixed_words"]) for a in b3.values()])
    string_kernel_lines(card, string_kernel_work(strings), strings.num_rows,
                        "strings_60m")
    wide = b2_second_shape(16_000_000)
    string_kernel_lines(card, {"xxhash64_fixed_rows": b2_string_work(wide)},
                        wide.size, "random_bytes_16m_0_100")
    del wide
    entries = []
    for i, (kname, wrapper, source, replaces) in enumerate(hashes_rowconv):
        run, plain, nbytes, nops = work[wrapper]
        b_ms, b_by = bound_ms(nbytes, nops)
        ms = cuda_ms(run)
        entry = {"name": kname, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[wrapper],
                 "bit_exact": True, "max_abs_err": 0, "ms": ms,
                 **profiler_fields(k_ms[i], ms),
                 "plain_ms": cuda_ms(plain, reps=3, warm=1),
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        jline({"phase": "kernel_time", "rows": n, **card, **entry})
        entries.append(entry)
    for i, (label, args) in enumerate(b3.items(), len(hashes_rowconv)):
        nbytes = _rowconv_bytes(args)
        b_ms, b_by = bound_ms(nbytes, args[4] * 3 * len(args[2]))
        ms = cuda_ms(lambda: K.rowconv_fixed_words(*args))
        jline({"phase": f"rowconv_time_{label}", **card, "rows": args[4],
               "columns": len(args[0]), "row_bytes": 4 * args[3],
               "bytes": nbytes, "ms": ms, **profiler_fields(k_ms[i], ms),
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


def _fresh(col):
    """The same column as a new Column object (a Table: each column): no
    padded-bytes memo, so a timed stage pads its string keys itself."""
    import dataclasses
    from spark_rapids_jni_tpu_torch.columnar.column import Table
    if isinstance(col, Table):
        return Table(tuple(dataclasses.replace(c) for c in col.columns))
    return dataclasses.replace(col)


def _same_table(a, b) -> bool:
    """Same dtypes, bytes (values, characters, offsets) and validity
    presence and bits."""
    for x, y in zip(a.columns, b.columns):
        if x.dtype != y.dtype or x.size != y.size \
                or (x.validity is None) != (y.validity is None):
            return False
        pairs = [(x.data.view(torch.uint8), y.data.view(torch.uint8))]
        if x.offsets is not None:
            pairs.append((x.offsets, y.offsets))
        if x.validity is not None:
            pairs.append((x.validity, y.validity))
        if not all(torch.equal(p, q) for p, q in pairs):
            return False
    return a.num_columns == b.num_columns


def strings_phase(dev, card, table, gen_s):
    """Phase 7: STRING columns through S1-S4 over ``table``, the string
    row table (see the module docstring), made in ``gen_s`` seconds.
    Returns the launches of the counted first pass, by wrapper."""
    from spark_rapids_jni_tpu_torch.columnar import dtype as dt
    from spark_rapids_jni_tpu_torch.columnar.column import Column
    from spark_rapids_jni_tpu_torch.columnar.table_ops import concat_tables
    from spark_rapids_jni_tpu_torch.ops import kernels as K
    from spark_rapids_jni_tpu_torch.ops import row_conversion as R
    from spark_rapids_jni_tpu_torch.ops.groupby import groupby_aggregate
    from spark_rapids_jni_tpu_torch.ops.join import inner_join
    from spark_rapids_jni_tpu_torch.parallel.exchange import partition_ids
    from spark_rapids_jni_tpu_torch.utils import datagen

    cuda = dev.type == "cuda"
    rows = table.num_rows
    # the generator's own draws: each row's pool entry, for the checks
    draws = datagen.string_draws(rows, datagen.STRING_ROWS_PROFILE,
                                 np.random.default_rng(0), None)
    keys, pool_gid = np.unique(np.array(draws.pool_strings(), dtype=object),
                               return_inverse=True)
    gid = pool_gid[draws.index]
    info = R.compute_column_information([c.dtype for c in table])
    sizes = (info.size_per_row + draws.lengths + 7) // 8 * 8
    dtypes = [c.dtype for c in table]
    aggs = [(0, "sum"), (0, "count"), (1, "min"), (1, "max")]
    dim = Column.from_pylist(list(keys), dt.STRING, device=dev)
    jline({"phase": "strings_table", **card, "rows": rows,
           "device_bytes": table.device_nbytes(),
           "string_bytes": int(table[4].data.numel()),
           "distinct_keys": len(keys), "size_per_row": info.size_per_row,
           "jcudf_bytes": int(sizes.sum()), "generate_s": gen_s})

    out = {}
    stages = {
        "S1_map_side": lambda: (partition_ids(_fresh(table), [4],
                                              PARTITIONS),
                                R.convert_to_rows(_fresh(table))),
        "S2_reduce_side": lambda: concat_tables(
            [R.convert_from_rows(b, dtypes) for b in out["S1_map_side"][1]]),
        "S3_aggregate": lambda: groupby_aggregate(
            _fresh(out["S2_reduce_side"]), [4], aggs),
        "S4_dimension_join": lambda: inner_join(
            [_fresh(out["S2_reduce_side"][4])], [_fresh(dim)]),
    }
    lines = {}
    K.reset_launches()
    for name, fn in stages.items():  # the counted first pass
        before = _kernel_counts()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        out[name], first = wall(fn, dev)
        lines[name] = {
            "phase": "strings_stage", **card, "stage": name, "rows": rows,
            "first_ms": first,
            "launches": {w: c - before[w]
                         for w, c in _kernel_counts().items()},
            "max_memory_allocated_gb": (torch.cuda.max_memory_allocated()
                                        / 1e9 if cuda else None)}
    launches = _kernel_counts()
    log(f"strings_60m launches: {launches}")
    for wrapper, count in launches.items():
        if cuda and wrapper in ROW_KERNELS and count < 1:
            raise AssertionError(f"strings_60m never launched {wrapper}")

    # S1: partition ids against the plain version on the same device;
    # two batches at the JAX package's boundaries
    pids, batches = out["S1_map_side"]
    sch = _schema([table[4]], False)
    plain = ((K.murmur3_fixed_rows_plain(sch, 42, rows).to(torch.int64)
              & 0xFFFFFFFF) % PARTITIONS).to(torch.int32)
    bounds = R._batch_boundaries(sizes, R.MAX_BATCH_BYTES)
    got_bounds = [0] + np.cumsum([b.size for b in batches]).tolist()
    checks = {
        "S1_partition_ids_equal_plain": torch.equal(pids, plain),
        "S1_batches": len(batches),
        "S1_boundaries_follow_the_rule": got_bounds == bounds,
        "S1_batch_bytes": [int(b.offsets[-1]) for b in batches] == [
            int(sizes[b0:b1].sum()) for b0, b1 in zip(bounds, bounds[1:])],
        "S2_round_trip_bit_for_bit": _same_table(table,
                                                 out["S2_reduce_side"]),
    }
    del plain
    # B2 on S4's right key, the dimension table's, against its plain
    # version at that shape (on the left key, T's, in phase 5)
    dsch = _schema([dim], True)
    checks["S4_dimension_key_B2_equal_plain"] = torch.equal(
        K.xxhash64_fixed_rows(dsch, 42, dim.size),
        K.xxhash64_fixed_rows_plain(dsch, 42, dim.size))
    # S3: numpy groups by the strings' bytes (pool entries can repeat)
    agg = out["S3_aggregate"]
    v0 = table[0].data.cpu().numpy()
    v1 = table[1].data.cpu().numpy().astype(np.int64)
    ng = len(keys)
    lo_sum = np.bincount(gid, weights=v0 & 0xFFFF, minlength=ng)
    hi_sum = np.bincount(gid, weights=v0 >> 16, minlength=ng)
    present = np.bincount(gid * 100 + v1, minlength=ng * 100).reshape(ng, 100)
    want = [np.round(hi_sum).astype(np.int64) * 65536
            + np.round(lo_sum).astype(np.int64),
            np.bincount(gid, minlength=ng),
            (present > 0).argmax(axis=1),              # least value
            99 - (present[:, ::-1] > 0).argmax(axis=1)]  # greatest value
    checks["S3_keys_equal_numpy"] = (
        agg.num_rows == ng
        and agg[0].to_pylist() == [k.decode() for k in keys])
    checks["S3_aggregates_equal_numpy"] = all(
        np.array_equal(c.to_numpy().astype(np.int64), w)
        for c, w in zip(agg.columns[1:], want))
    # S4: every row matches exactly its own key in the dimension table
    l_idx, r_idx = out["S4_dimension_join"]
    checks["S4_pairs"] = int(l_idx.numel())
    checks["S4_each_row_to_its_key"] = (
        torch.equal(l_idx, torch.arange(rows, device=dev))
        and torch.equal(r_idx, torch.from_numpy(gid).to(dev)))
    jline({"phase": "strings_checks", **card, **checks})
    failed = [k for k, v in checks.items() if v is not True
              and k not in ("S1_batches", "S4_pairs")]
    if checks["S4_pairs"] != rows:
        failed.append("S4_pairs")
    if rows == STRING_ROWS and len(batches) != 2:  # 3.4 GB of rows
        failed.append("S1_batches")
    if failed:
        raise AssertionError(f"strings_60m: {failed}")
    log(f"check strings_60m: S1 pids == plain, {len(batches)} batch(es) "
        f"at the rule's boundaries {bounds}, S2 round trip bit-identical, "
        f"S3 == numpy ({ng} groups by bytes), S4 {rows} pairs, each row "
        f"to its key")

    if cuda:
        for name, fn in stages.items():
            warm = sorted(wall(fn, dev)[1] for _ in range(5))
            lines[name].update(warm_median_ms=warm[2], warm_ms=warm,
                               profile=profile_once(fn))
            jline(lines[name])
    else:
        for line in lines.values():
            jline(line)
    del out, batches
    return launches


def string_key_draws(rows):
    """(keys, gid): the string table's distinct key bytes in byte order,
    and each row's index among them, from the generator's own draws."""
    from spark_rapids_jni_tpu_torch.utils import datagen
    draws = datagen.string_draws(rows, datagen.STRING_ROWS_PROFILE,
                                 np.random.default_rng(0), None)
    keys, pool_gid = np.unique(np.array(draws.pool_strings(), dtype=object),
                               return_inverse=True)
    return keys, pool_gid[draws.index]


def _same_col(a, b) -> bool:
    """Same dtype, rows, value bytes (characters and offsets of a STRING;
    the strings of a DICT32) and validity bits."""
    from spark_rapids_jni_tpu_torch.columnar import dictionary as D
    a = D.materialize(a) if D.is_dict(a) else a
    b = D.materialize(b) if D.is_dict(b) else b
    if a.dtype != b.dtype or a.size != b.size:
        return False
    if not torch.equal(a.valid_mask(), b.valid_mask()):
        return False
    if a.offsets is not None and not torch.equal(a.offsets, b.offsets):
        return False
    return torch.equal(a.data.view(torch.uint8), b.data.view(torch.uint8))


def _same_cols(a, b) -> bool:
    return (a.num_columns == b.num_columns
            and all(_same_col(x, y) for x, y in zip(a.columns, b.columns)))


def _numpy_groups(gid, ng, v):
    """Per group of ``gid`` (table order within a group): the sequential
    sum (np.cumsum), min, max and count of float64 ``v``."""
    order = np.argsort(gid, kind="stable")
    vs = v[order]
    bounds = np.searchsorted(gid[order], np.arange(ng + 1))
    sums = np.array([np.cumsum(vs[b:e])[-1] for b, e in
                     zip(bounds[:-1], bounds[1:])])
    seg = np.repeat(np.arange(ng), np.diff(bounds))
    mins = np.full(ng, np.inf)
    np.minimum.at(mins, seg, vs)
    maxs = np.full(ng, -np.inf)
    np.maximum.at(maxs, seg, vs)
    return sums, mins, maxs, np.diff(bounds)


def _h1_args(key, z):
    """(z, valid, starts) of the float64 values ``z`` grouped by the int64
    group ids ``key`` (sorted by a stable sort, as the groupby sorts)."""
    order = torch.sort(key, stable=True).indices
    k = key.index_select(0, order)
    ids = torch.arange(int(k[-1]) + 2, device=k.device)
    return (z.index_select(0, order),
            torch.ones(z.shape[0], dtype=torch.bool, device=z.device),
            torch.searchsorted(k, ids))


def h1_counted(z, valid, starts):
    """H1's (sum, min, max) and its count of chunks folded on the flushed
    path (the plain version's rule on the CPU)."""
    from spark_rapids_jni_tpu_torch.ops import kernels as K
    cnt = torch.zeros(1, dtype=torch.int64, device=z.device)
    out = K.segment_float_agg(z, valid, starts, flushed=cnt)
    return out, int(cnt)


def h1_entry(card, z, valid, starts, launches):
    """H1 at one shape: held bit for bit against its plain version, then
    its time by CUDA events, the plain version's, the bound (the larger of
    the byte bound and the longest segment's chain of dependent f64 adds
    at this card's add latency, measured here), and torch.segment_reduce
    as a yardstick that does not give the same bits."""
    from spark_rapids_jni_tpu_torch.ops import kernels as K
    n, G = z.shape[0], starts.shape[0] - 1
    got, flushed = h1_counted(z, valid, starts)
    want = K.segment_float_agg_plain(z, valid, starts)
    if not all(torch.equal(g.view(torch.int64), w.view(torch.int64))
               for g, w in zip(got, want)):
        raise AssertionError(f"H1 at {n} rows, {G} segments: differs "
                             f"from its plain version")
    rule = K.flushed_chunks_plain(z, valid, starts)
    if flushed != rule:
        raise AssertionError(f"H1 at {n} rows flushed {flushed} chunks, "
                             f"its rule {rule}")
    lens = starts[1:] - starts[:-1]
    longest = int(lens.max())
    entry = {"name": "H1 segment_float_agg", "route": "cuda",
             "source": K.KERNELS[3][2], "replaces": K.KERNELS[3][3],
             "launches": launches, "rows": n, "segments": G,
             "longest_segment": longest, "bit_exact": True,
             "max_abs_err": 0, "flushed_chunks": flushed, **card}
    if z.device.type != "cuda":  # a CPU rehearsal times nothing
        return entry
    add_ns = K.dadd_chain_ms(10_000_000, z.device) * 1e6 / 1e7
    nbytes = n * 9 + (G + 1) * 8 + 3 * G * 8
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    chain_ms = longest * add_ns / 1e6
    ms = cuda_ms(lambda: K.segment_float_agg(z, valid, starts), reps=5)
    entry.update(
        ms=ms, ns_per_row=ms * 1e6 / longest, chain_share=chain_ms / ms,
        plain_ms=wall(lambda: K.segment_float_agg_plain(z, valid, starts),
                      z.device)[1],
        bound_ms=max(byte_ms, chain_ms),
        bound_by="bytes" if byte_ms >= chain_ms else "operations",
        byte_bound_ms=byte_ms, chain_bound_ms=chain_ms,
        dadd_latency_ns=add_ns,
        library_ms=cuda_ms(lambda: torch.segment_reduce(
            z, "sum", lengths=lens), reps=5),
        library_call="torch.segment_reduce(z, 'sum'), not bit-equal")
    return entry


# the aggregates of S3/S6 and S5/S7 over the string table (key column 4)
S3_AGGS = [(0, "sum"), (0, "count"), (1, "min"), (1, "max")]
S5_AGGS = [(2, "sum"), (2, "mean"), (2, "min"), (2, "max"), (2, "count")]


def plan_s9(needle):
    """S9: a fused Filter -> GroupBy over the string table, with a string
    literal on the DICT32 key."""
    from spark_rapids_jni_tpu_torch.plan import Filter, GroupBy, Scan, col, lit
    return GroupBy(Filter(Scan(5), (col(1) < lit(50))
                          & (col(4) != lit(needle))),
                   (4,), ((2, "sum"), (2, "mean"), (2, "min"), (2, "max"),
                          (0, "sum"), (0, "count")))


def encoded_phase(dev, card, table, edge_rows=1 << 20):
    """Phase 8: float aggregates (kernel H1) and encoded columns over the
    string table ``table`` (phase 7's), stages S5-S10 and H1's two-group
    case, launch counts set to 0 just before and read just after the
    counted first pass; then every check; H1 against its plain version at
    S5's shape and on an edge table of ``edge_rows`` rows; encode_strings
    at 1M rows. Returns (launches, the H1 entry of the kernels line)."""
    from spark_rapids_jni_tpu_torch.columnar import dictionary as D
    from spark_rapids_jni_tpu_torch.columnar import dtype as dt
    from spark_rapids_jni_tpu_torch.columnar import encodings as E
    from spark_rapids_jni_tpu_torch.columnar.column import Column, Table
    from spark_rapids_jni_tpu_torch.ops import groupby as GB
    from spark_rapids_jni_tpu_torch.ops import kernels as K
    from spark_rapids_jni_tpu_torch.ops.join import inner_join
    from spark_rapids_jni_tpu_torch.plan import (execute_plan, plan_metrics,
                                                 resolve_literals, run_eager)
    from spark_rapids_jni_tpu_torch.plan.expr import Lit
    from spark_rapids_jni_tpu_torch.utils import datagen

    cuda = dev.type == "cuda"
    rows = table.num_rows
    keys, gid = string_key_draws(rows)
    ng = len(keys)
    codes = torch.from_numpy(gid.astype(np.int32)).to(dev)
    # the DICT32 key as a dictionary page hands it over: the entries, and
    # each row's code
    values = D.values_from_entries(list(keys), dev)
    dkey = D.dict_column(codes, values, validity=table[4].validity)
    td = Table(table.columns[:4] + (dkey,))
    dim = D.dict_column(torch.arange(ng, device=dev), values)
    t = time.perf_counter()
    tr = Table((E.rle_encode(Column(dt.INT32, rows, data=codes)),
                E.for_encode(table[1])))
    encode_s = time.perf_counter() - t
    tr_plain = Table((Column(dt.INT32, rows, data=codes), table[1]))
    s3_aggs, s5_aggs = S3_AGGS, S5_AGGS
    s10_aggs = [(1, "min"), (1, "max"), (1, "sum"), (1, "count")]
    needle = keys[min(7, ng - 1)].decode()
    plan9 = plan_s9(needle)
    jline({"phase": "encoded_table", **card, "rows": rows,
           "dictionary_entries": ng,
           "dict_key_device_bytes": dkey.device_nbytes(),
           "string_key_device_bytes": table[4].device_nbytes(),
           "rle_runs": E.num_runs(tr[0]), "for_width": E.for_width(tr[1]),
           "for_packed_bytes": int(tr[1].data.numel()),
           "host_encode_s": encode_s})
    stages = {
        "S5_float_aggregate": lambda: GB.groupby_aggregate(
            _fresh(table), [4], s5_aggs),
        "S6_dict_aggregate": lambda: GB.groupby_aggregate(td, [4], s3_aggs),
        "S7_dict_float_aggregate": lambda: GB.groupby_aggregate(
            td, [4], s5_aggs),
        "S8_dict_join": lambda: inner_join([dkey], [dim]),
        "S9_fused_dict_plan": lambda: execute_plan(plan9, td),
        "S10_rle_for_aggregate": lambda: GB.groupby_aggregate(
            tr, [0], s10_aggs),
        "H1_two_groups": lambda: GB.groupby_aggregate(
            table, [3], [(2, "sum"), (2, "mean")]),
    }
    out, lines = {}, {}
    K.reset_launches()
    plan_metrics.reset()
    for name, fn in stages.items():  # the counted first pass
        before = _kernel_counts()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        out[name], first = wall(fn, dev)
        lines[name] = {
            "phase": "encoded_stage", **card, "stage": name, "rows": rows,
            "first_ms": first,
            "launches": {w: c - before[w]
                         for w, c in _kernel_counts().items()},
            "max_memory_allocated_gb": (torch.cuda.max_memory_allocated()
                                        / 1e9 if cuda else None)}
    launches = _kernel_counts()
    snap = plan_metrics.snapshot()
    log(f"encoded launches: {launches}")
    for wrapper in ("segment_float_agg", "xxhash64_fixed_rows"):
        if cuda and launches[wrapper] < 1:
            raise AssertionError(f"phase 8 never launched {wrapper}")

    checks = {"dict_key_materializes_to_the_string_key":
              _same_col(D.materialize(dkey), table[4])}
    # S5: numpy per group in table order (sequential sums: standard normal
    # values, no flush can occur)
    v = table[2].data.cpu().numpy()
    sums, mins, maxs, cnt = _numpy_groups(gid, ng, v)
    s5 = out["S5_float_aggregate"]
    checks["S5_keys_equal_numpy"] = (
        s5.num_rows == ng and s5[0].to_pylist() == [k.decode() for k in keys])
    checks["S5_equal_numpy"] = all(
        np.array_equal(c.to_numpy().view(np.uint64), w.view(np.uint64))
        for c, w in zip(s5.columns[1:5], (sums, sums / cnt, mins, maxs))
    ) and np.array_equal(s5[5].to_numpy(), cnt)
    ref3 = GB.groupby_aggregate(table, [4], s3_aggs)
    checks["S6_equals_S3_bit_for_bit"] = _same_cols(out["S6_dict_aggregate"],
                                                    ref3)
    checks["S6_key_stays_dict32"] = D.is_dict(out["S6_dict_aggregate"][0])
    checks["S7_equals_S5_bit_for_bit"] = _same_cols(
        out["S7_dict_float_aggregate"], s5)
    l_idx, r_idx = out["S8_dict_join"]
    checks["S8_equals_S4_pairs"] = (
        torch.equal(l_idx, torch.arange(rows, device=dev))
        and torch.equal(r_idx, torch.from_numpy(gid).to(dev)))
    resolved = resolve_literals(plan9, td)
    lit_code = resolved.child.predicate.right.right
    checks["S9_literal_resolved_to_its_code"] = (
        isinstance(lit_code, Lit)
        and lit_code.value == D.lookup_code(dkey, needle) >= 0)
    checks["S9_fused_equals_eager"] = _same_cols(
        out["S9_fused_dict_plan"], run_eager(resolved, td))
    checks["S9_no_fallback"] = (snap["plan_fallbacks"] == 0
                                and snap["plan_executes"] == 1)
    checks["S9_sync_check"] = (sync_free(plan9, td) if cuda
                               else "not checked on the cpu")
    checks["S10_equals_plain_columns"] = _same_cols(
        out["S10_rle_for_aggregate"],
        GB.groupby_aggregate(tr_plain, [0], s10_aggs))
    b3 = table[3].data.cpu().numpy().astype(np.int64)
    sums2, _, _, cnt2 = _numpy_groups(b3, 2, v)
    two = out["H1_two_groups"]
    checks["H1_two_groups_equal_numpy"] = (
        np.array_equal(two[1].to_numpy().view(np.uint64),
                       sums2.view(np.uint64))
        and np.array_equal(two[2].to_numpy().view(np.uint64),
                           (sums2 / cnt2).view(np.uint64)))
    del v

    # H1 at S5's shape (995 segments) and on the edge table
    z, valid, starts = _h1_args(codes.to(torch.int64), table[2].data)
    entry = h1_entry(card, z, valid, starts, launches["segment_float_agg"])
    del z, valid, starts
    edge = datagen.float_edge_table(edge_rows, 0, device=dev)
    for c in (1, 2):
        ez, _, estarts = _h1_args(edge[0].data.to(torch.int64),
                                  GB._f64_values(edge[c]))
        evalid = edge[c].valid_mask().index_select(
            0, torch.sort(edge[0].data.to(torch.int64), stable=True).indices)
        got, flushed = h1_counted(ez, evalid, estarts)
        want = K.segment_float_agg_plain(ez, evalid, estarts)
        label = f"H1_edge_table_{edge[c].dtype.id.value}"
        checks[f"{label}_equals_plain"] = all(
            torch.equal(g.view(torch.int64), w.view(torch.int64))
            for g, w in zip(got, want))
        checks[f"{label}_flushed_chunks_follow_the_rule"] = (
            flushed == K.flushed_chunks_plain(ez, evalid, estarts))
        entry[f"flushed_chunks_edge_{edge[c].dtype.id.value}"] = flushed
    del edge
    small = datagen.string_rows_table(1_000_000, 3, device=dev)[4]
    enc = D.encode_strings(small)
    checks["encode_strings_1m_round_trip"] = _same_col(D.materialize(enc),
                                                       small)
    jline({"phase": "encoded_checks", **card, **checks})
    failed = [k for k, ok in checks.items() if ok is not True
              and not (k == "S9_sync_check" and ok in ("passed",
                                                       "not checked on the "
                                                       "cpu"))]
    if failed:
        raise AssertionError(f"phase 8: {failed}")
    log(f"check phase 8: S5 == numpy ({ng} groups), S6 == S3, S7 == S5, "
        f"S8 == S4's pairs, S9 fused == eager, S10 == plain columns, "
        f"two groups == numpy, H1 == plain at S5's shape and on the edge "
        f"table")
    jline({"phase": "kernel_time_h1", **entry})

    if cuda:
        two_args = _h1_args(table[3].data.to(torch.int64), table[2].data)
        lens = two_args[2][1:] - two_args[2][:-1]
        longest = int(lens.max())
        h1_ms = cuda_ms(lambda: K.segment_float_agg(*two_args), reps=3,
                        warm=1)
        chain_ms = longest * entry["dadd_latency_ns"] / 1e6
        lines["H1_two_groups"].update(
            h1_kernel_ms=h1_ms, longest_segment=longest,
            chain_bound_ms=chain_ms, ns_per_row=h1_ms * 1e6 / longest,
            chain_share=chain_ms / h1_ms,
            library_ms=cuda_ms(lambda: torch.segment_reduce(
                two_args[0], "sum", lengths=lens), reps=3, warm=1),
            library_call="torch.segment_reduce(z, 'sum'), not bit-equal")
        del two_args
        for name, fn in stages.items():
            warm = sorted(wall(fn, dev)[1] for _ in range(5))
            lines[name].update(warm_median_ms=warm[2], warm_ms=warm,
                               profile=profile_once(fn))
            jline(lines[name])
    else:
        for line in lines.values():
            jline(line)
    return launches, entry


def string_kernel_work(table):
    """B1, B2 and B3 at the string schema (the STRING key; the whole table
    for B3): {wrapper: (kernel call, plain call, bytes, operations)}.
    Operations: ~10 integer ops per murmur3 block or tail byte plus the
    fmix; ~20 per xxhash64 8-byte round (a 64-bit multiply counts 4) and
    ~10 per 4-byte or 1-byte round; 3 per B3 piece."""
    from spark_rapids_jni_tpu_torch.ops import kernels as K

    rows = table.num_rows
    key = table[4]
    lengths = (key.offsets[1:] - key.offsets[:-1]).to(torch.int64)
    chars = int(key.data.numel())
    blocks4 = int((lengths // 4).sum())
    mm = _schema([key], False)
    b3 = _rowconv_args(table)
    return {
        "murmur3_fixed_rows": (
            lambda: K.murmur3_fixed_rows(mm, 42, rows),
            lambda: K.murmur3_fixed_rows_plain(mm, 42, rows),
            4 * (rows + 1) + chars + 4 * rows,
            10 * (blocks4 + (chars - 4 * blocks4)) + 12 * rows),
        "xxhash64_fixed_rows": b2_string_work(key),
        "rowconv_fixed_words": (
            lambda: K.rowconv_fixed_words(*b3),
            lambda: K.rowconv_fixed_words_plain(*b3),
            _rowconv_bytes(b3), rows * 3 * len(b3[2])),
    }


def b2_string_work(key):
    """B2 over the STRING column ``key`` alone: (kernel call, plain call,
    bytes, operations), as string_kernel_work counts them."""
    from spark_rapids_jni_tpu_torch.ops import kernels as K

    rows = key.size
    lengths = (key.offsets[1:] - key.offsets[:-1]).to(torch.int64)
    chars = int(lengths.sum())
    rounds8 = int((lengths // 8).sum())
    xx = _schema([key], True)
    return (lambda: K.xxhash64_fixed_rows(xx, 42, rows),
            lambda: K.xxhash64_fixed_rows_plain(xx, 42, rows),
            4 * (rows + 1) + chars + 8 * rows,
            20 * rounds8 + 10 * (chars - 8 * rounds8) + 40 * rows)


def b2_second_shape(rows):
    """B2's second string shape: ``rows`` strings of random bytes, lengths
    0-100 (mean 50), 1% null."""
    from spark_rapids_jni_tpu_torch.utils import datagen
    return datagen.random_bytes_column(rows, 100, 0.01, seed=1,
                                       device="cuda")


def string_kernel_lines(card, work, rows, shape):
    """One ``string_kernel_time`` line per kernel of ``work``, each held
    bit for bit against its plain version on these inputs first (the
    shapes phase 7 gives B1 and B3, and B2 on S4's left key; or B2's
    second string shape)."""
    for name, (run, plain, _, _) in work.items():
        if not torch.equal(run(), plain()):
            raise AssertionError(f"{name} at {shape} ({rows} rows): "
                                 f"differs from its plain version")
        log(f"check {name} at {shape}: bit-exact over {rows} rows")
    k_ms = kernel_ms([(w[0], DEVICE_KERNEL[name])
                      for name, w in work.items()])
    for (name, (run, plain, nbytes, nops)), kms in zip(work.items(), k_ms):
        b_ms, b_by = bound_ms(nbytes, nops)
        ms = cuda_ms(run)
        jline({"phase": "string_kernel_time", **card, "kernel": name,
               "shape": shape, "rows": rows, "bytes": nbytes,
               "bit_exact": True,
               "max_abs_err": 0, "ms": ms, **profiler_fields(kms, ms),
               "plain_ms": cuda_ms(plain, reps=2, warm=1),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})


def variable_width_copy_times(card, table):
    """The variable-width byte copies of the string row table's first
    batch (row-matrix and per-byte assembly, string extraction), by CUDA
    events, against their byte bounds."""
    from spark_rapids_jni_tpu_torch.columnar.strings import padded_bytes
    from spark_rapids_jni_tpu_torch.ops import row_conversion as R

    table = _fresh(table)
    key = table[4]
    info = R.compute_column_information([c.dtype for c in table])
    batch = R.convert_to_rows(table)[0]
    spr = info.size_per_row
    lanes = R._string_lanes(table, info)
    fixed = R._build_fixed_words(table, info, R._round_up(spr, 8), lanes)
    mat, _ = padded_bytes(key)
    b1 = batch.size
    roffs = batch.offsets
    total = int(roffs[-1])
    bchars = int(key.offsets[b1]) - int(key.offsets[0])
    row_pad = R._round_up(int((roffs[1:] - roffs[:-1]).max()), 16)
    args = (fixed[:b1], [mat[:b1]], [(o[:b1], ln[:b1]) for o, ln in lanes],
            roffs, total)
    words = R._row_words(batch, info)
    o = info.column_starts[4]
    out_offs = torch.zeros(b1 + 1, dtype=torch.int32, device=roffs.device)
    torch.cumsum(words[:, o // 4 + 1], 0, dtype=torch.int32,
                 out=out_offs[1:])
    blob = batch.children[0].data.view(torch.uint8)
    slot = words[:, o // 4].contiguous()
    # bytes: the fixed words (or the slot words) and characters read once,
    # the row bytes (or the characters) written once
    assemble_bytes = 4 * fixed.shape[1] * b1 + bchars + 8 * b1 + total
    # the one string column into its row-matrix window two ways: the copy
    # _assemble_rowmat makes of a lone string column, and the masked
    # gather (_place_strings) it runs for several; both must agree
    w = min(mat.shape[1], row_pad - spr)
    by_copy = torch.zeros((b1, row_pad), dtype=torch.uint8,
                          device=roffs.device)
    by_gather = torch.zeros_like(by_copy)

    def window_copy():
        by_copy[:, spr:spr + w] = mat[:b1, :w]

    window_copy()
    R._place_strings(by_gather, args[1], args[2], spr)
    if not torch.equal(by_copy, by_gather):
        raise AssertionError("the window copy differs from _place_strings")
    copies = {
        "assemble_rowmat": (lambda: R._assemble_rowmat(*args, row_pad, spr),
                            assemble_bytes),
        "string_window_copy": (window_copy, 2 * b1 * w),
        "place_strings_gather": (lambda: R._place_strings(
            by_gather, args[1], args[2], spr), 2 * b1 * w),
        "assemble_bytes": (lambda: R._assemble_bytes(*args, spr),
                           assemble_bytes),
        "extract_string_bytes": (lambda: R._extract_string_bytes(
            blob, roffs[:-1], slot, out_offs, bchars),
            bchars * 2 + 12 * b1),
    }
    for name, (fn, nbytes) in copies.items():
        b_ms, _ = bound_ms(nbytes, 0)
        jline({"phase": "variable_width_copy_time", **card, "op": name,
               "batch_rows": b1, "batch_bytes": total, "bytes": nbytes,
               "ms": cuda_ms(fn, reps=3, warm=1), "bound_ms": b_ms,
               "bound_by": "bytes"})


def batch_boundary_times(card, table):
    """S1's batch boundaries over the string row table two ways: the
    device search convert_to_rows runs (_device_boundaries) and a host
    read of the row sizes with the JAX package's host rule
    (_batch_boundaries); both must agree. Wall ms, median of 5."""
    from spark_rapids_jni_tpu_torch.ops import row_conversion as R

    dev = table.device
    info = R.compute_column_information([c.dtype for c in table])
    row_sizes, cum = R._row_sizes(R._string_lanes(table, info))
    total, max_row = torch.cat([cum[-1:],
                                row_sizes.max().reshape(1)]).tolist()
    cap = R.MAX_BATCH_BYTES

    def host():
        sizes = row_sizes.cpu().numpy()
        bounds = R._batch_boundaries(sizes, cap)
        return bounds, [0] + np.cumsum([int(sizes[b0:b1].sum()) for b0, b1
                                        in zip(bounds, bounds[1:])]).tolist()

    def device():
        return R._device_boundaries(cum, table.num_rows, total, max_row, cap)

    got, ms = {}, {}
    for name, fn in (("host_read_and_rule", host), ("device_search", device)):
        runs = [wall(fn, dev) for _ in range(5)]
        got[name] = runs[0][0]
        ms[f"{name}_ms"] = sorted(t for _, t in runs)[2]
    if got["host_read_and_rule"] != got["device_search"]:
        raise AssertionError("batch boundaries: the device search differs "
                             "from the host rule")
    jline({"phase": "batch_boundary_time", **card, "rows": table.num_rows,
           "boundaries": got["device_search"][0], **ms})


MEMORY_TASK = 9  # the RmmSpark task id phase 9 runs as


def _dedicated(pool_bytes):
    """Install RmmSpark with ``pool_bytes`` and dedicate this thread to
    MEMORY_TASK; returns the undo."""
    from spark_rapids_jni_tpu_torch.memory import RmmSpark
    RmmSpark.set_event_handler(pool_bytes=pool_bytes)
    RmmSpark.current_thread_is_dedicated_to_task(MEMORY_TASK)

    def undo():
        try:
            RmmSpark.remove_current_thread_association()
            RmmSpark.task_done(MEMORY_TASK)
        finally:
            RmmSpark.clear_event_handler()
    return undo


def memory_phase(dev, card, rows):
    """Phase 9 (``memory_sf10``): the memory and fault domains at SF10.
    Returns the kernel launches of the governed eager pass (9b)."""
    from spark_rapids_jni_tpu_torch import tpch
    from spark_rapids_jni_tpu_torch.memory import RmmSpark

    li = tpch.generate_q1_lineitem(rows, 0, dev)
    want = numpy_q1(tpch.q1_arrays(rows, 0))
    ref = split_rung(dev, card, li, want)
    launches, s_tables = governed_ops(dev, card, rows)
    if dev.type == "cuda":
        spill_rung(dev, card, li, ref, s_tables)
    if RmmSpark.is_installed():
        raise AssertionError("phase 9 left RmmSpark installed")
    return launches


def split_rung(dev, card, li, want):
    """9a: fused q1 under a pool of 0.75 x its 2x reservation envelope: the
    reservation escalates to TpuSplitAndRetryOOM through the adaptor and
    the ladder splits the scan in two. Returns the ungoverned result."""
    from spark_rapids_jni_tpu_torch import tpch
    from spark_rapids_jni_tpu_torch.memory import RmmSpark
    from spark_rapids_jni_tpu_torch.plan import plan_metrics

    ref, ung_first = wall(lambda: tpch.run_q1(li), dev)
    ung_warm = sorted(wall(lambda: tpch.run_q1(li), dev)[1]
                      for _ in range(3))
    pool = int(0.75 * 2 * li.device_nbytes())
    undo = _dedicated(pool)
    try:
        plan_metrics.reset()
        got, gov_first = wall(lambda: tpch.run_q1(li), dev)
        snap = plan_metrics.snapshot()
        used = RmmSpark.pool_used()
        split_retries = RmmSpark.get_and_reset_num_split_retry(MEMORY_TASK)
        gov_warm = sorted(wall(lambda: tpch.run_q1(li), dev)[1]
                          for _ in range(3))
        used_after = RmmSpark.pool_used()
    finally:
        undo()
    line = {"phase": "memory_sf10", **card, "part": "a_split_rung",
            "rows": li.num_rows, "input_bytes": li.device_nbytes(),
            "envelope_bytes": 2 * li.device_nbytes(), "pool_bytes": pool,
            "plan_oom_splits": snap["plan_oom_splits"],
            "plan_oom_pieces": snap["plan_oom_pieces"],
            "plan_oom_retries": snap["plan_oom_retries"],
            "plan_fallbacks": snap["plan_fallbacks"],
            "num_split_retry": split_retries,
            "pool_used_after": [used, used_after],
            "governed_first_ms": gov_first,
            "governed_warm_median_ms": gov_warm[1],
            "ungoverned_first_ms": ung_first,
            "ungoverned_warm_median_ms": ung_warm[1],
            "equals_ungoverned": _tables_equal(got, ref),
            "ungoverned_equals_numpy": _equals_numpy(ref, want),
            "equals_numpy": _equals_numpy(got, want)}
    jline(line)
    if (line["plan_oom_splits"] < 1 or line["plan_oom_pieces"] != 2
            or line["plan_fallbacks"] or split_retries < 1
            or (used, used_after) != (0, 0)
            or not (line["equals_ungoverned"] and line["equals_numpy"]
                    and line["ungoverned_equals_numpy"])):
        raise AssertionError(f"9a split rung: {line}")
    log("check 9a: fused q1 split into 2 pieces by the pool, == unsplit == "
        "numpy, pool drained")
    return ref


def _shuffle_and_q3(tables, before_op=lambda: None):
    """The main path's eager stages: shuffle write (B1 partition route +
    B3 rows), shuffle read, q3's eager joins (B2) and groupby;
    ``before_op()`` runs before each of the seven top-level calls."""
    from spark_rapids_jni_tpu_torch import tpch
    from spark_rapids_jni_tpu_torch.ops import row_conversion as R
    from spark_rapids_jni_tpu_torch.parallel.exchange import partition_ids
    written, read = {}, {}
    for tn, tab in tables.items():
        before_op()
        written[tn] = (partition_ids(tab, [0], PARTITIONS),
                       R.convert_to_rows(tab))
    for tn, tab in tables.items():
        before_op()
        read[tn] = R.convert_from_rows(written[tn][1][0],
                                       [c.dtype for c in tab])
    before_op()
    top = tpch.run_q3(read["customer"], read["orders"], read["lineitem"],
                      engine="eager")
    return written, read, top


def _same_outputs(a, b) -> bool:
    (wa, ra, ta), (wb, rb, tb) = a, b
    for tn in wa:
        if not torch.equal(wa[tn][0], wb[tn][0]):
            return False
        for x, y in zip(wa[tn][1], wb[tn][1]):
            if not (torch.equal(x.offsets, y.offsets) and torch.equal(
                    x.children[0].data, y.children[0].data)):
                return False
        if not _tables_equal(ra[tn], rb[tn]):
            return False
    return _tables_equal(ta, tb)


def governed_ops(dev, card, rows):
    """9b: the eager main path (shuffle write and read, q3's eager joins)
    ungoverned, governed, and governed with the reservation audit on.
    Returns (the governed pass's kernel launches, the q3 tables)."""
    from spark_rapids_jni_tpu_torch import tpch
    from spark_rapids_jni_tpu_torch.memory import RmmSpark, hbm
    from spark_rapids_jni_tpu_torch.ops import kernels as K
    from spark_rapids_jni_tpu_torch.utils import config

    cust, orders, lineitem = tpch.generate_q3_tables(rows, 0, dev)
    tables = {"customer": cust, "orders": orders, "lineitem": lineitem}
    want = numpy_q3(tpch.q3_arrays(rows, 0))
    free, free_ms = wall(lambda: _shuffle_and_q3(tables), dev)
    free_warm = wall(lambda: _shuffle_and_q3(tables), dev)[1]
    pool = 64 << 30  # fits every estimate of the path
    undo = _dedicated(pool)
    try:
        K.reset_launches()
        gov, gov_ms = wall(lambda: _shuffle_and_q3(tables), dev)
        launches = _kernel_counts()
        gov_warm = wall(lambda: _shuffle_and_q3(tables), dev)[1]
        max_reserved = RmmSpark.get_and_reset_max_device_reserved(
            MEMORY_TASK)
        hbm.reset()
        # the audit's peak delta sees only growth above the peak at a
        # bracket's entry: the peak is reset before each top-level call
        reset = (torch.cuda.reset_peak_memory_stats if dev.type == "cuda"
                 else (lambda: None))
        with config.override("rmm.validate_hbm", True):
            audited, audit_ms = wall(
                lambda: _shuffle_and_q3(tables, reset), dev)
        report = hbm.report()
        used = RmmSpark.pool_used()
    finally:
        undo()
        hbm.reset()
    got = [c.to_numpy() for c in gov[2].columns]
    line = {"phase": "memory_sf10", **card, "part": "b_governed_ops",
            "rows": rows, "pool_bytes": pool,
            "ungoverned_first_ms": free_ms, "ungoverned_warm_ms": free_warm,
            "governed_first_ms": gov_ms, "governed_warm_ms": gov_warm,
            "governed_audited_ms": audit_ms,
            "max_device_reserved": max_reserved, "pool_used_after": used,
            "launches": launches, "hbm_report": report,
            "governed_equals_ungoverned": _same_outputs(gov, free),
            "audited_equals_ungoverned": _same_outputs(audited, free),
            "q3_equals_numpy": all(np.array_equal(g, w)
                                   for g, w in zip(got, want))}
    jline(line)
    failed = [k for k in ("governed_equals_ungoverned",
                          "audited_equals_ungoverned", "q3_equals_numpy")
              if not line[k]]
    if dev.type == "cuda":
        failed += [w for w in ROW_KERNELS if launches[w] < 1]
    if used:
        failed.append(f"pool_used {used}")
    if dev.type == "cuda" and (report["validated"] != report["brackets"]
                               or report["brackets"] < 1):
        failed.append(f"hbm audit {report}")
    if failed:
        raise AssertionError(f"9b governed ops: {failed}")
    log(f"check 9b: governed shuffle and q3 == ungoverned == numpy, B1/B2/B3 "
        f"launched, {report['validated']} of {report['brackets']} brackets "
        f"validated, {report['underestimates']} under-estimates")
    return launches, [cust, orders, lineitem]


def spill_rung(dev, card, li, ref, s_tables):
    """9c: a real CUDA OOM recovered by spill rollback, then a hopeless cap
    shed as a typed TpuRetryOOM. ``s_tables`` (the q3 tables, plus a
    second q1 lineitem here) become the spillable set S; the caller holds
    no other reference to them."""
    from spark_rapids_jni_tpu_torch import tpch
    from spark_rapids_jni_tpu_torch.memory import transport
    from spark_rapids_jni_tpu_torch.plan import plan_metrics
    from spark_rapids_jni_tpu_torch.utils import config

    total = torch.cuda.get_device_properties(dev).total_memory
    s_tables.append(tpch.generate_q1_lineitem(li.num_rows, 1, dev))
    torch.cuda.synchronize()
    # q1's own need: its peak over what is allocated when it starts
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tpch.run_q1(li)
    torch.cuda.synchronize()
    need = torch.cuda.max_memory_allocated() - base
    # device copies to hold the promoted tables against: S must leave
    # the card for q1 to fit, the copies stay (the cap counts them)
    copies = [[(c.data.clone(), None if c.validity is None
                else c.validity.clone()) for c in t.columns]
              for t in s_tables]
    store = transport.SpillStore()
    spillable = [store.register(t) for t in s_tables]
    s_bytes = store.device_bytes()
    del s_tables[:]
    rollbacks = []
    orig_rollback = transport.rollback_all_stores

    def timed_rollback():
        torch.cuda.synchronize()
        t = time.perf_counter()
        freed = orig_rollback()
        rollbacks.append(((time.perf_counter() - t) * 1e3, freed))
        return freed

    line = {"phase": "memory_sf10", **card, "part": "c_spill_rung",
            "s_bytes": s_bytes, "q1_need_bytes": need}
    transport.rollback_all_stores = timed_rollback
    try:
        torch.cuda.empty_cache()
        cap = torch.cuda.memory_reserved() - s_bytes + int(1.1 * need) \
            + (512 << 20)
        if cap >= torch.cuda.memory_reserved() + need:
            raise AssertionError(f"S ({s_bytes} B) too small against q1's "
                                 f"need ({need} B)")
        line["cap_bytes"] = cap
        torch.cuda.set_per_process_memory_fraction(cap / total)
        plan_metrics.reset()
        got, ms = wall(lambda: tpch.run_q1(li), dev)
        snap = plan_metrics.snapshot()
        line.update({
            "recovered_ms": ms,
            "plan_oom_retries": snap["plan_oom_retries"],
            "plan_oom_spill_bytes": snap["plan_oom_spill_bytes"],
            "plan_oom_splits": snap["plan_oom_splits"],
            "spill_ms": rollbacks[0][0] if rollbacks else None,
            "spill_gb_per_s": (s_bytes / rollbacks[0][0] / 1e6
                               if rollbacks else None),
            "equals_reference": _tables_equal(got, ref)})
        torch.cuda.synchronize()
        t = time.perf_counter()
        back = [st.get() for st in spillable]
        torch.cuda.synchronize()
        line["promote_ms"] = (time.perf_counter() - t) * 1e3
        line["promoted_bit_identical"] = all(
            torch.equal(c.data.view(torch.uint8), d.view(torch.uint8))
            and (v is None) == (c.validity is None)
            and (v is None or torch.equal(c.validity, v))
            for b, cs in zip(back, copies)
            for c, (d, v) in zip(b.columns, cs))
        del back, copies
        for st in spillable:
            store.unregister(st)
        del spillable, store
        torch.cuda.empty_cache()
        # a cap under q1's own need: the ladder retries, then sheds typed
        cap2 = torch.cuda.memory_reserved() + need // 2
        line["hopeless_cap_bytes"] = cap2
        torch.cuda.set_per_process_memory_fraction(cap2 / total)
        plan_metrics.reset()
        with config.override("plan.oom_retry_budget", 2):
            try:
                tpch.run_q1(li)
                shed = None
            except Exception as e:  # noqa: BLE001 - checked below
                shed = e
        line["shed"] = None if shed is None else type(shed).__name__
        line["shed_message"] = None if shed is None else str(shed)
        line["shed_cause"] = (None if shed is None or shed.__cause__ is None
                              else type(shed.__cause__).__name__)
        line["shed_retries"] = plan_metrics.snapshot()["plan_oom_retries"]
        del shed
    finally:
        transport.rollback_all_stores = orig_rollback
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.empty_cache()
    again = tpch.run_q1(li)
    line["after_equals_reference"] = _tables_equal(again, ref)
    jline(line)
    failed = []
    if (line["plan_oom_retries"], line["plan_oom_spill_bytes"]) != (
            1, s_bytes):
        failed.append("the first attempt did not spill S once")
    for k in ("equals_reference", "promoted_bit_identical",
              "after_equals_reference"):
        if not line[k]:
            failed.append(k)
    if (line["shed"], line["shed_message"], line["shed_cause"],
            line["shed_retries"]) != ("TpuRetryOOM",
                                      "gave up after 2 retries",
                                      "TpuRetryOOM", 2):
        failed.append("the hopeless cap did not shed as TpuRetryOOM")
    if failed:
        raise AssertionError(f"9c spill rung: {failed}: {line}")
    log("check 9c: a real CUDA OOM recovered by spilling S, == reference; "
        "S promoted bit-identical; a hopeless cap shed as TpuRetryOOM")


def strings_arrays(rows):
    """Phase 7's string table as numpy arrays, from the generator's own
    draws (``datagen.string_rows_table(rows, 0)``): the four fixed-width
    columns, and the key as its distinct strings in byte order with each
    row's code among them."""
    rng = np.random.default_rng(0)
    fixed = {"c0": rng.integers(-2**31, 2**31, rows),
             "c1": rng.integers(0, 100, rows).astype(np.int32),
             "c2": rng.standard_normal(rows),
             "c3": rng.integers(0, 2, rows).astype(np.uint8)}
    keys, gid = string_key_draws(rows)
    return fixed, keys, gid


def _read(path, dev, tier, encoded=False, timings=None, **kw):
    """(table, routes, wall ms) of one read_all on one tier."""
    from spark_rapids_jni_tpu_torch.parquet import ParquetReader
    from spark_rapids_jni_tpu_torch.utils import config
    with config.override("parquet.device_decode", tier), \
            config.override("parquet.encoded_strings", encoded):
        _sync(dev)
        t = time.perf_counter()
        with ParquetReader(path, device=dev, timings=timings, **kw) as r:
            table = r.read_all()
        _sync(dev)
        return table, r.routes, (time.perf_counter() - t) * 1e3


def _read_profile(fn):
    """One fn() call under torch.profiler: its CUDA kernel launches and
    copies, the device's busy time and idle share, and the aten ops that
    hold the device (inclusive device ms, top 6)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        span_ms = (time.perf_counter() - t) * 1e3
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = sum(1 for e in ev if e.name.startswith(("Memcpy", "Memset")))
    busy_ms = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    avg = prof.key_averages()
    ops = sorted((e for e in avg if e.key.startswith("aten::")
                  and e.device_time_total > 0),
                 key=lambda e: -e.device_time_total)[:6]
    kernels = {}
    for e in ev:
        kernels[e.name[:80]] = kernels.get(e.name[:80], 0.0) \
            + e.time_range.elapsed_us() / 1e3
    return {"device_kernel_launches": len(ev) - copies,
            "device_copies_and_memsets": copies, "wall_ms": span_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / span_ms,
            "top_aten_ops_inclusive_device_ms": {
                e.key: e.device_time_total / 1e3 for e in ops},
            "top_device_kernels_ms": dict(sorted(
                kernels.items(), key=lambda kv: -kv[1])[:6])}


def parquet_phase(dev, card, rows):
    """Phase 10: the Parquet read path (``parquet_sf10``). Writes file A
    (the q1/q6 lineitem) and file B (phase 7's string table, its key as
    dictionary codes, the last row's key a needle) with the port's
    parquet-mr-style writer; reads both through ``read_parquet`` on the
    device tier (the default on the card) with the launch counts set to 0
    and runs the read tables through q1, q6, the shuffle write (B1, B3)
    and, with the key read as DICT32, S6-S9 (H1, B2); reads the counts;
    then holds every column of both tiers against the generated tables
    and every stage against the same stage over them, checks that every
    column took the device tier, iter_chunks, pushdown, the page-checksum
    re-read and a sandboxed decode, and on the card times each read.
    Returns the launches of the counted run."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="parquet_sf10_")
    try:
        return _parquet_phase(dev, card, rows, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        from spark_rapids_jni_tpu_torch.faultinj import injector, sandbox
        injector.uninstall()
        sandbox.shutdown_all()


def _parquet_phase(dev, card, rows, tmp):
    import os
    from spark_rapids_jni_tpu_torch import tpch
    from spark_rapids_jni_tpu_torch.columnar import dictionary as D
    from spark_rapids_jni_tpu_torch.columnar import dtype as dt
    from spark_rapids_jni_tpu_torch.columnar.column import Column, Table
    from spark_rapids_jni_tpu_torch.columnar.table_ops import concat_tables
    from spark_rapids_jni_tpu_torch.faultinj import guard, injector, sandbox
    from spark_rapids_jni_tpu_torch.ops import groupby as GB
    from spark_rapids_jni_tpu_torch.ops import kernels as K
    from spark_rapids_jni_tpu_torch.ops import row_conversion as R
    from spark_rapids_jni_tpu_torch.ops.join import inner_join
    from spark_rapids_jni_tpu_torch.parallel.exchange import partition_ids
    from spark_rapids_jni_tpu_torch.parquet import ParquetReader
    from spark_rapids_jni_tpu_torch.parquet.reader import (reader_metrics,
                                                           route_metrics)
    from spark_rapids_jni_tpu_torch.plan import (Filter, Scan, col,
                                                 execute_plan, lit)
    from spark_rapids_jni_tpu_torch.utils import config
    from spark_rapids_jni_tpu_torch.utils import datagen_parquet as W

    cuda = dev.type == "cuda"
    device_tier = "auto" if cuda else "device"  # auto: the card's default

    # 1. the files
    a = tpch.q1_arrays(rows, 0)
    path_a = os.path.join(tmp, "lineitem_q1.parquet")
    t = time.perf_counter()
    info_a = W.write_parquet(path_a, [W.ParquetColumn(k, values=v)
                                      for k, v in a.items()])
    write_a_s = time.perf_counter() - t
    fixed, keys, gid = strings_arrays(rows)
    entries = list(keys) + [NEEDLE.encode()]
    codes = gid.astype(np.int32)
    codes[-1] = len(keys)  # the needle: the last row only
    cols_b = [W.ParquetColumn(k, values=v.astype(bool) if k == "c3" else v)
              for k, v in fixed.items()]
    cols_b.append(W.string_codes("key", codes, entries))
    path_b = os.path.join(tmp, "strings.parquet")
    t = time.perf_counter()
    info_b = W.write_parquet(path_b, cols_b)
    write_b_s = time.perf_counter() - t
    for name, info, secs in (("A", info_a, write_a_s),
                             ("B", info_b, write_b_s)):
        jline({"phase": "parquet_sf10", "part": "file", **card, "file": name,
               "rows": rows, "bytes": info["bytes"],
               "row_groups": len(info["row_groups"]),
               "rows_per_group": info["row_groups"][0],
               "encodings_first_group": {k: v[0] for k, v in
                                         info["encodings"].items()},
               "write_s": secs, "write_gb_per_s": info["bytes"] / secs / 1e9})

    # the generated tables, on the device
    li_gen = Table(tuple(Column.from_numpy(v, device=dev) for v in a.values()))
    dkey_gen = D.dict_column(torch.from_numpy(codes).to(dev),
                             D.values_from_entries(entries, dev))
    fixed_gen = (Column.from_numpy(fixed["c0"], device=dev),
                 Column.from_numpy(fixed["c1"], device=dev),
                 Column.from_numpy(fixed["c2"], device=dev),
                 Column.from_numpy(fixed["c3"], dt.BOOL8, device=dev))
    sb_gen = Table(fixed_gen + (D.materialize(dkey_gen),))
    td_gen = Table(fixed_gen + (dkey_gen,))
    ng = len(entries)
    plan9 = plan_s9(keys[min(7, len(keys) - 1)].decode())

    def dict_stages(td):
        dkey = td[4]
        dim = D.dict_column(torch.arange(D.dict_values(dkey).size,
                                         device=dev), D.dict_values(dkey))
        return {"S6_dict_aggregate": GB.groupby_aggregate(td, [4], S3_AGGS),
                "S7_dict_float_aggregate": GB.groupby_aggregate(td, [4],
                                                                S5_AGGS),
                "S8_dict_join": inner_join([dkey], [dim]),
                "S9_fused_dict_plan": execute_plan(plan9, td)}

    def shuffle_write(li):
        return partition_ids(li, [0], PARTITIONS), R.convert_to_rows(li)

    # 2-4. the counted run: reads on the device tier, then the stages
    K.reset_launches()
    route_metrics.reset()
    first = {}
    li_dev, routes_a, first["A_device"] = _read(path_a, dev, device_tier)
    with ParquetReader(path_a, device=dev) as r:
        with config.override("parquet.device_decode", device_tier):
            chunks = list(r.iter_chunks())
    q1 = tpch.run_q1(li_dev)
    q6 = tpch.run_q6(li_dev)
    written = shuffle_write(li_dev)
    td_dev, routes_bd, first["B_device_dict32"] = _read(
        path_b, dev, device_tier, encoded=True)
    stages = dict_stages(td_dev)
    _sync(dev)
    launches = _kernel_counts()
    counted_routes = route_metrics.snapshot()
    log(f"parquet launches: {launches}")
    for wrapper in ("murmur3_fixed_rows", "rowconv_fixed_words",
                    "segment_float_agg", "xxhash64_fixed_rows"):
        if cuda and launches[wrapper] < 1:
            raise AssertionError(f"phase 10 never launched {wrapper}")

    # the other tier and the STRING read of file B
    li_host, routes_ah, first["A_host"] = _read(path_a, dev, "native")
    sb_dev, routes_b, first["B_device"] = _read(path_b, dev, device_tier)
    sb_host, _, first["B_host"] = _read(path_b, dev, "native")
    routes = {"A": routes_a, "B": routes_b, "B_dict32": routes_bd}
    jline({"phase": "parquet_sf10", "part": "routes", **card,
           "columns": {f: {c: [r["tier"], r["encodings"]]
                           for c, r in rs.items()}
                       for f, rs in routes.items()},
           "route_metrics_counted_run": counted_routes})

    checks = {
        "A_device_equals_generated": _same_cols(li_dev, li_gen),
        "A_host_equals_generated": _same_cols(li_host, li_gen),
        "B_device_equals_generated": _same_cols(sb_dev, sb_gen),
        "B_host_equals_generated": _same_cols(sb_host, sb_gen),
        "B_dict32_equals_generated": _same_cols(td_dev, td_gen),
        "B_dict32_codes_and_dictionary_equal_generated": (
            D.is_dict(td_dev[4])
            and torch.equal(td_dev[4].data, dkey_gen.data)
            and D._entries(D.dict_values(td_dev[4])) == tuple(entries)),
        "every_column_took_the_device_tier": all(
            r["tier"] == "device" for rs in routes.values()
            for r in rs.values()) and len(routes_a) == 7
        and len(routes_b) == 5
        # file A, each chunk of its chunked read, file B as DICT32
        and counted_routes["device_columns"] == 7 + 7 * len(chunks) + 5,
        "host_tier_by_config_only": all(
            r["why"] == "host_columns_by_config" for r in routes_ah.values()),
        "iter_chunks_equals_read_all": (
            len(chunks) >= 1 and _same_cols(concat_tables(chunks), li_dev)),
        "q1_equals_generated": _tables_equal(q1, tpch.run_q1(li_gen)),
        "q6_equals_generated": q6 == tpch.run_q6(li_gen),
    }
    ref_pids, ref_rows = shuffle_write(li_gen)
    checks["B1_partition_ids_equal_generated"] = torch.equal(written[0],
                                                             ref_pids)
    checks["B3_rows_equal_generated"] = len(written[1]) == len(ref_rows) \
        and all(torch.equal(x.children[0].data, y.children[0].data)
                and torch.equal(x.offsets, y.offsets)
                for x, y in zip(written[1], ref_rows))
    ref_stages = dict_stages(td_gen)
    for name in ("S6_dict_aggregate", "S7_dict_float_aggregate",
                 "S9_fused_dict_plan"):
        checks[f"{name}_equals_generated"] = _same_cols(stages[name],
                                                        ref_stages[name])
    checks["S8_dict_join_equals_generated"] = all(
        torch.equal(x, y) for x, y in zip(stages["S8_dict_join"],
                                          ref_stages["S8_dict_join"]))
    checks["S6_groups"] = stages["S6_dict_aggregate"].num_rows == ng
    del stages, ref_stages, written, ref_pids, ref_rows, chunks, q1
    del li_host, sb_host, sb_dev

    # the footer filter (the plugin's ParquetFooter): file A's footer
    # pruned to two columns, whole and split at the file's midpoint
    from spark_rapids_jni_tpu_torch.parquet import (SchemaBuilder,
                                                    read_and_filter)
    from spark_rapids_jni_tpu_torch.utils.nativeload import so_path
    with open(path_a, "rb") as f:
        data = f.read()
    flen = int.from_bytes(data[-8:-4], "little")
    footer = data[-8 - flen:-8]
    schema = SchemaBuilder().add_value("l_quantity").add_value(
        "l_shipdate").build()
    half = len(data) // 2
    with read_and_filter(footer, 0, len(data), schema) as whole, \
            read_and_filter(footer, 0, half, schema) as first_half, \
            read_and_filter(footer, half, len(data) - half, schema) as rest:
        pruned = (whole.num_rows(), whole.num_columns(),
                  len(whole.serialize_thrift_file()),
                  first_half.num_rows(), rest.num_rows())
    del data
    jline({"phase": "parquet_sf10", "part": "footer", **card,
           "footer_bytes": flen, "pruned_rows": pruned[0],
           "pruned_columns": pruned[1], "serialized_bytes": pruned[2],
           "split_rows": [pruned[3], pruned[4]],
           "native_libraries": {n: so_path(n).is_file() for n in
                                ("libsparkpq.so", "libsparkpqd.so")}})
    checks["footer_filter_prunes_and_splits"] = (
        pruned[:2] == (rows, 2) and pruned[3] + pruned[4] == rows
        and (len(info_a["row_groups"]) == 1 or 0 < pruned[3] < rows)
        and all(so_path(n).is_file() for n in ("libsparkpq.so",
                                                "libsparkpqd.so")))

    # 5. pushdown: key == the needle, which only the last group holds
    pred = Filter(Scan(2), col(1) == lit(NEEDLE))
    n_groups_b = len(info_b["row_groups"])
    reader_metrics.reset()
    pushed, _, push_ms = _read(path_b, dev, device_tier, encoded=True,
                               columns=["c0", "key"],
                               predicate=pred.predicate)
    push = reader_metrics.snapshot()
    with config.override("parquet.predicate_pushdown", False):
        full, _, full_ms = _read(path_b, dev, device_tier, encoded=True,
                                 columns=["c0", "key"],
                                 predicate=pred.predicate)
    out_p = execute_plan(pred, pushed)
    out_f = execute_plan(pred, full)
    jline({"phase": "parquet_sf10", "part": "pushdown", **card,
           "predicate": f"key == {NEEDLE!r}", "row_groups": n_groups_b,
           "reader_metrics": push, "rows_read": pushed.num_rows,
           "pushdown_read_ms": push_ms, "full_read_ms": full_ms})
    checks["pushdown_prunes_every_other_group"] = (
        push["row_groups_skipped"] == n_groups_b - 1
        and push["membership_skips"] == n_groups_b - 1
        and pushed.num_rows == info_b["row_groups"][-1])
    checks["pushdown_answer_unchanged"] = (
        _same_cols(out_p, out_f) and out_p.num_rows == 1
        and out_p[0].to_pylist() == [int(fixed["c0"][-1])])
    del pushed, full, out_p, out_f

    # 6. fault domains: one flipped bit, and a sandboxed decode
    cfg = os.path.join(tmp, "flip.json")
    with open(cfg, "w") as f:
        json.dump({"xlaRuntimeFaults": {"parquet_page": {
            "percent": 100, "injectionType": 3,
            "interceptionCount": 1}}}, f)
    guard.metrics.reset()
    route_metrics.reset()
    injector.install(cfg, seed=3)
    try:
        flipped, _, _ = _read(path_a, dev, device_tier,
                              columns=["l_quantity"])
    finally:
        injector.uninstall()
    fm = guard.metrics.snapshot()
    checks["crc_flip_recovered_bit_identical"] = _same_col(flipped[0],
                                                           li_gen[0])
    checks["crc_flip_counted"] = (
        fm["corruption_detected"] == 1
        and route_metrics.snapshot()["host_columns_corruption"] == 1)
    # one column chunk (the first row group's) decoded in a worker
    first_rows = info_a["row_groups"][0]

    def first_chunk():
        with ParquetReader(path_a, columns=["l_quantity"], device=dev) as r:
            return next(r.iter_chunks(byte_budget=1))

    with config.override("parquet.device_decode", "native"):
        in_process = first_chunk()
        with config.override("sandbox.enabled", True):
            boxed, boxed_ms = wall(first_chunk, dev)
    pid = sandbox.get_worker().pid()
    sandbox.shutdown_all()
    checks["sandboxed_decode_equals_in_process"] = (
        pid is not None and boxed.num_rows == first_rows
        and _same_cols(boxed, in_process)
        and torch.equal(boxed[0].data, li_gen[0].data[:first_rows])
        and guard.metrics.snapshot()["crash_detected"] == 0)
    jline({"phase": "parquet_sf10", "part": "faults", **card,
           "corruption_detected": fm["corruption_detected"],
           "sandbox_worker_pid": pid, "sandboxed_read_ms": boxed_ms})
    del flipped, boxed, in_process

    jline({"phase": "parquet_sf10", "part": "checks", **card, **checks})
    failed = [k for k, ok in checks.items() if ok is not True]
    if failed:
        raise AssertionError(f"phase 10: {failed}")
    log("check phase 10: files A and B == the generated tables on both "
        "tiers, every column on the device tier, q1/q6/B1/B3/S6-S9 == the "
        "same over the generated tables, the footer filter prunes and "
        "splits, pushdown prunes, the flip is recovered and counted, the "
        "sandboxed decode is equal")

    # 7. times, on the card
    if cuda:
        li_bytes = {"A": info_a["bytes"], "B": info_b["bytes"]}
        for file, path, tier, key in (("A", path_a, device_tier, "A_device"),
                                      ("A", path_a, "native", "A_host"),
                                      ("B", path_b, device_tier, "B_device"),
                                      ("B", path_b, "native", "B_host")):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            warm, parts = [], []
            for _ in range(3):
                tim = {}
                table, _, ms = _read(path, dev, tier, timings=tim)
                warm.append(ms)
                parts.append(tim)
                del table
            peak = torch.cuda.max_memory_allocated() - base
            prof = (_read_profile(lambda: _read(path, dev, tier))
                    if tier == device_tier else None)
            mid = sorted(range(3), key=warm.__getitem__)[1]
            split = {k: v for k, v in parts[mid].items()
                     if not k.startswith("walk_ms:")}
            walk = {k[len("walk_ms:"):]: v for k, v in parts[mid].items()
                    if k.startswith("walk_ms:")}
            jline({"phase": "parquet_sf10", "part": "read_time", **card,
                   "file": file,
                   "tier": "device" if tier == device_tier else "host",
                   "rows": rows, "file_bytes": li_bytes[file],
                   "first_ms": first[key], "warm_ms": sorted(warm),
                   "warm_median_ms": warm[mid],
                   "file_gb_per_s": li_bytes[file] / warm[mid] / 1e6,
                   "split_ms_of_the_median_read": split,
                   "host_run_walk_ms_by_column": walk,
                   "peak_device_bytes_over_the_read": peak,
                   "profile_of_one_read": prof})
        # yardstick: file A's encoded bytes to the card, pinned and pageable
        raw = np.fromfile(path_a, dtype=np.uint8)
        pinned = torch.from_numpy(raw).pin_memory()
        pageable = torch.from_numpy(raw)
        yard = {}
        for name, src in (("pinned", pinned), ("pageable", pageable)):
            ms = sorted(wall(lambda: src.to(dev, non_blocking=True), dev)[1]
                        for _ in range(3))
            yard[f"{name}_h2d_ms"] = ms[1]
            yard[f"{name}_gb_per_s"] = raw.nbytes / ms[1] / 1e6
        jline({"phase": "parquet_sf10", "part": "h2d_yardstick", **card,
               "bytes": int(raw.nbytes), **yard})
        del raw, pinned, pageable
    return launches


# ---------------------------------------------------------------------------
# phase 11: DECIMAL128 (decimal_sf10)
# ---------------------------------------------------------------------------

# TPC-H's DECIMAL(12, 2) money columns of lineitem, as file C holds them
MONEY = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")
# q1's aggregates over (returnflag, linestatus, quantity, extendedprice,
# disc_price, charge, discount): four sums, three means, a count
Q1_DEC_AGGS = [(2, "sum"), (3, "sum"), (4, "sum"), (5, "sum"), (2, "mean"),
               (3, "mean"), (6, "mean"), (2, "count")]
Q1_DEC_SCALES = (2, 2, 4, 6, 6, 6, 6, None)
H2_DEVICE_KERNEL = "decimal128_kernel"
# H2's timing operands: (op, Java scales a, b -> out); the operands are
# 18-digit values at scale 4 and 9-digit nonzero values at scale 2
H2_TIMED = (("add", 4, 2, 4), ("sub", 4, 2, 4), ("multiply", 4, 2, 6),
            ("divide", 4, 2, 6), ("integer_divide", 4, 2, 0),
            ("remainder", 4, 2, 4))


def decimal_lineitem_arrays(rows):
    """File C's lineitem as numpy arrays: the q1/q6 draws of
    ``tpch.q1_arrays(rows, 0)`` with the four money columns as the
    unscaled int64 values of TPC-H's DECIMAL(12, 2) (quantity x 100 —
    its unit is whole —, cents, discount and tax in hundredths), and a
    uniform l_orderkey over SF10's 1..60M key range."""
    from spark_rapids_jni_tpu_torch import tpch
    a = tpch.q1_arrays(rows, 0)
    out = {"l_orderkey": np.random.default_rng(1).integers(1, 60_000_001,
                                                            rows)}
    out["l_quantity"] = a["l_quantity"] * 100
    out["l_extendedprice"] = a["l_extendedprice"]
    out["l_discount"] = a["l_discount"].astype(np.int64)
    out["l_tax"] = a["l_tax"].astype(np.int64)
    for k in ("l_returnflag", "l_linestatus", "l_shipdate"):
        out[k] = a[k]
    return out


def q1_decimal(li, cutoff=2400):
    """TPC-H q1 in Spark's decimal types on the eager ops, over file C's
    lineitem: disc_price = price * (1.00 - discount) at scale 4, charge =
    disc_price * (1.00 + tax) at scale 6 (kernel H2; the literal 1.00 is a
    stride-0 column), then the groupby of Q1_DEC_AGGS by (returnflag,
    linestatus) where shipdate <= cutoff, sorted by the keys. Returns (the
    result, the charge column, any overflow of the arithmetic)."""
    from spark_rapids_jni_tpu_torch.columnar.column import (
        Table, decimal128_literal)
    from spark_rapids_jni_tpu_torch.ops import decimal128 as D
    from spark_rapids_jni_tpu_torch.ops import groupby as G
    from spark_rapids_jni_tpu_torch.ops.sort import sort_table
    _, qty, price, disc, tax, rf, ls, ship = li.columns
    one = decimal128_literal("1.00", 2, li.num_rows, li.device)
    d1 = D.sub_decimal128(one, disc, 2)
    t1 = D.add_decimal128(one, tax, 2)
    dp = D.multiply_decimal128(price, d1[1], 4)
    ch = D.multiply_decimal128(dp[1], t1[1], 6)
    over = (d1[0].data | t1[0].data | dp[0].data | ch[0].data).any()
    g = G.groupby_aggregate(Table((rf, ls, qty, price, dp[1], ch[1], disc)),
                            [0, 1], Q1_DEC_AGGS,
                            row_mask=ship.data <= cutoff)
    return sort_table(g, [0, 1]), ch[1], over


def numpy_q1_decimal(a, cutoff=2400):
    """q1 in decimals over the arrays, independent of the port: per
    (returnflag, linestatus) in ascending order, the unscaled sums (exact
    in int64: the largest charge is 1.05e7 x 100 x 108 at scale 6), the
    means HALF_UP at scale 6 in Python ints, and the count."""
    keep = a["l_shipdate"] <= cutoff
    key = a["l_returnflag"].astype(np.int64) * 2 + a["l_linestatus"]
    price, disc, tax = (a[k] for k in ("l_extendedprice", "l_discount",
                                       "l_tax"))
    dp = price * (100 - disc)
    charge = dp * (100 + tax)
    out = []
    for g in np.unique(key[keep]):
        sel = keep & (key == g)
        cnt = int(sel.sum())
        sums = [int(v[sel].sum()) for v in (a["l_quantity"], price, dp,
                                            charge)]
        means = [(2 * s * 10**4 + cnt) // (2 * cnt)  # HALF_UP, s >= 0
                 for s in (sums[0], sums[1], int(disc[sel].sum()))]
        out.append([int(g) // 2, int(g) % 2] + sums + means + [cnt])
    return out


def _q1_rows(t):
    """The q1 result's rows as Python ints (decimals unscaled)."""
    cols = []
    for c, scale in zip(t.columns, (None, None) + Q1_DEC_SCALES):
        vals = c.to_pylist()
        cols.append(vals if scale is None else
                    [None if v is None else int(v.scaleb(scale))
                     for v in vals])
    return [list(r) for r in zip(*cols)]


def _sass_listing(lib_path, kernel):
    """(instructions [(address, text)], labels {name: address}) of the
    kernel whose mangled name holds ``kernel`` in the SASS of
    ``lib_path`` (cuobjdump -sass), its subroutines included; None
    without cuobjdump."""
    import re
    import shutil
    from pathlib import Path
    tool = next((c for c in (shutil.which("cuobjdump"),
                             "/usr/local/cuda/bin/cuobjdump")
                 if c and Path(c).exists()), None)
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    body = next((p for p in sass.split("Function : ")[1:]
                 if kernel in p.splitlines()[0]), "")
    labels, insns, pending = {}, [], []
    for line in body.splitlines():
        m = re.match(r"\s*([.$\w][^\s:]*):\s*$", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for lab in pending:
            labels[lab] = addr
        pending = []
        insns.append((addr, m.group(2).strip()))
    return insns, labels


def _sass_op(text):
    """(opcode, predicated) of one SASS instruction."""
    words = text.split()
    pred = words[0].startswith("@")
    return (words[1] if pred else words[0]).split(".")[0], pred


def _sass_target(text, labels):
    import re
    m = re.search(r"0x([0-9a-f]+)|`\(([^)]+)\)", text)
    if not m:
        return None
    return int(m.group(1), 16) if m.group(1) else labels.get(m.group(2))


def sass_fewest(insns, labels, start, stop):
    """Fewest instructions issued from address ``start`` to the first
    instruction that ``stop(address, text)`` accepts, both counted: a
    branch forward goes to its target (a predicated one may also fall
    through), a branch back is not taken, a call steps over its callee.
    None where no such path exists."""
    pos = {a: i for i, (a, _) in enumerate(insns)}
    inf = float("inf")
    dist = [inf] * len(insns)
    dist[pos[start]] = 1
    best = inf
    for i in range(pos[start], len(insns)):
        d = dist[i]
        if d == inf:
            continue
        addr, text = insns[i]
        if stop(addr, text):
            best = min(best, d)
            continue
        op, pred = _sass_op(text)
        nxt = [i + 1] if i + 1 < len(insns) else []
        if op in ("BRA", "JMP"):
            t = _sass_target(text, labels)
            succ = ([pos[t]] if t is not None and t > addr and t in pos
                    else []) + (nxt if pred else [])
        elif op in ("EXIT", "RET", "BRX", "JMX") and not pred:
            succ = []
        else:
            succ = nxt
        for j in succ:
            dist[j] = min(dist[j], d + 1)
    return None if best == inf else int(best)


def _sass_callees(listing):
    """{callee: fewest instructions from its entry to its RET} of every
    subroutine the kernel calls (nvcc's 64-bit division and remainder
    are such subroutines)."""
    import re
    insns, labels = listing
    out = {}
    for _, text in insns:
        if _sass_op(text)[0] != "CALL":
            continue
        m = re.search(r"`\(([^)]+)\)", text)
        entry = _sass_target(text, labels)
        if entry is None:
            continue
        name = m.group(1) if m else hex(entry)
        out[name] = sass_fewest(insns, labels, entry,
                                lambda _a, t: _sass_op(t)[0] == "RET")
    return out


def h2_kernel_ms(calls, reps=5):
    """Mean device ms of H2's kernel for each (fn, op) in ``calls``, where
    fn() launches H2 once for ``op``: the launches of that op's kernel
    (decimal128_kernel<code>, the op its template argument) under one
    torch.profiler session. An op none of whose launches the profiler saw
    reads None (not measured: the CUDA-event time ``ms`` stands)."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from spark_rapids_jni_tpu_torch.ops.decimal128 import OPS
    for fn, _ in calls:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn, _ in calls:
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    seen = {}
    for e in prof.events():
        m = re.search(H2_DEVICE_KERNEL + r"<[^0-9>]*(\d+)>", e.name)
        if e.device_type == DeviceType.CUDA and m:
            seen.setdefault(int(m.group(1)), []).append(
                e.time_range.elapsed_us() / 1e3)
    out = []
    for _, op in calls:
        d = seen.get(OPS[op], [])
        out.append(sum(d) / len(d) if d else None)
    return out


def h2_ptxas(report):
    """{op: {"registers", "stack_frame", "spill_stores", "spill_loads"}}
    of each decimal128_kernel<OP> in nvcc's -Xptxas -v report of
    csrc/decimal128.cu; None without a report (built before this run)."""
    import re
    from spark_rapids_jni_tpu_torch.ops.decimal128 import OPS
    if not report:
        return None
    op_of = {code: op for op, code in OPS.items()}
    out, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"decimal128_kernelILi(\d)E", line)
        if m:
            cur = out.setdefault(op_of[int(m.group(1))], {})
        elif "entry function" in line or "Function properties" in line:
            cur = None  # another function (a probe)
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack_frame=int(m.group(1)),
                       spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


H2_PROBES = ("reciprocal_2by1", "step_2by1")


def h2_sass(lib_path):
    """The SASS account of kernel H2 (cuobjdump -sass of the built
    library): each op's kernel's instructions and its LDL, STL and CALL
    counts; the fewest instructions issued by one per-row reciprocal and
    one digit step (the never-launched h2_probe_* kernels, less
    h2_probe_base, which loads and stores the same words); and the fewest
    of each division subroutine a kernel calls. None without cuobjdump;
    ``fewest`` None for a source without the probes."""
    from spark_rapids_jni_tpu_torch.ops.decimal128 import OPS
    kernels, callees = {}, {}
    for op, code in OPS.items():
        listing = _sass_listing(lib_path, f"decimal128_kernelILi{code}E")
        if listing is None:
            return None
        names = [_sass_op(t)[0] for _, t in listing[0]]
        kernels[op] = {"instructions": len(names),
                       **{k: names.count(k) for k in ("LDL", "STL",
                                                      "CALL")}}
        callees.update(_sass_callees(listing))
    fewest = {}
    for probe in ("base",) + H2_PROBES:
        insns, labels = _sass_listing(lib_path, f"h2_probe_{probe}")
        if not insns:
            fewest = None
            break
        fewest[probe] = sass_fewest(
            insns, labels, insns[0][0],
            lambda _a, t: _sass_op(t) == ("EXIT", False))
    if fewest:
        base = fewest.pop("base")
        fewest = {k: v - base for k, v in fewest.items()}
    return {"kernels": kernels, "fewest": fewest,
            "division_subroutines_fewest_to_ret": callees}


def h2_division_work(a_data, b_data):
    """{op: [per-row reciprocals, 2-by-1 digit steps, hardware 64-bit
    divisions]} that H2's long division takes on 11d's operands (a at
    scale 4, |a| < 10^18, b at scale 2, 0 < |b| < 10^9: H2_TIMED's
    scales). divide divides |a| 10^4 by |b| (one word): where |a| 10^4
    reaches 2^64, a reciprocal and two steps, else one hardware division.
    integer divide and remainder divide |a| (one word) by |b| in one
    hardware division, then the quotient by 10^2 (a step with the table's
    reciprocal, where the quotient is not 0)."""
    a = a_data.view(torch.int64)[:, 0].abs()
    b = b_data.view(torch.int64)[:, 0].abs()
    rows = a.numel()
    two = int((a >= -(-2**64 // 10**4)).sum())
    idiv = [0, int((a // b != 0).sum()), rows]
    return {"divide": [two, 2 * two, rows - two], "integer_divide": idiv,
            "remainder": idiv}


def h2_division_ops(work, sass):
    """The thread instructions of ``work`` (h2_division_work's counts) at
    the fewest the SASS gives a reciprocal, a step and the hardware
    division subroutine; None where the SASS lacks one that is needed."""
    rec, steps, hw = work
    few = (sass or {}).get("fewest") or {}
    sub = [v for v in (sass or {}).get(
        "division_subroutines_fewest_to_ret", {}).values() if v]
    need = [(rec, few.get("reciprocal_2by1")), (steps,
                                                few.get("step_2by1")),
            (hw, min(sub) if sub else None)]
    if any(n and c is None for n, c in need):
        return None
    return sum(n * c for n, c in need if n)


def _h2_operands(rows, dev, seed):
    from spark_rapids_jni_tpu_torch.columnar import dtype as dt
    from spark_rapids_jni_tpu_torch.columnar.column import Column
    from spark_rapids_jni_tpu_torch.utils import datagen
    rng = np.random.default_rng(seed)
    a = rng.integers(-10**18, 10**18, rows)
    b = rng.integers(1, 10**9, rows) * rng.choice([-1, 1], rows)
    valid = rng.random(rows) > 0.01
    return (Column.from_numpy(datagen.decimal128_limbs(a), dt.decimal128(4),
                              validity=valid, device=dev),
            Column.from_numpy(datagen.decimal128_limbs(b), dt.decimal128(2),
                              device=dev))


def _h2_call(op, a, b, scale, cast=True):
    from spark_rapids_jni_tpu_torch.ops import decimal128 as D
    fn = getattr(D, f"{op}_decimal128")
    kw = {"cast_interim_result": cast} if op == "multiply" else {}
    return fn(a, b, **kw) if op == "integer_divide" else fn(a, b, scale,
                                                            **kw)


def _h2_equals_plain(op, a, b, scale, cast=True, plain_device=None):
    """(H2 == its plain version, bit for bit: limbs, overflow and
    validity; the plain version's wall ms). The plain version
    (ops/decimal128.op_plain) runs on ``plain_device``, by default the
    inputs' own."""
    from spark_rapids_jni_tpu_torch.ops import decimal128 as D
    got = _h2_call(op, a, b, scale, cast)
    pdev = plain_device or a.device
    (over, res), ms = wall(lambda: D.op_plain(
        op, a.data.to(pdev), b.data.to(pdev), -a.dtype.scale,
        -b.dtype.scale, -scale, cast), a.device)
    ok = (torch.equal(got[0].data.cpu(), over.to(torch.uint8).cpu())
          and torch.equal(got[1].data.cpu(), res.cpu())
          and torch.equal(got[0].valid_mask(), got[1].valid_mask())
          and torch.equal(got[1].valid_mask(),
                          a.valid_mask() & b.valid_mask()))
    return ok, ms


def decimal_phase(dev, card, rows):
    """Phase 11: DECIMAL128 end to end (``decimal_sf10``). Writes file C,
    TPC-H's lineitem with its DECIMAL(12, 2) money columns as
    FIXED_LEN_BYTE_ARRAY, and with the launch counts set to 0 reads it
    with a CUDA reader (11a), runs q1 in Spark's decimal types on the
    eager ops (11b) and the shuffle of the decimal lineitem with both
    hashes over the charge column and a join on the discount (11c); reads
    the counts; then checks each against the generated table and numpy,
    and times H2's six ops (11d). Returns (the launches of the counted
    run, H2's kernels entry, the q1 result and 1M of the prices for
    phase 12)."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="decimal_sf10_")
    try:
        return _decimal_phase(dev, card, rows, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _decimal_phase(dev, card, rows, tmp):
    import os
    from spark_rapids_jni_tpu_torch.columnar import dtype as dt
    from spark_rapids_jni_tpu_torch.columnar.column import Column, Table
    from spark_rapids_jni_tpu_torch.columnar.table_ops import concat_tables
    from spark_rapids_jni_tpu_torch.ops import hashing as H
    from spark_rapids_jni_tpu_torch.ops import kernels as K
    from spark_rapids_jni_tpu_torch.ops import row_conversion as R
    from spark_rapids_jni_tpu_torch.ops.join import inner_join
    from spark_rapids_jni_tpu_torch.parallel.exchange import partition_ids
    from spark_rapids_jni_tpu_torch.parquet.reader import route_metrics
    from spark_rapids_jni_tpu_torch.utils import datagen
    from spark_rapids_jni_tpu_torch.utils import datagen_parquet as W

    cuda = dev.type == "cuda"
    device_tier = "auto" if cuda else "device"  # auto: the card's default
    secs, t_part = {}, [time.perf_counter()]

    def lap(name):  # seconds of each part of the phase
        now = time.perf_counter()
        secs[name] = now - t_part[0]
        t_part[0] = now

    # the file
    a = decimal_lineitem_arrays(rows)
    path = os.path.join(tmp, "lineitem_decimal.parquet")
    t = time.perf_counter()
    info = W.write_parquet(path, [W.ParquetColumn(
        k, values=v, decimal=(12, 2) if k in MONEY else None)
        for k, v in a.items()])
    write_s = time.perf_counter() - t
    jline({"phase": "decimal_sf10", "part": "file", **card, "file": "C",
           "rows": rows, "bytes": info["bytes"],
           "row_groups": len(info["row_groups"]),
           "money_columns": "FIXED_LEN_BYTE_ARRAY DECIMAL(12, 2), 6 bytes",
           "encodings_first_group": {k: v[0] for k, v in
                                     info["encodings"].items()},
           "write_s": write_s})
    gen = Table(tuple(
        Column.from_numpy(datagen.decimal128_limbs(v), dt.decimal128(2),
                          device=dev) if k in MONEY
        else Column.from_numpy(v, device=dev) for k, v in a.items()))
    dim = datagen.decimal128_column(list(range(11)), 2, device=dev)
    lap("write_and_generate")

    def shuffle(li):
        pids = partition_ids(li, [0], PARTITIONS)
        batches = R.convert_to_rows(li)
        dtypes = [c.dtype for c in li.columns]
        return pids, len(batches), concat_tables(
            [R.convert_from_rows(b, dtypes) for b in batches])

    # 11a-11c, counted
    K.reset_launches()
    route_metrics.reset()
    li, routes, first_read_ms = _read(path, dev, device_tier)
    counted_routes = route_metrics.snapshot()
    (q1, charge, over), first_q1_ms = wall(lambda: q1_decimal(li), dev)
    (pids, n_batches, back), first_shuffle_ms = wall(lambda: shuffle(li),
                                                     dev)
    h_mm = H.murmur_hash3_32([charge])
    h_xx = H.xxhash64([charge])
    l_idx, r_idx = inner_join([li[3]], [dim])
    _sync(dev)
    launches = _kernel_counts()
    log(f"decimal launches: {launches}")
    for wrapper in ("murmur3_fixed_rows", "xxhash64_fixed_rows",
                    "rowconv_fixed_words", "decimal128_op"):
        if cuda and launches[wrapper] < 1:
            raise AssertionError(f"phase 11 never launched {wrapper}")
    lap("counted_run")
    jline({"phase": "decimal_sf10", "part": "routes", **card,
           "columns": {c: [r["tier"], r["why"]] for c, r in routes.items()},
           "route_metrics_counted_run": counted_routes})

    # checks
    want_q1 = numpy_q1_decimal(a)
    n1 = min(rows, 1_000_000)
    head = Column(charge.dtype, n1, data=charge.data[:n1])
    schema = [("str", H.dec128_hash_words(head), None)]
    cpu_li = Table(tuple(Column(c.dtype, n1, data=c.data[:n1].cpu())
                         for c in li.columns))
    checks = {
        "C_read_equals_generated": _same_cols(li, gen),
        "money_columns_host_tier_unsupported": all(
            (routes[k]["tier"], routes[k]["why"]) ==
            ("host", "host_columns_unsupported") for k in MONEY)
        and counted_routes["host_columns_unsupported"] == len(MONEY),
        "other_columns_device_tier": all(
            r["tier"] == "device" for k, r in routes.items()
            if k not in MONEY) or not cuda,
        "q1_equals_numpy": _q1_rows(q1) == want_q1,
        "q1_no_overflow": not bool(over),
        "shuffle_round_trip_equals_input": _same_cols(back, li),
        "partition_ids_equal_cpu_1m": torch.equal(
            pids[:n1].cpu(), partition_ids(cpu_li, [0], PARTITIONS)),
        "B1_decimal_equals_plain_1m": torch.equal(
            H.murmur_hash3_32([head]).data,
            K.murmur3_fixed_rows_plain(schema, 42, n1)),
        "B2_decimal_equals_plain_1m": torch.equal(
            H.xxhash64([head]).data,
            K.xxhash64_fixed_rows_plain(schema, 42, n1)),
        "join_each_row_to_its_discount": (
            l_idx.numel() == rows and torch.equal(
                li[3].data.index_select(0, l_idx),
                dim.data.index_select(0, r_idx))),
    }
    del back, h_mm, h_xx, l_idx, r_idx, cpu_li, gen
    # phase 12 prints the q1 result and 1M of the prices as strings
    keep = {"q1": q1, "price_1m": Column(li[2].dtype, n1,
                                         data=li[2].data[:n1].clone())}

    # 11d: H2 == plain on 1M seeded rows (the plain version on the card,
    # timed) and on the edge table (the plain version on the CPU)
    xa, xb = _h2_operands(n1, dev, 12)
    plain_ms = {}
    for op, _, _, scale in H2_TIMED:
        checks[f"H2_{op}_equals_plain_1m"], plain_ms[op] = \
            _h2_equals_plain(op, xa, xb, scale)
    checks["H2_multiply_no_interim_cast_equals_plain_1m"] = \
        _h2_equals_plain("multiply", xa, xb, 6, cast=False)[0]
    edge = datagen.decimal128_edge_cases(512, 3, dev)
    checks["H2_edge_table_equals_plain"] = all(
        _h2_equals_plain(op, ea, eb, scale, cast, torch.device("cpu"))[0]
        for op, ea, eb, scale, cast in edge)
    table = datagen.decimal128_division_cases(256, 4, dev)
    checks["H2_division_table_equals_plain"] = all(
        _h2_equals_plain(op, ea, eb, scale, cast, torch.device("cpu"))[0]
        for op, ea, eb, scale, cast in table)
    del xa, xb, edge, table
    lap("checks")
    jline({"phase": "decimal_sf10", "part": "checks", **card, **checks})
    failed = [k for k, ok in checks.items() if ok is not True]
    if failed:
        raise AssertionError(f"phase 11: {failed}")
    log("check phase 11: file C == the generated table, its money columns "
        "on the host tier; decimal q1 == numpy; the shuffle round trip == "
        "its input; B1/B2 over DECIMAL128 == plain; H2 == plain on 1M rows, "
        "the edge table and the division table")

    entry = {"name": K.KERNELS[4][0], "route": "cuda",
             "source": K.KERNELS[4][2], "replaces": K.KERNELS[4][3],
             "launches": launches["decimal128_op"], "bit_exact": True,
             "max_abs_err": 0}
    if not cuda:
        return launches, entry, keep

    # times: 11a reads, 11b q1, 11c shuffle and hashes
    warm, parts = [], []
    for _ in range(3):
        tim = {}
        _, _, ms = _read(path, dev, device_tier, timings=tim)
        warm.append(ms)
        parts.append(tim)
    mid = sorted(range(3), key=warm.__getitem__)[1]
    jline({"phase": "decimal_sf10", "part": "read_time", **card,
           "file": "C", "rows": rows, "file_bytes": info["bytes"],
           "first_ms": first_read_ms, "warm_ms": sorted(warm),
           "warm_median_ms": warm[mid],
           "split_ms_of_the_median_read": {
               k: v for k, v in parts[mid].items()
               if not k.startswith("walk_ms:")},
           "tiers": {"host": list(MONEY),
                     "device": [k for k in a if k not in MONEY]}})
    for name, fn, first in (("q1", lambda: q1_decimal(li), first_q1_ms),
                            ("shuffle", lambda: shuffle(li),
                             first_shuffle_ms)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        K.reset_launches()
        times = sorted(wall(fn, dev)[1] for _ in range(3))
        n_launch = _kernel_counts()
        jline({"phase": "decimal_sf10", "part": f"{name}_time", **card,
               "rows": rows, "first_ms": first, "warm_ms": times,
               "warm_median_ms": times[1],
               "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
               "launches_per_run": {k: v // 3 for k, v in n_launch.items()
                                    if v},
               "profile": profile_once(fn)})
    lap("read_q1_shuffle_times")
    schema = [("str", H.dec128_hash_words(charge), None)]
    for wrapper in ("murmur3_fixed_rows", "xxhash64_fixed_rows"):
        fn = getattr(K, wrapper)
        plain = getattr(K, wrapper + "_plain")
        ms = cuda_ms(lambda: fn(schema, 42, rows), reps=5, warm=1)
        nbytes = schema[0][1][1].numel() + 4 * (rows + 1) + rows * (
            4 if wrapper.startswith("murmur") else 8)
        b_ms, b_by = bound_ms(nbytes, 0)
        jline({"phase": "decimal_sf10", "part": "hash_time", **card,
               "kernel": wrapper, "rows": rows, "column": "charge",
               "java_bytes": schema[0][1][1].numel(), "ms": ms,
               "words_ms": cuda_ms(lambda: H.dec128_hash_words(charge),
                                   reps=3, warm=1),
               "plain_ms": cuda_ms(lambda: plain(schema, 42, rows), reps=1,
                                   warm=0),
               "bound_ms": b_ms, "bound_by": b_by})
    del li, q1, charge, pids, schema

    # 11d: H2's six ops at 60M rows
    xa, xb = _h2_operands(rows, dev, 13)
    k_ms = h2_kernel_ms([((lambda o=o, s=s: _h2_call(o, xa, xb, s)), o)
                         for o, _, _, s in H2_TIMED])
    # operations bounds from the SASS: the reciprocals, digit steps and
    # hardware divisions H2's long division takes on this data, each at
    # the fewest instructions the SASS gives it (add, sub and multiply
    # divide nothing at these scales)
    lib = K._lib_path("decimal128")
    sass = h2_sass(lib)
    work = h2_division_work(xa.data, xb.data)
    ops = {}
    for i, (op, _, _, scale) in enumerate(H2_TIMED):
        out_bytes = 9 if op == "integer_divide" else 17
        nops = h2_division_ops(work[op], sass) if op in work else 0
        b_ms, b_by = bound_ms(rows * (32 + out_bytes), nops or 0)
        ms = cuda_ms(lambda: _h2_call(op, xa, xb, scale), reps=5, warm=1)
        timed = profiler_fields(k_ms[i], ms)
        ops[op] = {"ms": ms, **timed,
                   "plain_ms": plain_ms[op], "plain_rows": n1,
                   "bytes_ms": rows * (32 + out_bytes) / HBM_BYTES_PER_S
                   * 1e3, "operations": nops,
                   "operations_ms": (nops or 0) / INSTRUCTION_RATE["per_s"]
                   * 1e3, "bound_ms": b_ms, "bound_by": b_by,
                   # of the kernel's time (the events' where the profiler
                   # missed it)
                   "share": b_ms / (timed["kernel_ms"] or ms)}
        if op in work:
            ops[op]["division_work"] = dict(zip(
                ("reciprocals", "steps_2by1", "hw_divisions"), work[op]))
        jline({"phase": "decimal_sf10", "part": "h2_time", **card,
               "op": op, "rows": rows, **ops[op]})
    ptxas = h2_ptxas(BUILD_REPORTS.get("decimal128"))
    jline({"phase": "decimal_sf10", "part": "h2_sass", **card,
           "instruction_rate": INSTRUCTION_RATE,
           "ptxas": ptxas,
           # no stack frame, spill or local-memory access in any op
           "registers_only": None if not (ptxas and sass) else all(
               k["stack_frame"] == k["spill_stores"] == k["spill_loads"]
               == 0 for k in ptxas.values()) and all(
               k["LDL"] == k["STL"] == 0 for k in sass["kernels"].values()),
           **(sass or {"sass": None})})
    entry.update({k: ops["multiply"][k] for k in (
        "ms", "kernel_ms", "profiler_ms", "plain_ms", "plain_rows",
        "bound_ms", "bound_by")})
    entry.update({"library_ms": None, "op": "multiply", "ops": ops})
    lap("hash_and_h2_times")
    jline({"phase": "decimal_sf10", "part": "seconds", **card, **secs})
    return launches, entry, keep


# phase 12: Spark's runtime bloom filter (InjectRuntimeFilter): numBits =
# optimalNumOfBits(n, DEFAULT_FPP) capped at the runtime filter's maxNumBits
# default, numHashes = optimalNumOfHashFunctions(n, numBits)
# (org.apache.spark.util.sketch.BloomFilter; SQLConf
# spark.sql.optimizer.runtime.bloomFilter.maxNumBits)
SPARK_BLOOM_FPP = 0.03
SPARK_BLOOM_MAX_BITS = 67_108_864
BLOOM_PARTIALS = 8          # partial aggregations merged into one filter
XXHASH64_SEED = 42          # Spark's XxHash64 expression seed
HILBERT_BITS = 21
# Asia/Kolkata's transition history in the tz database (2025b), as
# (UTC instant, local search instant, offset) in seconds after the
# sentinel: phase 12 needs nothing of the card machine's zone files
KOLKATA = [(-3645237208, -3645216000, 21200),
           (-3155694800, -3155673600, 19270),
           (-2019705670, -2019685870, 19800),
           (-891581400, -891558000, 23400),
           (-872058600, -872035200, 19800),
           (-862637400, -862614000, 23400),
           (-764145000, -764121600, 19800)]
KOLKATA_LMT = 21208         # the offset before the first transition


def spark_bloom_parameters(n):
    """(numBits, numHashes, numLongs) of Spark's runtime filter over
    ``n`` build keys."""
    import math
    bits = min(int(-n * math.log(SPARK_BLOOM_FPP) / (math.log(2) ** 2)),
               SPARK_BLOOM_MAX_BITS)
    hashes = max(1, int(math.floor(bits / n * math.log(2) + 0.5)))
    return bits, hashes, -(-bits // 64)


def features_phase(dev, card, rows, decimal_keep):
    """Phase 12 (``spark_features_sf10``): the slice's path at SF10. With
    the launch counts set to 0: 12a Spark's runtime bloom filter on q3
    (XxHash64 of the filtered orders' keys in B2, BLOOM_PARTIALS partial
    filters put through B1's h1/h2 and merged, every l_orderkey probed,
    q3 over the kept rows), 12b the full join of late lineitem with early
    orders, 12c fused q1 over a donated lineitem, 12d hilbert_index of
    three lineitem columns, 12e the calendar rebase both ways and both
    time zone conversions over 60M microsecond and day values, 12f
    decimal_to_string of phase 11's q1 and of 1M of file C's prices
    (``decimal_keep``); then the counts, the checks and the times.
    Returns the launches of the counted run."""
    from spark_rapids_jni_tpu_torch import tpch
    from spark_rapids_jni_tpu_torch.columnar import dtype as dt
    from spark_rapids_jni_tpu_torch.columnar.column import Column, Table
    from spark_rapids_jni_tpu_torch.columnar.table_ops import gather_table
    from spark_rapids_jni_tpu_torch.ops import bloom_filter as BF
    from spark_rapids_jni_tpu_torch.ops import datetime_rebase as DR
    from spark_rapids_jni_tpu_torch.ops import hashing as H
    from spark_rapids_jni_tpu_torch.ops import kernels as K
    from spark_rapids_jni_tpu_torch.ops import timezones as TZ
    from spark_rapids_jni_tpu_torch.ops.decimal_to_string import \
        decimal_to_string
    from spark_rapids_jni_tpu_torch.ops.join import (
        full_join, inner_join, left_anti_join, left_join)
    from spark_rapids_jni_tpu_torch.ops.zorder import hilbert_index
    from spark_rapids_jni_tpu_torch.plan import execute_plan

    cuda = dev.type == "cuda"
    cpu = torch.device("cpu")
    cutoff, segment = tpch.CUTOFF_DAYS, 1
    n1 = min(rows, 1_000_000)
    secs, t_part = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        secs[name] = now - t_part[0]
        t_part[0] = now

    def prefix(col, n=n1, device=cpu):
        n = min(n, col.size)
        return Column(col.dtype, n, data=col.data[:n].to(device),
                      validity=None if col.validity is None
                      else col.validity[:n].to(device))

    a = tpch.q3_arrays(rows, 0)
    cust, orders, li = tpch._tables(a, tpch._Q3_SCHEMA, dev, stats=True)
    suppkey = tpch.q5_arrays(rows, 0)["l_suppkey"]
    gen = torch.Generator(device=dev).manual_seed(12)
    day_lo, day_hi = -719162, 47846     # 0001-01-01, 2100-12-31
    days = Column(dt.DType(dt.TypeId.TIMESTAMP_DAYS), rows, data=torch.randint(
        day_lo, day_hi + 1, (rows,), generator=gen, device=dev,
        dtype=torch.int32))
    us = Column(dt.DType(dt.TypeId.TIMESTAMP_MICROSECONDS), rows,
                data=torch.randint(day_lo * 86_400_000_000,
                                   (day_hi + 1) * 86_400_000_000, (rows,),
                                   generator=gen, device=dev))
    kolkata = TZ.make_transition_table(
        [[(TZ.INT64_MIN, TZ.INT64_MIN, KOLKATA_LMT)] + KOLKATA],
        ["Asia/Kolkata"])
    # l_orderkey (< 15M) and l_suppkey (< 100K) fit INT32; l_shipdate is
    # days
    hcols = [Column(dt.INT32, rows, data=li[0].data.to(torch.int32)),
             Column.from_numpy(suppkey.astype(np.int32), dt.INT32,
                               device=dev),
             Column(dt.INT32, rows, data=li[1].data)]
    del suppkey
    _sync(dev)
    lap("generate")

    # ---- the counted run --------------------------------------------------
    K.reset_launches()
    t0 = time.perf_counter()
    # 12a: build side = o_orderkey of orders passing the date and customer
    # filters (q3's semi join); its XxHash64 longs into the filter
    oi, _ = inner_join([orders[1]], [cust[0]],
                       left_mask=orders[2].data < cutoff,
                       right_mask=cust[1].data == segment)
    build = gather_table(orders, oi)[0]
    n_build = build.size
    num_bits, num_hashes, num_longs = spark_bloom_parameters(n_build)
    build_h = H.xxhash64([build], XXHASH64_SEED)
    bounds = [n_build * i // BLOOM_PARTIALS for i in range(
        BLOOM_PARTIALS + 1)]
    partials = [BF.bloom_filter_put(
        BF.bloom_filter_create(num_hashes, num_longs, dev),
        Column(dt.INT64, hi - lo, data=build_h.data[lo:hi]))
        for lo, hi in zip(bounds, bounds[1:])]
    bf = BF.bloom_filter_merge(partials)
    probe_h = H.xxhash64([li[0]], XXHASH64_SEED)
    hit = BF.bloom_filter_probe(probe_h, bf).data.bool()
    kept = gather_table(li, torch.nonzero(hit).reshape(-1))
    top_kept = tpch.run_q3(cust, orders, kept, engine="eager")
    # 12b: lineitem shipped after the cutoff, full join orders placed
    # before it (both sides have misses)
    li_late = gather_table(li, torch.nonzero(li[1].data > cutoff)
                           .reshape(-1))
    ord_early = gather_table(orders, torch.nonzero(
        orders[2].data < cutoff).reshape(-1))
    fl, fr = full_join([li_late[0]], [ord_early[0]])
    # 12c: fused q1 over a donated lineitem
    q1_plan = tpch._q1_plan(2400)
    q1_donated = execute_plan(q1_plan, tpch.generate_q1_lineitem(rows, 0,
                                                                 dev),
                              donate_input=True)
    # 12d: hilbert_index of l_orderkey, q5's l_suppkey and l_shipdate
    hidx = hilbert_index(HILBERT_BITS, hcols)
    # 12e: LEGACY rebase both ways; Asia/Kolkata both ways
    rebased = {k: DR.rebase_julian_to_gregorian(
        DR.rebase_gregorian_to_julian(c)) for k, c in (("days", days),
                                                       ("micros", us))}
    to_utc = TZ.convert_timestamp_to_utc(us, kolkata, 0)
    from_utc = TZ.convert_utc_timestamp_to_timezone(us, kolkata, 0)
    # 12f: phase 11's decimal q1 and 1M of file C's prices as strings
    q1_strings = [decimal_to_string(c) for c in decimal_keep["q1"].columns
                  if c.dtype.is_decimal]
    price_strings = decimal_to_string(decimal_keep["price_1m"])
    _sync(dev)
    counted_s = time.perf_counter() - t0
    launches = _kernel_counts()
    log(f"phase 12 launches: {launches}")
    for wrapper in ("murmur3_fixed_rows", "xxhash64_fixed_rows"):
        if cuda and launches[wrapper] < 1:
            raise AssertionError(f"phase 12 never launched {wrapper}")
    lap("counted_run")
    jline({"phase": "spark_features_sf10", "part": "bloom_parameters",
           **card, "build_keys": n_build, "fpp": SPARK_BLOOM_FPP,
           "max_num_bits": SPARK_BLOOM_MAX_BITS, "num_bits": num_bits,
           "num_hashes": num_hashes, "num_longs": num_longs,
           "filter_bytes": num_longs * 8, "partials": BLOOM_PARTIALS,
           "probe_rows": rows, "rows_kept": int(hit.sum())})

    # ---- checks ----------------------------------------------------------
    checks = {}
    whole = BF.bloom_filter_put(BF.bloom_filter_create(num_hashes,
                                                       num_longs, dev),
                                build_h)
    plain = BF.bloom_filter_put(BF.bloom_filter_create(num_hashes,
                                                       num_longs, cpu),
                                prefix(build_h, n_build))
    merged_bytes = BF.serialize(bf)
    checks["bloom_merged_equals_one_put"] = merged_bytes == BF.serialize(
        whole)
    checks["bloom_merged_equals_plain"] = merged_bytes == BF.serialize(plain)
    checks["bloom_every_build_key_probes_true"] = bool(
        BF.bloom_filter_probe(build_h, bf).data.bool().all())
    in_build = torch.zeros(orders.num_rows, dtype=torch.bool, device=dev)
    in_build[build.data] = True
    outside = ~in_build
    fp = int((BF.bloom_filter_probe(H.xxhash64([orders[0]],
                                               XXHASH64_SEED), bf)
              .data.bool() & outside).sum()) / int(outside.sum())
    fp_rows = int((hit & outside[li[0].data]).sum()) / int(
        outside[li[0].data].sum())
    checks["bloom_false_positive_share_in_2_to_4_pct"] = 0.02 <= fp <= 0.04
    checks["bloom_probe_equals_plain_1m"] = torch.equal(
        hit[:n1].cpu(), BF.bloom_filter_probe(prefix(probe_h), plain)
        .data.bool())
    top_all = tpch.run_q3(cust, orders, li, engine="eager")
    checks["q3_filtered_equals_q3_whole"] = _same_cols(top_kept, top_all)
    want = numpy_q3(a)
    checks["q3_filtered_equals_numpy"] = all(
        np.array_equal(c.to_numpy(), w)
        for c, w in zip(top_kept.columns, want))
    il, ir = inner_join([li_late[0]], [ord_early[0]])
    lmiss = left_anti_join([li_late[0]], [ord_early[0]])
    rmiss = left_anti_join([ord_early[0]], [li_late[0]])
    ll, lr = left_join([li_late[0]], [ord_early[0]])
    checks["full_join_pairs_are_inner_plus_misses"] = (
        fl.numel() == il.numel() + lmiss.numel() + rmiss.numel()
        and lmiss.numel() > 0 and rmiss.numel() > 0)
    checks["full_join_is_left_join_then_right_anti"] = (
        torch.equal(fl, torch.cat([ll, torch.full_like(rmiss, -1)]))
        and torch.equal(fr, torch.cat([lr, rmiss])))
    small = [full_join([prefix(li_late[0], n1, d)],
                       [prefix(ord_early[0], n1 // 4, d)]) for d in (dev, cpu)]
    checks["full_join_equals_cpu_1m"] = all(
        torch.equal(g.cpu(), w) for g, w in zip(*small))
    del il, ir, lmiss, ll, lr, small
    undonated = tpch.generate_q1_lineitem(rows, 0, dev)
    checks["q1_donated_equals_undonated"] = _same_cols(
        q1_donated, execute_plan(q1_plan, undonated))
    donor = tpch.generate_q1_lineitem(1024, 0, dev)
    execute_plan(q1_plan, donor, donate_input=True)
    try:
        donor.columns
        checks["donated_table_raises_on_use"] = False
    except RuntimeError:
        checks["donated_table_raises_on_use"] = True
    checks["hilbert_equals_plain_1m"] = _same_col(
        prefix(hidx), hilbert_index(HILBERT_BITS,
                                    [prefix(c) for c in hcols]))
    greg_start = {"days": -141427, "micros": -12219292800000000}
    for k, c in (("days", days), ("micros", us)):
        back = rebased[k]
        late = c.data >= greg_start[k]
        checks[f"rebase_{k}_round_trip_from_1582_10_15"] = bool(
            (back.data[late] == c.data[late]).all())
        pc = prefix(c)
        checks[f"rebase_{k}_equals_plain_1m"] = all(_same_col(
            prefix(fn(c)), fn(pc)) for fn in (DR.rebase_gregorian_to_julian,
                                             DR.rebase_julian_to_gregorian))
        checks[f"rebase_{k}_round_trip_equals_plain_1m"] = _same_col(
            prefix(back), DR.rebase_julian_to_gregorian(
                DR.rebase_gregorian_to_julian(pc)))
    checks["timezones_equal_plain_1m"] = all(_same_col(
        prefix(got), fn(prefix(us), kolkata, 0)) for got, fn in (
            (to_utc, TZ.convert_timestamp_to_utc),
            (from_utc, TZ.convert_utc_timestamp_to_timezone)))
    def same_strings(got, want):
        return (torch.equal(got.data.cpu(), want.data)
                and torch.equal(got.offsets.cpu(), want.offsets)
                and torch.equal(got.valid_mask().cpu(), want.valid_mask()))

    q1_cpu = [decimal_to_string(prefix(c, c.size))
              for c in decimal_keep["q1"].columns if c.dtype.is_decimal]
    checks["decimal_to_string_q1_equals_cpu"] = all(
        same_strings(g, w) for g, w in zip(q1_strings, q1_cpu))
    checks["decimal_to_string_1m_equals_cpu"] = same_strings(
        price_strings, decimal_to_string(prefix(
            decimal_keep["price_1m"], decimal_keep["price_1m"].size)))
    lap("checks")
    jline({"phase": "spark_features_sf10", "part": "checks", **card,
           "bloom_false_positive_share_distinct_keys": fp,
           "bloom_false_positive_share_lineitem_rows": fp_rows,
           "full_join_pairs": fl.numel(), "q3_top_orderkeys":
           top_kept[0].to_numpy().tolist(),
           "q1_strings_first_row": [s.to_pylist()[0] for s in q1_strings],
           **checks})
    failed = [k for k, ok in checks.items() if ok is not True]
    if failed:
        raise AssertionError(f"phase 12: {failed}")
    log("check phase 12: the merged bloom filter == one put == plain; "
        "every build key hits; q3 over the kept rows == q3 == numpy; the "
        "full join == left join + right anti rows; donated q1 == "
        "undonated; hilbert, rebase, time zones and decimal strings == "
        "plain")
    del undonated, whole, plain, top_all, q1_donated, donor

    # ---- times (the card only) -------------------------------------------
    if not cuda:
        return launches
    empty = BF.bloom_filter_create(num_hashes, num_longs, dev)
    full = BF.bloom_filter_put(empty, probe_h)
    work = {
        # bytes: the keys read once, the filter's bits written (put) or
        # read (probe) once, the probe's uint8 written once
        "bloom_put_build": (lambda: BF.bloom_filter_put(empty, build_h),
                            n_build * 8 + num_longs * 8),
        "bloom_put_60m": (lambda: BF.bloom_filter_put(empty, probe_h),
                          rows * 8 + num_longs * 8),
        "bloom_probe_60m": (lambda: BF.bloom_filter_probe(probe_h, full),
                            rows * 8 + num_longs * 8 + rows),
        "bloom_merge_8": (lambda: BF.bloom_filter_merge(partials),
                          (BLOOM_PARTIALS + 1) * num_longs * 64),
        "xxhash64_60m": (lambda: H.xxhash64([li[0]], XXHASH64_SEED),
                         rows * 16),
        "full_join": (lambda: full_join([li_late[0]], [ord_early[0]]),
                      (li_late.num_rows + ord_early.num_rows) * 8
                      + 2 * 8 * fl.numel()),
        "hilbert_index_60m": (lambda: hilbert_index(HILBERT_BITS, hcols),
                              rows * (3 * 4 + 8)),
        "rebase_days_both_ways": (lambda: DR.rebase_julian_to_gregorian(
            DR.rebase_gregorian_to_julian(days)), rows * 4 * 2 * 2),
        "rebase_micros_both_ways": (lambda: DR.rebase_julian_to_gregorian(
            DR.rebase_gregorian_to_julian(us)), rows * 8 * 2 * 2),
        "to_utc_micros": (lambda: TZ.convert_timestamp_to_utc(
            us, kolkata, 0), rows * 16),
        "from_utc_micros": (lambda: TZ.convert_utc_timestamp_to_timezone(
            us, kolkata, 0), rows * 16),
    }
    for name, (fn, nbytes) in work.items():
        b_ms, b_by = bound_ms(nbytes, 0)
        K.reset_launches()
        fn()
        per_call = {k: v for k, v in _kernel_counts().items() if v}
        ms = cuda_ms(fn, reps=2, warm=1)
        jline({"phase": "spark_features_sf10", "part": "time", **card,
               "work": name, "rows": rows, "ms": ms, "bound_ms": b_ms,
               "bound_by": b_by, "launches_per_call": per_call})
    for name, fn in (("decimal_to_string_1m",
                      lambda: decimal_to_string(decimal_keep["price_1m"])),):
        _, ms = wall(fn, dev)
        jline({"phase": "spark_features_sf10", "part": "time", **card,
               "work": name, "rows": n1, "wall_ms": ms})
    del full, empty
    peaks = {}
    for label, donate in (("undonated", False), ("donated", True)):
        t = tpch.generate_q1_lineitem(rows, 0, dev)
        _sync(dev)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res, ms = wall(lambda: execute_plan(q1_plan, t,
                                            donate_input=donate), dev)
        peaks[label] = {"max_memory_allocated_gb":
                        torch.cuda.max_memory_allocated() / 1e9,
                        "above_start_gb": (torch.cuda.max_memory_allocated()
                                           - base) / 1e9,
                        "input_gb": rows * 36 / 1e9, "ms": ms}
        del t, res
    jline({"phase": "spark_features_sf10", "part": "donation_peak", **card,
           "rows": rows, **peaks})
    lap("times")
    jline({"phase": "spark_features_sf10", "part": "seconds", **card,
           "counted_run_s": counted_s, **secs})
    return launches


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
