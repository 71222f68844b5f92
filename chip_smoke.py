"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py PHASE [ROWS]

With no argument, the whole run below. With a phase name (memory_sf10,
parquet_sf10, decimal_sf10, casts_sf10, nested_sf10 or weblog_strings)
and optionally a row count (SF10's 60M lineitem rows by default;
weblog_strings: 10M URLs, and two documents for every five URLs),
phases 1 and 2 and then that phase alone, ending with its seconds.

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
     donated and undonated q1;
 13. ``casts_sf10``: Spark's CastStrings at SF10, from TPC-H's text.
     Renders the q1 draws' l_quantity, l_extendedprice, l_discount and
     l_tax as dbgen's ``.tbl`` strings on the card (held against numpy's
     formatting on 1M rows); with the launch counts set to 0 casts them
     (l_quantity to INT32 and INT64, the four to DECIMAL(12, 2), the price
     to FLOAT64 and FLOAT32), runs phase 11's decimal q1 over the four
     cast columns (H2), casts the FLOAT64 prices to strings and back, and
     hashes l_orderkey through the engine bridge (``bridge.call``, B1);
     checks every cast on all 60M rows (== the draws, the unscaled values,
     the bits of cents / 100 in f64 and f32), q1 == numpy, the round trip
     on every row, the card == the CPU on 1M-row prefixes
     (float_to_string of both widths, format_number, both base casts, the
     JAX package's own cast cell == Python's float()), an ANSI error's row,
     and each of the bridge's 31 ops == the op called directly (the json
     ops over short JSON objects); then times each cast at 60M
     rows (first, warm median of 5, byte bound, launches and idle share by
     the profiler, peak memory), the price cast again over a column with
     one string in 100 of 256 characters, and the bridge's murmur3 split
     into marshalling and B1;
 14. ``nested_sf10``: nested columns (in the whole run at half SF10's
     lineitems, ``NESTED_RUN_ROWS``; alone at SF10). Groups the lineitem
     draws (stably sorted on l_orderkey) into their orders (15M at SF10)
     as o_orderkey, the
     STRUCT key o_key (o_custkey, o_orderdate), LIST<INT64> o_linekeys
     and LIST<STRUCT> o_lines (l_quantity, l_extendedprice, l_shipdate),
     with 1% null o_lines rows, l_quantity elements and o_key rows, and
     writes them with the port's writer (repetition and definition
     levels); with the launch counts set to 0 reads the file through
     ParquetReader in several chunks (o_linekeys on the device tier, the
     others through parquet/nested.py), hashes o_key (B1 over the
     flattened struct) and o_linekeys (B1's LIST entry), sorts the orders
     on o_orderdate and filters them to a cutoff carrying o_lines, takes
     the percentiles of each order's quantities and a histogram of the
     60M quantities, interleaves three lineitem columns (Z-order) and
     calls the three ops through the bridge at 1M rows; reads the
     counts; checks every column against the draws, B1 against its plain
     version (also on a copy where one list in 10,000 holds 4,096
     elements, and at 70 units across two launches, B2 too), each step
     against numpy and the bridge against direct calls, the percentiles
     on the card against the CPU on 1M rows of values where a fused
     multiply-add rounds apart; then times the read (its split, idle
     share), each step (first and warm median of 5, bounds, launches,
     idle share, peak memory), B1 in each case (events, profiler, plain,
     byte bound) and the bridge's ops;
 15. ``weblog_strings``: Spark's string device tiers over one web-log
     batch drawn from the seed (utils/datagen.weblog_urls, weblog_docs):
     10M URLs of 60-200 bytes and 4M JSON events of 120-450 bytes (about
     1.2 GB of characters each). With the launch counts and the tiers'
     route counts set to 0: parse_url PROTOCOL, HOST and QUERY of the URL
     column (one parse shared), parse_url(url, 'QUERY', 'utm_source') (the
     host tier, by the contract), GROUP BY the host (the shuffle's
     partition route over the HOST strings, B1, then the sorted groupby
     count), get_json_object with four KEY/INDEX paths and a wildcard (the
     host tier, by the contract), from_json's raw map, and the bridge's
     two json ops at 1M rows; reads the counts; checks each device tier
     against the host tier over the whole columns, the card against the
     CPU (device tier forced) on 100K-row slices, the route counts
     against the draw, the groupby against a Counter of the host tier's
     hosts, B1 against its plain version and the bridge against direct
     calls; then times each step (first, warm median of 5 over fresh
     columns, the host tier's time, launches and idle share by the
     profiler, host syncs, peak memory, byte bound).

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


# torch.cuda._sleep's kernel: the sentinels launched at both ends of a
# profiled session. On the H100 (torch 2.11, CUDA 12.8) a CUDA-only
# session after a process's first loses one device event at its start,
# which a pair of sentinels takes; late in a whole chip_smoke run
# sessions lose more, at the start and within, which the sentinels show
# only in part. Phase 14's profiler readings are taken from the phase
# run alone (``python3 chip_smoke.py nested_sf10``).
SENTINEL_KERNEL = "spin_kernel"


def _sentinels(count=2):
    for _ in range(count):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def kernel_ms(calls, reps=5):
    """Mean device time per call of each (fn, kernel) in ``calls``: the
    CUDA kernel whose name holds ``kernel``, which fn() launches once, timed
    by torch.profiler — the kernel alone, without the host gaps that cuda_ms
    counts when the wrapper's host work is the longer. One profiler session
    for all calls, between sentinel pairs (``_profiled``); the kernels are
    attributed in launch order. A session that misses launches is run once
    more; a kernel it still misses reads None (not measured: the
    CUDA-event time ``ms`` stands)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for fn, _ in calls:
        fn()
    torch.cuda.synchronize()
    names = {k for _, k in calls}
    events = []
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _sentinels()
            for fn, _ in calls:
                for _ in range(reps):
                    fn()
            torch.cuda.synchronize()
            _sentinels()
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


def main(argv=()):
    # one phase alone: (dev, card, rows) -> the phase's lines
    alone = {"memory_sf10": memory_phase, "parquet_sf10": parquet_phase,
             "decimal_sf10": decimal_phase, "casts_sf10": casts_phase,
             "nested_sf10": nested_phase, "weblog_strings": weblog_phase}
    default_rows = {"weblog_strings": WEBLOG_URLS}
    if argv and (argv[0] not in alone or len(argv) > 2):
        print(f"usage: chip_smoke.py [{'|'.join(alone)} [ROWS]]",
              file=sys.stderr)
        return 2
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
    if argv:
        alone[argv[0]](dev, card, int(argv[1]) if argv[1:]
                       else default_rows.get(argv[0], SF10_ROWS))
        phase_end(argv[0])
        jline({"phase_seconds": PHASE_SECONDS})
        return 0

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
    phase_end("spark_features_sf10")

    # ---- phase 13: Spark's casts from TPC-H text, and the bridge ----------
    paths["casts_sf10"] = casts_phase(dev, card, SF10_ROWS,
                                      decimal_keep["arrays"],
                                      decimal_keep["q1_want"])
    del decimal_keep
    phase_end("casts_sf10")

    # ---- phase 14: nested columns -----------------------------------------
    paths["nested_sf10"] = nested_phase(dev, card, NESTED_RUN_ROWS)
    phase_end("nested_sf10")

    # ---- phase 15: the string device tiers over a web-log batch -----------
    paths["weblog_strings"] = weblog_phase(dev, card, WEBLOG_URLS)
    phase_end("weblog_strings")
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


def _profiled(fn, activities, attempts=2):
    """(profiler, fn()'s device events in start order, fn()'s wall ms) of
    one fn() call under torch.profiler, the call bracketed by two sentinel
    kernels on each side outside the timed span; a session counts only
    where the profiler's first and last device events are sentinels and
    fn() shows a device event of its own (else it dropped events: a
    session that misses launches reads a device busier or idler than it
    was). Run again if not, up to ``attempts`` sessions; (None, None,
    None) when none counts: the reading is not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import profile
    for attempt in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            _sentinels()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            span_ms = (time.perf_counter() - t) * 1e3
            _sentinels()
        ev = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
        at = [i for i, e in enumerate(ev) if SENTINEL_KERNEL in e.name]
        if (len(at) >= 2 and at[0] == 0 and at[-1] == len(ev) - 1
                and len(ev) > len(at)):
            return prof, [e for e in ev if SENTINEL_KERNEL not in e.name], \
                span_ms
        log(f"the profiler showed sentinels at {at} of {len(ev)} device "
            f"events (session {attempt + 1}): not a whole session")
    return None, None, None


def _read_profile(fn):
    """One fn() call under torch.profiler (``_profiled``): its CUDA kernel
    launches and copies, the device's busy time and idle share, and the
    aten ops that hold the device (inclusive device ms, top 6); every
    field None where no session was whole."""
    from torch.profiler import ProfilerActivity
    prof, ev, span_ms = _profiled(fn, [ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
    if prof is None:
        return {"device_kernel_launches": None,
                "device_copies_and_memsets": None, "wall_ms": None,
                "device_busy_ms": None, "device_idle_share": None,
                "top_aten_ops_inclusive_device_ms": None,
                "top_device_kernels_ms": None}
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
    # phase 12 prints the q1 result and 1M of the prices as strings;
    # phase 13 casts the same arrays from text and checks the same q1
    keep = {"q1": q1, "price_1m": Column(li[2].dtype, n1,
                                         data=li[2].data[:n1].clone()),
            "arrays": a, "q1_want": want_q1}

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


CAST_P, CAST_S = 12, -2     # TPC-H's DECIMAL(12, 2), cudf scale -2
LONG_LEN = 256              # 13h: the long strings' length
LONG_EVERY = 100            # 13h: one row in 100 is long
ANSI_ROW = 500_000          # 13f: the bad row of the 1M-row column
CAST_WARM = 5               # warm calls a cast is timed over (median)
BRIDGE_OPS = 31             # the ops the port's bridge runs: all of them


def _prefix(col, n, device):
    """The first n rows of a column (a STRING's characters too) on
    ``device``."""
    from spark_rapids_jni_tpu_torch.columnar.column import Column
    n = min(n, col.size)
    validity = None if col.validity is None else col.validity[:n].to(device)
    if col.offsets is None:
        return Column(col.dtype, n, data=col.data[:n].to(device),
                      validity=validity)
    offs = col.offsets[:n + 1]
    return Column(col.dtype, n, data=col.data[:int(offs[-1])].to(device),
                  validity=validity, offsets=offs.to(device))


def _same_on_host(a, b) -> bool:
    """``_same_col`` of two columns wherever each lives."""
    cpu = torch.device("cpu")
    return _same_col(_prefix(a, a.size, cpu), _prefix(b, b.size, cpu))


def _widen128(col):
    """A DECIMAL32/64 column as DECIMAL128 (sign-extended limbs), as
    Spark widens a DECIMAL(12, 2) operand for its decimal arithmetic."""
    from spark_rapids_jni_tpu_torch.columnar import dtype as dt
    from spark_rapids_jni_tpu_torch.columnar.column import Column
    from spark_rapids_jni_tpu_torch.ops import int128
    return Column(dt.decimal128(col.dtype.scale), col.size,
                  data=int128.storage(int128.from_int64(col.data)),
                  validity=col.validity)


def _tbl_numpy(vals, frac_digits):
    """numpy's formatting of non-negative unscaled decimals in dbgen's
    form: (characters, int64 offsets)."""
    vals = np.asarray(vals, np.int64)
    if frac_digits:
        scale = 10 ** frac_digits
        s = np.char.add(np.char.add((vals // scale).astype(str), "."),
                        np.char.zfill((vals % scale).astype(str),
                                      frac_digits))
    else:
        s = vals.astype(str)
    offs = np.zeros(len(vals) + 1, np.int64)
    np.cumsum(np.char.str_len(s), out=offs[1:])
    return np.frombuffer("".join(s.tolist()).encode(), np.uint8), offs


def _with_long_rows(col, length, every):
    """The STRING column with every ``every``-th row left-padded with '0's
    to ``length`` characters: the same numbers (so the same casts), and a
    padded width of ``length``."""
    from spark_rapids_jni_tpu_torch.columnar import dtype as dt
    from spark_rapids_jni_tpu_torch.columnar.column import Column
    from spark_rapids_jni_tpu_torch.columnar.strings import row_of_position
    dev = col.data.device
    offs = col.offsets.to(torch.int64)
    lens = offs[1:] - offs[:-1]
    long = torch.arange(col.size, device=dev) % every == 0
    new_lens = torch.where(long, length, lens)
    new_offs = torch.zeros(col.size + 1, dtype=torch.int64, device=dev)
    new_offs[1:] = torch.cumsum(new_lens, 0)
    total = int(new_offs[-1])
    row = row_of_position(new_offs, total).to(torch.int64)
    k = torch.arange(total, device=dev) - new_offs[row]
    pad = (new_lens - lens)[row]
    src = (offs[row] + k - pad).clamp(min=0)
    chars = torch.where(k < pad, ord("0"), col.data[src].to(torch.int64))
    return Column(dt.STRING, col.size, data=chars.to(torch.uint8),
                  validity=col.validity, offsets=new_offs.to(torch.int32))


def _bits(col):
    """A float column's bit patterns (int64 or int32)."""
    return col.data.contiguous().view(
        torch.int64 if col.data.element_size() == 8 else torch.int32)


def cast_profile(fn, attempts=2):
    """One warm call of fn() under torch.profiler (``_profiled``): its
    device launches (kernels; copies and fills counted apart), the
    device's busy time and its idle share; every field None where no
    session was whole."""
    from torch.profiler import ProfilerActivity
    _, dev_ev, span_ms = _profiled(fn, [ProfilerActivity.CUDA], attempts)
    if dev_ev is None:
        return {"launches_per_call": None, "copies_and_fills_per_call": None,
                "profiled_wall_ms": None, "device_busy_ms": None,
                "device_idle_share": None}
    copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in dev_ev)
    busy = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e3
    return {"launches_per_call": len(dev_ev) - copies,
            "copies_and_fills_per_call": copies, "profiled_wall_ms": span_ms,
            "device_busy_ms": busy, "device_idle_share": 1 - busy / span_ms}


def bridge_cases(dev, n, seed):
    """(cases, wire columns): for each of the 31 ops the port's bridge
    runs, (op, args, input names, direct), with the inputs made with numpy
    from ``seed`` at n rows; ``direct(cols)`` runs the port's op on the
    marshalled columns without the bridge, as a caller of the op would."""
    from spark_rapids_jni_tpu_torch.columnar import dtype as dt
    from spark_rapids_jni_tpu_torch.columnar.column import Column, Table
    from spark_rapids_jni_tpu_torch.columnar.interop import (col_to_wire,
                                                             wire_to_col)
    from spark_rapids_jni_tpu_torch.ops import bloom_filter as BF
    from spark_rapids_jni_tpu_torch.ops import cast_float_to_string as CF
    from spark_rapids_jni_tpu_torch.ops import cast_string as CS
    from spark_rapids_jni_tpu_torch.ops import cast_string_base as CB
    from spark_rapids_jni_tpu_torch.ops import datetime_rebase as DR
    from spark_rapids_jni_tpu_torch.ops import decimal128 as D
    from spark_rapids_jni_tpu_torch.ops import get_json_object as GJ
    from spark_rapids_jni_tpu_torch.ops import hashing as H
    from spark_rapids_jni_tpu_torch.ops import map_utils as MU
    from spark_rapids_jni_tpu_torch.ops import histogram as HI
    from spark_rapids_jni_tpu_torch.ops import row_conversion as R
    from spark_rapids_jni_tpu_torch.ops import timezones as TZ
    from spark_rapids_jni_tpu_torch.ops.decimal_to_string import \
        decimal_to_string
    from spark_rapids_jni_tpu_torch.ops.zorder import (hilbert_index,
                                                       interleave_bits)
    from spark_rapids_jni_tpu_torch.utils.datagen import decimal128_limbs

    rng = np.random.default_rng(seed)
    valid = (rng.random(n) > 0.05).astype(np.uint8).tobytes()

    def fixed(name, arr, v=None):
        return (name, n, np.ascontiguousarray(arr).tobytes(), None, v)

    ints = rng.integers(-10 ** 9, 10 ** 9, n)
    words = np.array(["42", "-7", " 12 ", "bogus", "1.5", "99999999999", "",
                      "+3", "1F", "ff", "1e3", "-0.25", "21168.23"])
    strs = words[rng.integers(0, len(words), n)]
    soffs = np.zeros(n + 1, np.int64)
    np.cumsum(np.char.str_len(strs), out=soffs[1:])
    floats = rng.standard_normal(n) * 10.0 ** rng.integers(-5, 6, n)
    w = {"i64": fixed("int64", ints, valid),
         "keys": fixed("int64", rng.integers(0, 10 ** 6, n)),
         "i32": fixed("int32", (ints // 7).astype(np.int32)),
         "f64": fixed("float64", floats.view(np.uint64), valid),
         "str": ("string", n, "".join(strs.tolist()).encode(),
                 soffs.tobytes(), valid),
         "dec_a": fixed("decimal128:2", decimal128_limbs(
             rng.integers(-10 ** 12, 10 ** 12, n)), valid),
         "dec_b": fixed("decimal128:2", decimal128_limbs(
             rng.integers(1, 10 ** 6, n) * rng.choice([-1, 1], n))),
         "days": fixed("timestamp_days", rng.integers(
             -200_000, 50_000, n).astype(np.int32)),
         "micros": fixed("timestamp_us", rng.integers(
             -10 ** 16, 2 * 10 ** 15, n)),
         "h32": fixed("int32", rng.integers(0, 1 << 12, n).astype(np.int32)),
         "h32b": fixed("int32", rng.integers(0, 1 << 12, n).astype(np.int32)),
         "freq": fixed("int64", rng.integers(0, 4, n))}
    # short JSON objects, one in 16 with a float, an escape or no object
    kinds = rng.integers(0, 16, n)
    docs = np.char.add(np.char.add('{"a":', ints.astype(str)),
                       ',"b":{"c":"x"}}')
    docs = np.where(kinds == 0, '{"a":1.5e3,"b":{"c":"y\\n"}}', docs)
    docs = np.where(kinds == 1, "[1,2]", docs)
    doffs = np.zeros(n + 1, np.int64)
    np.cumsum(np.char.str_len(docs), out=doffs[1:])
    w["json"] = ("string", n, "".join(docs.tolist()).encode(),
                 doffs.tobytes(), valid)
    bloom = {"num_hashes": 3, "num_longs": 1 << 14}
    pcts = {"percentages": [0.25, 0.5, 0.75], "as_list": True}

    def offs_wire(col):
        o = col.offsets.cpu().numpy().astype(np.int64)
        return ("int64", int(o.shape[0]), o.tobytes(), None, None)

    def list_parts(col, children):
        # the bridge's wire layout of a LIST: offsets, children, validity
        tail = [] if col.validity is None else [Column(
            dt.BOOL8, col.size, data=col.validity.to(torch.uint8))]
        return [offs_wire(col), *children, *tail]

    def hist_create(c):
        h = HI.create_histogram_if_valid(c[0], c[1], True)
        return list_parts(h, h.children[0].children)

    def hist_pct(c):
        h = Column.list_of(Column.struct_of([c[1], c[2]]),
                           c[0].data.to(torch.int32))
        p = HI.percentile_from_histogram(h, pcts["percentages"], True)
        return list_parts(p, p.children)

    def interleave(c):
        z = interleave_bits(c)
        return [offs_wire(z), z.children[0]]

    def raw_map(c):
        m = MU.extract_raw_map_from_json_string(c[0])
        return list_parts(m, m.children[0].children)

    def put(col):
        return BF.bloom_filter_put(BF.bloom_filter_create(3, 1 << 14, dev),
                                   col)

    def blob(f):
        data = torch.from_numpy(np.frombuffer(BF.serialize(f), np.uint8)
                                .copy()).to(dev)
        return Column(dt.UINT8, int(data.shape[0]), data=data)

    def filt(c):
        return BF.deserialize(c.to_numpy().tobytes(), dev)

    w["blob"] = col_to_wire(blob(put(wire_to_col(w["keys"], dev))))
    w["blob2"] = col_to_wire(blob(put(wire_to_col(w["i64"], dev))))
    batches = R.convert_to_rows(Table((wire_to_col(w["i64"], dev),)))
    rc = batches[0]
    rows_blob = Column(dt.UINT8, rc.children[0].size,
                       data=rc.children[0].data.view(torch.uint8))
    rows_offs = ("int64", int(rc.offsets.shape[0]), rc.offsets.cpu().numpy()
                 .astype(np.int64).tobytes(), None, None)
    w["rows_blob"], w["rows_offs"] = col_to_wire(rows_blob), rows_offs
    hist = hist_create([wire_to_col(w["f64"], dev),
                        wire_to_col(w["freq"], dev)])
    w["hist_offs"], w["hist_vals"], w["hist_freqs"] = [
        x if isinstance(x, tuple) else col_to_wire(x) for x in hist]
    kolkata = TZ.make_transition_table(
        [[(TZ.INT64_MIN, TZ.INT64_MIN, KOLKATA_LMT)] + KOLKATA],
        ["Asia/Kolkata"])

    def dec(fn, *a):
        t = fn(*a)
        return [t.columns[0], t.columns[1]]

    def from_rows(c):
        rows = Column.list_of(Column(dt.UINT8, c[0].size, data=c[0].data),
                              c[1].data.to(torch.int32))
        return list(R.convert_from_rows(rows, [dt.INT64]).columns)

    cases = [
        ("engine.echo", {}, ["i64", "str", "dec_a", "f64"], lambda c: c),
        ("hash.murmur3", {"seed": 42}, ["i64", "i32", "str", "f64"],
         lambda c: [H.murmur_hash3_32(Table(tuple(c)), seed=42)]),
        ("hash.xxhash64", {}, ["i64", "i32", "str", "f64"],
         lambda c: [H.xxhash64(Table(tuple(c)), seed=42)]),
        ("bloom.build", bloom, ["keys"], lambda c: [blob(put(c[0]))]),
        ("bloom.probe", {}, ["i64", "blob"],
         lambda c: [BF.bloom_filter_probe(c[0], filt(c[1]))]),
        ("bloom.merge", {}, ["blob", "blob2"],
         lambda c: [blob(BF.bloom_filter_merge([filt(x) for x in c]))]),
        ("cast.string_to_integer", {"type": "int32"}, ["str"],
         lambda c: [CS.string_to_integer(c[0], dt.INT32)]),
        ("cast.string_to_float", {"type": "float64"}, ["str"],
         lambda c: [CS.string_to_float(c[0], dt.FLOAT64)]),
        ("cast.string_to_decimal", {"precision": CAST_P, "scale": CAST_S},
         ["str"], lambda c: [CS.string_to_decimal(c[0], CAST_P, CAST_S)]),
        ("cast.string_to_integer_base", {"base": 16, "type": "int64"},
         ["str"], lambda c: [CB.to_integers_with_base(c[0], 16, dt.INT64)]),
        ("cast.integer_to_string_base", {"base": 16}, ["i32"],
         lambda c: [CB.from_integers_with_base(c[0], 16)]),
        ("cast.float_to_string", {}, ["f64"],
         lambda c: [CF.float_to_string(c[0])]),
        ("cast.format_number", {"digits": 2}, ["f64"],
         lambda c: [CF.format_number(c[0], 2)]),
        ("cast.decimal_to_string", {}, ["dec_a"],
         lambda c: [decimal_to_string(c[0])]),
        ("decimal.add", {"scale": 2}, ["dec_a", "dec_b"],
         lambda c: dec(D.add_decimal128, c[0], c[1], 2)),
        ("decimal.subtract", {"scale": 2}, ["dec_a", "dec_b"],
         lambda c: dec(D.sub_decimal128, c[0], c[1], 2)),
        ("decimal.multiply", {"scale": 4}, ["dec_a", "dec_b"],
         lambda c: dec(D.multiply_decimal128, c[0], c[1], 4, False)),
        ("decimal.divide", {"scale": 4}, ["dec_a", "dec_b"],
         lambda c: dec(D.divide_decimal128, c[0], c[1], 4)),
        ("decimal.integer_divide", {}, ["dec_a", "dec_b"],
         lambda c: dec(D.integer_divide_decimal128, c[0], c[1])),
        ("decimal.remainder", {"scale": 2}, ["dec_a", "dec_b"],
         lambda c: dec(D.remainder_decimal128, c[0], c[1], 2)),
        ("rowconv.to_rows", {}, ["i64"],
         lambda c: ([rows_blob, rows_offs],
                    {"n_batches": len(batches), "rows": rc.size})),
        ("rowconv.from_rows", {"types": ["int64"]}, ["rows_blob",
                                                     "rows_offs"], from_rows),
        ("zorder.hilbert", {"num_bits": 12}, ["h32", "h32b"],
         lambda c: [hilbert_index(12, c)]),
        ("zorder.interleave", {}, ["h32", "h32b"], interleave),
        ("histogram.create", {"as_lists": True}, ["f64", "freq"],
         hist_create),
        ("histogram.percentile", pcts, ["hist_offs", "hist_vals",
                                        "hist_freqs"], hist_pct),
        ("datetime.rebase", {"direction": "gregorian_to_julian"}, ["days"],
         lambda c: [DR.rebase_gregorian_to_julian(c[0])]),
        ("tz.to_utc", {"zone": "Asia/Kolkata"}, ["micros"],
         lambda c: [TZ.convert_timestamp_to_utc(c[0], kolkata, 0)]),
        ("tz.from_utc", {"zone": "Asia/Kolkata"}, ["micros"],
         lambda c: [TZ.convert_utc_timestamp_to_timezone(c[0], kolkata, 0)]),
        ("json.get_json_object", {"path": "$.b.c"}, ["json"],
         lambda c: [GJ.get_json_object(c[0], "$.b.c")]),
        ("json.from_json_map", {}, ["json"], raw_map),
    ]
    return cases, w


def bridge_checks(dev, n):
    """13g: each of the 31 ops through ``bridge.call`` on ``dev`` equal,
    wire byte for wire byte and meta JSON, to the op called directly;
    each op's wall ms through the bridge."""
    from spark_rapids_jni_tpu_torch import bridge
    from spark_rapids_jni_tpu_torch.columnar.interop import (col_to_wire,
                                                             wire_to_col)
    cases, w = bridge_cases(dev, n, 21)
    same, ms = {}, {}
    for op, args, names, direct in cases:
        wires = [w[k] for k in names]
        (got, meta), ms[op] = wall(lambda: bridge.call(
            op, json.dumps(args), wires, device=dev), dev)
        want = direct([wire_to_col(x, dev) for x in wires])
        want_meta = {}
        if isinstance(want, tuple):
            want, want_meta = want
        want = [x if isinstance(x, tuple) else col_to_wire(x) for x in want]
        same[op] = got == want and json.loads(meta) == want_meta
    return same, ms, sorted(bridge.ops())


def casts_phase(dev, card, rows, arrays=None, q1_want=None):
    """Phase 13 (``casts_sf10``): SF10 lineitem read from its TPC-H text
    and cast. Renders l_quantity, l_extendedprice, l_discount and l_tax of
    the q1 draws as dbgen's ``.tbl`` strings on the card
    (``datagen.tbl_decimal_strings``, held against numpy's formatting on a
    1M-row prefix); with the launch counts set to 0 casts them (13a:
    l_quantity to INT32 and INT64, the four to DECIMAL(12, 2), the price
    to FLOAT64 and FLOAT32), runs phase 11's decimal q1 over the four cast
    columns (13b, kernel H2), casts the FLOAT64 prices to strings and back
    (13c) and hashes l_orderkey through ``bridge.call("hash.murmur3")``
    (13d, B1); reads the counts; then checks every 60M-row cast exactly,
    q1 against numpy and the round trip on every row, the card against
    the CPU on 1M-row prefixes (13e), an ANSI error's row (13f) and the
    bridge's 31 ops against direct calls (13g); then times each cast at
    60M rows (first, warm, bound, launches, idle share, peak memory), the
    price cast over a column with one string in 100 of 256 characters
    (13h), and the bridge's murmur3 split into marshalling and B1 (13i).
    ``arrays`` and ``q1_want``: phase 11's ``decimal_lineitem_arrays(rows)``
    and its numpy q1, made here when not given. Returns the launches of
    the counted run."""
    from spark_rapids_jni_tpu_torch import bridge
    from spark_rapids_jni_tpu_torch.columnar import dtype as dt
    from spark_rapids_jni_tpu_torch.columnar.column import Column, Table
    from spark_rapids_jni_tpu_torch.columnar.interop import (col_to_wire,
                                                             wire_to_col)
    from spark_rapids_jni_tpu_torch.columnar.strings import pack_byte_rows
    from spark_rapids_jni_tpu_torch.ops import cast_float_to_string as CF
    from spark_rapids_jni_tpu_torch.ops import cast_string as CS
    from spark_rapids_jni_tpu_torch.ops import cast_string_base as CB
    from spark_rapids_jni_tpu_torch.ops import hashing as H
    from spark_rapids_jni_tpu_torch.ops import kernels as K
    from spark_rapids_jni_tpu_torch.utils import datagen

    cuda = dev.type == "cuda"
    cpu = torch.device("cpu")
    n1 = min(rows, 1_000_000)
    secs, t_part = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        secs[name] = now - t_part[0]
        t_part[0] = now

    a = decimal_lineitem_arrays(rows) if arrays is None else arrays
    money = {k: torch.from_numpy(a[k]).to(dev) for k in MONEY}
    frac = {"l_quantity": 0, "l_extendedprice": 2, "l_discount": 2,
            "l_tax": 2}
    text = {k: datagen.tbl_decimal_strings(
        money[k] // 100 if frac[k] == 0 else money[k], frac[k])
        for k in MONEY}
    other = {k: Column.from_numpy(a[k], device=dev) for k in (
        "l_orderkey", "l_returnflag", "l_linestatus", "l_shipdate")}
    _sync(dev)
    lap("generate")
    checks = {}
    for k in MONEY:
        chars, offs = _tbl_numpy(a[k][:n1] // (100 if frac[k] == 0 else 1),
                                 frac[k])
        got = _prefix(text[k], n1, cpu)
        checks[f"render_{k}_equals_numpy_1m"] = (
            np.array_equal(got.data.numpy(), chars)
            and np.array_equal(got.offsets.numpy().astype(np.int64), offs))
    jline({"phase": "casts_sf10", "part": "text", **card, "rows": rows,
           "bytes": {k: int(text[k].data.numel()) for k in MONEY},
           "first_rows": {k: _prefix(text[k], 3, cpu).to_pylist()
                          for k in MONEY}})

    # ---- the counted run --------------------------------------------------
    first, peaks = {}, {}

    def timed(name, fn):
        """fn()'s first call, on the wall clock, with its peak memory."""
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        out, first[name] = wall(fn, dev)
        if cuda:
            peaks[name] = (torch.cuda.max_memory_allocated() - base) / 1e9
        return out

    K.reset_launches()
    t0 = time.perf_counter()
    # each first call pads its column itself (a fresh Column object)
    qty32 = timed("s2i_int32", lambda: CS.string_to_integer(
        _fresh(text["l_quantity"]), dt.INT32))
    qty64 = timed("s2i_int64", lambda: CS.string_to_integer(
        _fresh(text["l_quantity"]), dt.INT64))
    decs = {k: timed(f"s2d_{k}", lambda k=k: CS.string_to_decimal(
        _fresh(text[k]), CAST_P, CAST_S)) for k in MONEY}
    f64 = timed("s2f_float64", lambda: CS.string_to_float(
        _fresh(text["l_extendedprice"]), dt.FLOAT64))
    f32 = timed("s2f_float32", lambda: CS.string_to_float(
        _fresh(text["l_extendedprice"]), dt.FLOAT32))
    li = Table((other["l_orderkey"],) + tuple(_widen128(decs[k])
                                              for k in MONEY)
               + (other["l_returnflag"], other["l_linestatus"],
                  other["l_shipdate"]))
    (q1, _, over), first["q1_decimal"] = wall(lambda: q1_decimal(li), dev)
    price_text = timed("f2s_float64", lambda: CF.float_to_string(f64))
    back = CS.string_to_float(price_text, dt.FLOAT64)
    key_wire = [col_to_wire(other["l_orderkey"])]
    (hashed, _), first["bridge_murmur3"] = wall(lambda: bridge.call(
        "hash.murmur3", "{}", key_wire, device=dev), dev)
    _sync(dev)
    counted_s = time.perf_counter() - t0
    launches = _kernel_counts()
    log(f"phase 13 launches: {launches}")
    for wrapper in ("murmur3_fixed_rows", "decimal128_op"):
        if cuda and launches[wrapper] < 1:
            raise AssertionError(f"phase 13 never launched {wrapper}")
    lap("counted_run")

    # ---- checks ----------------------------------------------------------
    qty = money["l_quantity"] // 100  # whole units; money holds x 100
    checks["s2i_int32_equals_draws"] = bool(
        (qty32.data == qty.to(torch.int32)).all() and qty32.validity.all())
    checks["s2i_int64_equals_draws"] = bool(
        (qty64.data == qty).all() and qty64.validity.all())
    for k in MONEY:
        d = decs[k]
        checks[f"s2d_{k}_equals_unscaled"] = bool(
            d.dtype == dt.decimal64(2) and (d.data == money[k]).all()
            and d.validity.all())
    # numpy's division on the host: one correctly rounded IEEE division
    # of two exact integers (torch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not)
    cents = a["l_extendedprice"]
    for name, col, want in (
            ("float64", f64, (cents.astype(np.float64) / np.float64(100))
             .view(np.int64)),
            ("float32", f32, (cents.astype(np.float32) / np.float32(100))
             .view(np.int32))):
        checks[f"s2f_{name}_equals_cents_div_100"] = bool(
            np.array_equal(_bits(col).cpu().numpy(), want)
            and col.validity.all())
    checks["q1_over_cast_columns_equals_numpy"] = _q1_rows(q1) == (
        numpy_q1_decimal(a) if q1_want is None else q1_want)
    checks["q1_no_overflow"] = not bool(over)
    checks["round_trip_bits_every_row"] = bool(
        (_bits(back) == _bits(f64)).all() and back.validity.all())
    del back, price_text, li
    checks["bridge_murmur3_equals_direct"] = hashed == [col_to_wire(
        H.murmur_hash3_32([other["l_orderkey"]]))]
    lap("checks_60m")

    # 13e: the card against the CPU on 1M-row prefixes
    p64, p32 = _prefix(f64, n1, dev), _prefix(f32, n1, dev)
    for name, fn, col in (
            ("f2s_float64", CF.float_to_string, p64),
            ("f2s_float32", CF.float_to_string, p32),
            ("format_number_2", lambda c: CF.format_number(c, 2), p64)):
        checks[f"{name}_equals_cpu_1m"] = _same_on_host(
            fn(col), fn(_prefix(col, n1, cpu)))
    keys = _prefix(other["l_orderkey"], n1, dev)
    for base in (10, 16):
        s_dev = CB.from_integers_with_base(keys, base)
        s_cpu = CB.from_integers_with_base(_prefix(keys, n1, cpu), base)
        checks[f"from_integers_base{base}_equals_cpu_1m"] = _same_on_host(
            s_dev, s_cpu)
        i_dev = CB.to_integers_with_base(s_dev, base, dt.INT64)
        checks[f"to_integers_base{base}_equals_cpu_1m"] = _same_on_host(
            i_dev, CB.to_integers_with_base(s_cpu, base, dt.INT64))
        checks[f"to_integers_base{base}_round_trip"] = bool(
            (i_dev.data == keys.data).all())
    rng = np.random.default_rng(0)  # the JAX package's cast cell, seed 0
    cell = rng.standard_normal(n1) * 10.0 ** rng.integers(-5, 6, n1)
    cell_s = [f"{v:.6f}" for v in cell]
    cell_col = pack_byte_rows([s.encode() for s in cell_s], device=dev)
    cell_dev = CS.string_to_float(cell_col, dt.FLOAT64)
    checks["cast_cell_equals_cpu_1m"] = _same_on_host(
        cell_dev, CS.string_to_float(_prefix(cell_col, n1, cpu),
                                     dt.FLOAT64))
    checks["cast_cell_equals_python_float_1m"] = np.array_equal(
        cell_dev.data.cpu().numpy().view(np.uint64),
        np.array([float(s) for s in cell_s]).view(np.uint64))
    del cell, cell_s, cell_col, cell_dev
    lap("checks_1m")

    # 13f: ANSI mode names its first bad row
    bad = _prefix(text["l_quantity"], n1, dev)
    start = int(bad.offsets[min(ANSI_ROW, n1 - 1)])
    bad.data = bad.data.clone()
    bad.data[start] = ord("x")
    row = min(ANSI_ROW, n1 - 1)
    try:
        CS.string_to_integer(bad, dt.INT32, ansi_mode=True)
        checks["ansi_raises_on_its_row"] = False
    except CS.CastException as e:
        checks["ansi_raises_on_its_row"] = (
            e.row_number == row and e.string_with_error.startswith("x"))
    # 13g: the bridge's 31 ops against direct calls
    same, bridge_ms, ops = bridge_checks(dev, n1)
    checks["bridge_31_ops_equal_direct_calls"] = (
        len(same) == BRIDGE_OPS and all(same.values()))
    checks["bridge_has_31_ops"] = len(ops) == 31
    lap("checks_bridge")
    jline({"phase": "casts_sf10", "part": "checks", **card, "rows": rows,
           "q1_first_row": _q1_rows(q1)[0], "bridge_ops_equal": same,
           **checks})
    failed = [k for k, ok in checks.items() if ok is not True]
    if failed:
        raise AssertionError(f"phase 13: {failed}")
    log("check phase 13: every 60M-row cast exact; decimal q1 over the "
        "cast columns == numpy; the round trip on every row; the card == "
        "the CPU on 1M rows; ANSI names its row; the bridge == direct "
        "calls")
    jline({"phase": "casts_sf10", "part": "bridge_ops_wall_ms", **card,
           "rows": n1, **bridge_ms})
    del qty, qty32, qty64, f32, q1, p64, p32, keys, bad

    # ---- times (the card only) -------------------------------------------
    if not cuda:
        return launches
    str_bytes = {k: int(text[k].data.numel()) + 4 * (rows + 1)
                 for k in MONEY}
    long_text = _with_long_rows(text["l_extendedprice"], LONG_LEN,
                                LONG_EVERY)
    work = [
        ("s2i_int32", lambda c: CS.string_to_integer(c, dt.INT32),
         "l_quantity", 4 + 1),
        ("s2i_int64", lambda c: CS.string_to_integer(c, dt.INT64),
         "l_quantity", 8 + 1)] + [
        (f"s2d_{k}", lambda c: CS.string_to_decimal(c, CAST_P, CAST_S),
         k, 8 + 1) for k in MONEY] + [
        ("s2f_float64", lambda c: CS.string_to_float(c, dt.FLOAT64),
         "l_extendedprice", 8 + 1),
        ("s2f_float32", lambda c: CS.string_to_float(c, dt.FLOAT32),
         "l_extendedprice", 4 + 1)]
    for name, fn, src, out_row in work:
        col = text[src]
        in_bytes = str_bytes[src]
        _time_cast(card, name, lambda: fn(_fresh(col)), rows,
                   in_bytes + out_row * rows, first.get(name),
                   peaks.get(name), CAST_WARM)
    f2s_out = CF.float_to_string(f64)
    _time_cast(card, "f2s_float64", lambda: CF.float_to_string(f64), rows,
               (8 + 2) * rows + int(f2s_out.data.numel()) + 4 * (rows + 1),
               first.get("f2s_float64"), peaks.get("f2s_float64"), CAST_WARM)
    del f2s_out
    long_bytes = int(long_text.data.numel()) + 4 * (rows + 1)
    _sync(dev)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got_long, long_first = wall(lambda: CS.string_to_float(
        _fresh(long_text), dt.FLOAT64), dev)
    long_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    if not bool((_bits(got_long) == _bits(f64)).all()):
        raise AssertionError("phase 13: the long strings cast to other bits")
    del got_long
    _time_cast(card, "s2f_float64_1pct_256_chars", lambda: CS.string_to_float(
        _fresh(long_text), dt.FLOAT64), rows, long_bytes + 9 * rows,
        long_first, long_peak, 3, profiled=False,
        extra={"long_rows": rows // LONG_EVERY, "long_len": LONG_LEN})
    del long_text
    lap("cast_times")

    # 13i: the bridge's murmur3 at 60M rows: marshalling and B1
    key = other["l_orderkey"]
    total = sorted(wall(lambda: bridge.call("hash.murmur3", "{}", key_wire,
                                            device=dev), dev)[1]
                   for _ in range(3))[1]
    to_card = sorted(wall(lambda: wire_to_col(key_wire[0], dev), dev)[1]
                     for _ in range(3))[1]
    out_col = H.murmur_hash3_32([key])
    to_wire = sorted(wall(lambda: col_to_wire(out_col), dev)[1]
                     for _ in range(3))[1]
    op_ms = cuda_ms(lambda: H.murmur_hash3_32([key]), reps=5)
    schema = _schema([key], False)
    b1_ms = cuda_ms(lambda: K.murmur3_fixed_rows(schema, 42, rows), reps=5)
    jline({"phase": "casts_sf10", "part": "bridge_murmur3_time", **card,
           "rows": rows, "first_ms": first["bridge_murmur3"],
           "warm_ms": total, "wire_to_card_ms": to_card,
           "card_to_wire_ms": to_wire, "murmur_hash3_32_ms": op_ms,
           "b1_kernel_ms": b1_ms,
           "marshalling_share": (to_card + to_wire) / total,
           "b1_share": b1_ms / total,
           "wire_bytes_in": len(key_wire[0][2]), "wire_bytes_out": 4 * rows})
    lap("bridge_time")
    jline({"phase": "casts_sf10", "part": "seconds", **card,
           "counted_run_s": counted_s, "first_ms": first, **secs})
    return launches


def _time_cast(card, name, fn, rows, nbytes, first_ms, peak_gb, warm,
               profiled=True, extra=None):
    """One cast at 60M rows: warm median of ``warm`` calls by CUDA events,
    its byte bound and (``profiled``) one call under the profiler
    (launches, idle share)."""
    times = []
    for _ in range(warm):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    b_ms, b_by = bound_ms(nbytes, 0)
    warm_ms = sorted(times)[len(times) // 2]
    jline({"phase": "casts_sf10", "part": "cast_time", **card, "cast": name,
           "rows": rows, "first_ms": first_ms, "warm_ms": warm_ms,
           "warm_all_ms": times, "bound_ms": b_ms, "bound_by": b_by,
           "bound_share": b_ms / warm_ms, "bytes": nbytes,
           "peak_memory_gb": peak_gb,
           **(cast_profile(fn) if profiled else {}), **(extra or {})})


# ---- phase 14: nested columns ---------------------------------------------
NESTED_CUTOFF = 1200        # 14d: orders with o_orderdate before this day
NESTED_PCTS = [0.25, 0.5, 0.75]
NESTED_WARM = 5             # warm calls a timed step's median is taken of
NESTED_READ_WARM = 1        # warm reads (the first under the profiler)
SKEW_EVERY, SKEW_LEN = 10_000, 4096   # 14c's skewed copy
WIDE_UNITS = 70             # the 64-unit repair's schema width
BRIDGE_ROWS = 1_000_000     # 14g
# the whole run takes phase 14 at half SF10's lineitems (7.5M orders), so
# that all 15 phases end well inside the run's limit; ``python3
# chip_smoke.py nested_sf10`` runs it at SF10
NESTED_RUN_ROWS = SF10_ROWS // 2
Z_CHECK_EVERY = 8           # 14f: numpy checks every 8th of the 60M rows


def nested_orders_arrays(rows, dev):
    """Phase 14's orders: SF10's lineitem draws (tpch.q3_arrays, and
    l_quantity of tpch.q1_arrays) stably sorted on l_orderkey on ``dev``
    and grouped into the rows / 4 orders, with the seeded nulls TPC-H
    lacks (1% of o_lines rows, 1% of l_quantity elements, 1% of o_key
    rows). Host numpy arrays: per order ``offsets`` (rows + 1),
    ``o_custkey``, ``o_orderdate``, ``lines_valid``, ``key_valid``; per
    lineitem, in order, ``l_linekey`` (l_orderkey x 64 + its line
    number), ``l_quantity`` (int32), ``q_valid``, ``l_extendedprice``,
    ``l_shipdate``, ``l_discount``."""
    from spark_rapids_jni_tpu_torch import tpch
    a = tpch.q3_arrays(rows, 0)
    q = tpch.q1_arrays(rows, 0)["l_quantity"]
    nord = a["o_orderkey"].shape[0]
    key = torch.from_numpy(a["l_orderkey"]).to(dev)
    perm = torch.sort(key, stable=True).indices
    key = key.index_select(0, perm)
    counts = torch.bincount(key, minlength=nord)
    offsets = torch.zeros(nord + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=offsets[1:])
    line = torch.arange(rows, device=dev) - offsets.index_select(0, key)
    out = {"offsets": offsets, "l_linekey": key * 64 + line}
    for name, arr in (("l_quantity", q.astype(np.int32)),
                      ("l_extendedprice", a["l_extendedprice"]),
                      ("l_shipdate", a["l_shipdate"]),
                      ("l_discount", a["l_discount"])):
        out[name] = torch.from_numpy(arr).to(dev).index_select(0, perm)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    rng = np.random.default_rng(14)
    out.update(o_custkey=a["o_custkey"], o_orderdate=a["o_orderdate"],
               lines_valid=rng.random(nord) >= 0.01,
               q_valid=rng.random(rows) >= 0.01,
               key_valid=rng.random(nord) >= 0.01)
    return out


def nested_orders_columns(o):
    """The writer's columns of phase 14's orders table."""
    from spark_rapids_jni_tpu_torch.utils import datagen_parquet as W
    nord = o["o_custkey"].shape[0]
    return [
        W.ParquetColumn("o_orderkey", values=np.arange(nord,
                                                       dtype=np.int64)),
        W.StructField("o_key", [
            W.ParquetColumn("o_custkey", values=o["o_custkey"]),
            W.ParquetColumn("o_orderdate", values=o["o_orderdate"],
                            converted=W.DATE)], valid=o["key_valid"]),
        W.ListField("o_linekeys", o["offsets"],
                    W.ParquetColumn("l_linekey", values=o["l_linekey"])),
        W.ListField("o_lines", o["offsets"], W.StructField("line", [
            W.ParquetColumn("l_quantity", values=o["l_quantity"],
                            valid=o["q_valid"]),
            W.ParquetColumn("l_extendedprice", values=o["l_extendedprice"]),
            W.ParquetColumn("l_shipdate", values=o["l_shipdate"],
                            converted=W.DATE)]), valid=o["lines_valid"]),
    ]


def numpy_interleave3(cols):
    """Z-order bytes of three int32 arrays, column 0 most significant, by
    numpy's unpackbits (independent of the port)."""
    be = np.stack([c.astype(">i4").view(np.uint8).reshape(-1, 4)
                   for c in cols], axis=1)             # [n, 3, 4]
    bits = np.unpackbits(be, axis=2)                   # [n, 3, 32]
    return np.packbits(bits.transpose(0, 2, 1).reshape(len(cols[0]), -1),
                       axis=1)                         # [n, 12]


def numpy_list_percentiles(offsets, values, valid, pcts):
    """Per row, numpy's linear percentile of its valid values (NaN for a
    row with none; the values small non-negative ints): the items at
    floor and ceil of p x (k - 1) of the row's sorted values,
    interpolated. The rows' values sort as one key, row x 64 + value,
    which the rows' order leaves nearly sorted (a stable sort's runs)."""
    n = offsets.shape[0] - 1
    lens = np.diff(offsets)
    row = np.repeat(np.arange(n, dtype=np.int64), lens)[valid]
    v = values[valid].astype(np.int64)
    assert v.size == 0 or (v.min() >= 0 and v.max() < 64)
    key = np.sort(row * 64 + v, kind="stable")
    v, row = key & 63, key >> 6
    k = np.bincount(row, minlength=n)
    start = np.concatenate([[0], np.cumsum(k)[:-1]])
    out = np.full((n, len(pcts)), np.nan)
    has = k > 0
    for j, p in enumerate(pcts):
        pos = p * (k[has] - 1)
        lo, hi = np.floor(pos), np.ceil(pos)
        vlo = v[start[has] + lo.astype(np.int64)].astype(np.float64)
        vhi = v[start[has] + hi.astype(np.int64)].astype(np.float64)
        out[has, j] = vlo + (vhi - vlo) * (pos - lo)
    return out, has


def nested_phase(dev, card, rows):
    """Phase 14 (``nested_sf10``): nested columns at SF10. Writes the
    orders table of ``nested_orders_arrays`` (o_orderkey, the STRUCT key
    o_key, LIST<INT64> o_linekeys, LIST<STRUCT> o_lines) with the port's
    writer; with the launch counts set to 0 reads it through
    ParquetReader in several chunks (14a), hashes o_key (14b: Spark's
    HashPartitioning on a struct, B1) and o_linekeys (14c: B1's LIST
    entry), sorts the orders on o_orderdate and filters them to a cutoff
    carrying o_lines (14d), takes percentiles of each order's quantities
    and a histogram of the 60M quantities (14e), interleaves three
    lineitem columns (14f) and calls the three ops through the bridge
    (14g); reads the counts; then checks each step against the draws and
    numpy, B1 against its plain version (also on a skewed copy and at 70
    units, the 64-unit repair), the card against the CPU on 1M-row
    prefixes, and times each step. Returns the launches of the counted
    run."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="nested_sf10_")
    try:
        return _nested_phase(dev, card, rows, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _nested_phase(dev, card, rows, tmp):
    import os
    from spark_rapids_jni_tpu_torch import bridge
    from spark_rapids_jni_tpu_torch.columnar import dtype as dt
    from spark_rapids_jni_tpu_torch.columnar.column import Column, Table
    from spark_rapids_jni_tpu_torch.columnar.interop import col_to_wire
    from spark_rapids_jni_tpu_torch.columnar.table_ops import (
        concat_tables, filter_table)
    from spark_rapids_jni_tpu_torch.ops import hashing as H
    from spark_rapids_jni_tpu_torch.ops import histogram as HI
    from spark_rapids_jni_tpu_torch.ops import kernels as K
    from spark_rapids_jni_tpu_torch.ops.sort import sort_table
    from spark_rapids_jni_tpu_torch.ops.zorder import interleave_bits
    from spark_rapids_jni_tpu_torch.parquet.reader import ParquetReader
    from spark_rapids_jni_tpu_torch.utils import datagen_parquet as W

    cuda = dev.type == "cuda"
    cpu = torch.device("cpu")
    secs, t_part = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        secs[name] = now - t_part[0]
        t_part[0] = now

    o = nested_orders_arrays(rows, dev)
    nord = o["o_custkey"].shape[0]
    lap("generate")
    path = os.path.join(tmp, "orders.parquet")
    # parquet-mr's row groups (128 MiB) at SF10; four at a rehearsal's
    # few rows, so that the read still takes several chunks
    info = W.write_parquet(path, nested_orders_columns(o),
                           row_group_rows=None if rows >= 10_000_000
                           else -(-nord // 4))
    lap("write")
    jline({"phase": "nested_sf10", "part": "file", **card, "orders": nord,
           "lineitems": rows, "bytes": info["bytes"],
           "row_groups": len(info["row_groups"]),
           "empty_orders": int((np.diff(o["offsets"]) == 0).sum()),
           "longest_order": int(np.diff(o["offsets"]).max()),
           "null_rows": {"o_lines": int((~o["lines_valid"]).sum()),
                         "o_key": int((~o["key_valid"]).sum()),
                         "l_quantity": int((~o["q_valid"]).sum())},
           "encodings": info["encodings"], "write_s": secs["write"]})
    budget = info["bytes"] // 3 + 1   # three or more chunks

    def read(timings=None):
        with ParquetReader(path, device=dev, timings=timings) as r:
            chunks = list(r.iter_chunks(byte_budget=budget))
            return concat_tables(chunks), len(chunks), r.routes

    def hash_key(t):
        return H.murmur_hash3_32([t[1]])

    def hash_lines(t):
        return H.murmur_hash3_32([t[2]])

    def sort_filter(t):
        od = t[1].children[1]
        s = sort_table(Table((t[0], od, t[3])), [1])
        keep = s[1].valid_mask() & (s[1].data < NESTED_CUTOFF)
        return filter_table(s, keep)

    def histograms(t):
        lines = t[3]
        q = lines.children[0].children[0]
        freq = Column(dt.INT64, q.size, data=q.valid_mask().to(torch.int64))
        vals = Column(q.dtype, q.size, data=q.data)
        return Column.list_of(Column.struct_of([vals, freq]), lines.offsets,
                              lines.validity)

    def percentiles(t):
        return HI.percentile_from_histogram(histograms(t), NESTED_PCTS,
                                            True)

    qty_col = Column(dt.INT32, rows, data=torch.from_numpy(
        o["l_quantity"]).to(dev), validity=torch.from_numpy(
        o["q_valid"]).to(dev))
    ones = Column(dt.INT64, rows, data=torch.ones(rows, dtype=torch.int64,
                                                  device=dev))
    z_cols = [Column(dt.INT32, rows, data=torch.from_numpy(
        np.ascontiguousarray(o[k])).to(dev))
        for k in ("l_quantity", "l_shipdate", "l_discount")]
    n_b = min(BRIDGE_ROWS, rows)
    b_vals = Column(dt.INT32, n_b, data=qty_col.data[:n_b].clone(),
                    validity=qty_col.validity[:n_b].clone())
    b_freq = Column(dt.INT64, n_b, data=torch.from_numpy(
        np.random.default_rng(15).integers(0, 4, n_b)).to(dev))
    b_wires = [col_to_wire(b_vals), col_to_wire(b_freq)]
    z_wires = [col_to_wire(Column(dt.INT32, n_b, data=c.data[:n_b].clone()))
               for c in z_cols]
    _sync(dev)
    lap("inputs")

    # ---- the counted run --------------------------------------------------
    K.reset_launches()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if cuda else 0
    first, out = {}, {}
    tm_first = {}
    (t, n_chunks, routes), first["read"] = wall(lambda: read(tm_first), dev)
    b1_steps = {}   # B1's launches in each step of this run
    for name, fn in (("hash_o_key", hash_key),
                     ("hash_o_linekeys", hash_lines),
                     ("sort_filter", sort_filter),
                     ("percentiles", percentiles)):
        b1_before = K.murmur3_fixed_rows.launches
        out[name], first[name] = wall(lambda fn=fn: fn(t), dev)
        b1_steps[name] = K.murmur3_fixed_rows.launches - b1_before
    out["create_histogram"], first["create_histogram"] = wall(
        lambda: HI.create_histogram_if_valid(qty_col, ones, True), dev)
    out["interleave"], first["interleave"] = wall(
        lambda: interleave_bits(z_cols), dev)
    bridge_out = {}
    for name, op, args, wires in (
            ("histogram.create", "histogram.create", {"as_lists": True},
             b_wires),
            ("zorder.interleave", "zorder.interleave", {}, z_wires)):
        bridge_out[name], first[f"bridge_{name}"] = wall(
            lambda op=op, args=args, wires=wires: bridge.call(
                op, json.dumps(args), wires, device=dev), dev)
    pct_args = {"percentages": NESTED_PCTS, "as_list": True}
    bridge_out["histogram.percentile"], first[
        "bridge_histogram.percentile"] = wall(lambda: bridge.call(
            "histogram.percentile", json.dumps(pct_args),
            bridge_out["histogram.create"][0][:3], device=dev), dev)
    launches = {w: getattr(K, w).launches for _, w, _, _ in K.KERNELS}
    peak = ((torch.cuda.max_memory_allocated() - base) / 1e9
            if cuda else None)
    lap("counted_run")
    if cuda and (launches["murmur3_fixed_rows"] != 2
                 or b1_steps["hash_o_key"] != 1
                 or b1_steps["hash_o_linekeys"] != 1):
        raise AssertionError(f"phase 14's path launched B1 "
                             f"{launches['murmur3_fixed_rows']} times "
                             f"({b1_steps}), not once in 14b and once in "
                             f"14c")

    # ---- checks -----------------------------------------------------------
    checks = {}
    dev_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    lens = np.diff(o["offsets"])
    checks["read_in_chunks"] = n_chunks >= 2
    checks["routes"] = not cuda or (
        routes["o_linekeys"]["tier"] == "device"
                        and routes["o_orderkey"]["tier"] == "device"
        and all(routes[f"o_key.{f}"]["tier"] == "host"
                for f in ("o_custkey", "o_orderdate")))
    ok_col, key, linekeys, lines = t.columns
    checks["o_orderkey"] = bool(torch.equal(ok_col.data, torch.arange(
        nord, device=dev)))
    kv = dev_t(o["key_valid"])
    cust, od = key.children
    checks["o_key"] = (bool(torch.equal(key.valid_mask(), kv))
                       and all(bool(torch.equal(c.valid_mask(), kv))
                               for c in key.children)
                       and bool(torch.equal(cust.data[kv],
                                            dev_t(o["o_custkey"])[kv]))
                       and bool(torch.equal(od.data[kv],
                                            dev_t(o["o_orderdate"])[kv])))
    checks["o_linekeys"] = (
        bool(torch.equal(linekeys.offsets, dev_t(o["offsets"]).to(
            torch.int32)))
        and bool(linekeys.valid_mask().all())
        and bool(torch.equal(linekeys.children[0].data,
                             dev_t(o["l_linekey"]))))
    lv = o["lines_valid"]
    keep_el = np.repeat(lv, lens)
    want_offs = np.zeros(nord + 1, np.int64)
    np.cumsum(np.where(lv, lens, 0), out=want_offs[1:])
    q, price, ship = lines.children[0].children
    qv = o["q_valid"][keep_el]
    checks["o_lines"] = (
        bool(torch.equal(lines.valid_mask(), dev_t(lv)))
        and bool(torch.equal(lines.offsets, dev_t(want_offs).to(
            torch.int32)))
        and bool(torch.equal(q.valid_mask(), dev_t(qv)))
        and bool(torch.equal(q.data[dev_t(qv)],
                             dev_t(o["l_quantity"][keep_el][qv])))
        and bool(torch.equal(price.data, dev_t(o["l_extendedprice"]
                                               [keep_el])))
        and bool(torch.equal(ship.data, dev_t(o["l_shipdate"][keep_el]))))
    lap("check_read")

    # 14b: the struct key, B1 against its plain version and against the
    # flattened fields with the parent's nulls laid over
    kmask = key.valid_mask()
    schema_key = [("u64", cust.data, kmask & cust.valid_mask()),
                  ("u32", od.data, kmask & od.valid_mask())]
    plain_key = K.murmur3_fixed_rows_plain(schema_key, 42, nord)
    flat = H.murmur_hash3_32([
        Column(dt.INT64, nord, data=cust.data,
               validity=kmask & cust.valid_mask()),
        Column(dt.INT32, nord, data=od.data,
               validity=kmask & od.valid_mask())])
    checks["hash_o_key_equals_plain"] = bool(torch.equal(
        out["hash_o_key"].data, plain_key))
    checks["hash_o_key_equals_flattened"] = bool(torch.equal(
        out["hash_o_key"].data, flat.data))
    # 14c: B1's LIST entry, and the skewed copy
    lk = linekeys.children[0]
    starts, ends = linekeys.offsets[:-1], linekeys.offsets[1:]
    schema_list = [("list", (starts, ends, "u64", lk.data, None), None)]
    checks["hash_o_linekeys_equals_plain"] = bool(torch.equal(
        out["hash_o_linekeys"].data,
        K.murmur3_fixed_rows_plain(schema_list, 42, nord)))
    skew_lens = torch.from_numpy(lens.copy()).to(dev)
    skew_lens[::SKEW_EVERY] = SKEW_LEN
    skew_offs = torch.zeros(nord + 1, dtype=torch.int32, device=dev)
    torch.cumsum(skew_lens, 0, dtype=torch.int32, out=skew_offs[1:])
    gen = torch.Generator(device=dev).manual_seed(16)
    skew_leaf = torch.randint(-(1 << 62), 1 << 62, (int(skew_offs[-1]),),
                              generator=gen, device=dev)
    schema_skew = [("list", (skew_offs[:-1], skew_offs[1:], "u64",
                             skew_leaf, None), None)]
    skew_hash = K.murmur3_fixed_rows(schema_skew, 42, nord)
    checks["hash_skewed_equals_plain"] = bool(torch.equal(
        skew_hash, K.murmur3_fixed_rows_plain(schema_skew, 42, nord)))
    # the 64-unit repair: 70 INT32 units, on 1M rows
    n1 = min(rows, 1_000_000)
    wide = [("u32", torch.randint(-1000, 1000, (n1,), generator=gen,
                                  device=dev, dtype=torch.int32),
             torch.rand(n1, generator=gen, device=dev) > 0.1)
            for _ in range(WIDE_UNITS)]
    before = (K.murmur3_fixed_rows.launches, K.xxhash64_fixed_rows.launches)
    checks["b1_70_units_equals_plain"] = bool(torch.equal(
        K.murmur3_fixed_rows(wide, 42, n1),
        K.murmur3_fixed_rows_plain(wide, 42, n1)))
    checks["b2_70_units_equals_plain"] = bool(torch.equal(
        K.xxhash64_fixed_rows(wide, 42, n1),
        K.xxhash64_fixed_rows_plain(wide, 42, n1)))
    wide_launches = (K.murmur3_fixed_rows.launches - before[0],
                     K.xxhash64_fixed_rows.launches - before[1])
    if cuda:
        checks["wide_launches_2_each"] = wide_launches == (2, 2)
    lap("check_hashes")

    # 14d: numpy's stable sort on (null first, o_orderdate), then the cutoff
    odv = np.where(o["key_valid"], o["o_orderdate"], -1)
    order = np.argsort((odv + 1).astype(np.int16), kind="stable")
    rows_d = order[(odv[order] >= 0) & (odv[order] < NESTED_CUTOFF)]
    sf = out["sort_filter"]
    got_lens = np.diff(sf[2].offsets.cpu().numpy())
    want_lens = np.where(lv, lens, 0)[rows_d]
    el_first = want_offs[:-1][rows_d]
    el_idx = np.repeat(el_first - np.concatenate([[0], np.cumsum(
        want_lens)[:-1]]), want_lens) + np.arange(int(want_lens.sum()))
    checks["sort_filter_equals_numpy"] = (
        np.array_equal(sf[0].data.cpu().numpy(), rows_d)
        and np.array_equal(got_lens, want_lens)
        and np.array_equal(sf[2].validity.cpu().numpy() if sf[2].validity
                           is not None else np.ones(len(rows_d), bool),
                           lv[rows_d])
        and np.array_equal(
            sf[2].children[0].children[1].data.cpu().numpy(),
            o["l_extendedprice"][keep_el][el_idx]))
    # 14e: the percentiles against numpy's, the histogram of 60M
    pct = out["percentiles"]
    want_pct, has = numpy_list_percentiles(
        want_offs, o["l_quantity"][keep_el], qv, NESTED_PCTS)
    has &= lv
    got_valid = pct.validity.cpu().numpy()
    got_vals = pct.children[0].data.cpu().numpy().reshape(-1,
                                                          len(NESTED_PCTS))
    checks["percentiles_equal_numpy"] = (
        np.array_equal(got_valid, has)
        and np.array_equal(got_vals, want_pct[has]))
    ch = out["create_histogram"]
    qvalid_all = o["q_valid"]
    checks["create_histogram_60m"] = (
        np.array_equal(np.diff(ch.offsets.cpu().numpy()),
                       qvalid_all.astype(np.int32))
        and np.array_equal(ch.children[0].children[0].data.cpu().numpy(),
                           o["l_quantity"][qvalid_all]))
    # the card against the CPU at 1M prefixes, on values where a fused
    # multiply-add rounds apart from a multiply then an add
    rng = np.random.default_rng(17)
    n_f = min(nord, 1_000_000)
    f_lens = rng.integers(1, 8, n_f)
    f_offs = np.concatenate([[0], np.cumsum(f_lens)]).astype(np.int32)
    f_vals = rng.standard_normal(int(f_offs[-1])) * 1e3
    f_freq = rng.integers(1, 6, int(f_offs[-1]))
    f_pcts = [0.1, 0.3, 0.5, 0.7, 0.9]

    def f_hist(d):
        return Column.list_of(Column.struct_of([
            Column.from_numpy(f_vals, dt.FLOAT64, device=d),
            Column.from_numpy(f_freq, dt.INT64, device=d)]),
            torch.from_numpy(f_offs).to(d))

    f_card = HI.percentile_from_histogram(f_hist(dev), f_pcts, False)
    f_cpu = HI.percentile_from_histogram(f_hist(cpu), f_pcts, False)
    checks["percentile_card_equals_cpu_1m"] = bool(torch.equal(
        f_card.data.cpu().view(torch.int64), f_cpu.data.view(torch.int64)))
    # 14f: against numpy's bit interleave, on every Z_CHECK_EVERY-th row
    # of the 60M (and every row of a rehearsal's few)
    step = Z_CHECK_EVERY if rows >= 10_000_000 else 1
    z = out["interleave"].children[0].data.view(-1, 12)[::step]
    zc = [o[k][::step] for k in ("l_quantity", "l_shipdate", "l_discount")]
    checks["interleave_equals_numpy"] = np.array_equal(
        z.cpu().numpy(), numpy_interleave3(zc))
    # 14g: the bridge's three ops == the direct calls
    direct_h = HI.create_histogram_if_valid(b_vals, b_freq, True)
    hw = bridge_out["histogram.create"][0]
    checks["bridge_histogram_create"] = (
        hw[0][2] == direct_h.offsets.cpu().numpy().astype(np.int64)
        .tobytes()
        and hw[1] == col_to_wire(direct_h.children[0].children[0])
        and hw[2] == col_to_wire(direct_h.children[0].children[1]))
    direct_p = HI.percentile_from_histogram(direct_h, NESTED_PCTS, True)
    pw = bridge_out["histogram.percentile"][0]
    checks["bridge_histogram_percentile"] = (
        pw[0][2] == direct_p.offsets.cpu().numpy().astype(np.int64)
        .tobytes() and pw[1] == col_to_wire(direct_p.children[0]))
    direct_z = interleave_bits([Column(dt.INT32, n_b, data=c.data[:n_b])
                                for c in z_cols])
    zw = bridge_out["zorder.interleave"][0]
    checks["bridge_zorder_interleave"] = (
        zw[1] == col_to_wire(direct_z.children[0]))
    lap("check_rest")
    jline({"phase": "nested_sf10", "part": "checks", **card,
           "checks": checks, "launches": launches,
           "b1_launches_by_step": b1_steps,
           "wide_launches": wide_launches, "peak_memory_gb": peak,
           "read_chunks": n_chunks, "routes": routes,
           "first_read_split_ms": tm_first})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 14 checks failed: {failed}")

    # ---- times ------------------------------------------------------------
    if cuda:
        reads = []
        for i in range(NESTED_READ_WARM):
            tm = {}
            if i == 0:
                prof = _read_profile(lambda: read(tm))
            else:
                reads.append(wall(lambda: read(tm), dev)[1])
            jline({"phase": "nested_sf10", "part": "read_time", **card,
                   "first_ms": first["read"], "read": i, "split_ms": tm,
                   **({"profile": prof} if i == 0 else {"wall_ms":
                                                        reads[-1]})})
        steps = [("hash_o_key", lambda: hash_key(t),
                  _b1_bytes(schema_key, nord)),
                 ("hash_o_linekeys", lambda: hash_lines(t),
                  _b1_bytes(schema_list, nord)),
                 ("sort_filter", lambda: sort_filter(t), None),
                 ("percentiles", lambda: percentiles(t), None),
                 ("create_histogram", lambda: HI.create_histogram_if_valid(
                     qty_col, ones, True), None),
                 ("interleave", lambda: interleave_bits(z_cols),
                  12 * rows + 12 * rows + 4 * (rows + 1))]
        for name, fn, nbytes in steps:
            _nested_time(card, name, fn, first[name], nbytes)
        # each case with its launches in the counted run (the skewed
        # copy is not on the path)
        b1_lines = [("STRUCT key (15M)", schema_key, b1_steps["hash_o_key"]),
                    ("LIST<INT64> (15M rows, ~60M elements)", schema_list,
                     b1_steps["hash_o_linekeys"]),
                    ("LIST, skewed", schema_skew, None)]
        # one profiler session a case: a session that misses a launch
        # reads None for its case alone
        kms = [kernel_ms([(lambda s=s: K.murmur3_fixed_rows(s, 42, nord),
                           "murmur3_rows_kernel")], reps=5)[0]
               for _, s, _ in b1_lines]
        for (case, schema, on_path), km in zip(b1_lines, kms):
            nbytes = _b1_bytes(schema, nord)
            b1_before = K.murmur3_fixed_rows.launches
            ms = cuda_ms(lambda s=schema: K.murmur3_fixed_rows(s, 42, nord),
                         reps=5, warm=1)
            per_call = (K.murmur3_fixed_rows.launches - b1_before) / 6
            plain = cuda_ms(lambda s=schema: K.murmur3_fixed_rows_plain(
                s, 42, nord), reps=1, warm=0)
            b_ms, b_by = bound_ms(nbytes, 0)
            jline({"phase": "nested_sf10", "part": "b1_time", **card,
                   "case": case, "rows": nord,
                   "elements": None if schema[0][0] != "list" else
                   int(schema[0][1][3].numel()),
                   "launches": on_path, "launches_per_timed_call": per_call,
                   "ms": ms, **profiler_fields(km, ms),
                   "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                   "bound_share": b_ms / ms, "bytes": nbytes,
                   "library_ms": None})
        for name, op, args, wires in (
                ("histogram.create", "histogram.create",
                 {"as_lists": True}, b_wires),
                ("histogram.percentile", "histogram.percentile", pct_args,
                 bridge_out["histogram.create"][0][:3]),
                ("zorder.interleave", "zorder.interleave", {}, z_wires)):
            walls = sorted(wall(lambda: bridge.call(
                op, json.dumps(args), wires, device=dev), dev)[1]
                for _ in range(3))
            jline({"phase": "nested_sf10", "part": "bridge_time", **card,
                   "op": name, "rows": n_b,
                   "first_ms": first[f"bridge_{name}"],
                   "warm_ms": walls[1]})
        lap("times")
    jline({"phase": "nested_sf10", "part": "seconds", **card, **secs})
    return launches


def _b1_bytes(schema, n):
    """Bytes B1 must move for a schema: each entry's words (a LIST's row
    starts and ends and its leaf's words), validity bytes, the output.
    Ends that are the starts shifted by one (both views of one offsets
    tensor) are one read of n + 1 offsets."""
    total = 4 * n
    for kind, words, v in schema:
        if kind == "list":
            s, e, _, leaf, lvalid = words
            shared = (e.numel() == s.numel()
                      and e.data_ptr() == s.data_ptr() + 4)
            total += (4 * (s.numel() + 1) if shared
                      else 4 * s.numel() + 4 * e.numel())
            total += leaf.numel() * leaf.element_size()
            if lvalid is not None:
                total += lvalid.numel()
        elif kind == "str":  # offsets and characters
            total += sum(w.numel() * w.element_size() for w in words)
        else:
            total += words.numel() * words.element_size()
        if v is not None:
            total += v.numel()
    return total


def _nested_time(card, name, fn, first_ms, nbytes):
    """A phase-14 step: warm median of NESTED_WARM calls by CUDA events,
    its byte bound where it has one, peak memory and one call under the
    profiler (launches, idle share)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = []
    for _ in range(NESTED_WARM):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    warm = sorted(times)[len(times) // 2]
    line = {"phase": "nested_sf10", "part": "step_time", **card,
            "step": name, "first_ms": first_ms, "warm_ms": warm,
            "warm_all_ms": times, "peak_memory_gb": peak,
            **cast_profile(fn)}
    if nbytes is not None:
        b_ms, b_by = bound_ms(nbytes, 0)
        line.update(bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / warm,
                    bytes=nbytes)
    jline(line)


WEBLOG_URLS = 10_000_000     # phase 15: URLs of one batch (~1.2 GB)
WEBLOG_DOCS_PER_URL = 0.4    # 4M documents for 10M URLs (~1.2 GB)
WEBLOG_SLICE = 100_000       # 15: the card == the CPU on this many rows
WEBLOG_WARM = 5              # warm calls a step's median is taken of
WEBLOG_PATHS = ("$.user.id", "$.event.items[0].sku", "$.ts", "$.tags[1]")
WEBLOG_WILDCARD = "$.event.items[*].sku"


def _out_bytes(x):
    """Device bytes of an output: a tensor, a column, a table or a list of
    them."""
    if torch.is_tensor(x):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_out_bytes(y) for y in x)
    return x.device_nbytes()


def _same_bits(a, b) -> bool:
    """``_same_on_host`` of two STRING columns, or of two raw maps: list
    offsets and validity bits, keys and values."""
    if a.children:
        return (torch.equal(a.offsets.cpu(), b.offsets.cpu())
                and torch.equal(a.valid_mask().cpu(), b.valid_mask().cpu())
                and all(_same_on_host(x, y) for x, y in zip(
                    a.children[0].children, b.children[0].children)))
    return _same_on_host(a, b)


def _host_syncs(fn):
    """(fn(), the host syncs it made): torch's sync debug mode warns at
    each synchronizing call; the warnings are counted."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def weblog_phase(dev, card, rows):
    """Phase 15 (``weblog_strings``): Spark's string device tiers over one
    web-log batch, ``rows`` URLs and two documents for every five (module
    docstring). Returns the launches of the counted run."""
    import collections
    from spark_rapids_jni_tpu_torch import bridge
    from spark_rapids_jni_tpu_torch.columnar import dtype as dt
    from spark_rapids_jni_tpu_torch.columnar.column import Column, Table
    from spark_rapids_jni_tpu_torch.columnar.interop import (col_to_wire,
                                                             wire_to_col)
    from spark_rapids_jni_tpu_torch.ops import get_json_object as G
    from spark_rapids_jni_tpu_torch.ops import kernels as K
    from spark_rapids_jni_tpu_torch.ops import map_utils as M
    from spark_rapids_jni_tpu_torch.ops import parse_uri as P
    from spark_rapids_jni_tpu_torch.ops.groupby import groupby_aggregate
    from spark_rapids_jni_tpu_torch.parallel.exchange import partition_ids
    from spark_rapids_jni_tpu_torch.utils import config, datagen
    from spark_rapids_jni_tpu_torch.utils.backend import (string_routes,
                                                           tier_is_device)

    cuda = dev.type == "cuda"
    cpu = torch.device("cpu")
    secs, t_part = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        secs[name] = now - t_part[0]
        t_part[0] = now

    n_docs = max(1, int(rows * WEBLOG_DOCS_PER_URL))
    # the two columns' draws are independent: numpy runs them in two
    # threads at once
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as pool:
        urls_f = pool.submit(datagen.weblog_urls, rows, 15, dev)
        docs_f = pool.submit(datagen.weblog_docs, n_docs, 15, dev)
        (url_col, ud), (doc_col, dd) = urls_f.result(), docs_f.result()
    _sync(dev)
    lap("generate")
    jline({"phase": "weblog_strings", "part": "batch", **card,
           "urls": rows, "url_bytes": int(url_col.data.numel()),
           "url_width": int((url_col.offsets[1:] - url_col.offsets[:-1])
                            .max()),
           "url_nulls": int((~ud["valid"]).sum()),
           "url_invalid": {k: int((ud["invalid"] == i).sum())
                           for i, k in enumerate(datagen.URL_INVALID_KINDS)},
           "docs": n_docs, "doc_bytes": int(doc_col.data.numel()),
           "doc_width": int((doc_col.offsets[1:] - doc_col.offsets[:-1])
                            .max()),
           "doc_nulls": int((~dd["valid"]).sum()),
           "doc_kinds": {k: int(((dd["kind"] == i) & dd["valid"]).sum())
                         for i, k in enumerate(datagen.DOC_KINDS)},
           "generate_s": secs["generate"]})

    def parse3(col):
        return (P.parse_uri_to_protocol(col), P.parse_uri_to_host(col),
                P.parse_uri_to_query(col))

    def group_host(host):
        pids = partition_ids(Table((host,)), [0], PARTITIONS)
        ones = Column(dt.INT64, host.size, data=torch.ones(
            host.size, dtype=torch.int64, device=host.device))
        return pids, groupby_aggregate(Table((host, ones)), [0],
                                       [(1, "count")])

    path_routes = {}

    def get_json(col):
        out = []
        for p in WEBLOG_PATHS:
            before = string_routes.snapshot()
            out.append(G.get_json_object(col, p))
            after = string_routes.snapshot()
            path_routes[p] = {k: after[k] - before[k] for k in after
                              if after[k] != before[k]}
        return out

    n_b = min(BRIDGE_ROWS, n_docs)
    b_wire = col_to_wire(_prefix(doc_col, n_b, dev))
    b_args = {"json.get_json_object": {"path": WEBLOG_PATHS[1]},
              "json.from_json_map": {}}

    def bridge_ops():
        return {op: bridge.call(op, json.dumps(a), [b_wire], device=dev)
                for op, a in b_args.items()}
    lap("inputs")

    # ---- the counted run --------------------------------------------------
    K.reset_launches()
    string_routes.reset()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if cuda else 0
    first, out, routes, syncs = {}, {}, {}, {}

    def step(name, fn):
        string_routes.reset()
        if cuda:  # the host syncs of the first call
            (out[name], first[name]), syncs[name] = _host_syncs(
                lambda: wall(fn, dev))
        else:
            out[name], first[name] = wall(fn, dev)
        routes[name] = {k: v for k, v in string_routes.snapshot().items()
                        if v}

    urls = _fresh(url_col)
    step("parse_url", lambda: parse3(urls))
    step("parse_url_utm", lambda: P.parse_uri_to_query_with_literal(
        urls, "utm_source"))
    b1_before = K.murmur3_fixed_rows.launches
    step("groupby_host", lambda: group_host(out["parse_url"][1]))
    b1_group = K.murmur3_fixed_rows.launches - b1_before
    docs = _fresh(doc_col)
    step("get_json", lambda: get_json(docs))
    gj_routes = dict(path_routes)
    step("get_json_wildcard", lambda: G.get_json_object(docs,
                                                        WEBLOG_WILDCARD))
    step("from_json", lambda: M.extract_raw_map_from_json_string(
        _fresh(doc_col)))
    step("bridge_json", bridge_ops)
    launches = {w: getattr(K, w).launches for _, w, _, _ in K.KERNELS}
    peak = ((torch.cuda.max_memory_allocated() - base) / 1e9
            if cuda else None)
    lap("counted_run")
    if cuda and b1_group < 1:
        raise AssertionError("phase 15's GROUP BY host never launched B1")

    # ---- checks -----------------------------------------------------------
    checks = {}
    proto, host, query = out["parse_url"]
    # each device tier == the host tier over the whole column, the host
    # tier's wall time taken on the way
    hosts, host_ms = {}, {}
    hosts["parse_url"], host_ms["parse_url"] = wall(lambda: [
        P._native_parse(url_col, P._PARTS[x])
        for x in ("PROTOCOL", "HOST", "QUERY")], dev)
    hosts["get_json"], host_ms["get_json"] = wall(lambda: [
        G.get_json_object_with_instructions(doc_col, G.parse_path(p))
        for p in WEBLOG_PATHS], dev)
    hosts["from_json"], host_ms["from_json"] = wall(
        lambda: M.extract_raw_map_host(doc_col), dev)
    for part, got, want in zip(("PROTOCOL", "HOST", "QUERY"),
                               out["parse_url"], hosts["parse_url"]):
        checks[f"parse_url_{part}_equals_host_tier"] = _same_bits(got, want)
    for p, got, want in zip(WEBLOG_PATHS, out["get_json"],
                            hosts["get_json"]):
        checks[f"get_json_{p}_equals_host_tier"] = _same_bits(got, want)
    checks["from_json_equals_host_tier"] = _same_bits(out["from_json"],
                                                      hosts["from_json"])
    hb = hosts["parse_url"][1]
    del hosts
    lap("check_tiers")
    # the route counts the draw fixes
    ok = ud["valid"] & (ud["invalid"] < 0)
    checks["parse_url_null_counts_follow_the_draw"] = [
        int(c.valid_mask().sum()) for c in (proto, host, query,
                                            out["parse_url_utm"])] == [
        int((ok & ud["scheme"]).sum()), int(ok.sum()),
        int((ok & ud["query"]).sum()), int((ok & ud["utm"]).sum())]
    # under auto a CUDA column takes the device tiers (a rehearsal on the
    # CPU forces them with the tier keys)
    on_dev = {k: tier_is_device(f"{k}.tier", dev)
              for k in ("parse_uri", "get_json", "from_json")}
    checks["parse_url_routes"] = routes["parse_url"] == (
        {"parse_uri_device": 3 * rows} if on_dev["parse_uri"]
        else {"parse_uri_host_by_config": 3 * rows})
    checks["parse_url_utm_routes"] = routes["parse_url_utm"] == {
        "parse_uri_host_key": rows}
    kind = np.asarray(datagen.DOC_KINDS)[dd["kind"]]
    live = dd["valid"]
    odd = live & np.isin(kind, ["malformed", "deep"])
    for p, got in zip(WEBLOG_PATHS, out["get_json"]):
        present = got.valid_mask().cpu().numpy()
        norm = int((present & (kind == "exponent")).sum()) \
            if p == "$.ts" else 0
        want = {"get_json_device": n_docs,
                "get_json_canonical": int((present & ~odd).sum()) - norm,
                "get_json_span_normalized": norm,
                "get_json_host_uncertified": int(odd.sum())}
        want = {k: v for k, v in want.items() if v}
        checks[f"get_json_{p}_routes"] = gj_routes[p] == (
            want if on_dev["get_json"]
            else {"get_json_host_by_config": n_docs})
    checks["get_json_wildcard_routes"] = routes["get_json_wildcard"] == (
        {"get_json_host_path": n_docs} if on_dev["get_json"]
        else {"get_json_host_by_config": n_docs})
    fj_want = {"from_json_device": n_docs,
               "from_json_host_backslash": int((live & (kind == "escaped"))
                                               .sum()),
               "from_json_host_deep": int((live & (kind == "deep")).sum())}
    checks["from_json_routes"] = routes["from_json"] == (
        {k: v for k, v in fj_want.items() if v} if on_dev["from_json"]
        else {"from_json_host_by_config": n_docs})
    # GROUP BY host == a Counter of the host tier's hosts
    chars = hb.data.cpu().numpy().tobytes()
    offs = hb.host_offsets()
    hv = hb.valid_mask().cpu().numpy()
    want_groups = collections.Counter(
        chars[offs[i]:offs[i + 1]] if hv[i] else None for i in range(rows))
    pids, groups = out["groupby_host"]
    gk, gc = groups.columns
    gchars = gk.data.cpu().numpy().tobytes()
    goffs = gk.host_offsets()
    gv = gk.valid_mask().cpu().numpy()
    gn = gc.data.cpu().numpy()
    got_groups = {(gchars[goffs[i]:goffs[i + 1]] if gv[i] else None):
                  int(gn[i]) for i in range(gk.size)}
    checks["groupby_host_equals_counter"] = (
        got_groups == dict(want_groups) and gk.size == len(want_groups))
    pid_np = pids.cpu().numpy()
    checks["partition_ids_in_range"] = bool(
        (pid_np >= 0).all() and (pid_np < PARTITIONS).all())
    # B1 on the HOST column == its plain version
    schema = [("str", (host.offsets, host.data), host.validity)]
    checks["b1_host_equals_plain"] = bool(torch.equal(
        K.murmur3_fixed_rows(schema, 42, rows).cpu(),
        K.murmur3_fixed_rows_plain(schema, 42, rows).cpu()))
    lap("check_routes_groupby_b1")
    # the card == the CPU (device tier forced) on slices
    n_s = min(WEBLOG_SLICE, rows, n_docs)
    res = {}
    for d in (dev, cpu):
        u, j = _prefix(url_col, n_s, d), _prefix(doc_col, n_s, d)
        with config.override("parse_uri.tier", "device"), \
                config.override("get_json.tier", "device"), \
                config.override("from_json.tier", "device"):
            res[str(d)] = (list(parse3(u)) + get_json(j)
                           + [M.extract_raw_map_from_json_string(j)])
    checks["card_equals_cpu_on_slices"] = all(
        _same_bits(a, b) for a, b in zip(res[str(dev)], res["cpu"]))
    # the bridge's json ops == the direct calls
    bcol = wire_to_col(b_wire, dev)
    direct_gj = G.get_json_object(bcol, WEBLOG_PATHS[1])
    direct_fj = M.extract_raw_map_from_json_string(bcol)
    gw, _ = out["bridge_json"]["json.get_json_object"]
    fw, _ = out["bridge_json"]["json.from_json_map"]
    struct = direct_fj.children[0]
    checks["bridge_get_json_equals_direct"] = gw == [col_to_wire(direct_gj)]
    checks["bridge_from_json_equals_direct"] = (
        fw[0][2] == direct_fj.offsets.cpu().numpy().astype(np.int64)
        .tobytes() and fw[1] == col_to_wire(struct.children[0])
        and fw[2] == col_to_wire(struct.children[1]))
    lap("check_slices_bridge")
    jline({"phase": "weblog_strings", "part": "checks", **card,
           "checks": checks, "launches": launches,
           "b1_launches_groupby": b1_group, "routes": routes,
           "get_json_routes_by_path": gj_routes, "groups": gk.size,
           "peak_memory_gb": peak})
    failed = [k for k, v in checks.items() if v is not True]
    if failed:
        raise AssertionError(f"phase 15 checks failed: {failed}")

    # ---- times ------------------------------------------------------------
    if cuda:
        steps = {
            "parse_url": (url_col, parse3),
            "parse_url_utm": (url_col, lambda c: P.
                              parse_uri_to_query_with_literal(
                                  c, "utm_source")),
            "groupby_host": (host, lambda c: group_host(c)),
            "get_json": (doc_col, get_json),
            "get_json_wildcard": (doc_col, lambda c: G.get_json_object(
                c, WEBLOG_WILDCARD)),
            "from_json": (doc_col, M.extract_raw_map_from_json_string)}
        for name, (src, fn) in steps.items():
            nbytes = src.device_nbytes() + _out_bytes(out[name])
            _weblog_time(card, name, lambda fn=fn, src=src: fn(_fresh(src)),
                         first[name], nbytes, host_ms.get(name),
                         syncs[name], routes[name])
        # B1 over the HOST column (the STRING key of the GROUP BY)
        km = kernel_ms([(lambda: K.murmur3_fixed_rows(schema, 42, rows),
                         "murmur3_rows_kernel")], reps=5)[0]
        ms = cuda_ms(lambda: K.murmur3_fixed_rows(schema, 42, rows),
                     reps=5, warm=1)
        plain = cuda_ms(lambda: K.murmur3_fixed_rows_plain(schema, 42, rows),
                        reps=1, warm=0)
        nbytes = _b1_bytes(schema, rows)
        b_ms, b_by = bound_ms(nbytes, 0)
        jline({"phase": "weblog_strings", "part": "b1_time", **card,
               "case": "STRING key: the HOST column", "rows": rows,
               "launches": b1_group, "ms": ms, **profiler_fields(km, ms),
               "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
               "bound_share": b_ms / ms, "bytes": nbytes,
               "library_ms": None})
        walls = {op: sorted(wall(lambda op=op, a=a: bridge.call(
            op, json.dumps(a), [b_wire], device=dev), dev)[1]
            for _ in range(3))[1] for op, a in b_args.items()}
        jline({"phase": "weblog_strings", "part": "bridge_time", **card,
               "rows": n_b, "first_ms": first["bridge_json"],
               "warm_ms": walls, "routes": routes["bridge_json"]})
        lap("times")
    jline({"phase": "weblog_strings", "part": "seconds", **card, **secs})
    return launches


def _weblog_time(card, name, fn, first_ms, nbytes, host_ms, syncs, routes):
    """A phase-15 step: the warm median of WEBLOG_WARM calls by CUDA
    events (each over fresh columns, so that no memo of an earlier call
    answers it), one call under the profiler (launches, copies, idle
    share; one session), peak memory and the byte bound, beside the host
    tier's wall ms on the same column and the first call's host syncs
    (both taken in the phase's counted run and checks)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = []
    for _ in range(WEBLOG_WARM):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    warm = sorted(times)[len(times) // 2]
    b_ms, b_by = bound_ms(nbytes, 0)
    jline({"phase": "weblog_strings", "part": "step_time", **card,
           "step": name, "first_ms": first_ms, "warm_ms": warm,
           "warm_all_ms": times, "host_tier_ms": host_ms,
           "host_syncs": syncs, "peak_memory_gb": peak, "routes": routes,
           "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / warm,
           "bytes": nbytes, **cast_profile(fn, attempts=1)})


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
    sys.exit(main(sys.argv[1:]))
