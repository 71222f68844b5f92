"""The engine bridge's dispatch: the surface Spark's JNI shims call (the
JAX package's bridge.py).

A shim calls ``call(op, args_json, wire_cols)`` with an op name, its JSON
arguments and its columns in the wire format (columnar/interop.py: the
tuple ``(dtype_str, rows, data, offsets, validity)`` of raw little-endian
bytes; FLOAT64 as IEEE-754 bits, DECIMAL128 as 16-byte two's complement,
STRING offsets as int64). ``call`` marshals the columns onto ``device``
(the card unless the caller asks for the CPU), dispatches the op by name
under the fault-domain supervisor and returns ``(out_wire_cols,
meta_json)``. Nested results are decomposed by each handler into flat
wire columns (offsets column + children).

The op names, their arguments, their outputs and their meta JSON are the
JAX package's, all 31 of them, and all 31 run. A LIST result or argument crosses decomposed, as in
the JAX package: its offsets as an INT64 column, then its children's
columns, then its validity as a BOOL8 column where it has one
(``_list_parts``). An op named in ``sandbox.bridge_ops`` (with
``sandbox.enabled``) runs in the sandbox's "bridge" worker instead
(faultinj/sandbox.py): the wire columns are the payload, and the worker
runs the op on the caller's device, the card included, in its own
process. The default list is empty. The C ABI that embeds the bridge
(native/engine_bridge.cpp) imports the JAX package's module; the port's
own embedding waits for ROADMAP A17.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .columnar import dtype as dt
from .columnar.column import Column, Table, resolve_device
from .columnar.interop import WireCol, col_to_wire, wire_to_col

_OPS: Dict[str, Callable] = {}


def op(name: str):
    """Register a handler ``fn(args, cols, device)`` under ``name``."""
    def deco(fn):
        _OPS[name] = fn
        return fn
    return deco


def ops() -> List[str]:
    return sorted(_OPS)


def call(op_name: str, args_json: str, wire_cols: Sequence[WireCol],
         device="cuda") -> Tuple[List[WireCol], str]:
    """Run one op on wire columns: a watchdog checkpoint before the
    columns are built, then the op under ``guarded_dispatch(op_name,
    ...)`` (faultinj/guard.py), so a fault config naming the op fires
    there and real failures take their fault domain's recovery. An op in
    ``sandbox.bridge_ops`` runs the whole marshal -> dispatch -> unmarshal
    in the sandbox's "bridge" worker, under the same guard: a dead worker
    is a CRASH the caller replays. Returns the output wire columns and the
    meta JSON."""
    from .faultinj import sandbox, watchdog
    from .faultinj.guard import guarded_dispatch
    if op_name not in _OPS:
        raise KeyError(f"unknown engine op: {op_name!r} (have: {ops()})")
    watchdog.checkpoint()  # a chunk boundary: before the marshalling
    dev = resolve_device(device)
    if sandbox.active(op_name, kind="bridge"):
        return guarded_dispatch(
            op_name, sandbox.sandbox_call, op_name,
            sandbox.mod_target("spark_rapids_jni_tpu_torch.bridge",
                               "_sandboxed_op"),
            op_name, args_json, [tuple(w) for w in wire_cols], str(dev),
            group="bridge")
    args = json.loads(args_json) if args_json else {}
    cols = [wire_to_col(w, dev) for w in wire_cols]
    return _to_wire(guarded_dispatch(op_name, _OPS[op_name], args, cols,
                                     dev))


def _to_wire(out) -> Tuple[List[WireCol], str]:
    """A handler's output (its columns, or (columns, meta)) as wire
    columns and the meta JSON."""
    meta = {}
    if isinstance(out, tuple):
        out, meta = out
    return [c if isinstance(c, tuple) else col_to_wire(c) for c in out], \
        json.dumps(meta)


def _sandboxed_op(op_name: str, args_json: str,
                  wire_cols: Sequence[WireCol],
                  device: str) -> Tuple[List[WireCol], str]:
    """The bridge worker's half of a sandboxed op: ``call`` without the
    supervisor (the caller's ``guarded_dispatch`` owns the retries; a
    fault here relays to it as raised)."""
    dev = resolve_device(device)
    args = json.loads(args_json) if args_json else {}
    cols = [wire_to_col(w, dev) for w in wire_cols]
    return _to_wire(_OPS[op_name](args, cols, dev))


def _i64_wire(t: torch.Tensor) -> WireCol:
    a = t.cpu().numpy().astype(np.int64)
    return ("int64", int(a.shape[0]), a.tobytes(), None, None)


def _list_parts(col: Column):
    """A LIST column's offsets (an INT64 wire column of n + 1 rows) and
    its validity as a BOOL8 column, or None; the caller adds the
    children."""
    vcol = None
    if col.validity is not None:
        vcol = Column(dt.BOOL8, col.size,
                      data=col.validity.to(torch.uint8))
    return _i64_wire(col.offsets), vcol


def _u8_column(blob: bytes, device) -> Column:
    data = torch.from_numpy(np.frombuffer(blob, np.uint8).copy()).to(device)
    return Column(dt.UINT8, int(data.shape[0]), data=data)


# ---------------------------------------------------------------------------
# handlers (each names the Java facade method it serves)
# ---------------------------------------------------------------------------

@op("engine.echo")
def _echo(args, cols, device):
    """Marshalling self-check: the inputs, unchanged."""
    return cols


@op("hash.murmur3")
def _murmur3(args, cols, device):
    """Hash.murmurHash32."""
    from .ops.hashing import murmur_hash3_32
    return [murmur_hash3_32(Table(tuple(cols)),
                            seed=int(args.get("seed", 42)))]


@op("hash.xxhash64")
def _xxhash64(args, cols, device):
    """Hash.xxhash64."""
    from .ops.hashing import xxhash64
    return [xxhash64(Table(tuple(cols)), seed=int(args.get("seed", 42)))]


@op("bloom.build")
def _bloom_build(args, cols, device):
    """BloomFilter create + put -> the serialized filter (UINT8)."""
    from .ops import bloom_filter as bf
    filt = bf.bloom_filter_create(int(args["num_hashes"]),
                                  int(args["num_longs"]), device)
    filt = bf.bloom_filter_put(filt, cols[0])
    return [_u8_column(bf.serialize(filt), device)]


@op("bloom.probe")
def _bloom_probe(args, cols, device):
    """BloomFilter probe."""
    from .ops import bloom_filter as bf
    keys, blob = cols
    filt = bf.deserialize(blob.to_numpy().tobytes(), device)
    return [bf.bloom_filter_probe(keys, filt)]


@op("bloom.merge")
def _bloom_merge(args, cols, device):
    """BloomFilter merge."""
    from .ops import bloom_filter as bf
    filts = [bf.deserialize(c.to_numpy().tobytes(), device) for c in cols]
    return [_u8_column(bf.serialize(bf.bloom_filter_merge(filts)), device)]


@op("cast.string_to_integer")
def _s2i(args, cols, device):
    """CastStrings.toInteger."""
    from .ops.cast_string import string_to_integer
    return [string_to_integer(cols[0], dt.parse_dtype(args["type"]),
                              ansi_mode=bool(args.get("ansi", False)))]


@op("cast.string_to_float")
def _s2f(args, cols, device):
    """CastStrings.toFloat."""
    from .ops.cast_string import string_to_float
    return [string_to_float(cols[0], dt.parse_dtype(args["type"]),
                            ansi_mode=bool(args.get("ansi", False)))]


@op("cast.string_to_decimal")
def _s2d(args, cols, device):
    """CastStrings.toDecimal."""
    from .ops.cast_string import string_to_decimal
    return [string_to_decimal(cols[0], int(args["precision"]),
                              int(args["scale"]),
                              ansi_mode=bool(args.get("ansi", False)))]


@op("cast.string_to_integer_base")
def _s2i_base(args, cols, device):
    """CastStrings.toIntegersWithBase."""
    from .ops.cast_string_base import to_integers_with_base
    return [to_integers_with_base(cols[0], int(args.get("base", 10)),
                                  dt.parse_dtype(args["type"]))]


@op("cast.integer_to_string_base")
def _i2s_base(args, cols, device):
    """CastStrings.fromIntegersWithBase."""
    from .ops.cast_string_base import from_integers_with_base
    return [from_integers_with_base(cols[0], int(args.get("base", 10)))]


@op("cast.float_to_string")
def _f2s(args, cols, device):
    """CastStrings.fromFloat: Ryu's shortest round trip."""
    from .ops.cast_float_to_string import float_to_string
    return [float_to_string(cols[0])]


@op("cast.format_number")
def _fmtnum(args, cols, device):
    """CastStrings.fromFloatWithFormat."""
    from .ops.cast_float_to_string import format_number
    return [format_number(cols[0], int(args["digits"]))]


@op("cast.decimal_to_string")
def _d2s(args, cols, device):
    """CastStrings.fromDecimal."""
    from .ops.decimal_to_string import decimal_to_string
    return [decimal_to_string(cols[0])]


def _decimal_table(t: Table):
    """(overflow BOOL8, result DECIMAL128)."""
    return [t.columns[0], t.columns[1]]


@op("decimal.add")
def _dec_add(args, cols, device):
    """DecimalUtils.add128."""
    from .ops.decimal128 import add_decimal128
    return _decimal_table(add_decimal128(cols[0], cols[1],
                                         int(args["scale"])))


@op("decimal.subtract")
def _dec_sub(args, cols, device):
    """DecimalUtils.subtract128."""
    from .ops.decimal128 import sub_decimal128
    return _decimal_table(sub_decimal128(cols[0], cols[1],
                                         int(args["scale"])))


@op("decimal.multiply")
def _dec_mul(args, cols, device):
    """DecimalUtils.multiply128."""
    from .ops.decimal128 import multiply_decimal128
    return _decimal_table(multiply_decimal128(
        cols[0], cols[1], int(args["scale"]),
        bool(args.get("interim_cast", False))))


@op("decimal.divide")
def _dec_div(args, cols, device):
    """DecimalUtils.divide128."""
    from .ops.decimal128 import divide_decimal128
    return _decimal_table(divide_decimal128(cols[0], cols[1],
                                            int(args["scale"])))


@op("decimal.integer_divide")
def _dec_idiv(args, cols, device):
    """DecimalUtils.integerDivide128."""
    from .ops.decimal128 import integer_divide_decimal128
    return _decimal_table(integer_divide_decimal128(cols[0], cols[1]))


@op("decimal.remainder")
def _dec_rem(args, cols, device):
    """DecimalUtils.remainder128."""
    from .ops.decimal128 import remainder_decimal128
    return _decimal_table(remainder_decimal128(cols[0], cols[1],
                                               int(args["scale"])))


@op("rowconv.to_rows")
def _to_rows(args, cols, device):
    """RowConversion.convertToRows -> (blob UINT8, offsets INT64) of batch
    0, with the batch count in the meta."""
    from .ops.row_conversion import convert_to_rows
    batches = convert_to_rows(Table(tuple(cols)))
    rows_col = batches[0]
    child = rows_col.children[0]
    blob = Column(dt.UINT8, child.size, data=child.data.view(torch.uint8))
    return ([blob, _i64_wire(rows_col.offsets)],
            {"n_batches": len(batches), "rows": rows_col.size})


@op("rowconv.from_rows")
def _from_rows(args, cols, device):
    """RowConversion.convertFromRows."""
    from .ops.row_conversion import convert_from_rows
    blob, offsets = cols
    child = Column(dt.UINT8, blob.size, data=blob.data)
    rows_col = Column.list_of(child, offsets.data.to(torch.int32))
    out = convert_from_rows(rows_col,
                            [dt.parse_dtype(s) for s in args["types"]])
    return list(out.columns)


@op("histogram.create")
def _hist_create(args, cols, device):
    """Histogram.createHistogramIfValid -> (offsets INT64, values, freqs
    INT64[, validity BOOL8])."""
    from .ops.histogram import create_histogram_if_valid
    h = create_histogram_if_valid(cols[0], cols[1],
                                  bool(args.get("as_lists", True)))
    offs_w, vcol = _list_parts(h)
    struct = h.children[0]
    out = [offs_w, struct.children[0], struct.children[1]]
    if vcol is not None:
        out.append(vcol)
    return out


@op("histogram.percentile")
def _hist_pct(args, cols, device):
    """Histogram.percentileFromHistogram: (offsets INT64, values, freqs
    INT64) in; FLOAT64 percentiles out, a decomposed list when
    ``as_list``."""
    from .ops.histogram import percentile_from_histogram
    offsets, values, freqs = cols[:3]
    hist = Column.list_of(Column.struct_of([values, freqs]),
                          offsets.data.to(torch.int32))
    as_list = bool(args.get("as_list", True))
    out = percentile_from_histogram(
        hist, [float(p) for p in args["percentages"]], as_list)
    if not as_list:
        return [out]
    offs_w, vcol = _list_parts(out)
    res = [offs_w, out.children[0]]
    if vcol is not None:
        res.append(vcol)
    return res


@op("zorder.interleave")
def _zorder(args, cols, device):
    """ZOrder.interleaveBits -> (offsets INT64, bytes UINT8). With zero
    columns (the interleaveBits(numRows) overload) the row count rides
    ``args["num_rows"]``."""
    from .ops.zorder import interleave_bits
    out = interleave_bits(
        cols, num_rows=int(args["num_rows"]) if "num_rows" in args else None,
        device=device)
    offs_w, _ = _list_parts(out)
    return [offs_w, out.children[0]]


@op("zorder.hilbert")
def _hilbert(args, cols, device):
    """ZOrder.hilbertIndex."""
    from .ops.zorder import hilbert_index
    return [hilbert_index(int(args["num_bits"]), cols)]


@op("datetime.rebase")
def _rebase(args, cols, device):
    """DateTimeRebase.rebaseGregorianToJulian / JulianToGregorian."""
    from .ops.datetime_rebase import (rebase_gregorian_to_julian,
                                      rebase_julian_to_gregorian)
    if args["direction"] == "gregorian_to_julian":
        return [rebase_gregorian_to_julian(cols[0])]
    return [rebase_julian_to_gregorian(cols[0])]


@op("tz.to_utc")
def _tz_to_utc(args, cols, device):
    """GpuTimeZoneDB.fromTimestampToUtcTimestamp."""
    from .ops.timezones import convert_timestamp_to_utc, load_zones
    return [convert_timestamp_to_utc(cols[0], load_zones([args["zone"]]), 0)]


@op("tz.from_utc")
def _tz_from_utc(args, cols, device):
    """GpuTimeZoneDB.fromUtcTimestampToTimestamp."""
    from .ops.timezones import convert_utc_timestamp_to_timezone, load_zones
    return [convert_utc_timestamp_to_timezone(
        cols[0], load_zones([args["zone"]]), 0)]


@op("json.get_json_object")
def _gjo(args, cols, device):
    """JSONUtils.getJsonObject."""
    from .ops.get_json_object import get_json_object
    return [get_json_object(cols[0], args["path"])]


@op("json.from_json_map")
def _from_json(args, cols, device):
    """MapUtils.extractRawMapFromJsonString, decomposed to (offsets INT64,
    keys STRING, values STRING[, validity BOOL8])."""
    from .ops.map_utils import extract_raw_map_from_json_string
    m = extract_raw_map_from_json_string(cols[0])
    offs_w, vcol = _list_parts(m)
    keys, vals = m.children[0].children
    return [offs_w, keys, vals] + ([] if vcol is None else [vcol])
