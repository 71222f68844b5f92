"""Kernel times of two or more checkouts of the port, side by side, on one
NVIDIA GPU.

    python3 chip_hash_ab.py TREE [TREE ...]

For each TREE in the order given (for an A/B: parent, change, change,
parent), a child process imports that checkout's spark_rapids_jni_tpu_torch
(its kernels built into TREE/build/torch_kernels) and, on inputs made from
the same seeds, holds each kernel bit-exact against that checkout's plain
version, then times it: its own device time by torch.profiler
(chip_smoke.kernel_ms, one session) and the wrapper's calls by CUDA events
(chip_smoke.cuda_ms). The calls: B2 over the STRING key of strings_60m
(60M rows, 0-32 bytes) and over 16M strings of random bytes of 0-100
bytes; B2 and B1 over SF10's l_orderkey (60M rows); B1 over the 60M-row
STRING key; B3 over SF10's lineitem; and, in a tree whose B1 takes a LIST
entry, B1 at chip_smoke.py phase 14's shapes, made on the card from a
fixed seed: a STRUCT key of 15M rows (INT64 and INT32 fields, 1% null
rows), LIST<INT64> of 15M rows with Poisson(4) lengths (~60M elements),
and the same lists with one row in 10,000 of 4,096 elements. The helpers
come from this script's own chip_smoke.py. Prints one JSON line per tree
and call. Exits 2 without a CUDA device.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
NESTED_ROWS = 15_000_000   # SF10's orders


def nested_cases(torch, dev):
    """{label: B1 schema} at phase 14's shapes: the STRUCT key flattened
    into two fixed-width entries, and two LIST entries over one offsets
    tensor each."""
    n = NESTED_ROWS
    gen = torch.Generator(device=dev).manual_seed(14)
    valid = torch.rand(n, generator=gen, device=dev) >= 0.01
    cust = torch.randint(0, 1_500_000, (n,), generator=gen, device=dev)
    date = torch.randint(0, 2400, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    lens = torch.poisson(torch.full((n,), 4.0, device=dev),
                         generator=gen).to(torch.int32)
    out = {"B1 STRUCT key (15M)": [("u64", cust, valid),
                                   ("u32", date, valid)]}
    for label, every in (("B1 LIST<INT64> (15M rows, ~60M elements)", None),
                         ("B1 LIST, skewed", 10_000)):
        ln = lens.clone()
        if every:
            ln[::every] = 4096
        offs = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        torch.cumsum(ln, 0, dtype=torch.int32, out=offs[1:])
        leaf = torch.randint(-(1 << 62), 1 << 62, (int(offs[-1]),),
                             generator=gen, device=dev)
        out[label] = [("list", (offs[:-1], offs[1:], "u64", leaf, None),
                       None)]
    return out


def one_tree(tree):
    sys.path.insert(0, str(Path(tree).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke_ab",
                                                  HERE / "chip_smoke.py")
    C = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(C)
    import torch
    from spark_rapids_jni_tpu_torch import tpch
    from spark_rapids_jni_tpu_torch.ops import kernels as K
    from spark_rapids_jni_tpu_torch.utils import datagen

    if Path(K.__file__).resolve().parents[2] != Path(tree).resolve():
        raise RuntimeError(f"imported {K.__file__}, not {tree}'s package")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    K.build_all()
    key = datagen.string_rows_table(C.STRING_ROWS, 0, device=dev)[4]
    wide = C.b2_second_shape(16_000_000)
    lineitem = tpch.generate_q3_tables(C.SF10_ROWS, 0, dev)[2]
    n = lineitem.num_rows
    li_mm = C._schema([lineitem[0]], False)
    li_xx = C._schema([lineitem[0]], True)
    str_mm = C._schema([key], False)
    li_args = C._rowconv_args(lineitem)
    calls = {
        "B2 strings_60m key": C.b2_string_work(key)[:2],
        "B2 random bytes 16M 0-100": C.b2_string_work(wide)[:2],
        "B2 SF10 l_orderkey": (
            lambda: K.xxhash64_fixed_rows(li_xx, 42, n),
            lambda: K.xxhash64_fixed_rows_plain(li_xx, 42, n)),
        "B1 SF10 l_orderkey": (
            lambda: K.murmur3_fixed_rows(li_mm, 42, n),
            lambda: K.murmur3_fixed_rows_plain(li_mm, 42, n)),
        "B1 strings_60m key": (
            lambda: K.murmur3_fixed_rows(str_mm, 42, key.size),
            lambda: K.murmur3_fixed_rows_plain(str_mm, 42, key.size)),
        "B3 SF10 lineitem": (
            lambda: K.rowconv_fixed_words(*li_args),
            lambda: K.rowconv_fixed_words_plain(*li_args)),
    }
    if hasattr(K, "_LIST_KIND"):   # B1 takes LIST entries
        for label, sch in nested_cases(torch, dev).items():
            calls[label] = (
                lambda s=sch: K.murmur3_fixed_rows(s, 42, NESTED_ROWS),
                lambda s=sch: K.murmur3_fixed_rows_plain(s, 42,
                                                         NESTED_ROWS))
    wrapper = {"B1": "murmur3_fixed_rows", "B2": "xxhash64_fixed_rows",
               "B3": "rowconv_fixed_words"}
    for label, (run, plain) in calls.items():
        if not torch.equal(run(), plain()):
            raise AssertionError(f"{tree}: {label} differs from its plain "
                                 f"version")
    torch.cuda.synchronize()
    k_ms = C.kernel_ms([(run, C.DEVICE_KERNEL[wrapper[label[:2]]])
                        for label, (run, _) in calls.items()])
    for (label, (run, _)), km in zip(calls.items(), k_ms):
        print(json.dumps({"tree": tree, "card": card, "call": label,
                          "bit_exact": True, "kernel_ms": km,
                          "ms": C.cuda_ms(run)}), flush=True)
    return 0


def main():
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        return one_tree(args[1])
    import torch
    if not torch.cuda.is_available():
        print("chip_hash_ab: no CUDA device", file=sys.stderr)
        return 2
    for tree in args:
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--one", tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
