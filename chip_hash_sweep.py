"""Sweep of kernel B2's STRING-path constants on one NVIDIA GPU.

    python3 chip_hash_sweep.py [--baseline OTHER_row_hash.cu ...]
                               [--staging-share]

B2 over a schema with a STRING column (csrc/row_hash.cu,
xxhash64_staged_rows_kernel) has four constants: the warps of a block
(kXxWarps), the rows a lane hashes per tile (kXxRowsPerLane), the bytes
of characters one warp stages (kXxStage) and the blocks an SM must hold
(kXxBlocksPerSm, a cap on registers). For each setting this script
builds a copy of csrc/row_hash.cu with those constants (all nvcc
processes started together, into build/hash_sweep/), prints the staged
kernel's registers, and on four string shapes holds the kernel bit-exact
against its plain version and times the wrapper's calls by CUDA events
(chip_smoke.cuda_ms; torch.profiler drops kernel events over this many
sessions). The shapes: the STRING key of strings_60m (60M rows, 0-32
bytes), 16M strings of random bytes with lengths 0-100, 1M strings of
0-100 bytes of which ~1% are 2-8 KB, and 60M strings of exactly 16 bytes
(the first shape's mean, with no divergence between lanes).
``--baseline`` times other versions of row_hash.cu the same way (earlier
designs, for a side-by-side reading in one run), each labelled by its
file name; ``--staging-share`` also times the source as it is with each
row's hash cut to one mix of its first word (the offsets, the staging
and the loop without the hashing; not bit-exact, and marked so). Prints
one JSON line per setting and shape, then the fastest setting per shape.
Exits 2 without a CUDA device.
"""

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as C

# (warps per block, rows per lane, stage bytes per warp, blocks per SM):
# the source's setting and its neighbours
SETTINGS = [(8, 4, 4096, 3), (8, 4, 4096, 4), (8, 4, 4096, 5),
            (8, 4, 2048, 4), (8, 2, 4096, 4), (8, 2, 4096, 5),
            (4, 4, 4096, 8), (4, 4, 8192, 8), (4, 2, 8192, 8)]


def build_variants(sources):
    """{label: .so path} for {label: CUDA source text}; one nvcc each, all
    at once. Prints the staged kernel's ptxas lines."""
    from spark_rapids_jni_tpu_torch.ops import kernels as K
    out_dir = K.BUILD_DIR.parent / "hash_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, text in sources.items():
        src = out_dir / f"row_hash_{label}.cu"
        src.write_text(text)
        lib = out_dir / f"librow_hash_{label}.so"
        procs[label] = (subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for label, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {label}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "xxhash64" in line:
                regs = next((x for x in lines[i + 1:i + 4]
                             if "registers" in x), "")
                print(f"{label}: {line.strip()} {regs.strip()}", flush=True)
        libs[label] = lib
    return libs


def fixed_length_column(rows, length, dev):
    """``rows`` strings of exactly ``length`` random bytes, no nulls."""
    from spark_rapids_jni_tpu_torch.columnar import dtype as dt
    from spark_rapids_jni_tpu_torch.columnar.column import Column
    g = torch.Generator(device=dev).manual_seed(3)
    chars = torch.randint(0, 256, (rows * length,), generator=g,
                          dtype=torch.uint8, device=dev)
    offsets = (torch.arange(rows + 1, device=dev) * length).to(torch.int32)
    return Column(dt.STRING, rows, data=chars, offsets=offsets)


def staging_only(text):
    """row_hash.cu with xx_row (a row's hash) cut to one mix of the row's
    first word: what is left is the offsets, the staging and the loop."""
    head = ("template <bool kShared>\n__device__ __forceinline__ uint64_t "
            "xx_row(")
    a = text.index(head)
    b = text.index("\n}\n", a) + 3
    return text[:a] + head + (
        "uint64_t seed, const RowWords<kShared>& r, int len) {\n"
        "  return seed ^ (len > 0 ? r.u32(0, len < 4 ? len : 4) : 0u) ^\n"
        "         (uint64_t)len;\n}\n") + text[b:]


def with_constants(text, warps, rows, stage, blocks):
    for name, value in (("kXxWarps", warps), ("kXxRowsPerLane", rows),
                        ("kXxStage", stage), ("kXxBlocksPerSm", blocks)):
        text, count = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {value};", text)
        if count != 1:
            raise RuntimeError(f"row_hash.cu: {name} not found")
    return text


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", nargs="*", default=[],
                    help="other row_hash.cu versions to time")
    ap.add_argument("--staging-share", action="store_true",
                    help="also time the source without the row hashing")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_hash_sweep: no CUDA device", file=sys.stderr)
        return 2
    from spark_rapids_jni_tpu_torch.ops import kernels as K
    from spark_rapids_jni_tpu_torch.utils import datagen

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    text = (K._CSRC / "row_hash.cu").read_text()
    sources = {f"w{w}_k{k}_s{b}_b{m}": with_constants(text, w, k, b, m)
               for w, k, b, m in SETTINGS}
    sweep = set(sources)
    for path in args.baseline:
        sources[Path(path).stem] = Path(path).read_text()
    unchecked = set()
    if args.staging_share:
        sources["staging_only"] = staging_only(text)
        unchecked.add("staging_only")
    libs = {label: K.load_library(path)
            for label, path in build_variants(sources).items()}
    shapes = {
        "strings_60m_key": datagen.string_rows_table(C.STRING_ROWS, 0,
                                                     device=dev)[4],
        "random_bytes_16m_0_100": C.b2_second_shape(16_000_000),
        "long_strings_1m": C.long_strings_column(1 << 20, 5, dev),
        "fixed_16_60m": fixed_length_column(C.STRING_ROWS, 16, dev),
    }
    work = {}
    for label, col in shapes.items():
        run, plain, nbytes, nops = C.b2_string_work(col)
        work[label] = (run, plain(), C.bound_ms(nbytes, nops))
    torch.cuda.synchronize()
    best = {}
    for label, lib in libs.items():
        K._libs["row_hash"] = lib
        for shape, (run, want, _) in work.items():
            if label not in unchecked and not torch.equal(run(), want):
                raise AssertionError(f"{label} at {shape}: differs from the "
                                     f"plain version")
        for shape, (run, _, (b_ms, b_by)) in work.items():
            ms = C.cuda_ms(run)
            row = {"shape": shape, "card": card, "setting": label,
                   "bit_exact": label not in unchecked, "ms": ms,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "bound_share": b_ms / ms}
            print(json.dumps(row), flush=True)
            if label in sweep and (shape not in best
                                   or ms < best[shape]["ms"]):
                best[shape] = row
    for row in best.values():
        print(json.dumps({"best": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
