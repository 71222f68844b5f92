"""Sweep of kernel B3's tile parameters on one NVIDIA GPU.

    python3 chip_rowconv_sweep.py

Builds csrc/rowconv.cu, makes B3's three timed shapes of chip_smoke.py
(SF10 lineitem, 60M rows; 1M rows of the mixed 11-column nullable schema;
250K rows of the 600-column schema), and for each setting of the tile plan
(stage budget, output sub-tile budget) checks B3 bit-exact
against its plain version and times the kernel's own device time
(torch.profiler, chip_smoke.kernel_ms). Prints one JSON line per setting
and shape, then the fastest setting per shape. Exits 2 without a CUDA
device.
"""

import json
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as C

# (stage budget KB, output sub-tile budget KB)
SETTINGS = [(kb, out) for kb in (16, 20, 24, 32) for out in (24, 32, 48)]


def main():
    if not torch.cuda.is_available():
        print("chip_rowconv_sweep: no CUDA device", file=sys.stderr)
        return 2
    from spark_rapids_jni_tpu_torch import tpch
    from spark_rapids_jni_tpu_torch.columnar import dtype as dt
    from spark_rapids_jni_tpu_torch.columnar.column import Column, Table
    from spark_rapids_jni_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    K.build_all(["rowconv"])
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    lineitem = tpch.generate_q3_tables(C.SF10_ROWS, 0, dev)[2]
    mixed_gen = [(np.int8, dt.INT8), (np.int64, dt.INT64),
                 (np.int16, dt.INT16), (np.float32, dt.FLOAT32),
                 (np.uint8, dt.BOOL8), (np.float64, dt.FLOAT64),
                 (np.int32, dt.INT32), (np.uint16, dt.UINT16),
                 (np.int8, dt.INT8), (np.int64, dt.INT64),
                 (np.int32, dt.INT32)]
    n1 = 1 << 20
    mixed = Table(tuple(
        Column.from_numpy(rng.integers(0, 2**62, n1).astype(npt), d,
                          validity=(rng.random(n1) > 0.2) if i % 3 else None,
                          device=dev)
        for i, (npt, d) in enumerate(mixed_gen)))
    shapes = {"lineitem": lineitem, "mixed": mixed,
              "wide": C._wide_table(250_000, dev, rng)}
    args = {k: C._rowconv_args(t) for k, t in shapes.items()}
    want = {k: K.rowconv_fixed_words_plain(*a) for k, a in args.items()}
    best = {}
    for stage_kb, out_kb in SETTINGS:
        K.STAGE_BUDGET, K.OUT_BUDGET = stage_kb * 1024, out_kb * 1024
        K.rowconv_layout.cache_clear()
        for label, a in args.items():
            got = K.rowconv_fixed_words(*a)
            if not torch.equal(got, want[label]):
                raise AssertionError(f"{label} at {stage_kb} KB stages, "
                                     f"{out_kb} KB out: words differ")
            del got
        k_ms = C.kernel_ms(
            [((lambda a=a: K.rowconv_fixed_words(*a)),
              C.DEVICE_KERNEL["rowconv_fixed_words"])
             for a in args.values()])
        for (label, a), km in zip(args.items(), k_ms):
            lay = K.rowconv_meta(*a[:4])[1]
            b_ms, _ = C.bound_ms(C._rowconv_bytes(a), 0)
            row = {"shape": label, "card": card,
                   "stage_kb": stage_kb, "out_kb": out_kb,
                   "R": lay.tiles.rows, "windows": lay.nwin,
                   "out_rows": lay.tiles.out_rows, "kernel_ms": km,
                   "bound_ms": b_ms, "bound_share": b_ms / km}
            print(json.dumps(row), flush=True)
            if label not in best or km < best[label]["kernel_ms"]:
                best[label] = row
    for row in best.values():
        print(json.dumps({"best": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
