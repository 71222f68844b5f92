"""Phase 13 of chip_smoke.py alone (Spark's casts from TPC-H text and the
engine bridge) on one NVIDIA GPU, at TPC-H SF10's 60M lineitem rows or a
row count given.

    python3 chip_casts.py [ROWS]

Prints the card's name and power limit, one JSON line ``division`` (the
rows of 1..ROWS where torch's CUDA division by a Python scalar, ``x /
100``, differs from numpy's correctly rounded division, in FLOAT64 and
FLOAT32: why phase 13 checks its float casts against numpy), then phase
13's own lines (``casts_sf10``: the text, the checks, each cast's times,
the bridge's) and the phase's seconds. Any failed check raises. Exits 2
without a CUDA device.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch


def main(argv):
    if not torch.cuda.is_available():
        print("chip_casts: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    import chip_smoke
    from spark_rapids_jni_tpu_torch.ops import kernels as K
    rows = int(argv[0]) if argv else chip_smoke.SF10_ROWS
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = {"card": smi}

    x = torch.arange(1, rows + 1, dtype=torch.int64, device="cuda")
    host = x.cpu().numpy()
    f64 = int(((x.double() / 100).cpu().numpy()
               != host.astype(np.float64) / np.float64(100)).sum())
    f32 = int(((x.float() / 100).cpu().numpy()
               != host.astype(np.float32) / np.float32(100)).sum())
    del x, host
    print(json.dumps({"part": "division", **card, "rows": rows,
                      "torch_scalar_div_differs_float64": f64,
                      "torch_scalar_div_differs_float32": f32}), flush=True)

    K.build_all()
    chip_smoke.read_instruction_rate()
    t = time.perf_counter()
    launches = chip_smoke.casts_phase(torch.device("cuda"), card, rows)
    print(json.dumps({"part": "done", **card, "phase_s":
                      time.perf_counter() - t, "launches": launches}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
