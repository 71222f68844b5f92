"""TPC-H q1/q6/q3/q5 at SF10 on the plan engine, fused and eager, for
several checkouts of the port side by side on one card (an A/B of the
ungoverned path).

    python3 chip_plan_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (for an A/B against a parent, unpack
``git archive`` of each under ``build/`` and pass parent, change, change,
parent). Every tree runs in a process of its own with that tree first on
``sys.path``, builds its kernels, and prints one JSON line per query and
engine: first and warm ms (median of 5), the peak device memory of the
first run and the warm runs (``max_memory_allocated`` after a reset) and
whether the answer equals the first tree's. The card's name and power
limit come first.
"""

import json
import subprocess
import sys

_CHILD = r'''
import hashlib, json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from spark_rapids_jni_tpu_torch import tpch
from spark_rapids_jni_tpu_torch.ops import kernels as K
from spark_rapids_jni_tpu_torch.utils import config
K.build_all()
rows, dev = 60_000_000, torch.device("cuda")

def wall(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3

def digest(out):
    h = hashlib.sha256(str(out).encode() if isinstance(out, int) else b"")
    for c in ([] if isinstance(out, int) else out.columns):
        h.update(c.data.cpu().numpy().tobytes())
        h.update(c.valid_mask().cpu().numpy().tobytes())
    return h.hexdigest()

li = tpch.generate_q1_lineitem(rows, 0, dev)
q3 = tpch.generate_q3_tables(rows, 0, dev)
q5 = tpch.generate_q5_tables(rows, 0, dev)
runs = {"q1": lambda e: tpch.run_q1(li, engine=e),
        "q6": lambda e: tpch.run_q6(li, engine=e),
        "q3": lambda e: tpch.run_q3(*q3, engine=e),
        "q5": lambda e: tpch.run_q5(*q5, engine=e)}
with config.override("plan.groupby_wide_span", 1 << 24):
    for q, run in runs.items():
        for engine in ("auto", "eager"):
            torch.cuda.reset_peak_memory_stats()
            out, first = wall(lambda: run(engine))
            warm = sorted(wall(lambda: run(engine))[1] for _ in range(5))
            print(json.dumps({"tree": sys.argv[1], "query": q,
                              "engine": "fused" if engine == "auto"
                              else "eager", "first_ms": first,
                              "warm_median_ms": warm[2], "warm_ms": warm,
                              "peak_gb": torch.cuda.max_memory_allocated()
                              / 1e9, "digest": digest(out)}), flush=True)
'''


def main(trees):
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    first = {}
    for tree in trees:
        p = subprocess.run([sys.executable, "-c", _CHILD, tree],
                           capture_output=True, text=True, timeout=900)
        if p.returncode != 0:
            print(p.stderr[-4000:], file=sys.stderr)
            return 1
        for line in p.stdout.splitlines():
            r = json.loads(line)
            key = (r["query"], r["engine"])
            r["equals_first_tree"] = first.setdefault(key, r["digest"]) \
                == r.pop("digest")
            r["card"] = smi
            print(json.dumps(r), flush=True)
            if not r["equals_first_tree"]:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
