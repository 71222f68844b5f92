"""Kernel H2 (DECIMAL128 arithmetic) of one or more checkouts of the port,
side by side, on one NVIDIA GPU.

    python3 chip_h2.py [TREE ...]    (no TREE: this checkout)

For each TREE in the order given (for an A/B: parent, change, change,
parent), a child process imports that checkout's spark_rapids_jni_tpu_torch
(its kernels built into TREE/build/torch_kernels) and prints, one JSON line
each:

- ``h2_build``: nvcc's ``-Xptxas -v`` lines for csrc/decimal128.cu, and
  each op's kernel's registers, stack frame and spill bytes;
- ``h2_sass``: from ``cuobjdump -sass`` of the built library, each op's
  kernel's instructions and its LDL, STL and CALL counts, the fewest
  instructions of one per-row reciprocal and one digit step (a source
  without the h2_probe_* kernels: null) and of any division subroutine;
- ``h2_check``: H2 held bit for bit (limbs, overflow, validity) against
  that checkout's plain version (run on the card) on the edge table and on
  the division table (``decimal128_division_cases`` of this checkout's
  utils/datagen.py, which older checkouts lack, built on the tree's
  columns);
- ``h2_time``: the six ops of chip_smoke.py's phase 11d at 60M rows from
  its seed (18-digit values at scale 4 by 9-digit ones at scale 2): CUDA
  event ms, the profiler's kernel ms, the bound (bytes, or the division's
  instructions from the tree's SASS at the card's issue rate where the
  tree has the probes), the share (the bound over the kernel's ms), and a
  digest of the outputs, which every tree must give alike (the script
  fails otherwise).

Exits 2 without a CUDA device.
"""

import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROWS = 60_000_000


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _here_datagen():
    """This checkout's utils/datagen.py as a module of the imported
    (tree's) package, for its division table."""
    spec = importlib.util.spec_from_file_location(
        "spark_rapids_jni_tpu_torch.utils._datagen_h2",
        HERE / "spark_rapids_jni_tpu_torch" / "utils" / "datagen.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def one_tree(tree):
    tree = Path(tree).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke_h2",
                                                  HERE / "chip_smoke.py")
    C = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(C)
    import torch
    from spark_rapids_jni_tpu_torch.ops import decimal128 as D
    from spark_rapids_jni_tpu_torch.ops import kernels as K
    from spark_rapids_jni_tpu_torch.utils import datagen

    if Path(K.__file__).resolve().parents[2] != tree:
        raise RuntimeError(f"imported {K.__file__}, not {tree}'s package")
    card = {"tree": str(tree), "card": _card()}
    C.read_instruction_rate()
    dev = torch.device("cuda")
    rep = K.build_all(["decimal128"]).get("decimal128", "")
    print(json.dumps({"phase": "h2_build", **card, "ptxas": [
        ln.strip() for ln in rep.splitlines()
        if "registers" in ln or "spill" in ln or "Compiling" in ln],
        "kernels": C.h2_ptxas(rep)}), flush=True)
    lib = K._lib_path("decimal128")
    sass = C.h2_sass(lib)
    print(json.dumps({"phase": "h2_sass", **card,
                      **(sass or {"sass": None})}), flush=True)

    checks = {}
    tables = {"edge": datagen.decimal128_edge_cases(512, 3, dev),
              "division": _here_datagen().decimal128_division_cases(
                  4096, 4, dev)}
    for name, cases in tables.items():
        checks[name] = all(C._h2_equals_plain(op, a, b, scale, cast)[0]
                           for op, a, b, scale, cast in cases)
    del tables
    print(json.dumps({"phase": "h2_check", **card, **checks}), flush=True)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"{tree}: H2 differs from plain on {bad}")

    xa, xb = C._h2_operands(ROWS, dev, 13)
    work = C.h2_division_work(xa.data, xb.data)
    k_ms = C.h2_kernel_ms([((lambda o=o, s=s: C._h2_call(o, xa, xb, s)), o)
                           for o, _, _, s in C.H2_TIMED])
    digests = {}
    for i, (op, _, _, scale) in enumerate(C.H2_TIMED):
        out = C._h2_call(op, xa, xb, scale)
        digests[op] = _digest([out[0].data, out[1].data])
        del out
        ms = C.cuda_ms(lambda: C._h2_call(op, xa, xb, scale), reps=5,
                       warm=1)
        nbytes = ROWS * (32 + (9 if op == "integer_divide" else 17))
        nops = (C.h2_division_ops(work[op], sass) if op in work else 0)
        b_ms, b_by = C.bound_ms(nbytes, nops or 0)
        timed = C.profiler_fields(k_ms[i], ms)
        print(json.dumps({
            "phase": "h2_time", **card, "op": op, "rows": ROWS, "ms": ms,
            **timed, "bytes_ms": nbytes / C.HBM_BYTES_PER_S * 1e3,
            "operations": nops, "bound_ms": b_ms, "bound_by": b_by,
            "share": b_ms / (timed["kernel_ms"] or ms),
            "digest": digests[op],
            "division_work": work.get(op) if nops else None}),
            flush=True)
    print(json.dumps({"phase": "h2_digests", "tree": str(tree),
                      **digests}), flush=True)


def main(argv):
    if argv[:1] == ["--one"]:
        one_tree(argv[1])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_h2: no CUDA device", file=sys.stderr)
        return 2
    trees = argv or [str(HERE)]
    digests = []
    for tree in trees:
        proc = subprocess.run([sys.executable, __file__, "--one", tree],
                              capture_output=True, text=True, timeout=900)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            return proc.returncode
        digests += [ln for ln in proc.stdout.splitlines()
                    if '"h2_digests"' in ln]
    seen = {json.dumps({k: v for k, v in json.loads(d).items()
                        if k != "tree"}) for d in digests}
    if len(seen) != 1:
        print("chip_h2: the trees' H2 outputs differ", file=sys.stderr)
        return 1
    print(json.dumps({"h2_trees_agree": True, "trees": trees}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
