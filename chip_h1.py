"""Kernel H1 of one or more checkouts of the port, side by side, on one
NVIDIA GPU.

    python3 chip_h1.py [--time-only] [--sass-dir DIR] [TREE ...]
    (no TREE: this checkout)

For each TREE in the order given (for an A/B: parent, change, change,
parent), a child process imports that checkout's spark_rapids_jni_tpu_torch
(its kernels built into TREE/build/torch_kernels) and prints, one JSON line
each:

- ``h1_build``: nvcc's ``-Xptxas -v`` lines for csrc/segment_agg.cu;
- ``h1_sass``: the SASS account of H1's chain (``cuobjdump -sass`` of the
  built library): in ``segment_float_agg_kernel``, the DADDs whose source
  is the previous DADD's result, and the instructions issued between two
  such DADDs, as sequences of opcodes with their counts (with --sass-dir,
  the kernel's whole SASS into DIR/<tree name>.sass);
- ``h1_check``: H1 held bit for bit against that checkout's plain version
  on the edge table (f64 and f32), on ``datagen.subnormal_sum_table`` and
  on long segments with odd starts; with the flushed-chunk count where the
  checkout's wrapper takes one (``flushed``), against
  ``kernels.flushed_chunks_plain``;
- ``h1_time``: at S5's shape of ``chip_smoke.py`` (60M standard normals of
  the string table grouped by its STRING key: 995 segments) and at its
  two-group shape (grouped by the BOOL8 column), from the same seeds:
  H1's device ms by CUDA events, the f64 add latency of one thread's chain
  (``kernels.dadd_chain_ms``), the chain bound, ns per row of the longest
  segment, the chain share (bound over ms), ``torch.segment_reduce``'s ms
  (not bit-equal) and a digest of H1's output bits, which every tree must
  give alike (the script fails otherwise).

With --time-only a tree whose H1 differs from its plain version or from
the other trees is timed all the same (for diagnostic copies of the
kernel that skip part of its work). Exits 2 without a CUDA device.
"""

import hashlib
import importlib.util
import inspect
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROWS = 60_000_000


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _cuobjdump():
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("cuobjdump not found")


_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)"
                   r"\s*([^;]*);")


def _regs(arg):
    """The registers (R5, P0, ...) an operand names."""
    return re.findall(r"\b(U?R\d+|U?P\d+)\b", arg)


def sass_account(lib_path, kernel="segment_float_agg_kernel", top=6,
                 dump=None):
    """The chain of ``kernel`` in the SASS of ``lib_path``: its DADDs, the
    DADDs that read the previous DADD's result (through the instructions
    between them: register and predicate dependences), the instructions
    issued between two such DADDs, and those of them that lie on the chain
    (they depend on the previous DADD and the next one depends on them), as
    opcode sequences with their counts, most frequent first."""
    sass = subprocess.run([_cuobjdump(), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    body = ""
    for part in sass.split("Function : ")[1:]:
        if kernel in part.splitlines()[0]:
            body = part
    if dump:
        Path(dump).parent.mkdir(parents=True, exist_ok=True)
        Path(dump).write_text(body)
    insns = [(m.group(1), m.group(2),
              [a.strip() for a in m.group(3).split(",")])
             for m in _INSN.finditer(body)]
    daddn, chained, gaps, on_chain = 0, 0, {}, {}
    taint, between = None, []
    for pred, op, args in insns:
        base = op.split(".")[0]
        dest = _regs(args[0]) if args and args[0] else []
        if base == "ISETP" or base.endswith("SETP"):
            dest += [r for r in _regs(args[1])] if len(args) > 1 else []
        srcs = [r for a in [pred or ""] + args[len(dest) and 1:]
                for r in _regs(a)]
        hit = taint is not None and any(r in taint for r in srcs)
        if base == "DADD":
            daddn += 1
            if hit:
                chained += 1
                key = " ".join(o for o, _ in between) or "(none)"
                gaps[key] = gaps.get(key, 0) + 1
                key = " ".join(o for o, t in between if t) or "(none)"
                on_chain[key] = on_chain.get(key, 0) + 1
            n = int(dest[0][1:]) if dest and dest[0][0] == "R" else None
            taint = set() if n is None else {f"R{n}", f"R{n + 1}"}
            between = []
        elif taint is not None:
            if hit:
                taint.update(d for d in dest if d not in ("PT", "RZ"))
            elif not pred:  # overwritten by a value off the chain
                taint.difference_update(dest)
            between.append((op, hit))
    return {"instructions": len(insns), "dadd": daddn,
            "dadd_on_previous_dadd": chained,
            "between_chained_dadds": sorted(gaps.items(),
                                            key=lambda kv: -kv[1])[:top],
            "on_the_chain_between": sorted(on_chain.items(),
                                           key=lambda kv: -kv[1])[:top]}


def _digest(outs):
    h = hashlib.sha256()
    for t in outs:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _args(key, z):
    """(z, valid, starts) of float64 ``z`` grouped by int64 ``key`` (a
    stable sort, as the groupby sorts)."""
    import torch
    order = torch.sort(key, stable=True).indices
    k = key.index_select(0, order)
    ids = torch.arange(int(k[-1]) + 2, device=k.device)
    return (z.index_select(0, order),
            torch.ones(z.shape[0], dtype=torch.bool, device=z.device),
            torch.searchsorted(k, ids))


def one_tree(tree):
    tree = Path(tree).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke_h1",
                                                  HERE / "chip_smoke.py")
    C = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(C)
    import torch
    from spark_rapids_jni_tpu_torch.ops import kernels as K
    from spark_rapids_jni_tpu_torch.utils import datagen

    if Path(K.__file__).resolve().parents[2] != tree:
        raise RuntimeError(f"imported {K.__file__}, not {tree}'s package")
    card = {"tree": str(tree), "card": _card()}
    dev = torch.device("cuda")
    rep = K.build_all(["segment_agg"]).get("segment_agg", "")
    print(json.dumps({"phase": "h1_build", **card, "ptxas": [
        ln.strip() for ln in rep.splitlines()
        if "registers" in ln or "spill" in ln or "Compiling" in ln]}),
        flush=True)
    dump = (Path(SASS_DIR) / f"{tree.name}.sass") if SASS_DIR else None
    print(json.dumps({"phase": "h1_sass", **card,
                      **sass_account(K._lib_path("segment_agg"),
                                     dump=dump)}), flush=True)

    counts = "flushed" in inspect.signature(K.segment_float_agg).parameters

    def run(z, valid, starts):
        """H1 == plain, bit for bit; the flushed count against the rule."""
        cnt = torch.zeros(1, dtype=torch.int64, device=dev)
        got = (K.segment_float_agg(z, valid, starts, flushed=cnt) if counts
               else K.segment_float_agg(z, valid, starts))
        want = K.segment_float_agg_plain(z, valid, starts)
        same = all(torch.equal(g.view(torch.int64), w.view(torch.int64))
                   for g, w in zip(got, want))
        line = {"equal_plain": same}
        if counts:
            line.update(flushed_chunks=int(cnt),
                        flushed_chunks_rule=K.flushed_chunks_plain(
                            z, valid, starts))
        return line

    checks = {}
    edge = datagen.float_edge_table(1 << 20, 0, device=dev)
    ekey = edge[0].data.to(torch.int64)
    eorder = torch.sort(ekey, stable=True).indices
    for c in (1, 2):
        ez, _, est = _args(ekey, K_values(edge[c]))
        checks[f"edge_{edge[c].dtype.id.value}"] = run(
            ez, edge[c].valid_mask().index_select(0, eorder), est)
    if hasattr(datagen, "subnormal_sum_table"):  # not in older checkouts
        sub = datagen.subnormal_sum_table(seed=0, device=dev)
        skey = sub[0].data.to(torch.int64)
        sz, _, sst = _args(skey, sub[1].data)
        checks["subnormal_sums"] = run(
            sz, sub[1].valid_mask().index_select(
                0, torch.sort(skey, stable=True).indices), sst)
    rng = np.random.default_rng(3)
    n = 3_000_001
    lz = torch.from_numpy(rng.standard_normal(n + 1)).to(dev)[1:]
    lv = torch.from_numpy(rng.random(n + 1) > 0.1).to(dev)[1:]
    lst = torch.tensor([0, 1, 1, 1_000_003, 1_000_004, 2_999_999, n],
                       dtype=torch.int64, device=dev)
    checks["long_odd_starts"] = run(lz, lv, lst)
    print(json.dumps({"phase": "h1_check", **card, **checks}), flush=True)
    bad = [k for k, v in checks.items() if not v["equal_plain"] or (
        counts and v["flushed_chunks"] != v["flushed_chunks_rule"])]
    if bad and not TIME_ONLY:
        raise AssertionError(f"{tree}: H1 differs from plain on {bad}")

    # S5's shape and the two-group shape, from chip_smoke's seeds
    r = np.random.default_rng(0)
    r.integers(-2**31, 2**31, ROWS)
    r.integers(0, 100, ROWS)
    z = torch.from_numpy(r.standard_normal(ROWS)).to(dev)
    b8 = torch.from_numpy(r.integers(0, 2, ROWS).astype(np.int64)).to(dev)
    _, gid = C.string_key_draws(ROWS)
    add_ns = K.dadd_chain_ms(10_000_000, dev) * 1e6 / 1e7
    digests = {}
    for shape, key, reps in (("S5_995_segments", torch.from_numpy(gid).to(
            dev), 5), ("two_groups", b8, 3)):
        args = _args(key, z)
        lens = args[2][1:] - args[2][:-1]
        longest = int(lens.max())
        ms = C.cuda_ms(lambda: K.segment_float_agg(*args), reps=reps, warm=1)
        chain = longest * add_ns / 1e6
        digests[shape] = _digest(K.segment_float_agg(*args))
        lib = C.cuda_ms(lambda: torch.segment_reduce(args[0], "sum",
                                                     lengths=lens),
                        reps=reps, warm=1)
        print(json.dumps({
            "phase": "h1_time", **card, "shape": shape, "rows": ROWS,
            "segments": int(lens.numel()), "longest_segment": longest,
            "ms": ms, "dadd_latency_ns": add_ns, "chain_bound_ms": chain,
            "ns_per_row": ms * 1e6 / longest, "chain_share": chain / ms,
            "library_ms": lib, "digest": digests[shape]}), flush=True)
        del args
    print(json.dumps({"phase": "h1_digests", "tree": str(tree),
                      **digests}), flush=True)


def K_values(col):
    """A FLOAT32/FLOAT64 column's values as float64 (the groupby's)."""
    from spark_rapids_jni_tpu_torch.ops import groupby as G
    return G._f64_values(col)


SASS_DIR = None
TIME_ONLY = False


def main(argv):
    global SASS_DIR, TIME_ONLY
    if argv[:1] == ["--time-only"]:
        TIME_ONLY, argv = True, argv[1:]
    if argv[:1] == ["--sass-dir"]:
        SASS_DIR, argv = argv[1], argv[2:]
    if argv[:1] == ["--one"]:
        one_tree(argv[1])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_h1: no CUDA device", file=sys.stderr)
        return 2
    trees = argv or [str(HERE)]
    digests = []
    for tree in trees:
        sass = ["--sass-dir", SASS_DIR] if SASS_DIR else []
        proc = subprocess.run([sys.executable, __file__,
                               *(["--time-only"] if TIME_ONLY else []),
                               *sass, "--one", tree],
                              capture_output=True, text=True, timeout=600)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            return proc.returncode
        digests += [ln for ln in proc.stdout.splitlines()
                    if '"h1_digests"' in ln]
    seen = {json.dumps({k: v for k, v in json.loads(d).items()
                        if k != "tree"}) for d in digests}
    if len(seen) != 1 and not TIME_ONLY:
        print("chip_h1: the trees' H1 outputs differ", file=sys.stderr)
        return 1
    print(json.dumps({"h1_trees_agree": True, "trees": trees}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
