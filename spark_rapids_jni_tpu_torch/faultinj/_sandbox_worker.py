"""Sandbox worker entry point (runs inside the supervised subprocess; the
JAX package's faultinj/_sandbox_worker.py).

Launched by faultinj/sandbox.py as ``python _sandbox_worker.py <fd_in>
<fd_out>``: as a plain script, NOT a package module, so a "native" worker
hosting file-loaded targets (faultinj/_sandbox_targets.py) starts with
bare python and numpy: it never imports torch and never creates a CUDA
context (the parent also hides every card from it). A "bridge" worker's
targets are package modules ("mod" specs: the bridge's ``_sandboxed_op``),
imported on first use; it imports torch, and the card is visible to it.

Protocol (pickled over a pipe pair, multiprocessing Connection framing):

  request:  {"id": n, "target": ("file", path, func) | ("mod", dotted,
             func), "args": tuple, "kwargs": dict, "crash": directive}
  response: ("ok", n, result) | ("err", n, exception)
  shutdown: None (the worker exits 0)

A ``crash`` directive ({"mode": "abort"|"kill"|"exit", "code": k}) is
injectionType 5, sampled by the PARENT (injector.crash_spec) but executed
HERE: the point of the sandbox is that real process death, not a
simulated exception, is what the supervisor must contain. The parent
detects it by exitcode/signal and classifies the CRASH fault domain.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import signal
import sys


_file_modules = {}


def _load_file_module(path: str):
    """Import a module by absolute file path (no package machinery)."""
    mod = _file_modules.get(path)
    if mod is None:
        name = "srjt_sandbox_file_%d" % len(_file_modules)
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _file_modules[path] = mod
    return mod


def _resolve(target):
    kind, where, func = target
    if kind == "file":
        return getattr(_load_file_module(where), func)
    if kind == "mod":
        return getattr(importlib.import_module(where), func)
    raise ValueError(f"unknown sandbox target kind {kind!r}")


def _crash(directive):
    mode = directive.get("mode", "abort")
    if mode == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    elif mode == "exit":
        os._exit(int(directive.get("code", 1)) or 1)
    os.abort()  # SIGABRT — the native-trap analog


def worker_main(fd_in: int, fd_out: int) -> None:
    from multiprocessing.connection import Connection
    rx = Connection(fd_in, writable=False)
    tx = Connection(fd_out, readable=False)
    while True:
        try:
            msg = rx.recv()
        except EOFError:
            return  # parent closed the pipe: orderly shutdown
        if msg is None:
            return
        rid = msg.get("id")
        directive = msg.get("crash")
        if directive:
            _crash(directive)  # never returns
        try:
            fn = _resolve(msg["target"])
            out = fn(*msg.get("args", ()), **(msg.get("kwargs") or {}))
            tx.send(("ok", rid, out))
        except BaseException as e:  # noqa: BLE001 — relayed to the parent
            try:
                tx.send(("err", rid, e))
            except Exception:
                # unpicklable exception: degrade to its repr
                tx.send(("err", rid,
                         RuntimeError(f"{type(e).__name__}: {e}")))


if __name__ == "__main__":
    worker_main(int(sys.argv[1]), int(sys.argv[2]))
