"""Plan-core registry: the contract between the op layer and the fused
plan engine.

An op module marks each function the lowering (plan/compile.py) composes
with ``@plan_core("name")``. The decorator only records the function and
tags it; it carries the contract every fused program depends on:

  * no host sync: no ``.item()``, ``int(t)``, ``.tolist()``,
    ``torch.nonzero``, boolean-mask indexing, ``torch.unique``,
    ``repeat_interleave`` without ``output_size``, and no tensor built from
    host data (a pageable host-to-device copy waits too) — the one sync of
    a fused query is the executor's read of the program's ``head``;
  * static shapes: every output size follows from the input sizes and the
    planner's decisions, never from the data;
  * every gather index in range: a CUDA gather out of range is a
    device-side assert that ends the process's CUDA context, so indices
    that can be garbage (misses, overflowed slots) are clamped first.

This module is a leaf: op modules import it without the rest of the plan
package (plan/__init__ exports lazily).
"""

from __future__ import annotations

from typing import Callable, Dict

_CORES: Dict[str, str] = {}


def plan_core(name: str) -> Callable:
    """Register ``fn`` as a core the fused lowering composes."""

    def deco(fn: Callable) -> Callable:
        _CORES[name] = f"{fn.__module__}.{fn.__qualname__}"
        fn.__plan_core__ = name
        return fn

    return deco


def registered_cores() -> Dict[str, str]:
    """name -> qualified function name, for introspection and tests."""
    return dict(_CORES)
