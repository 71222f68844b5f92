"""The plan engine: logical plans run by an eager interpreter or lowered
into one fused program of torch ops with one host sync.

Exports are lazy (PEP 562): op modules import ``plan.registry`` directly
and must not drag the executor (which imports the ops back) into their
import cycle.
"""

from __future__ import annotations

_LAZY = {
    "plan_core": ".registry",
    "registered_cores": ".registry",
    "Expr": ".expr",
    "col": ".expr",
    "lit": ".expr",
    "i64": ".expr",
    "PlanError": ".nodes",
    "PlanNode": ".nodes",
    "Scan": ".nodes",
    "Filter": ".nodes",
    "Project": ".nodes",
    "GroupBy": ".nodes",
    "Sort": ".nodes",
    "Limit": ".nodes",
    "Join": ".nodes",
    "fingerprint": ".nodes",
    "is_dag": ".nodes",
    "walk": ".nodes",
    "optimize": ".planner",
    "plan_decisions": ".planner",
    "push_filters": ".planner",
    "source_predicates": ".planner",
    "ProgramCache": ".compile",
    "plan_metrics": ".compile",
    "execute_plan": ".executor",
    "unsupported_reason": ".executor",
    "run_eager": ".interpreter",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod, __name__), name)


def __dir__():
    return __all__
