"""Admission control's typed rejection (the JAX package's
serving/admission.py).

This file holds only ``AdmissionRejected``, the error a closed
``parallel.task_executor.TaskExecutor`` raises from ``submit``. The rest
of the JAX module (the admission controller over the session registry,
the breaker and the queue-depth and queue-delay inputs) comes with the
serving tier, ROADMAP A16. The executor imports this class lazily, inside
``submit``, as the JAX package does: the serving tier imports the
executor back.
"""

from __future__ import annotations

from typing import Optional


class AdmissionRejected(RuntimeError):
    """Typed front-door rejection. ``reason`` is one of ``closed`` /
    ``draining`` / ``breaker_open`` / ``queue_full`` /
    ``tenant_queue_budget`` / ``queue_delay`` / ``unknown_tenant`` /
    ``tenant_in_flight`` / ``hbm_budget`` / ``requeue_exhausted``;
    ``retry_after_s`` is the caller's backoff hint (0.0 = do not retry,
    the resource is gone). Subclasses RuntimeError, so callers of
    ``TaskExecutor.submit`` that catch RuntimeError keep working."""

    def __init__(self, reason: str, retry_after_s: float = 0.0,
                 tenant_id: Optional[str] = None, detail: str = ""):
        self.reason = reason
        self.retry_after_s = float(retry_after_s)
        self.tenant_id = tenant_id
        msg = f"admission rejected ({reason})"
        if tenant_id is not None:
            msg += f" for tenant {tenant_id!r}"
        if detail:
            msg += f": {detail}"
        if self.retry_after_s > 0:
            msg += f" [retry after {self.retry_after_s:.3f}s]"
        super().__init__(msg)
