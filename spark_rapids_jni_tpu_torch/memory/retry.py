"""Retry-loop helper implementing the OOM-exception contract (the JAX
package's memory/retry.py, the same behaviour).

The reference leaves the retry loop to the spark-rapids plugin
(RmmRapidsRetryIterator); the JNI layer only defines the exceptions and the
state machine. This helper is the minimal in-framework equivalent so tests
and internal callers can exercise the full roll-back / split protocol.

Degradation ladder: a ``TpuRetryOOM``
rolls back (spill), blocks at the pool gate, and re-runs the SAME work; a
``TpuSplitAndRetryOOM`` halves the input and re-runs the pieces — depth
bounded by ``rmm.max_split_depth`` so a demand the pool can never satisfy
surfaces as a typed OOM chained to the demand that proved it, not an
unbounded subdivision. While a thread is inside the protocol's blocking
sections (rollback, the BUFN gate) it is marked with
``faultinj.watchdog.oom_wait`` so the hang watchdog never mistakes a
legitimately blocked-until-ready thread for a stall.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple, TypeVar

from .exceptions import (
    CpuRetryOOM,
    CpuSplitAndRetryOOM,
    TpuRetryOOM,
    TpuSplitAndRetryOOM,
)
from .rmm_spark import RmmSpark

T = TypeVar("T")
A = TypeVar("A")


def _max_split_depth(given: Optional[int]) -> int:
    if given is not None:
        return int(given)
    from ..utils import config
    return int(config.get("rmm.max_split_depth"))


def with_retry(
    attempt: Callable[[A], T],
    arg: A,
    split: Callable[[A], List[A]] = None,
    rollback: Callable[[], None] = None,
    max_retries: int = 100,
    max_split_depth: Optional[int] = None,
) -> List[T]:
    """Run ``attempt(arg)`` under the retry-OOM protocol.

    * On ``TpuRetryOOM``/``CpuRetryOOM``: call ``rollback()`` (release
      spillable state), ``block_thread_until_ready()``, and retry.
    * On ``TpuSplitAndRetryOOM``/``CpuSplitAndRetryOOM``: call ``split(arg)``
      to divide the input, then process each piece under the same protocol.
      Each piece may be split again, at most ``max_split_depth`` times
      total along any one lineage (default: the ``rmm.max_split_depth``
      config key); past the bound — or when no ``split`` callback is
      given — the demanding OOM propagates typed to the caller.

    ``max_retries`` bounds the TOTAL number of recovery actions (rollbacks
    plus splits) across all pieces; exhausting it raises ``TpuRetryOOM``
    chained to the OOM that spent the last attempt.

    Returns the list of results (one per final piece, in input order).
    """
    # pending carries (split_depth, piece); splits splice pieces in place
    # so result order always matches input row order
    pending: List[Tuple[int, A]] = [(0, arg)]
    out: List[T] = []
    retries = 0
    depth_bound = _max_split_depth(max_split_depth)

    def bump(cause: BaseException) -> None:
        nonlocal retries
        retries += 1
        if retries > max_retries:
            raise TpuRetryOOM(
                f"gave up after {max_retries} retries") from cause

    def do_split(cause: BaseException) -> None:
        if split is None:
            # nothing to subdivide with: the demanding OOM is the answer
            # (re-raised explicitly — never a bare ``raise`` that would
            # RuntimeError with no active exception)
            raise cause
        depth, piece = pending[0]
        if depth >= depth_bound:
            raise TpuSplitAndRetryOOM(
                f"split depth {depth} reached rmm.max_split_depth="
                f"{depth_bound}; cannot subdivide further") from cause
        pieces = split(piece)
        if not pieces or len(pieces) < 2:
            # a split that can't divide is terminal: surface it as such
            # (chained to the OOM that demanded it) rather than silently
            # re-raising the original as if no split had been attempted
            n = len(pieces) if pieces else 0
            raise TpuSplitAndRetryOOM(
                f"split produced {n} piece(s); cannot subdivide further"
            ) from cause
        pending[0:1] = [(depth + 1, p) for p in pieces]

    def recover(fn: Callable[[], None]) -> None:
        # rollback + the BUFN gate are the protocol's legitimate blocking
        # sections: mark the thread so the hang watchdog's stall sweep
        # never cancels a split-retrying thread as wedged
        from ..faultinj import watchdog
        with watchdog.oom_wait():
            fn()

    # the native retry-block bracket (and BUFN gate) exist only when the
    # resource adaptor is installed; ungoverned callers (unit tests, pure
    # fault-injection OOMs) still get the full rollback/split ladder
    governed = RmmSpark.is_installed()
    if governed:
        RmmSpark.start_retry_block()
    try:
        while pending:
            try:
                out.append(attempt(pending[0][1]))
                pending.pop(0)
            except (TpuRetryOOM, CpuRetryOOM) as oom:
                bump(oom)
                if rollback is not None:
                    recover(rollback)
                # Re-entering the gate may itself escalate: the machine hands
                # a BUFN thread SplitAndRetryOOM (or another RetryOOM) from
                # block_thread_until_ready, not only from alloc.
                while True:
                    try:
                        if governed:
                            recover(RmmSpark.block_thread_until_ready)
                        break
                    except (TpuSplitAndRetryOOM, CpuSplitAndRetryOOM) as esc:
                        bump(esc)
                        do_split(esc)
                        break
                    except (TpuRetryOOM, CpuRetryOOM) as again:
                        bump(again)
                        if rollback is not None:
                            recover(rollback)
            except (TpuSplitAndRetryOOM, CpuSplitAndRetryOOM) as oom:
                bump(oom)
                do_split(oom)
        return out
    finally:
        if governed:
            RmmSpark.end_retry_block()
