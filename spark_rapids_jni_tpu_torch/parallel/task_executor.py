"""Per-task dispatch contexts: concurrent Spark tasks on one GPU, each on
its own CUDA stream (the JAX package's parallel/task_executor.py).

Reference capability: the reference compiles with per-thread default
streams (PTDS, CMakeLists.txt:221-225 / pom.xml:80), so every Spark task's
kernels and copies ride its own CUDA stream and overlap on the GPU. Here
each task gets a dedicated worker thread, registered with the RmmSpark
state machine (so the retry/BUFN/split scheduler arbitrates between live
tasks), whose submissions run under the degradation ladder with tracing
spans; and, for an executor built for the card, a ``torch.cuda.Stream`` of
its own, current in that thread for the thread's whole life. Torch's
current stream is per thread, so every torch op of a task body and every
kernel wrapper (ops/kernels.py launches on the current stream) lands on
the task's stream. One task's host phase (a Parquet read's run walk and
host extract) overlaps another task's kernels.

The handoff between streams, which ``submit`` and the worker keep:

- **Inputs.** ``submit`` records an event on the submitter's current
  stream, and the task's stream waits on it before the body runs: the body
  sees everything the submitter enqueued before it submitted. Every CUDA
  tensor among the arguments (tensors, Columns, Tables, and lists, tuples
  and dicts of them) gets ``record_stream(task stream)``, so the caching
  allocator hands none of its blocks out again, should the submitter drop
  it, before the task's stream has passed the point of the free.
- **Outputs.** A Future resolves with a result only after the task's
  stream has finished the submission's work: the worker records an event
  after the body and synchronises on it, which blocks that task's thread
  alone (a body that raises resolves its Future with the exception at
  once). Every CUDA tensor in the result gets ``record_stream(submitter's
  stream)``: the allocator would otherwise reuse its blocks on the task's
  stream while the consumer still reads them.
- **Same-task order** is stream order plus the worker queue (the
  reference's per-stream ordering contract).
- **Other threads.** Work a task body hands to another thread runs on that
  thread's current stream, not the task's. The Parquet decode pool
  (parquet/reader.py) does host work only and ships to the device from the
  task's own thread, so a read stays on the task's stream.
- **On the CPU** (``device="cpu"``) there is no stream: the executor is the
  JAX package's threads and nothing more.

Usage::

    with TaskExecutor(device="cuda") as ex:
        fa = ex.submit(1, sort_table, table_a, [0])   # task 1
        fb = ex.submit(2, sort_table, table_b, [0])   # task 2
        out_a, out_b = fa.result(), fb.result()
"""

from __future__ import annotations

import contextlib
import queue
import signal
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from ..columnar.column import resolve_device
from ..faultinj import guard, watchdog
from ..faultinj.injector import DeviceAssertError, DeviceTrapError
from ..faultinj.sandbox import WorkerCrashError
from ..memory.exceptions import CpuRetryOOM, TpuOOM, TpuRetryOOM
from ..memory.integrity import CorruptionError
from ..memory.reservation import cuda_tensors
from ..memory.rmm_spark import RmmSpark
from ..utils.tracing import trace_range

_SENTINEL = object()

# failures the degradation ladder counts as "the device is unhealthy":
# traps/asserts that escaped an unguarded path, plus the guard's own
# exhausted-budget verdicts (a storm or a poisoned program at any surface)
_DEVICE_FAILURES = (DeviceTrapError, DeviceAssertError,
                    guard.FaultStormError, guard.ProgramPoisonedError)

# stall verdicts from the deadline/watchdog subsystem: the task's budget
# expired or the watchdog cancelled it mid-dispatch — same ladder as a
# device failure (a wedged device and a trapped one are equally unhealthy)
_STALL_FAILURES = (watchdog.DeadlineExceededError,
                   watchdog.StallCancelledError)


class _Handoff(NamedTuple):
    """A submission's stream handoff: the event the task's stream waits on
    before the body, and the submitter's stream its result is handed to."""
    ready: torch.cuda.Event
    consumer: torch.cuda.Stream


class _TaskWorker:
    """Dedicated worker thread for one task id (the reference's
    per-task-thread model: RmmSpark.java startDedicatedTaskThread), with
    its own CUDA stream when ``stream`` is given.

    Every submission runs under the degradation ladder (_supervise):
    retry-OOM rolls back to spillable state and retries within the
    ``task.retry_budget``; after ``task.degrade_after`` consecutive device
    failures the task is downgraded to the host/CPU compute path
    (guard.degraded mode: injection suppressed, auto tiers resolve host)
    for the rest of its life, with a tracing span and a degradation
    counter recording the downgrade. Degraded mode is per thread, so a
    degraded task degrades only itself.
    """

    def __init__(self, task_id: int, register: bool, spill_store=None,
                 on_lost=None, stream: Optional[torch.cuda.Stream] = None):
        self.task_id = task_id
        self.degraded = False
        # set by the watchdog's lost-worker path: the thread ignored a
        # cancel past watchdog.lost_after_s; exit as soon as it wakes
        self.lost = False
        self.stream = stream
        self._register = register
        self._spill_store = spill_store
        self._on_lost = on_lost
        self._current = None  # the item being executed (requeue on lost)
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(
            target=self._run, name=f"task-exec-{task_id}", daemon=True)
        self._thread.start()

    def _rollback(self):
        """Roll back to a spillable state between attempts (the TpuRetryOOM
        contract): demote every registered buffer, then re-enter the
        scheduler's gate when one is installed."""
        if self._spill_store is not None:
            self._spill_store.spill_all()
        if RmmSpark.is_installed():
            try:
                RmmSpark.block_thread_until_ready()
            except (TpuOOM, RuntimeError):
                # an escalation here re-manifests at the next reservation;
                # the retry budget still bounds the loop
                pass

    def _attempt_deadline(self, snap, stalled: bool):
        """Deadline context for one supervised attempt.

        First attempts adopt the submitter's snapshot (absolute expiry:
        queue time counts) or arm ``task.budget_s``. After a stall the
        prior budget is spent and its token cancelled, so a retry runs
        under a FRESH deadline (the per-attempt ``with`` has exited by
        then, so it never nests with the expired one)."""
        from ..utils import config
        budget_s = float(config.get("task.budget_s"))
        what = f"task{self.task_id}"
        if stalled:
            fresh = budget_s if budget_s > 0 else (snap[0] if snap else 0.0)
            if fresh > 0:
                return watchdog.Deadline(fresh, what)
            return contextlib.nullcontext()
        if snap is not None:
            return watchdog.Deadline.adopt(snap)
        if budget_s > 0:
            return watchdog.Deadline(budget_s, what)
        return contextlib.nullcontext()

    def _run_attempt(self, fn, args, kwargs, label):
        """One attempt, registered with the watchdog as a task-body
        dispatch: a stall in unguarded code is still detected, diagnosed
        and cancelled."""
        handle = watchdog.begin_dispatch(f"task{self.task_id}:{label}")
        try:
            if self.degraded:
                with guard.degraded(), \
                        trace_range(f"task{self.task_id}:degraded:"
                                    f"{label}"):
                    return fn(*args, **kwargs)
            with trace_range(f"task{self.task_id}:{label}"):
                return fn(*args, **kwargs)
        finally:
            watchdog.end_dispatch(handle)

    def _degrade(self, device_failures: int, degrade_after: int) -> bool:
        """True when this device or stall failure downgrades the task to
        the host path (the downgrade itself is not a retry spend)."""
        if (degrade_after > 0 and not self.degraded
                and device_failures >= degrade_after):
            self.degraded = True
            guard.metrics.bump("degradations")
            with trace_range(f"task{self.task_id}:degrade"):
                pass
            return True
        return False

    def _supervise(self, fn, args, kwargs, snap=None):
        """Run one submission under the per-task retry/degradation ladder."""
        from ..utils import config
        budget = int(config.get("task.retry_budget"))
        degrade_after = int(config.get("task.degrade_after"))
        attempts = 0
        device_failures = 0
        stalled = False
        label = getattr(fn, "__name__", None) or repr(fn)
        while True:
            try:
                with self._attempt_deadline(snap, stalled):
                    return self._run_attempt(fn, args, kwargs, label)
            except _STALL_FAILURES:
                # the budget expired or the watchdog cancelled us: same
                # ladder as a device failure, but the next attempt gets a
                # fresh budget
                stalled = True
                attempts += 1
                device_failures += 1
                if self._degrade(device_failures, degrade_after):
                    continue
                if attempts > budget:
                    raise
            except (TpuRetryOOM, CpuRetryOOM):
                # memory pressure: not a device-health signal — rollback
                # and retry under the budget (split escalation is the
                # caller's protocol via memory.retry.with_retry)
                attempts += 1
                device_failures = 0
                if attempts > budget:
                    raise
            except (CorruptionError, WorkerCrashError):
                # a verified-corrupt buffer was quarantined by its
                # detector, or a sandbox worker died: re-running the
                # submission re-materializes from upstream (the worker
                # respawns lazily). Same budget; never retry-in-place.
                attempts += 1
                device_failures = 0
                if attempts > budget:
                    raise
            except _DEVICE_FAILURES:
                attempts += 1
                device_failures += 1
                if self._degrade(device_failures, degrade_after):
                    continue
                if attempts > budget:
                    raise
            guard.metrics.bump("task_retries")
            self._rollback()

    def _resolve(self, fut: Future, value, exc) -> None:
        """Resolve a future that the lost-worker path may have resolved
        first (the re-queued attempt races a wedged original that finally
        woke up — first writer wins, the loser's outcome is dropped)."""
        if fut.done():
            return
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(value)
        except InvalidStateError:
            pass

    def _finish(self, result, handoff: Optional[_Handoff]) -> None:
        """The output half of the handoff: wait for the task's stream to
        finish the submission's work (this thread alone blocks; a device
        error surfaces here, and the Future carries it), then hand the
        result's tensors to the submitter's stream."""
        if handoff is None:
            return
        done = torch.cuda.Event()
        done.record(self.stream)
        done.synchronize()
        for t in cuda_tensors(result):
            t.record_stream(handoff.consumer)

    def _execute(self, item) -> None:
        fut, fn, args, kwargs, snap, requeues, handoff = item
        self._current = item
        try:
            if handoff is not None:
                self.stream.wait_event(handoff.ready)
            try:
                result = self._supervise(fn, args, kwargs, snap)
                self._finish(result, handoff)
            except BaseException as e:  # noqa: BLE001 — future
                self._resolve(fut, None, e)
            else:
                self._resolve(fut, result, None)
        finally:
            self._current = None

    def _run(self):
        registered = False
        if self._register:
            try:
                RmmSpark.current_thread_is_dedicated_to_task(self.task_id)
                registered = True
            except RuntimeError:
                pass  # no event handler installed: ops run ungoverned
        if self._on_lost is not None:
            watchdog.set_lost_handler(lambda: self._on_lost(self))
        streamed = (torch.cuda.stream(self.stream)
                    if self.stream is not None else contextlib.nullcontext())
        try:
            with streamed:
                while True:
                    if self.lost:
                        break  # retired by the watchdog; a fresh worker
                        # owns the queue's remaining items now
                    try:
                        # bounded get: a lost worker that wakes mid-idle
                        # still notices within one poll
                        item = self._q.get(timeout=0.5)
                    except queue.Empty:
                        continue
                    if item is _SENTINEL:
                        break
                    fut, requeues = item[0], item[5]
                    if requeues == 0 and \
                            not fut.set_running_or_notify_cancel():
                        continue
                    if fut.done():
                        continue  # lost path already failed it
                    self._execute(item)
        finally:
            if registered:
                try:
                    RmmSpark.remove_current_thread_association(self.task_id)
                except RuntimeError:
                    pass

    def submit(self, fn, args, kwargs, snap=None) -> Future:
        """Enqueue one submission; on the card, its input handoff is taken
        here, on the submitter's thread."""
        handoff = None
        if self.stream is not None:
            consumer = torch.cuda.current_stream(self.stream.device)
            ready = torch.cuda.Event()
            ready.record(consumer)
            for t in cuda_tensors([args, kwargs]):
                t.record_stream(self.stream)
            handoff = _Handoff(ready, consumer)
        fut: Future = Future()
        self._q.put((fut, fn, args, kwargs, snap, 0, handoff))
        return fut

    def stop(self):
        self._q.put(_SENTINEL)

    def join(self, timeout: Optional[float] = None) -> bool:
        """Join the worker; returns True iff it actually exited. Joining
        from the worker thread itself (an op closing its own executor) is a
        no-op that reports still-running."""
        if self._thread is threading.current_thread():
            return False
        self._thread.join(timeout)
        return not self._thread.is_alive()


class TaskExecutor:
    """Dispatch contexts for concurrent tasks (see the module docstring).

    ``submit(task_id, fn, *args)`` enqueues ``fn`` on the task's dedicated
    worker; distinct tasks run concurrently, each on its own CUDA stream
    for an executor on the card; same-task ops keep submission order —
    the per-stream ordering contract CUDA streams give the reference.

    ``spill_store`` (optional): a :class:`memory.transport.SpillStore` the
    degradation ladder rolls back through between retry attempts.
    ``device``: the card (the default; raises without one) or ``"cpu"``,
    where the workers have no stream.
    """

    def __init__(self, mark_tasks_done: bool = True, spill_store=None,
                 device="cuda"):
        self.device = resolve_device(device)
        self._workers: Dict[int, _TaskWorker] = {}
        # workers whose join timed out in task_done(): popped from
        # _workers but their task not yet marked done — close() gives
        # them a second chance so the scheduler slot isn't leaked
        self._zombies: Dict[int, _TaskWorker] = {}
        # workers the watchdog declared lost (cancel ignored past
        # watchdog.lost_after_s): replaced in _workers by a fresh worker,
        # joined best-effort at close() if they ever wake
        self._lost: List[_TaskWorker] = []
        self._lock = threading.Lock()
        self._mark_done = mark_tasks_done
        self._spill_store = spill_store
        self._closed = False
        self.last_drain: Optional[Dict[str, Any]] = None

    def _new_worker(self, task_id: int) -> _TaskWorker:
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)
        return _TaskWorker(task_id, RmmSpark.is_installed(),
                           spill_store=self._spill_store,
                           on_lost=self._worker_lost, stream=stream)

    def degraded_task_ids(self):
        """Task ids currently downgraded to the host/CPU compute path."""
        with self._lock:
            return sorted(tid for tid, w in self._workers.items()
                          if w.degraded)

    def task_streams(self) -> Dict[int, Optional[torch.cuda.Stream]]:
        """Each live task's CUDA stream (None on the CPU)."""
        with self._lock:
            return {tid: w.stream for tid, w in self._workers.items()}

    def submit(self, task_id: int, fn: Callable[..., Any], *args,
               **kwargs) -> Future:
        # capture the submitter's deadline (if any) so the worker thread
        # runs the task body under the same absolute budget + cancel token
        dl = watchdog.current_deadline()
        snap = dl.snapshot() if dl is not None else None
        with self._lock:
            if self._closed:
                # typed front-door rejection (subclasses RuntimeError);
                # lazy import: the serving tier imports this module back
                from ..serving.admission import AdmissionRejected
                raise AdmissionRejected(
                    "closed", 0.0, None,
                    "TaskExecutor is closed (drain() has run)")
            w = self._workers.get(task_id)
            if w is None:
                w = self._workers[task_id] = self._new_worker(task_id)
            # enqueue under the lock: a concurrent task_done()/close() could
            # otherwise slip its stop sentinel ahead of this item and leave
            # the returned Future pending forever
            return w.submit(fn, args, kwargs, snap)

    def _worker_lost(self, worker: _TaskWorker):
        """Watchdog callback (runs on the watchdog thread): ``worker``
        ignored its cooperative cancel past ``watchdog.lost_after_s`` —
        the final rung of the escalation ladder. Retire it, re-queue its
        in-flight submission on a fresh worker (degraded: the lost
        worker's surface is presumed wedged, the retry takes the host
        path) against ``task.retry_budget``, and migrate any queued items.
        The lost worker is joined best-effort at close(), and its task is
        marked done only through its replacement."""
        from ..utils import config
        worker.lost = True
        with self._lock:
            if self._workers.get(worker.task_id) is not worker:
                return  # already replaced (duplicate lost-fire guard)
            del self._workers[worker.task_id]
            self._lost.append(worker)
            # release the lost thread's RmmSpark association NOW: a wedged
            # thread never runs its own cleanup, and the native deadlock
            # sweep would count the dead tid as BLOCKED forever
            if RmmSpark.is_installed():
                try:
                    RmmSpark.remove_thread_association_for(
                        worker._thread, worker.task_id)
                except RuntimeError:
                    pass
            item = worker._current
            pending = []
            while True:
                try:
                    pending.append(worker._q.get_nowait())
                except queue.Empty:
                    break
            pending = [it for it in pending if it is not _SENTINEL]
            budget = int(config.get("task.retry_budget"))
            requeue = None
            if item is not None and not item[0].done():
                fut, fn, args, kwargs, snap, requeues, handoff = item
                if requeues + 1 > budget:
                    self._fail(fut, watchdog.StallCancelledError(
                        f"task {worker.task_id} worker declared lost; "
                        f"retry budget ({budget}) exhausted"))
                else:
                    # the old snapshot's budget is spent and its token
                    # cancelled — the retry arms task.budget_s afresh
                    requeue = (fut, fn, args, kwargs, None, requeues + 1,
                               handoff)
            if requeue is None and not pending:
                # no replacement worker will ever exist for this task:
                # retire its scheduler slot here
                self._mark_task_done(worker.task_id)
                return
            if self._closed:
                orphans = pending if requeue is None else [requeue] + pending
                for it in orphans:
                    self._fail(it[0], RuntimeError(
                        "TaskExecutor closed while its worker was lost"))
                self._mark_task_done(worker.task_id)
                return
            w = self._new_worker(worker.task_id)
            w.degraded = True
            self._workers[worker.task_id] = w
            for it in ([] if requeue is None else [requeue]) + pending:
                if it[6] is not None:
                    # the queued inputs are read on the new task stream
                    for t in cuda_tensors([it[2], it[3]]):
                        t.record_stream(w.stream)
                w._q.put(it)

    @staticmethod
    def _fail(fut: Future, exc: BaseException):
        if not fut.done():
            try:
                fut.set_exception(exc)
            except InvalidStateError:
                pass

    def task_done(self, task_id: int, timeout: Optional[float] = 30.0):
        """Drain and retire one task's worker (Spark task completion).

        The adaptor's task is marked done only once the worker has really
        exited — retiring a task whose registered thread is still reserving
        would desynchronize the scheduler's state machine.
        """
        with self._lock:
            w = self._workers.pop(task_id, None)
            if w is None:
                return
            w.stop()
        # an active Deadline bounds the drain too
        timeout = watchdog.derive_timeout(timeout)
        if w.join(timeout):
            self._mark_task_done(task_id)
        else:
            # the worker outlived the timeout with the task still
            # unmarked: remember it so close() can mark the task done
            # once it has really exited
            with self._lock:
                self._zombies[task_id] = w

    def _mark_task_done(self, task_id: int):
        if self._mark_done and RmmSpark.is_installed():
            try:
                RmmSpark.task_done(task_id)
            except RuntimeError:
                pass

    def drain(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """Graceful executor drain:

        1. stop admission (``submit`` raises from here on);
        2. run every in-flight/queued submission to completion under a
           drain Deadline (``drain.timeout_s``) — workers that beat the
           deadline retire their scheduler slots, stragglers are kept as
           zombies so a later drain/close can still retire them;
        3. flush the SpillStore: demote host-resident spilled tables to
           the checksummed disk tier and fsync;
        4. terminate sandbox workers;
        5. report a verdict dict (also kept on ``self.last_drain``).

        Idempotent: a second drain finds no workers and reports
        ``already_closed``. ``close()`` delegates here.
        """
        from ..utils import config
        if timeout is None:
            timeout = float(config.get("drain.timeout_s"))
        t0 = time.monotonic()
        with self._lock:
            already_closed = self._closed
            self._closed = True  # admission stops before the first join
            workers = dict(self._workers)
            self._workers.clear()
            for w in workers.values():
                w.stop()
            zombies = dict(self._zombies)
            self._zombies.clear()
            lost = list(self._lost)
            self._lost.clear()
        completed = 0
        stragglers: List[int] = []
        ctx = (watchdog.Deadline(timeout, "drain")
               if timeout and timeout > 0 else contextlib.nullcontext())
        with ctx:
            for group in (workers, zombies):
                for task_id, w in group.items():
                    if w.join(watchdog.derive_timeout(timeout)):
                        self._mark_task_done(task_id)
                        completed += 1
                    else:
                        stragglers.append(task_id)
                        with self._lock:
                            self._zombies[task_id] = w
            still_lost = 0
            for w in lost:
                # best-effort, short bound — a truly wedged thread never
                # joins, and its task was already retired
                if not w.join(watchdog.derive_timeout(0.1)):
                    still_lost += 1
        spill = None
        if self._spill_store is not None:
            try:
                spill = self._spill_store.flush(fsync=True)
            except OSError as e:
                spill = {"error": f"{type(e).__name__}: {e}"}
        from ..faultinj import sandbox
        sandbox_stopped = sandbox.shutdown_all()
        guard.metrics.bump("drains")
        verdict = {
            "clean": (not stragglers
                      and (spill is None or "error" not in spill)),
            "already_closed": already_closed,
            "tasks_completed": completed,
            "stragglers": stragglers,
            "lost_workers": still_lost,
            "spill": spill,
            "sandbox_workers_stopped": sandbox_stopped,
            "elapsed_s": round(time.monotonic() - t0, 3),
        }
        self.last_drain = verdict
        return verdict

    def close(self, timeout: Optional[float] = 30.0):
        self.drain(timeout=timeout)

    def install_sigterm_drain(self, chain: bool = True):
        """Drain on SIGTERM (the executor-decommission signal): install a
        handler that runs ``drain()`` and then, when ``chain`` and a prior
        python-level handler existed, invokes it. Main-thread only (signal
        module contract); returns the previous handler."""
        prev = signal.getsignal(signal.SIGTERM)

        def _handler(signum, frame):
            self.drain()
            if chain and callable(prev) and prev not in (
                    signal.SIG_IGN, signal.SIG_DFL):
                prev(signum, frame)

        signal.signal(signal.SIGTERM, _handler)
        return prev

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
