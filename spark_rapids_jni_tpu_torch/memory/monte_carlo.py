"""Monte-Carlo memory-pressure stress: library + reference-shaped CLI (the
JAX package's memory/monte_carlo.py, pure Python over RmmSpark).

Re-build of the reference's RmmSparkMonteCarlo.java fuzz harness (979 LoC;
CI runs it as ``--taskMaxMiB=2048 --gpuMiB=3072 --skewed --allocMode=ASYNC``,
ci/fuzz-test.sh:10-12). Simulated Spark tasks execute skewed random
reserve/free walks under the retry-OOM protocol against a pool smaller than
their combined demand; optional shuffle threads (the reference's UCX
simulation, --shuffleThreads) add pool-thread traffic. Success = zero fatal
OOMs, zero task errors, pool fully drained.

CLI (flag names follow the reference so the CI invocation reads the same):

    python -m spark_rapids_jni_tpu_torch.memory.monte_carlo \\
        --gpuMiB=3072 --taskMaxMiB=2048 --skewed --numSeconds=60

``allocMode`` is accepted for invocation parity and recorded in the report;
the adaptation has one reservation-ledger mode (SURVEY.md §7 hard-part 4),
so it does not change behavior.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .exceptions import TaskRemovedException, TpuOOM
from .retry import with_retry
from .rmm_spark import RmmSpark

MB = 1024 * 1024


@dataclass
class MonteCarloConfig:
    """Knobs mirror RmmSparkMonteCarlo.java:38-44 (names in comments)."""

    pool_mib: int = 64             # --gpuMiB
    task_max_mib: int = 48         # --taskMaxMiB
    num_tasks: int = 8             # --parallelism
    ops_per_task: int = 60         # --maxTaskAllocs-shaped workload length
    shuffle_threads: int = 0       # --shuffleThreads
    skewed: bool = False           # --skewed
    skew_amount: int = 4           # --skewAmount
    max_task_sleep_ms: int = 1     # --maxTaskSleep
    num_seconds: Optional[float] = None  # --numSeconds (loop until elapsed)
    seed: int = 0                  # --seed
    alloc_mode: str = "RESERVE"    # --allocMode (recorded, one mode)
    watchdog_period_s: float = 0.05


@dataclass
class MonteCarloStats:
    errors: List[Tuple[int, BaseException]] = field(default_factory=list)
    fatal_ooms: int = 0
    retries: int = 0
    split_retries: int = 0
    block_time_ns: int = 0
    max_reserved: int = 0
    tasks_run: int = 0
    pool_leak: int = 0
    elapsed_s: float = 0.0

    @property
    def ok(self) -> bool:
        return (not self.errors and self.fatal_ooms == 0
                and self.pool_leak == 0)

    def to_json(self) -> str:
        return json.dumps({
            "ok": self.ok,
            "tasks_run": self.tasks_run,
            "retries": self.retries,
            "split_retries": self.split_retries,
            "block_time_ms": self.block_time_ns // 1_000_000,
            "max_reserved": self.max_reserved,
            "fatal_ooms": self.fatal_ooms,
            "errors": [f"task {t}: {type(e).__name__}: {e}"
                       for t, e in self.errors],
            "pool_leak": self.pool_leak,
            "elapsed_s": round(self.elapsed_s, 3),
        })


class _TaskSim:
    """One simulated Spark task: a skewed random walk of reserve/free ops,
    each reservation wrapped in the retry protocol. The skewed-task
    multiplier mirrors the reference's makeSkewed (:942)."""

    def __init__(self, cfg: MonteCarloConfig, task_id: int, seed: int,
                 skew_mult: int, errors, barrier):
        self.cfg = cfg
        self.task_id = task_id
        self.rng = random.Random(seed)
        self.skew_mult = skew_mult
        self.errors = errors
        self.barrier = barrier
        self.held: List[int] = []

    def rollback(self):
        while self.held:
            RmmSpark.dealloc(self.held.pop())

    def attempt(self, nbytes):
        RmmSpark.alloc(nbytes)
        self.held.append(nbytes)
        return nbytes

    @staticmethod
    def split(nbytes):
        if nbytes < 2:
            return [nbytes]
        return [nbytes // 2, nbytes - nbytes // 2]

    def next_size(self) -> int:
        task_max = self.cfg.task_max_mib * MB
        if self.rng.random() < 0.15:
            size = self.rng.randint(task_max // 2, task_max)
        else:
            size = self.rng.randint(1, 4) * MB
        return min(task_max, size * self.skew_mult)

    def run(self):
        try:
            RmmSpark.current_thread_is_dedicated_to_task(self.task_id)
            self.barrier.wait(timeout=30.0)
            task_max = self.cfg.task_max_mib * MB
            for _ in range(self.cfg.ops_per_task):
                # simulated compute while holding reservations: without this
                # the GIL serializes the run and no contention happens
                if self.held and self.rng.random() < 0.3:
                    time.sleep(self.cfg.max_task_sleep_ms / 1000.0
                               * self.rng.random())
                r = self.rng.random()
                if r < 0.55 or not self.held:
                    size = self.next_size()
                    # cap what one task holds so progress is always possible
                    while sum(self.held) + size > task_max:
                        if not self.held:
                            size = task_max
                            break
                        RmmSpark.dealloc(self.held.pop())
                    with_retry(self.attempt, size, split=self.split,
                               rollback=self.rollback)
                else:
                    RmmSpark.dealloc(self.held.pop())
            self.rollback()
        except TaskRemovedException:
            pass  # benign shutdown race
        except BaseException as e:  # noqa: BLE001 - surfaced in stats
            self.errors.append((self.task_id, e))
        finally:
            try:
                self.rollback()
                RmmSpark.task_done(self.task_id)
            except BaseException as e:  # noqa: BLE001
                self.errors.append((self.task_id, e))


class _ShuffleSim:
    """UCX-shuffle simulation (reference --shuffleThreads): a pool thread
    attached to every live task making small short-lived reservations."""

    def __init__(self, cfg: MonteCarloConfig, seed: int, task_ids, errors,
                 stop: threading.Event):
        self.cfg = cfg
        self.rng = random.Random(seed)
        self.task_ids = task_ids
        self.errors = errors
        self.stop = stop

    def run(self):
        try:
            RmmSpark.shuffle_thread_working_on_tasks(self.task_ids)
            while not self.stop.is_set():
                size = self.rng.randint(64 * 1024, MB)
                try:
                    RmmSpark.alloc(size)
                except TpuOOM:
                    try:
                        RmmSpark.block_thread_until_ready()
                    except TpuOOM:
                        pass
                    continue
                time.sleep(0.0005)
                RmmSpark.dealloc(size)
        except TaskRemovedException:
            pass
        except BaseException as e:  # noqa: BLE001
            self.errors.append((-1, e))
        finally:
            try:
                RmmSpark.pool_thread_finished_for_tasks(self.task_ids)
                RmmSpark.remove_current_thread_association()
            except BaseException:  # noqa: BLE001 - shutdown race
                pass


def run_monte_carlo(cfg: MonteCarloConfig) -> MonteCarloStats:
    """Run one full situation (or repeat until --numSeconds elapses)."""
    stats = MonteCarloStats()
    t0 = time.monotonic()
    RmmSpark.set_event_handler(pool_bytes=cfg.pool_mib * MB,
                               watchdog_period_s=cfg.watchdog_period_s)
    try:
        round_no = 0
        while True:
            round_no += 1
            _run_round(cfg, stats, round_no)
            stats.elapsed_s = time.monotonic() - t0
            if stats.errors:
                break
            if cfg.num_seconds is None or stats.elapsed_s >= cfg.num_seconds:
                break
        stats.pool_leak = RmmSpark.pool_used()
    finally:
        RmmSpark.clear_event_handler()
    return stats


def _run_round(cfg: MonteCarloConfig, stats: MonteCarloStats, round_no: int):
    errors: List[Tuple[int, BaseException]] = []
    barrier = threading.Barrier(cfg.num_tasks)
    base = cfg.seed * 1_000_000 + round_no * 1000
    skew_index = random.Random(base).randrange(cfg.num_tasks) \
        if cfg.skewed else -1
    task_ids = [round_no * 10_000 + i + 1 for i in range(cfg.num_tasks)]
    sims = [_TaskSim(cfg, task_ids[i], base + i,
                     cfg.skew_amount if i == skew_index else 1,
                     errors, barrier)
            for i in range(cfg.num_tasks)]
    stop = threading.Event()
    shufflers = [_ShuffleSim(cfg, base + 900 + s, task_ids, errors, stop)
                 for s in range(cfg.shuffle_threads)]

    threads = [threading.Thread(target=s.run, name=f"mc-task-{s.task_id}")
               for s in sims]
    threads += [threading.Thread(target=s.run, name=f"mc-shuffle-{i}")
                for i, s in enumerate(shufflers)]
    for t in threads:
        t.start()
    for t in threads[:cfg.num_tasks]:
        t.join(timeout=300.0)
    stop.set()
    for t in threads[cfg.num_tasks:]:
        t.join(timeout=30.0)
    hung = any(t.is_alive() for t in threads)
    if hung:
        errors.append((-2, RuntimeError("stress round hung")))

    stats.errors.extend(errors)
    # exact-type check: retry/split OOM subclasses are protocol, not fatal
    stats.fatal_ooms += sum(1 for _, e in errors if type(e) is TpuOOM)
    stats.tasks_run += cfg.num_tasks
    for tid in task_ids:
        stats.retries += RmmSpark.get_and_reset_num_retry(tid)
        stats.split_retries += RmmSpark.get_and_reset_num_split_retry(tid)
        stats.block_time_ns += RmmSpark.get_and_reset_block_time_ns(tid)
        stats.max_reserved = max(
            stats.max_reserved,
            RmmSpark.get_and_reset_max_device_reserved(tid))


def _parse_args(argv) -> MonteCarloConfig:
    ap = argparse.ArgumentParser(
        description="RmmSpark Monte-Carlo stress (reference flag names)")
    ap.add_argument("--gpuMiB", type=int, default=64)
    ap.add_argument("--taskMaxMiB", type=int, default=48)
    ap.add_argument("--parallelism", type=int, default=8)
    ap.add_argument("--maxTaskAllocs", type=int, default=60)
    ap.add_argument("--maxTaskSleep", type=int, default=1, metavar="MS")
    ap.add_argument("--shuffleThreads", type=int, default=0)
    ap.add_argument("--skewed", action="store_true")
    ap.add_argument("--skewAmount", type=int, default=4)
    ap.add_argument("--numSeconds", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--allocMode", default="RESERVE",
                    help="accepted for reference-invocation parity")
    a = ap.parse_args(argv)
    return MonteCarloConfig(
        pool_mib=a.gpuMiB, task_max_mib=a.taskMaxMiB,
        num_tasks=a.parallelism, ops_per_task=a.maxTaskAllocs,
        shuffle_threads=a.shuffleThreads, skewed=a.skewed,
        skew_amount=a.skewAmount, max_task_sleep_ms=a.maxTaskSleep,
        num_seconds=a.numSeconds, seed=a.seed, alloc_mode=a.allocMode)


def main(argv=None) -> int:
    cfg = _parse_args(argv if argv is not None else sys.argv[1:])
    stats = run_monte_carlo(cfg)
    print(stats.to_json())
    return 0 if stats.ok else 1


if __name__ == "__main__":
    sys.exit(main())
