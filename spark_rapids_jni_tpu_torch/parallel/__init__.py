"""Parallel execution (the JAX package's parallel/): the shuffle's
partition route (``exchange.partition_ids``) and the task executor, one
CUDA stream per task (``task_executor.TaskExecutor``). The all-to-all
exchange and the sharded lane are ROADMAP A15b."""

from .task_executor import TaskExecutor

__all__ = ["TaskExecutor"]
