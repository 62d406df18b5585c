"""Orca — the unified high-level Estimator over sharded data, the task
pool and the RL trainer (port of ``analytics_zoo_tpu/orca/``)."""

from ..data.xshards import XShards
from .learn.estimator import Estimator
from .rl import CatchEnv, PPOTrainer
from .task_pool import ActorHandle, Future, TaskPool, pool_rank, pool_world

__all__ = ["ActorHandle", "CatchEnv", "Estimator", "Future", "PPOTrainer",
           "TaskPool", "XShards", "pool_rank", "pool_world"]
