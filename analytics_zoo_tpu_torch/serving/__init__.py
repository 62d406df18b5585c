"""Serving (port of ``analytics_zoo_tpu/serving``): the stream broker, the
binary wire and its same-host shm ring, the queue clients, ``ClusterServing``
(source → batched inference → sink), the HTTP frontend, hot swap from
published checkpoints, generation — ``ContinuousBatcher`` in process or
``GenerationEngine``/``GenerationClient`` over the broker — and the control
plane: the replica fleet (``ReplicaRouter``, ``FleetSupervisor``, the
autoscaler), canary rollout (``RolloutController``), the host agents, the
hot-row cache (``HostRowCache``), the one-command ``stack`` and the ``cli``.
"""

from .broker import QueueBroker, start_broker
from .client import InputQueue, OutputQueue
from .config import ServingConfig
from .engine import ClusterServing
from .fleet import FleetSupervisor, ReplicaRouter
from .generation import (ContinuousBatcher, GenerationClient,
                         GenerationEngine, StreamHandle)
from .hotswap import (ModelPublisher, ModelSwapper, RolloutController,
                      SwapRejected)
from .http_frontend import FrontEndApp
from .qos import PRIORITIES, ShedError
from .rowcache import HostRowCache

__all__ = ["ClusterServing", "ContinuousBatcher", "FleetSupervisor",
           "FrontEndApp", "GenerationClient", "GenerationEngine",
           "HostRowCache", "InputQueue", "ModelPublisher", "ModelSwapper",
           "OutputQueue", "PRIORITIES", "QueueBroker", "ReplicaRouter",
           "RolloutController", "ServingConfig", "ShedError", "StreamHandle",
           "SwapRejected", "start_broker"]
