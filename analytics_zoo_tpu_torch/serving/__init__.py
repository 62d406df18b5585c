"""Serving (port of ``analytics_zoo_tpu/serving``): the stream broker, the
binary wire and its same-host shm ring, the queue clients, ``ClusterServing``
(source → batched inference → sink), the HTTP frontend, hot swap from
published checkpoints, and generation — ``ContinuousBatcher`` in process or
``GenerationEngine``/``GenerationClient`` over the broker.

Not ported yet (ROADMAP Queue 1, item 8's next slice): the replica fleet
(``FleetSupervisor``, ``ReplicaRouter``, ``RolloutController``), the host
agents, the hot-row cache, the serving stack and its CLI.
"""

from .broker import QueueBroker, start_broker
from .client import InputQueue, OutputQueue
from .config import ServingConfig
from .engine import ClusterServing
from .generation import (ContinuousBatcher, GenerationClient,
                         GenerationEngine, StreamHandle)
from .hotswap import ModelPublisher, ModelSwapper, SwapRejected
from .http_frontend import FrontEndApp
from .qos import PRIORITIES, ShedError

__all__ = ["ClusterServing", "ContinuousBatcher", "FrontEndApp",
           "GenerationClient", "GenerationEngine", "InputQueue",
           "ModelPublisher", "ModelSwapper", "OutputQueue", "PRIORITIES",
           "QueueBroker", "ServingConfig", "ShedError", "StreamHandle",
           "SwapRejected", "start_broker"]
