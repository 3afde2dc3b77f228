"""Serving (counterpart of ``llmspeculativesampling_tpu/serve``): the HTTP
front ends, the slotted continuous-batching engine, the paged engine
(``serve/paged.py``) and the lockstep drivers across ranks
(``serve/multihost.py``)."""

from .multihost import MultiHostDriver, PagedMultiHostDriver, WorkerLostError
from .scheduler import Completion, ContinuousBatchingEngine, Request
from .server import (
    BatchedInferenceServer,
    InferenceServer,
    ServerConfig,
    make_http_server,
)

__all__ = [
    "BatchedInferenceServer",
    "Completion",
    "ContinuousBatchingEngine",
    "InferenceServer",
    "MultiHostDriver",
    "PagedMultiHostDriver",
    "Request",
    "ServerConfig",
    "WorkerLostError",
    "make_http_server",
]
