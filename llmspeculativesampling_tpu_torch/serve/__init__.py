"""Serving (counterpart of ``llmspeculativesampling_tpu/serve``): the HTTP
front ends, the slotted continuous-batching engine and the paged engine
(``serve/paged.py``)."""

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
    "Request",
    "ServerConfig",
    "make_http_server",
]
