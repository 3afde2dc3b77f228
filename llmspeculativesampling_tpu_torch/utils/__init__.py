"""Utility sidecars: tokenizer singleton, power sampling, tracing
(counterpart of ``llmspeculativesampling_tpu/utils``)."""

from .decoder import Decoder, Singleton
from .power import PowerMonitor

__all__ = ["Decoder", "Singleton", "PowerMonitor"]
