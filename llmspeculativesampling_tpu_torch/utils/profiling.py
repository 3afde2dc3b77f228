"""Tracing and timing helpers
(counterpart of ``llmspeculativesampling_tpu/utils/profiling.py``).

* :func:`trace`: a context manager around ``torch.profiler`` (CPU
  activities, and CUDA's when a card is present) that writes a Chrome
  trace into ``log_dir``; open it in Perfetto or ``chrome://tracing``.
* :func:`benchmark`: repeat a generate call and report wall-clock stats,
  optionally tracing the first timed repeat.
* :class:`PhaseTimer`: host-side accounting of named phases.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body with ``torch.profiler`` and write one Chrome trace,
    ``trace_<pid>_<ns>.json``, into ``log_dir`` (created if missing)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def benchmark(
    fn: Callable[[], object],
    *,
    repeats: int = 10,
    warmup: int = 1,
    tokens_per_call: Optional[int] = None,
    trace_dir: Optional[str] = None,
) -> Dict:
    """Repeat ``fn`` and report wall-clock stats: ``repeats``, ``mean_s``,
    ``best_s``, ``worst_s`` and, given ``tokens_per_call``,
    ``tokens_per_s`` and ``best_tokens_per_s``.

    ``fn`` must synchronize internally (the engines do: they copy the
    generated tokens to the host). If ``trace_dir`` is given, the first
    timed repeat runs under :func:`trace`."""
    for _ in range(warmup):
        fn()
    times = []
    for i in range(repeats):
        ctx = trace(trace_dir) if i == 0 and trace_dir else contextlib.nullcontext()
        with ctx:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    mean = sum(times) / len(times)
    out = {
        "repeats": repeats,
        "mean_s": mean,
        "best_s": min(times),
        "worst_s": max(times),
    }
    if tokens_per_call:
        out["tokens_per_s"] = tokens_per_call / mean
        out["best_tokens_per_s"] = tokens_per_call / min(times)
    return out


class PhaseTimer:
    """Accumulate named phase wall times."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals)
