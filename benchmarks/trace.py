"""The device trace of a run's traced window, and the host spans beside it.

``torch.profiler`` records the device's activity (kernels, copies, fills)
through CUPTI; the events are read raw, without the profiler's event tree.
Kineto stamps them on the host's Unix clock, as :class:`Spans` stamps the
benchmark's own spans around its calls into the program, so an idle gap on
the device can be laid beside what the host was doing.

Kernel families (B1, B2, B3, ...) are named by the files
``benchmarks/kernels/<family>*.json``: each holds ``match`` and ``exclude``
lists of regular expressions, and a kernel belongs to a family when some
file of it matches the kernel's name and excludes nothing of it.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import re
import time
from collections import defaultdict
from pathlib import Path
from typing import Optional

KERNELS_DIR = Path(__file__).resolve().parent / "kernels"
TOP = 10
NAME_CHARS = 120


def load_families(directory: Path = KERNELS_DIR) -> dict:
    """{family: [(match regexes, exclude regexes), ...]} from the pattern
    files; a file's family is its ``family`` key."""
    fams = defaultdict(list)
    for f in sorted(directory.glob("*.json")):
        spec = json.loads(f.read_text())
        fams[spec["family"]].append(([re.compile(p) for p in spec["match"]],
                                     [re.compile(p) for p in spec.get("exclude", [])]))
    return dict(fams)


def in_family(name: str, rules: list) -> bool:
    return any(any(m.search(name) for m in match) and not any(x.search(name) for x in exclude)
               for match, exclude in rules)


def union_ns(intervals) -> int:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


class Spans:
    """The benchmark's own spans around its calls into the program, on the
    host's Unix clock (kineto's). Spans do not nest."""

    def __init__(self):
        self.spans = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((t0, time.time_ns(), name))

    def labeller(self):
        """A function from a host time to the span that covers it."""
        spans = sorted(self.spans)
        starts = [s for s, _, _ in spans]

        def at(t_ns: int) -> str:
            i = bisect.bisect_right(starts, t_ns) - 1
            if i >= 0 and spans[i][1] >= t_ns:
                return spans[i][2]
            return "between the benchmark's calls"
        return at


class Trace:
    """Device events of one traced window ``[t0_ns, t1_ns]`` (host clock)."""

    def __init__(self, events, t0_ns: int, t1_ns: int, spans: Spans, families: dict):
        self.events = [(s, e, n) for s, e, n in events if e > t0_ns and s < t1_ns]
        self.t0, self.t1 = t0_ns, t1_ns
        self.spans = spans
        self.families = families
        self._member = {}  # (family, kernel name) -> bool

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def _clip(self, s, e):
        return max(s, self.t0), min(e, self.t1)

    def busy_s(self) -> float:
        return union_ns(self._clip(s, e) for s, e, _ in self.events) / 1e9

    def family_s(self, family: str) -> Optional[float]:
        """Seconds in which some kernel of ``family`` ran; None if none ran."""
        rules = self.families.get(family)
        if not rules:
            return None
        def member(n):
            key = (family, n)
            if key not in self._member:
                self._member[key] = in_family(n, rules)
            return self._member[key]

        iv = [self._clip(s, e) for s, e, n in self.events if member(n)]
        return union_ns(iv) / 1e9 if iv else None

    def device_ops(self) -> list:
        by = defaultdict(int)
        for s, e, n in self.events:
            by[n[:NAME_CHARS]] += e - s
        return [[n, t / 1e9] for n, t in sorted(by.items(), key=lambda x: -x[1])[:TOP]]

    def idle_gaps(self) -> list:
        """Idle seconds of the window by the host span each gap fell in (at
        its middle), the largest first."""
        at = self.spans.labeller()
        by, end = defaultdict(int), self.t0
        for s, e, _ in sorted(self.events):
            s, e = self._clip(s, e)
            if s > end:
                by[at((s + end) // 2)] += s - end
            end = max(end, e)
        if self.t1 > end:
            by[at((self.t1 + end) // 2)] += self.t1 - end
        return [[n, t / 1e9] for n, t in sorted(by.items(), key=lambda x: -x[1])[:TOP]]


class Tracer:
    """Traces the device between :meth:`start` and :meth:`stop` (a no-op
    when disabled)."""

    def __init__(self, enabled: bool, spans: Spans):
        self.enabled = enabled
        self.spans = spans
        self._prof = None
        self._done = None

    def warm(self) -> None:
        """Start and stop the profiler once, so the window's first trace does
        not pay CUPTI's start."""
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]):
                torch.zeros(1, device="cuda").add_(1)
                torch.cuda.synchronize()

    def start(self) -> None:
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.time_ns()

    def stop(self) -> None:
        if self._prof is None:
            return
        import torch

        torch.cuda.synchronize()
        self._t1 = time.time_ns()
        self._prof.__exit__(None, None, None)
        self._done, self._prof = self._prof, None

    def read(self) -> Optional[Trace]:
        """The traced window's device events, read once the run is over."""
        if self._done is None:
            return None
        from torch.autograd import DeviceType

        cuda = DeviceType.CUDA
        events = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in self._done.profiler.kineto_results.events()
                  if e.device_type() == cuda]
        self._done = None
        return Trace(events, self._t0, self._t1, self.spans, load_families())
