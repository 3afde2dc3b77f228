"""Power and energy sampling
(counterpart of ``llmspeculativesampling_tpu/utils/power.py``).

:class:`PowerMonitor` samples watts in a background thread, from the first
source that answers:

* ``nvidia-smi --query-gpu=power.draw``: the cards' board power, summed
  over the cards it lists (the reference's own 1 Hz source);
* ``/sys/class/powercap`` RAPL counters (host CPU packages);
* otherwise nothing: no samples, energy 0, so callers' code paths stay the
  same on a machine without either.
"""

from __future__ import annotations

import glob
import shutil
import subprocess
import threading
import time
from typing import List, Optional, Tuple

NVIDIA_SMI_QUERY = ("--query-gpu=power.draw", "--format=csv,noheader,nounits")


class PowerMonitor:
    """Background sampler: collect (timestamp, watts) every ``interval`` s.
    ``source`` names what is sampled: "nvidia-smi", "rapl" or None."""

    def __init__(self, interval: float = 1.0):
        self.interval = interval
        self.samples: List[Tuple[float, float]] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._smi = shutil.which("nvidia-smi")
        self._rapl = sorted(glob.glob("/sys/class/powercap/intel-rapl:*/energy_uj"))
        self._last_energy = None
        self.source = "nvidia-smi" if self._smi else ("rapl" if self._rapl else None)

    def _read_smi(self) -> Optional[float]:
        try:
            out = subprocess.run([self._smi, *NVIDIA_SMI_QUERY], capture_output=True, text=True,
                                 timeout=10)
            watts = [float(x) for x in out.stdout.split()] if out.returncode == 0 else []
        except (OSError, ValueError, subprocess.SubprocessError):
            watts = []
        return sum(watts) if watts else None

    def _read_rapl(self) -> Optional[float]:
        try:
            total = 0
            for p in self._rapl:
                with open(p) as fh:
                    total += int(fh.read())
        except OSError:
            return None
        now = time.time()
        if self._last_energy is None:
            self._last_energy = (total, now)
            return None
        de = total - self._last_energy[0]
        dt = now - self._last_energy[1]
        self._last_energy = (total, now)
        if dt <= 0 or de < 0:  # counter wrap
            return None
        return de / 1e6 / dt

    def _read_watts(self) -> Optional[float]:
        if self.source == "nvidia-smi":
            w = self._read_smi()
            if w is not None:
                return w
            # the tool is present but reads no card: fall back
            self.source = "rapl" if self._rapl else None
        if self.source == "rapl":
            return self._read_rapl()
        return None

    def _run(self):
        while not self._stop.is_set():
            w = self._read_watts()
            if w is not None:
                self.samples.append((time.time(), w))
            self._stop.wait(self.interval)

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=12)

    def total_energy(self, t1: float, t2: float) -> float:
        """Joules over (t1, t2): the samples strictly inside the window,
        the first skipped, each standing for ``interval`` seconds."""
        inside = [w for ts, w in self.samples if t1 < ts < t2]
        return float(sum(inside[1:])) * self.interval if len(inside) > 1 else 0.0
