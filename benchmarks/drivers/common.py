"""What both drivers share: the tallies the metric readers read, and what a
driver hands back.

The drivers and a family's ``bundles`` (``benchmarks/families/``) are the
only places that import the program (``llmspeculativesampling_tpu_torch``).
"""

from __future__ import annotations

import dataclasses
import sys
from collections import Counter
from typing import Optional

import numpy as np
import torch

ROLES = ("draft", "target")


def log(*parts) -> None:
    """A progress line on standard error (set-up's phases and their seconds)."""
    print(*parts, file=sys.stderr, flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


@dataclasses.dataclass
class AttentionTally:
    """Sums over short-block attention rows of one model (one row of one
    forward: ``prefix`` cached positions, ``s_new`` new tokens), linear in
    what the roofline's bytes and FLOPs need: rows, sum of prefixes, of new
    tokens, of new tokens times prefix, and of s(s+1)/2; and the rows
    themselves, ``shapes[(prefix, s_new)]`` of each, for a count that is not
    linear in the prefix (a window's ``min(prefix, window)``)."""

    rows: int = 0
    prefix: int = 0
    new: int = 0
    new_x_prefix: int = 0
    causal: int = 0
    shapes: Counter = dataclasses.field(default_factory=Counter)

    def add(self, prefix: int, s_new: int) -> None:
        self.shapes[(prefix, s_new)] += 1
        self.rows += 1
        self.prefix += prefix
        self.new += s_new
        self.new_x_prefix += s_new * prefix
        self.causal += s_new * (s_new + 1) // 2


def spec_step_rows(c: int, gamma: int):
    """The (prefix, new tokens) of each forward of one speculative step whose
    committed length is ``c`` at its start: the draft re-feeds positions
    c-2, c-1, then drafts gamma-1 single tokens; the target verifies gamma+1
    tokens from c-1. Returns (draft rows, target row)."""
    draft = [(c - 2, 2)] + [(c - 1 + j, 1) for j in range(1, gamma)]
    return draft, (c - 1, gamma + 1)


def step_starts(p_len: int, acc_len) -> np.ndarray:
    """Committed length at the start of each step: ``p_len``, then each
    step commits its accepted drafts plus one token."""
    a = np.asarray(acc_len, dtype=np.int64)
    return p_len + np.concatenate([[0], np.cumsum(a + 1)[:-1]]) if a.size else a


def tally_steps(tally: dict, starts, gamma: int) -> None:
    """Add each step's attention rows (one live row a step) to the tallies."""
    for c in starts:
        draft, target = spec_step_rows(int(c), gamma)
        for prefix, s in draft:
            tally["draft"].add(prefix, s)
        tally["target"].add(*target)


@dataclasses.dataclass
class Answer:
    """A finished request: its prompt, the tokens it was served, and, for a
    sampled request, its sampling settings (``temperature``, ``top_k``,
    ``top_p``); None for a greedy one."""

    prompt: np.ndarray
    served: np.ndarray
    sampling: Optional[dict] = None


@dataclasses.dataclass
class Outcome:
    """What a driver hands back once its window has closed and the program's
    state is freed: the end-to-end values it measured (``setup_s`` aside),
    the counts its metric readers read (over the traced window in a traced
    run), the finished answers the check may sample, and the benchmark's own
    weights, which the reference reads."""

    window_start: float
    end_to_end: dict
    counts: dict
    answers: list
    attempted: int
    failed: int
    memory_peak_bytes: int
    pair: dict
    error: Optional[str] = None


def w8a16_counts() -> dict:
    return {role: {"exact": Counter(), "pooled": []} for role in ROLES}
