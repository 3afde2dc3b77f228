"""Request and completion records of the serving engines (counterpart of
``Request`` and ``Completion`` in ``llmspeculativesampling_tpu/serve/scheduler.py``).

The slotted ``ContinuousBatchingEngine`` is not ported yet (ROADMAP A13).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray       # [P] int32
    max_new_tokens: int
    submit_time: float
    prefill_time: Optional[float] = None
    cached_len: int = 0      # prompt positions served from the prefix cache
    # preemption resume (the paged engine's on-demand paging): a preempted
    # request requeues with its committed tokens as the prompt, the row's
    # evolved stream key (so the continuation replays the preempted run)
    # and its detail counters so far
    resume_key: Optional[np.ndarray] = None   # [2] stream key
    carry: Optional[dict] = None              # accumulated details
    orig_prompt_len: Optional[int] = None     # the user's prompt length


@dataclasses.dataclass
class Completion:
    rid: int
    output_ids: np.ndarray   # prompt + generation, EOS-truncated
    prompt_len: int
    details: dict
