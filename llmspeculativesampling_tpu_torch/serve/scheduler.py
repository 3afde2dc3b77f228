"""Request and completion records of the serving engines (counterpart of
``Request`` and ``Completion`` in ``llmspeculativesampling_tpu/serve/scheduler.py``).

The slotted ``ContinuousBatchingEngine`` is not ported yet (ROADMAP A13);
neither are the preemption-resume fields of ``Request`` (``resume_key``,
``carry``, ``orig_prompt_len``) and ``cached_len``, which serve on-demand
paging and the prefix cache.
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


@dataclasses.dataclass
class Completion:
    rid: int
    output_ids: np.ndarray   # prompt + generation, EOS-truncated
    prompt_len: int
    details: dict
