"""The one traffic generator: requests from a mix's parameters and a seed.

A mix is the ``traffic`` object of a workload file:

``prompt_len`` [lo, hi]: prompt lengths, uniform over the range;
``new_tokens`` [lo, hi]: each request's budget of new tokens, likewise;
``block``: requests come in blocks of this many, each block holding the same
(prompt length, budget) pairs in an order drawn from the seed, so every
seed offers the same work in another order: the stratified lengths ``lo +
(hi - lo) * (i + 0.5) / block``, the ``i``-th shortest prompt paired with
the ``(i * stride) % block``-th smallest budget, ``stride`` the integer
nearest ``0.38 * block`` that is prime to it (no length predicts its
budget);
``greedy_every``: one request in this many of a block (by rank of its
prompt length, so they spread over the lengths) decodes greedily, the rest
sample with the workload's settings; 1 makes all greedy, 0 none;
``token_ids`` [lo, hi): prompt ids are uniform over the range.

Requests are numbered from 0; each carries a 31-bit seed of its own for the
program's random stream.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    prompt: np.ndarray  # int32 [P]
    max_new: int
    greedy: bool
    seed: int


def _stratified(lo: int, hi: int, n: int) -> np.ndarray:
    return np.rint(lo + (hi - lo) * (np.arange(n) + 0.5) / n).astype(np.int64)


def requests(traffic: dict, seed: int) -> Iterator[Request]:
    """The endless request sequence of a mix for ``seed``."""
    rng = np.random.default_rng(int(seed))
    n = int(traffic["block"])
    lens = _stratified(*traffic["prompt_len"], n)
    news = _stratified(*traffic["new_tokens"], n)[(np.arange(n) * _stride(n)) % n]
    every = int(traffic.get("greedy_every", 0))
    greedy = np.array([every > 0 and i % every == 0 for i in range(n)])
    lo_id, hi_id = traffic["token_ids"]
    index = 0
    while True:
        for i in rng.permutation(n):
            yield Request(index, rng.integers(lo_id, hi_id, size=int(lens[i])).astype(np.int32),
                          int(news[i]), bool(greedy[i]), int(rng.integers(0, 2**31 - 1)))
            index += 1


def _stride(n: int) -> int:
    return min((s for s in range(1, n + 1) if math.gcd(s, n) == 1),
               key=lambda s: abs(s - 0.38 * n))


def bucket_of(p_len: int, multiple: int = 64) -> int:
    """The prompt bucket of a length: padded up to ``multiple``."""
    return max(multiple, -(-int(p_len) // multiple) * multiple)


def first_block(traffic: dict, seed: int) -> list:
    """The first block of the mix: every prompt length, budget and mode it
    uses, once."""
    gen = requests(traffic, seed)
    return [next(gen) for _ in range(int(traffic["block"]))]
