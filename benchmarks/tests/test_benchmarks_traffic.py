"""The traffic generator: the same requests for the same seed, the same work
in another order for another."""

import itertools
import json
from pathlib import Path

import numpy as np

from benchmarks import traffic

MIX = json.loads((Path(__file__).resolve().parents[1] / "workloads" /
                  "opt30b.batch_prefill.json").read_text())["traffic"]


def take(mix, seed, n):
    return list(itertools.islice(traffic.requests(mix, seed), n))


def test_same_seed_same_requests():
    big = 2**31 + 12345
    a, b = take(MIX, big, 60), take(MIX, big, 60)
    assert all(np.array_equal(x.prompt, y.prompt) and x.max_new == y.max_new
               and x.greedy == y.greedy and x.seed == y.seed for x, y in zip(a, b))
    c = take(MIX, big + 1, 60)
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))


def test_every_block_holds_the_same_sizes():
    n = MIX["block"]
    for seed in (0, 7, 2**33 + 1):
        reqs = take(MIX, seed, 3 * n)
        for k in range(3):
            block = reqs[k * n:(k + 1) * n]
            assert sorted(len(r.prompt) for r in block) == sorted(
                len(r.prompt) for r in reqs[:n])
            assert sorted(r.max_new for r in block) == sorted(r.max_new for r in reqs[:n])
    lens = [len(r.prompt) for r in take(MIX, 3, n)]
    assert min(lens) >= MIX["prompt_len"][0] and max(lens) <= MIX["prompt_len"][1]
    assert all(MIX["token_ids"][0] <= int(r.prompt.min()) and int(r.prompt.max()) <
               MIX["token_ids"][1] for r in take(MIX, 3, n))


def test_greedy_share_and_buckets():
    mix = dict(MIX, greedy_every=4, block=16)
    reqs = take(mix, 5, 32)
    assert sum(r.greedy for r in reqs) == 8
    assert traffic.bucket_of(1) == 64 and traffic.bucket_of(64) == 64
    assert traffic.bucket_of(65) == 128 and traffic.bucket_of(1536) == 1536

