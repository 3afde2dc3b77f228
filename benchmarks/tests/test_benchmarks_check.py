"""The check's number on hand-worked logits: the least raise that puts a
served token inside the reference's support, greedy and sampled; the
support agrees with the program's own top-k/top-p filter; the control's
draws stay inside its support; the judge holds each gap to its limit."""

import math

import numpy as np
import pytest
import torch

from benchmarks import check
from benchmarks.drivers.common import Answer


def _raise(logits, token, **sampling):
    lg = torch.tensor([logits], dtype=torch.float32)
    return float(check.least_raise(lg, torch.tensor([token]), sampling or None)[0])


def test_greedy_is_the_gap_to_the_best():
    assert _raise([3.0, 2.0, 0.5], 2) == pytest.approx(2.5)
    assert _raise([3.0, 2.0, 0.5], 0) == 0.0


def test_top_k_without_nucleus():
    assert _raise([3.0, 2.0, 1.0, 0.0], 2, temperature=1.0, top_k=2, top_p=0.0) \
        == pytest.approx(1.0, abs=1e-5)
    assert _raise([3.0, 2.0, 1.0, 0.0], 1, temperature=1.0, top_k=2, top_p=0.0) == 0.0


def test_nucleus_edge():
    lg = [math.log(0.5), math.log(0.3), math.log(0.2)]
    s = dict(temperature=1.0, top_k=3, top_p=0.6)
    assert _raise(lg, 0, **s) == 0.0 and _raise(lg, 1, **s) == 0.0
    # 0.8 of the mass lies before token 2; raised past token 1 (by ln 1.5)
    # only 0.5 / (0.8 + 0.3) does
    assert _raise(lg, 2, **s) == pytest.approx(math.log(1.5), abs=1e-5)


def test_support_is_the_programs_filter():
    from llmspeculativesampling_tpu_torch.ops.sampling import SamplingConfig, norm_logits_topk

    g = torch.Generator().manual_seed(0)
    lg = torch.randn((64, 200), generator=g) * 3
    for temp, k, p in ((1.0, 20, 0.9), (0.7, 8, 0.5), (1.0, 20, 0.0)):
        dist = norm_logits_topk(lg, SamplingConfig(temperature=temp, top_k=k, top_p=p))
        s = dict(temperature=temp, top_k=k, top_p=p)
        for j in range(k):
            b = check.least_raise(lg, dist.idx[:, j], s)
            kept = dist.probs[:, j] > 0
            assert torch.all(b[kept] == 0) and torch.all(b[~kept] > 0), (temp, k, p, j)
        outside = torch.topk(lg, k + 1, dim=-1).indices[:, k]
        assert torch.all(check.least_raise(lg, outside, s) > 0)


def test_control_draws_lie_in_its_support():
    g = torch.Generator().manual_seed(1)
    lg = torch.randn((256, 100), generator=g) * 2
    s = dict(temperature=1.0, top_k=20, top_p=0.9)
    drawn = check.draw(lg, s, torch.Generator().manual_seed(2))
    assert torch.all(check.least_raise(lg, drawn, s) == 0)
    assert len(set(drawn.tolist())) > 20


def test_sample_keeps_the_kinds_apart():
    ans = [Answer(np.arange(5), np.arange(n), None if i % 2 else {"top_k": 20})
           for i, n in enumerate([10, 40, 20, 30, 50, 60])]
    got = check.sample(ans, {"served_tokens": 50, "sampled_tokens": 1}, seed=3)
    greedy = [a for a in got if a.sampling is None]
    sampled = [a for a in got if a.sampling is not None]
    assert len(sampled) == 1 and len(sampled[0].served) == 50
    assert greedy[0].served.size == 60 and sum(a.served.size for a in greedy) >= 50


@pytest.mark.parametrize("sample_gap,ok", [(0.1, True), (0.9, False), (None, False)])
def test_judge_holds_the_sample_gap(sample_gap, ok):
    measured = {"logit_gap": 0.0, "served_checked": 100, "sample_gap": sample_gap,
                "sampled_checked": 100}
    lim = {"logit_gap_limit": 0.5, "min_served": 64, "sample_gap_limit": 0.5,
           "min_sampled": 64}
    got, checks = check.judge(measured, lim, 0)
    assert got is ok and list(checks) == ["logit_gap", "served_checked", "sample_gap",
                                          "sampled_checked", "failed"]
    assert check.judge(measured, {"logit_gap_limit": 0.5, "min_served": 64}, 0)[0]
