"""Whether what the timed path served is right: a comparison with the plain
reference of the model's family (``benchmarks/families/<model_type>.py``
names it, from ``benchmarks/reference/``).

Once the window has closed and the program's state is freed, a sample of
the requests the window finished, drawn from the seed and always holding
the longest, is run through the reference once over each prompt and its
served tokens. Greedy and sampled requests are sampled apart, each until it
holds ``served_tokens`` (greedy) or ``sampled_tokens`` (sampled) served
tokens, or all there are, and must reach ``min_served`` or ``min_sampled``.

At each served position the number read is the least raise of the served
token's reference logit that puts the token inside the support the
reference's own logits give under the request's sampling settings: the
top ``top_k`` (after ``temperature``), then the nucleus of mass ``top_p``
(a token is kept while the mass before it is at most ``top_p``; the first
always). Greedy (``top_k`` 1) makes it the gap by which the token lies
below the reference's best. A sound program's token lies in its own
support, so only rounding at the support's edge raises it above 0; a
token from outside (a wrong residual, a skipped nucleus, a wrong accept
ratio) reads the gap to the edge. ``logit_gap`` is the widest over the
greedy requests, ``sample_gap`` over the sampled ones.

The control, run only by ``benchmarks/control.py``, is the reference in
the precision below the one the configuration states (float8 activations,
``act_quant="fp8"``) put in the program's place: at each of the same
positions, ``control_gap`` reads the token it puts first (greedy
requests) and ``control_sample_gap`` a token drawn from its own support
(sampled requests), each by the same least raise.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from . import families

GREEDY = {"temperature": 1.0, "top_k": 1, "top_p": 0.0}


def _pick(answers: list, budget: int, rng: np.random.Generator) -> list:
    if not answers:
        return []
    longest = max(range(len(answers)),
                  key=lambda i: (len(answers[i].prompt) + len(answers[i].served), -i))
    order = [longest] + [int(i) for i in rng.permutation(len(answers)) if i != longest]
    out, served = [], 0
    for i in order:
        if served >= budget:
            break
        out.append(answers[i])
        served += len(answers[i].served)
    return out


def sample(answers: list, check: dict, seed: int) -> list:
    """The answers to compare: of the greedy ones and of the sampled ones
    each, the longest, then others in an order drawn from the seed, until
    ``served_tokens`` (greedy) or ``sampled_tokens`` (sampled) served tokens
    are held."""
    rng = np.random.default_rng(int(seed) + 1)
    greedy = [a for a in answers if a.sampling is None]
    sampled = [a for a in answers if a.sampling is not None]
    return (_pick(greedy, check["served_tokens"], rng)
            + _pick(sampled, check.get("sampled_tokens", 0), rng))


def least_raise(lg: torch.Tensor, ids: torch.Tensor, sampling: Optional[dict],
                iters: int = 48) -> torch.Tensor:
    """[n] least raise of ``lg[i, ids[i]]`` (float32 logits ``[n, V]``) that
    puts ``ids[i]`` inside the support of ``lg[i]`` under ``sampling``
    (None: greedy). Raising the token by ``b`` leaves the others; the token
    is inside when fewer than ``top_k`` others lie above it and the mass of
    those above, over the top ``top_k`` with it, is at most ``top_p`` (no
    nucleus when ``top_p`` is 0; ``top_k`` 0 keeps every token). Both
    fall as ``b`` grows, so ``b`` is found by bisection between 0 and the
    token's gap to the best, where it is first."""
    s = GREEDY if sampling is None else sampling
    temp, k, top_p = float(s["temperature"]), int(s["top_k"]), float(s["top_p"])
    k = min(k, lg.shape[-1]) if k > 0 else lg.shape[-1]
    x = lg.gather(1, ids[:, None])[:, 0]
    others = lg.scatter(1, ids[:, None], float("-inf"))
    u = torch.topk(others, k, dim=-1).values  # the k best of the others, descending
    hi = torch.clamp(u[:, 0] - x, min=0.0)

    def inside(b: torch.Tensor) -> torch.Tensor:
        xb = x + b
        above = u > xb[:, None]
        rank = above.sum(dim=-1)
        m = torch.maximum(u[:, :1], xb[:, None])
        w = torch.exp((u[:, :k - 1] - m) / temp)
        wx = torch.exp((xb[:, None] - m) / temp)[:, 0]
        num = torch.where(above[:, :k - 1], w, torch.zeros_like(w)).sum(dim=-1)
        mass = num / (w.sum(dim=-1) + wx)
        return (rank < k) & ((rank == 0) | (mass <= top_p) | (top_p <= 0.0))

    lo = torch.zeros_like(hi)
    ok0 = inside(lo)
    top = hi.clone()
    for _ in range(iters):
        mid = (lo + top) / 2
        ok = inside(mid)
        top = torch.where(ok, mid, top)
        lo = torch.where(ok, lo, mid)
    return torch.where(ok0, torch.zeros_like(top), top)


def draw(lg: torch.Tensor, sampling: dict, gen: torch.Generator) -> torch.Tensor:
    """[n] one token a row drawn from the support of ``lg`` under
    ``sampling`` (top-k after temperature, then the nucleus), with ``gen``."""
    k = min(int(sampling["top_k"]), lg.shape[-1])
    vals, idx = torch.topk(lg / float(sampling["temperature"]), k, dim=-1)
    probs = torch.softmax(vals, dim=-1)
    if float(sampling["top_p"]) > 0:
        before = torch.cumsum(probs, dim=-1) - probs
        probs = torch.where(before <= float(sampling["top_p"]), probs, torch.zeros_like(probs))
    j = torch.multinomial(probs / probs.sum(dim=-1, keepdim=True), 1, generator=gen)
    return idx.gather(1, j)[:, 0]


def _positions(ans) -> tuple:
    """(tokens the reference reads, the served ids, first served position's
    predictor)."""
    prompt = np.asarray(ans.prompt, np.int64)
    served = np.asarray(ans.served, np.int64)
    seq = np.concatenate([prompt, served[:-1]])
    return seq, served, len(prompt) - 1


def _widest(out: dict, key: str, value: float) -> None:
    out[key] = value if out.get(key) is None else max(out[key], value)


def gaps(pair: dict, chosen: list, device, control: bool = False, seed: int = 0) -> dict:
    """{"logit_gap", "served_checked", "sample_gap", "sampled_checked"} over
    ``chosen`` (a gap is None where no answer of its kind was chosen) and,
    with ``control``, {"control_gap", "control_sample_gap"} over the same
    positions, the control's draws from a generator seeded with ``seed``."""
    w = pair["widths"]["target"]
    reference = families.of(w).reference
    reference.setup_precision()
    out = {"logit_gap": None, "served_checked": 0, "sample_gap": None, "sampled_checked": 0}
    if not chosen:
        return out
    params = pair["target"]
    prepared = [_positions(a) for a in chosen]
    seqs = [torch.as_tensor(s, device=device) for s, _, _ in prepared]
    head = reference.head_weight(params)
    names = {True: ("logit_gap", "served_checked", "control_gap"),
             False: ("sample_gap", "sampled_checked", "control_sample_gap")}
    with torch.no_grad():
        hidden = reference.final_hidden(params, w, seqs)
        ref_logits = []
        for h, a, (_, served, first) in zip(hidden, chosen, prepared):
            lg = reference.logits(head, h[first:first + len(served)])
            ids = torch.as_tensor(served, device=device)
            gap, count, _ = names[a.sampling is None]
            _widest(out, gap, float(least_raise(lg, ids, a.sampling).max()))
            out[count] += len(served)
            if control:
                ref_logits.append(lg)
        del hidden
        if control:
            gen = torch.Generator(device=device).manual_seed(int(seed))
            hidden = reference.final_hidden(params, w, seqs, act_quant="fp8")
            for h, lg, a, (_, served, first) in zip(hidden, ref_logits, chosen, prepared):
                low = reference.logits(head, h[first:first + len(served)], act_quant="fp8")
                pick = low.argmax(dim=-1) if a.sampling is None else draw(low, a.sampling, gen)
                _widest(out, names[a.sampling is None][2],
                        float(least_raise(lg, pick, a.sampling).max()))
    return out


def judge(measured: dict, check: dict, failed: int) -> tuple:
    """(correct, {name: {"value", "limit"}}): each gap at most its limit, the
    served tokens of each kind the check holds a limit for at least theirs,
    no request failed."""
    checks = {
        "logit_gap": {"value": measured["logit_gap"], "limit": check["logit_gap_limit"]},
        "served_checked": {"value": measured["served_checked"], "limit": check["min_served"]},
    }
    if "sample_gap_limit" in check:
        checks["sample_gap"] = {"value": measured["sample_gap"],
                                "limit": check["sample_gap_limit"]}
        checks["sampled_checked"] = {"value": measured["sampled_checked"],
                                     "limit": check["min_sampled"]}
    checks["failed"] = {"value": failed, "limit": 0}
    ok = failed == 0
    for gap, count in (("logit_gap", "served_checked"), ("sample_gap", "sampled_checked")):
        if gap in checks:
            g, c = checks[gap], checks[count]
            ok = ok and c["value"] >= c["limit"] and g["value"] is not None \
                and g["value"] <= g["limit"]
    return ok, checks


def describe(checks: dict) -> List[str]:
    return [f"{name} {c['value']} limit {c['limit']}" for name, c in checks.items()]
