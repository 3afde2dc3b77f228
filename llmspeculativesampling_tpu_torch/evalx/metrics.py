"""Evaluation metrics
(counterpart of ``llmspeculativesampling_tpu/evalx/metrics.py``).

The text metrics are this package's own copies of the JAX module's, line
for line: SQuAD-style exact match (lowercase, strip punctuation, drop
articles, collapse whitespace; max over ground truths), Spider execution
accuracy (predicted and gold SQL on the database's sqlite file, result
sets compared as order-insensitive sets of per-row sorted stringified
tuples; a gold error counts as an exception, outside the denominator),
ROUGE-1/2/L (the ``rouge_score`` definitions at ``use_stemmer=False``,
averaged over examples) and corpus BLEU (the HF ``bleu`` metric's
``compute_bleu``, smooth=False, on lowercased punctuation-free tokens).
The JAX module's docstring lists their known deltas against the canonical
implementations.

:func:`get_score` is the quality "prob score": the mean target log-prob of
the generated continuation, through this package's model forward.
"""

from __future__ import annotations

import math
import re
import sqlite3
import string
from collections import Counter
from typing import Iterable, List, Sequence

import numpy as np
import torch

from ..engine.types import pad_prompt

_ARTICLES = re.compile(r"\b(a|an|the)\b")
_PUNCT = set(string.punctuation)


def normalize_answer(s: str) -> str:
    s = s.lower()
    s = "".join(ch for ch in s if ch not in _PUNCT)
    s = _ARTICLES.sub(" ", s)
    return " ".join(s.split())


def exact_match_score(prediction: str, ground_truth: str) -> bool:
    return normalize_answer(prediction) == normalize_answer(ground_truth)


def exact_match_references(predictions: Sequence[str], references: Sequence[Iterable[str]]):
    em = sum(
        max(exact_match_score(pred, gt) for gt in refs)
        for pred, refs in zip(predictions, references)
    )
    return {"exact_match": 100.0 * em / len(predictions)}


def _result_set(rows):
    return {tuple(sorted(str(c) for c in row)) for row in rows}


def execution_accuracy(db_path: str, pred_sql: str, gold_sql: str) -> float:
    """-1: gold errored (exception); 0: prediction errored/mismatch; 1: match."""
    conn = sqlite3.connect(db_path)
    conn.text_factory = bytes
    cur = conn.cursor()
    try:
        gold = cur.execute(gold_sql).fetchall()
    except Exception:
        return -1.0
    try:
        pred = cur.execute(pred_sql).fetchall()
    except Exception:
        return 0.0
    return float(_result_set(pred) == _result_set(gold))


def execution_accuracy_references(
    predictions: Sequence[str], references: Sequence[str], db_root: str = "./spider/spider/database"
):
    """references entries are '<db>[SQL]<gold sql>' like the reference."""
    em, exceptions = 0.0, 0
    for pred, ref in zip(predictions, references):
        db, gold = ref.split("[SQL]", 1)
        acc = execution_accuracy(f"{db_root}/{db}/{db}.sqlite", pred, gold)
        if acc >= 0:
            em += acc
        else:
            exceptions += 1
    denom = max(len(predictions) - exceptions, 1)
    return {"execution accuracy": 100.0 * em / denom, "exception": exceptions}


# ------------------------------------------------------------------- ROUGE
def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def _tokenize(text: str) -> List[str]:
    return re.findall(r"[a-z0-9]+", text.lower())


def _ngram_f1(pred: List[str], ref: List[str], n: int) -> float:
    pc = Counter(tuple(pred[i : i + n]) for i in range(len(pred) - n + 1))
    rc = Counter(tuple(ref[i : i + n]) for i in range(len(ref) - n + 1))
    overlap = sum((pc & rc).values())
    if overlap == 0:
        return 0.0
    p = overlap / max(sum(pc.values()), 1)
    r = overlap / max(sum(rc.values()), 1)
    return 2 * p * r / (p + r)


def rouge(predictions: Sequence[str], references: Sequence[str]):
    r1, r2, rl = [], [], []
    for pred, ref in zip(predictions, references):
        pt, rt = _tokenize(pred), _tokenize(ref)
        r1.append(_ngram_f1(pt, rt, 1))
        r2.append(_ngram_f1(pt, rt, 2))
        lcs = _lcs_len(pt, rt)
        if lcs == 0:
            rl.append(0.0)
        else:
            p, r = lcs / max(len(pt), 1), lcs / max(len(rt), 1)
            rl.append(2 * p * r / (p + r))
    return {
        "rouge1": float(np.mean(r1)) if r1 else 0.0,
        "rouge2": float(np.mean(r2)) if r2 else 0.0,
        "rougeL": float(np.mean(rl)) if rl else 0.0,
    }


# -------------------------------------------------------------------- BLEU
def bleu(predictions: Sequence[str], references: Sequence, max_n: int = 4):
    """Corpus BLEU (Papineni et al.), the HF ``bleu`` metric's semantics
    (Google NMT ``compute_bleu``, smooth=False): clipped n-gram counts
    merged with max over the example's references, geometric mean of the
    four modified precisions (zero if any order has zero matches), and a
    brevity penalty against the corpus sum of per-example MIN reference
    lengths. ``references[i]`` may be one string or a list of strings."""
    pred_toks = [_tokenize(p) for p in predictions]
    ref_toks = [
        [_tokenize(r)] if isinstance(r, str) else [_tokenize(x) for x in r]
        for r in references
    ]
    p_logs = []
    for n in range(1, max_n + 1):
        match, total = 0, 0
        for pt, rts in zip(pred_toks, ref_toks):
            pc = Counter(tuple(pt[i : i + n]) for i in range(len(pt) - n + 1))
            rc = Counter()
            for rt in rts:
                rc |= Counter(tuple(rt[i : i + n]) for i in range(len(rt) - n + 1))
            match += sum((pc & rc).values())
            total += max(sum(pc.values()), 0)
        if total == 0 or match == 0:
            return {"bleu": 0.0}
        p_logs.append(math.log(match / total))
    pred_len = sum(len(t) for t in pred_toks)
    ref_len = sum(min(len(rt) for rt in rts) for rts in ref_toks)
    bp = 1.0 if pred_len > ref_len else math.exp(1 - ref_len / max(pred_len, 1))
    return {"bleu": float(bp * math.exp(sum(p_logs) / max_n))}


# -------------------------------------------------------- target prob score
def _device_of(params):
    """The device of the first tensor leaf of a param tree."""
    if isinstance(params, torch.Tensor):
        return params.device
    leaves = params.values() if isinstance(params, dict) else params
    for leaf in leaves:
        dev = _device_of(leaf)
        if dev is not None:
            return dev
    return None


def get_score(bundle, params, output_ids: np.ndarray, prompt_len: int, max_len: int = 2048):
    """Mean target log-prob of the generated continuation: the ids padded
    to a 64 bucket, one forward over all of them on the params' device,
    then the mean log-prob of each next id over rows
    ``[prompt_len - 1, total - 1)``. ``max_len`` is unused, as in the JAX
    function."""
    del max_len
    ids, total = pad_prompt(output_ids, 64)
    dev = _device_of(params)
    with torch.no_grad():
        cache = bundle.make_cache(1, ids.shape[1], device=dev)
        tok = torch.as_tensor(ids, dtype=torch.long, device=dev)
        logits, _ = bundle.forward(params, bundle.cfg, tok, cache)
        logp = torch.log_softmax(logits[0].float(), dim=-1)
        rows = torch.arange(ids.shape[1] - 1, device=dev)
        token_logp = logp[rows, tok[0, 1:]]
        mask = (rows >= prompt_len - 1) & (rows < total - 1)
        num = torch.where(mask, token_logp, torch.zeros((), device=dev)).sum()
        return float(num / mask.sum().clamp_min(1))
