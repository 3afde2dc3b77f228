"""The port's evaluation layer (``llmspeculativesampling_tpu_torch/evalx``)
against the JAX package's, on the CPU.

* Metrics: equal results (``==``) on the golden strings of
  tests/test_evalx.py, on 200 seeded random strings, and for execution
  accuracy on a sqlite file.
* Datasets: equal synthetic prompt ids, equal chatalpaca, spider and
  local-file loads, the same ``FileNotFoundError`` for missing files (the
  HF fallback stubbed to ``None`` on both sides, as on a machine without the
  ``datasets`` package: nothing is downloaded).
* ``get_score``: within 1e-5 absolute of JAX's on a converted fp32 tiny
  target; within 2e-3 on its int8 weight-only copy (the port's plain W8A16
  product against JAX's reference product: one bf16 rounding of the
  activations, different fp32 summation order).
* The harness: ``build_parser``'s flags and defaults equal JAX's; on a
  converted tiny pair at ``--top_k 1`` the autoregressive,
  autoregressive_small, speculative and speculative_v2 blocks give JAX's
  ids (greedy, so deterministic) and scores within 1e-4; every block of all
  ten methods carries JAX's result keys; ``--sweep`` and ``--sweep_bild``
  run JAX's grids (24 and 12 blocks, the same override values in order).
"""

import dataclasses
import json
import sqlite3
import string

import numpy as np
import pytest

from llmspeculativesampling_tpu.core.synthetic import synthetic_pair as j_synthetic_pair
from llmspeculativesampling_tpu.evalx import datasets as jds
from llmspeculativesampling_tpu.evalx import harness as jh
from llmspeculativesampling_tpu.evalx import metrics as jm
from llmspeculativesampling_tpu.quant.core import quantize_params as jquant
from llmspeculativesampling_tpu_torch.core.config import LlamaConfig as TCfg
from llmspeculativesampling_tpu_torch.engine.types import ModelBundle as TBundle
from llmspeculativesampling_tpu_torch.evalx import datasets as tds
from llmspeculativesampling_tpu_torch.evalx import harness as th
from llmspeculativesampling_tpu_torch.evalx import metrics as tm
from llmspeculativesampling_tpu_torch.models import llama as tl

from _torch_port import one_thread, to_port  # noqa: F401 (fixture)

DETERMINISTIC = ("autoregressive", "autoregressive_small", "speculative", "speculative_v2")


# ------------------------------------------------------------------ metrics

GOLDEN = [  # (prediction, reference or references) from tests/test_evalx.py
    ("The  Cat, sat!", "cat sat"),
    ("An apple a day", "apple day"),
    ("a golden statue", ["A Golden Statue!", "other"]),
    ("wrong", ["right"]),
    ("the cat sat on the mat", "the cat sat on the mat"),
    ("xyz", "abc def"),
    ("zzz", "the cat"),
    ("the cat was found under the bed", "the cat was under the bed"),
    ("the gunman killed police", "police killed the gunman"),
    ("cats sleeping", "cat sleep"),
    ("the quick brown fox jumps over the lazy dog", "the quick brown fox jumped over the lazy dog"),
    ("hello there general kenobi", ["hello there general kenobi", "hello there"]),
    ("foo bar foobar", ["foo bar foobar"]),
    ("the the the the the the the", "the cat is on the mat"),
    ("the cat", "the cat is here"),
    ("The Cat Sat Down", "the cat sat down"),
]


def _random_pairs(n=200, seed=0):
    rng = np.random.default_rng(seed)
    words = ["the", "a", "an", "The", "cat", "Cat", "sat", "mat", "dog", "ran", "x1", "42", "on",
             "under", "it's", "don't", "U.S.", "hello,", "world!", "(yes)", "Ünïcode", "\t", "  "]
    alphabet = string.ascii_letters + string.digits + string.punctuation + " "

    def text():
        if rng.random() < 0.2:
            return "".join(rng.choice(list(alphabet), size=int(rng.integers(0, 30))))
        return " ".join(rng.choice(words, size=int(rng.integers(0, 14))))

    pairs = []
    for _ in range(n):
        refs = [text() for _ in range(int(rng.integers(1, 4)))]
        pairs.append((text(), refs[0] if len(refs) == 1 else refs))
    return pairs


@pytest.mark.parametrize("which", ["golden", "random"])
def test_text_metrics_equal_jax(which):
    pairs = GOLDEN if which == "golden" else _random_pairs()
    preds = [p for p, _ in pairs]
    refs = [r for _, r in pairs]
    lists = [[r] if isinstance(r, str) else r for r in refs]
    firsts = [ls[0] for ls in lists]
    for p, ls in zip(preds, lists):
        assert tm.normalize_answer(p) == jm.normalize_answer(p)
        assert tm.exact_match_score(p, ls[0]) == jm.exact_match_score(p, ls[0])
    assert tm.exact_match_references(preds, lists) == jm.exact_match_references(preds, lists)
    assert tm.rouge(preds, firsts) == jm.rouge(preds, firsts)
    for max_n in (1, 2, 4):
        assert tm.bleu(preds, refs, max_n=max_n) == jm.bleu(preds, refs, max_n=max_n)
    for p, first, r in zip(preds, firsts, refs):  # one by one: corpus sums could hide a difference
        assert tm.rouge([p], [first]) == jm.rouge([p], [first])
        assert tm.bleu([p], [r], max_n=2) == jm.bleu([p], [r], max_n=2)
    assert tm.rouge([], []) == jm.rouge([], [])


def test_execution_accuracy_equal_jax(tmp_path):
    db_dir = tmp_path / "db" / "shop"
    db_dir.mkdir(parents=True)
    conn = sqlite3.connect(db_dir / "shop.sqlite")
    conn.execute("CREATE TABLE head (name TEXT, age INT)")
    conn.executemany("INSERT INTO head VALUES (?, ?)", [("a", 60), ("b", 50), ("c", 70), ("d", 57)])
    conn.commit()
    conn.close()
    db = str(db_dir / "shop.sqlite")
    gold = "SELECT count(*) FROM head WHERE age > 56"
    cases = [("SELECT 3", gold), ("SELECT 2", gold), ("bad sql", gold), ("SELECT 3", "bad gold"),
             ("SELECT name, age FROM head", "SELECT age, name FROM head ORDER BY age"),
             ("SELECT name FROM head WHERE age > 55", "SELECT name FROM head WHERE age >= 57"),
             ("SELECT name FROM head", "SELECT name FROM head LIMIT 2")]
    for pred, g in cases:
        assert tm.execution_accuracy(db, pred, g) == jm.execution_accuracy(db, pred, g)
    preds = [p for p, _ in cases]
    refs = ["shop[SQL]" + g for _, g in cases]
    root = str(tmp_path / "db")
    got = tm.execution_accuracy_references(preds, refs, db_root=root)
    assert got == jm.execution_accuracy_references(preds, refs, db_root=root)
    assert got["exception"] == 1


# ----------------------------------------------------------------- datasets

def test_synthetic_prompts_equal_jax():
    for kw in (dict(limit=3, vocab_size=1000, synthetic_prompt_len=8, seed=0),
               dict(limit=20, vocab_size=32000, seed=123), dict(limit=5, vocab_size=256, seed=7)):
        got, ref = tds.load_eval_dataset("synthetic", **kw), jds.load_eval_dataset("synthetic", **kw)
        assert len(got.prompt_ids) == len(ref.prompt_ids)
        for a, b in zip(got.prompt_ids, ref.prompt_ids):
            assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
        assert (got.name, got.prompts, got.references, got.metric) == (
            ref.name, ref.prompts, ref.references, ref.metric)


def _same(got, ref):
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def _write_sets(root):
    conv = {"conversations": [{"from": "human", "value": "hi"}, {"from": "gpt", "value": "hello"},
                              {"from": "human", "value": "more"}, {"from": "gpt", "value": "sure"}]}
    (root / "chatalpaca-10k.json").write_text((json.dumps(conv) + "\n") * 3)
    spider = root / "spider" / "spider"
    spider.mkdir(parents=True)
    (spider / "tables.json").write_text(json.dumps([{
        "db_id": "d", "table_names_original": ["head", "dept"],
        "column_names_original": [[-1, "*"], [0, "head_ID"], [0, "age"], [1, "dept_ID"]],
        "foreign_keys": [[3, 1]]}]))
    (spider / "dev.json").write_text(json.dumps(
        [{"db_id": "d", "question": f"how many {i}?", "query": f"SELECT {i}"} for i in range(4)]))
    (root / "cnndm_test.json").write_text(json.dumps(
        [{"article": f"story {i}", "highlights": f"sum {i}"} for i in range(3)]))
    (root / "squad_validation.json").write_text(json.dumps(
        [{"context": "c", "question": "q?", "answers": ["a", "b"]}]))
    (root / "chatgpt_prompts.json").write_text(json.dumps(
        [{"human_prompt": "p", "chatgpt_response": "r"}] * 2))
    (root / "wmt14_deen.json").write_text(json.dumps([{"de": "Hallo", "en": "Hello"}]))


def test_file_loaders_equal_jax(tmp_path, monkeypatch):
    for mod in (tds, jds):
        monkeypatch.setattr(mod, "_try_hf", lambda *a, **k: None)
    empty = tmp_path / "empty"
    empty.mkdir()
    for name in ("chatalpaca", "cnndm", "squad", "spider", "ChatGPT", "chatgpt", "wmt", "wmt14"):
        with pytest.raises(FileNotFoundError) as got:
            tds.load_eval_dataset(name, data_root=str(empty))
        with pytest.raises(FileNotFoundError) as ref:
            jds.load_eval_dataset(name, data_root=str(empty))
        assert str(got.value) == str(ref.value)
    with pytest.raises(RuntimeError, match="Unrecognized"):
        tds.load_eval_dataset("nope")
    _write_sets(tmp_path)
    for name in ("chatalpaca", "cnndm", "squad", "spider", "ChatGPT", "wmt14"):
        for kw in (dict(limit=2), dict(limit=100, draft_family="opt")):
            got = tds.load_eval_dataset(name, data_root=str(tmp_path), **kw)
            _same(got, jds.load_eval_dataset(name, data_root=str(tmp_path), **kw))
            assert got.prompts
    tables = str(tmp_path / "spider" / "spider" / "tables.json")
    assert tds.spider_schema_prompt(tables, "d") == jds.spider_schema_prompt(tables, "d")


# ------------------------------------------------------------------ models

def _port_bundle(jb):
    fields = {f.name for f in dataclasses.fields(TCfg)}
    cfg = TCfg(**{k: v for k, v in dataclasses.asdict(jb.cfg).items() if k in fields})
    return TBundle(jb.family, cfg, tl.forward)


@pytest.fixture(scope="module")
def tiny_pair():
    """JAX's tiny synthetic pair (tests/test_evalx.py's: 64 wide, 4 target
    and 2 draft layers, vocab 256, fp32) and its conversion to the port."""
    jbd, jpd, jbt, jpt = j_synthetic_pair("llama", hidden_size=64, num_layers=4, draft_layers=2,
                                          num_heads=4, vocab_size=256, max_position=512,
                                          dtype="float32")
    return (jbd, jpd, jbt, jpt), (_port_bundle(jbd), to_port(jpd), _port_bundle(jbt), to_port(jpt))


def test_get_score_equals_jax(tiny_pair):
    (_, _, jbt, jpt), (_, _, tbt, tpt) = tiny_pair
    rng = np.random.default_rng(0)
    qt = jquant(jpt, "llama", quantize_lm_head=True)
    tqt = to_port(qt)
    for total, plen in ((40, 16), (64, 10), (100, 64)):
        ids = rng.integers(0, 256, size=(1, total)).astype(np.int32)
        got = tm.get_score(tbt, tpt, ids, plen)
        ref = jm.get_score(jbt, jpt, ids, plen)
        assert abs(got - ref) <= 1e-5, (total, got, ref)
        got_q, ref_q = tm.get_score(tbt, tqt, ids, plen), jm.get_score(jbt, qt, ids, plen)
        assert abs(got_q - ref_q) <= 2e-3, (total, got_q, ref_q)


# ------------------------------------------------------------------ harness

def test_build_parser_equals_jax():
    got = {a.dest: a for a in th.build_parser()._actions}
    ref = {a.dest: a for a in jh.build_parser()._actions}
    assert got.keys() == ref.keys()
    for dest, a in ref.items():
        b = got[dest]
        assert (b.option_strings, b.default, b.type, b.choices, b.nargs, b.const, type(b)) == (
            a.option_strings, a.default, a.type, a.choices, a.nargs, a.const, type(a)), dest
    assert th.ALL_METHODS == jh.ALL_METHODS and th.DATASET_PARAMS == jh.DATASET_PARAMS


def _run(mod, pair, argv, monkeypatch, **eval_kw):
    """``mod.evaluate`` on ``pair`` with every block's output ids kept."""
    outputs = {}
    orig = mod.add_quality

    def add_quality(res, *a, **k):
        outputs.setdefault(res["method"], []).append([np.asarray(o) for o in res["_outputs"]])
        return orig(res, *a, **k)

    monkeypatch.setattr(mod, "_load_models", lambda args, *a: (*pair, None, 2))
    monkeypatch.setattr(mod, "add_quality", add_quality)
    args = mod.build_parser().parse_args(argv)
    return mod.evaluate(args, **eval_kw), outputs


def test_evaluate_greedy_ids_and_keys_equal_jax(tiny_pair, monkeypatch, tmp_path):
    jpair, tpair = tiny_pair
    argv = ["--dataset", "synthetic", "--num_prompts", "2", "--max_tokens", "8", "--top_k", "1",
            "--score"]
    ref, ref_ids = _run(jh, jpair, argv + ["--methods", ",".join(DETERMINISTIC)], monkeypatch)
    log = tmp_path / "port.log"
    got, got_ids = _run(th, tpair, argv + ["--methods", "all", "--log_file", str(log)],
                        monkeypatch, device="cpu")
    keys = {frozenset(r) for r in ref}
    assert len(keys) == 1
    assert [r["method"] for r in got] == list(th.ALL_METHODS)
    for r in got:
        assert set(r) in keys, (r["method"], set(r) ^ set(next(iter(keys))))
        assert r["prompts"] == 2 and r["total_tokens"] >= 16
    by_method = {r["method"]: r for r in got}
    for r in ref:
        name = r["method"]
        for a, b in zip(got_ids[name][0], ref_ids[name][0]):
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert abs(by_method[name]["prob_score"] - r["prob_score"]) <= 1e-4, name
        for key in ("total_tokens", "mean_acc_len", "acc_rate", "target_call_times"):
            assert by_method[name][key] == r[key], (name, key)
    text = log.read_text()
    assert all(json.dumps(r) in text for r in got)


@pytest.mark.parametrize("flag,method,blocks", [("--sweep", "beam_v2", 24),
                                                ("--sweep_bild", "bild", 12)])
def test_sweeps_run_jax_grids(tiny_pair, monkeypatch, flag, method, blocks):
    jpair, tpair = tiny_pair
    argv = ["--dataset", "synthetic", "--methods", method, flag, "--num_prompts", "1",
            "--max_tokens", "4", "--gamma", "2"]
    grid = []

    def stub_block(name, models, prompts_ids, prompt_texts, args, eos, log, **over):
        grid.append(over)
        return {"method": name, **over, "tokens_per_s": 0.0, "_outputs": [], "_prompt_lens": []}

    monkeypatch.setattr(jh, "run_block", stub_block)
    monkeypatch.setattr(jh, "_load_models", lambda args: (*jpair, None, 2))
    jh.evaluate(jh.build_parser().parse_args(argv))
    got, _ = _run(th, tpair, argv, monkeypatch, device="cpu")
    assert len(got) == len(grid) == blocks
    for r, over in zip(got, grid):
        assert {k: r[k] for k in over} == over
        assert r["method"] == method and r["total_tokens"] >= 4 and r["tokens_per_s"] > 0
