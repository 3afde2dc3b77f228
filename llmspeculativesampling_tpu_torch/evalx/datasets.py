"""Evaluation datasets and prompt templates
(counterpart of ``llmspeculativesampling_tpu/evalx/datasets.py``; this
package's own copy, numpy only).

The reference harness's sets: cnndm summarization (the llama [INST]
template), SQuAD few-shot QA, Spider text-to-SQL with schema prompting,
ChatGPT-prompts chat, chatalpaca multi-turn chat (a local jsonl) and WMT14
de-en, each cut to the first ``limit`` prompts. Every loader reads a local
file under ``data_root`` first, then tries the HF ``datasets`` cache
(:func:`_try_hf`, ``None`` where the package is absent), and raises
``FileNotFoundError`` when neither has the set; ``synthetic`` makes
random-id prompts from a seed, so the harness runs with no data at all.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

SQUAD_FEWSHOT = (
    "[INST] <<SYS>> You need to answer the question using the exact words "
    "from the context. Below are some examples of how to answer questions "
    "based on context<</SYS>>\nExample 1\nContext: Architecturally, the "
    "school has a Catholic character. Atop the Main Building's gold dome is "
    "a golden statue of the Virgin Mary.\nQuestion: What sits on top of the "
    "Main Building at Notre Dame?\nAnswer: a golden statue of the Virgin "
    "Mary\n\nNow, answer the following question[/INST]\n"
)

SPIDER_FEWSHOT = (
    "[INST] <<SYS>> You are a SQL expert. You need to write the correct SQL "
    "based on the user question and database schemas. Below are some "
    "examples <</SYS>>\nExample\nSchema:\nTable head, columns = "
    "[*,head_ID,name,born_state,age]\nQuestion: \"How many heads of the "
    "departments are older than 56 ?\"\nSQL: SELECT count(*) FROM head "
    "WHERE age  >  56;\n\n"
)


@dataclass
class EvalDataset:
    name: str
    prompts: List[str]          # text prompts (empty for synthetic)
    references: List            # per-prompt reference(s)
    metric: Optional[str]       # 'rouge' | 'em' | 'exec' | 'bleu' | None
    prompt_ids: Optional[List[np.ndarray]] = None  # pre-tokenized (synthetic)


def spider_schema_prompt(tables_json: str, db_id: str) -> str:
    """Schema block like the reference's find_fields_MYSQL_like
    (evaluation.py:36-80): per-table column lists + foreign keys."""
    with open(tables_json) as f:
        tables = json.load(f)
    entry = next(t for t in tables if t["db_id"] == db_id)
    lines = []
    for ti, tname in enumerate(entry["table_names_original"]):
        cols = ["*"] + [c[1] for c in entry["column_names_original"] if c[0] == ti]
        lines.append(f"Table {tname}, columns = [{','.join(cols)}]")
    fks = []
    for a, b in entry.get("foreign_keys", []):
        ta, ca = entry["column_names_original"][a]
        tb, cb = entry["column_names_original"][b]
        fks.append(
            f"{entry['table_names_original'][ta]}.{ca} = "
            f"{entry['table_names_original'][tb]}.{cb}"
        )
    if fks:
        lines.append(f"Foreign_keys = [{','.join(fks)}]")
    return "\n".join(lines)


def _try_hf(name, *args, **kwargs):
    try:
        import datasets as hfd

        return hfd.load_dataset(name, *args, **kwargs)
    except Exception:
        return None


def load_eval_dataset(
    name: str,
    data_root: str = "data",
    limit: int = 100,
    draft_family: str = "llama",
    vocab_size: int = 32000,
    synthetic_prompt_len: int = 64,
    seed: int = 0,
) -> EvalDataset:
    """Load one of the reference's eval sets (or 'synthetic')."""
    if name == "synthetic":
        rng = np.random.default_rng(seed)
        ids = [
            rng.integers(10, vocab_size - 10, size=synthetic_prompt_len).astype(np.int32)
            for _ in range(limit)
        ]
        return EvalDataset("synthetic", [], [None] * limit, None, prompt_ids=ids)

    if name == "chatalpaca":
        path = os.path.join(data_root, "chatalpaca-10k.json")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"chatalpaca requires {path} (see reference README.md:1 — the "
                "file must be downloaded separately)"
            )
        prompts, refs = [], []
        with open(path) as f:
            for line in f:
                conv = json.loads(line)["conversations"]
                text = ""
                for turn in conv:
                    if turn["from"] == "human":
                        text += turn["value"] + "\n"
                    else:
                        prompts.append(text)
                        refs.append(turn["value"])
                        text += turn["value"] + "\n"
        return EvalDataset("chatalpaca", prompts[:limit], refs[:limit], "rouge")

    if name == "cnndm":
        local = os.path.join(data_root, "cnndm_test.json")
        if os.path.exists(local):
            rows = json.load(open(local))
        else:
            ds = _try_hf("cnn_dailymail", "3.0.0", split="test")
            if ds is None:
                raise FileNotFoundError(
                    f"cnndm: no {local} and no HF cache (offline environment)"
                )
            rows = [{"article": s["article"], "highlights": s["highlights"]} for s in ds]
        if draft_family == "llama":
            pre, post = "[INST] <<SYS>> Please Summarize <</SYS>>", "[/INST]"
        else:
            pre, post = "Summarize: ", ""
        prompts = [pre + r["article"] + post for r in rows[:limit]]
        refs = [r["highlights"] for r in rows[:limit]]
        return EvalDataset("cnndm", prompts, refs, "rouge")

    if name == "squad":
        local = os.path.join(data_root, "squad_validation.json")
        if os.path.exists(local):
            rows = json.load(open(local))
        else:
            ds = _try_hf("squad", split="validation")
            if ds is None:
                raise FileNotFoundError(f"squad: no {local} and no HF cache")
            rows = [
                {"context": s["context"], "question": s["question"], "answers": s["answers"]["text"]}
                for s in ds
            ]
        prompts = [
            SQUAD_FEWSHOT + "Context: " + r["context"] + "\n" +
            "Question: " + r["question"] + " \nAnswer:"
            for r in rows[:limit]
        ]
        refs = [r["answers"] for r in rows[:limit]]
        return EvalDataset("squad", prompts, refs, "em")

    if name == "spider":
        dev = os.path.join(data_root, "spider/spider/dev.json")
        tables = os.path.join(data_root, "spider/spider/tables.json")
        if not os.path.exists(dev):
            raise FileNotFoundError(f"spider requires {dev} + {tables}")
        rows = json.load(open(dev))[:limit]
        prompts = [
            SPIDER_FEWSHOT + "Schema:\n" + spider_schema_prompt(tables, r["db_id"]) +
            "\nQuestion: " + r["question"] + "\nSQL:"
            for r in rows
        ]
        refs = [r["db_id"] + "[SQL]" + r["query"] for r in rows]
        return EvalDataset("spider", prompts, refs, "exec")

    if name in ("ChatGPT", "chatgpt"):
        local = os.path.join(data_root, "chatgpt_prompts.json")
        if os.path.exists(local):
            rows = json.load(open(local))
        else:
            ds = _try_hf("MohamedRashad/ChatGPT-prompts", split="train")
            if ds is None:
                raise FileNotFoundError(f"ChatGPT: no {local} and no HF cache")
            rows = [
                {"human_prompt": s["human_prompt"], "chatgpt_response": s["chatgpt_response"]}
                for s in ds
            ]
        prompts = [r["human_prompt"] for r in rows[:limit]]
        refs = [r["chatgpt_response"] for r in rows[:limit]]
        return EvalDataset("ChatGPT", prompts, refs, "rouge")

    if name in ("wmt", "wmt14"):
        local = os.path.join(data_root, "wmt14_deen.json")
        if os.path.exists(local):
            rows = json.load(open(local))
        else:
            ds = _try_hf("wmt14", "de-en", split="test")
            if ds is None:
                raise FileNotFoundError(f"wmt14: no {local} and no HF cache")
            rows = [{"de": s["translation"]["de"], "en": s["translation"]["en"]} for s in ds]
        prompts = [
            "Translate German to English:\nGerman: " + r["de"] + "\nEnglish:"
            for r in rows[:limit]
        ]
        refs = [r["en"] for r in rows[:limit]]
        return EvalDataset("wmt14", prompts, refs, "bleu")

    raise RuntimeError(f"Unrecognized dataset {name}")
