"""Evaluation harness CLI
(counterpart of ``llmspeculativesampling_tpu/evalx/harness.py``, the
reference's ``evaluation.py``).

The same flags and defaults as the JAX harness (top_k 20, top_p 0.9), the
same method blocks (the autoregressive baseline first, then speculative
sampling and the research variants, with the beam_v2 width x extra x
threshold sweep and the BiLD threshold grid) and the same result keys a
block: total and per-token seconds, mean accepted length, acceptance rate,
call counts, energy and J/token (:class:`~..utils.power.PowerMonitor`),
the optional target-logprob score and the dataset's task metric. Stdout is
duplicated into ``--log_file``.

The engines run on the card (``evaluate(args, device=...)`` takes
another device; the tests pass ``"cpu"``). Each prompt's randomness is its
own ``torch.Generator``, seeded from ``--seed``. Models are local
checkpoint directories (:func:`~..core.loader.load_pretrained`; nothing is
downloaded) or the synthetic pair born on the device.

Run:  python -m llmspeculativesampling_tpu_torch.evalx.harness \\
        --dataset synthetic --methods autoregressive,speculative
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.config import resolve_device
from ..core.loader import load_pretrained
from ..core.synthetic import synthetic_pair
from ..engine import (
    autoregressive_generate,
    beam_speculative_generate,
    beam_speculative_v2_generate,
    bild_generate,
    mjsd_generate,
    multi_speculative_generate,
    random_width_beam_generate,
    speculative_generate,
    speculative_generate_v2,
)
from ..engine.types import ModelBundle
from ..utils.decoder import Decoder
from ..utils.power import PowerMonitor
from . import metrics as M
from .datasets import load_eval_dataset

# the reference's per-dataset knobs
DATASET_PARAMS = {
    "cnndm": {"bild": {"fallback_thres": 0.9, "rollback_thres": 2.0},
              "multi": {"width": 4, "num_beams": 4}},
    "chatalpaca": {"bild": {"fallback_thres": 0.9, "rollback_thres": 5.0},
                   "multi": {"width": 4, "num_beams": 4}},
    "ChatGPT": {"bild": {"fallback_thres": 0.9, "rollback_thres": 5.0},
                "multi": {"width": 4, "num_beams": 4}},
}

ALL_METHODS = (
    "autoregressive", "autoregressive_small", "speculative",
    "speculative_v2", "bild", "mjsd", "multi", "beam", "beam_v2",
    "random_beam",
)


class Tee:
    """Duplicate stdout writes into a log file."""

    def __init__(self, path: Optional[str]):
        self._f = open(path, "a") if path else None

    def __call__(self, *parts):
        line = " ".join(str(p) for p in parts)
        print(line, flush=True)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()

    def close(self):
        if self._f:
            self._f.close()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="speculative-decoding evaluation harness (PyTorch/CUDA)")
    p.add_argument("--approx_model_name", default="synthetic",
                   help="local HF dir for the draft model, or 'synthetic'")
    p.add_argument("--target_model_name", default="synthetic",
                   help="local HF dir for the target model, or 'synthetic'")
    p.add_argument("--family", default="llama", choices=["llama", "opt"],
                   help="model family for synthetic mode")
    p.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", "cnndm", "squad", "spider", "ChatGPT",
                            "chatalpaca", "wmt14"])
    p.add_argument("--data_root", default="data")
    p.add_argument("--methods", default="autoregressive,speculative",
                   help=f"comma list from {ALL_METHODS} or 'all'")
    p.add_argument("--max_tokens", "-M", type=int, default=128)
    p.add_argument("--gamma", "-g", type=int, default=4)
    p.add_argument("--width", "-w", type=int, default=4)
    p.add_argument("--num_beams", type=int, default=8)
    p.add_argument("--extra_sample_cnt", type=int, default=-1)
    p.add_argument("--expect_thres", type=float, default=0.7)
    p.add_argument("--accept_thres", type=float, default=0.1)
    p.add_argument("--fallback_thres", type=float, default=0.6)
    p.add_argument("--rollback_thres", type=float, default=5.0)
    p.add_argument("--strategy", default="iid", choices=["iid", "beam", "acc_beam"])
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=20)
    p.add_argument("--top_p", type=float, default=0.9)
    p.add_argument("--num_prompts", "-n", type=int, default=20)
    p.add_argument("--max_seconds", type=int, default=1 << 30,
                   help="wall-clock budget per method block")
    p.add_argument("--seed", "-s", type=int, default=123)
    p.add_argument("--random_seed", type=int, default=None,
                   help="reference-style accept-draw reseed for speculative")
    p.add_argument("--log_file", default=None)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--sweep", action="store_true",
                   help="beam_v2 hyperparameter sweep (width x extra x threshold)")
    p.add_argument("--sweep_bild", action="store_true",
                   help="BiLD fallback/rollback threshold grid")
    p.add_argument("--score", action="store_true",
                   help="compute the target-logprob quality score (slow)")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler Chrome trace of one prompt "
                        "per method block into <profile_dir>/<method>")
    p.add_argument("--cache_dir", default=None,
                   help="root of the one-time checkpoint conversion cache "
                        "(load_pretrained's cache_dir)")
    return p


def _load_models(args, device=None):
    """Returns (bundle_d, params_d, bundle_t, params_t, tokenizer|None, eos)."""
    if args.approx_model_name == "synthetic" or args.target_model_name == "synthetic":
        bd, pd, bt, pt = synthetic_pair(args.family, dtype=args.dtype, device=device)
        return bd, pd, bt, pt, None, 2

    from ..models import llama as llama_mod
    from ..models import opt as opt_mod

    fwd = {"llama": llama_mod.forward, "opt": opt_mod.forward}

    def cache_for(name):
        if not args.cache_dir:
            return None
        return os.path.join(args.cache_dir, name.strip("/").replace("/", "--"))

    fam_d, cfg_d, pd = load_pretrained(
        args.approx_model_name, args.dtype, cache_dir=cache_for(args.approx_model_name),
        device=device)
    fam_t, cfg_t, pt = load_pretrained(
        args.target_model_name, args.dtype, cache_dir=cache_for(args.target_model_name),
        device=device)
    bd = ModelBundle(fam_d, cfg_d, fwd[fam_d])
    bt = ModelBundle(fam_t, cfg_t, fwd[fam_t])

    tokenizer, eos = None, 2
    try:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.target_model_name, local_files_only=True)
        Decoder().set_tokenizer(tokenizer)
        eos = tokenizer.eos_token_id or 2
    except Exception:
        pass
    return bd, pd, bt, pt, tokenizer, eos


def _method_fn(name: str, models, args, eos: int, device=None):
    bd, pd, bt, pt = models
    common = dict(eos_token_id=eos, temperature=args.temperature,
                  top_k=args.top_k, top_p=args.top_p, details=True, device=device)
    ds_p = DATASET_PARAMS.get(args.dataset, {})

    def run(prompt_ids, generator, **over):
        # `over` carries sweep overrides; each branch pops what it consumes
        # and anything left merges into kw exactly once
        over = dict(over)
        kw = dict(common, generator=generator)
        if name == "autoregressive":
            kw.update(over)
            return autoregressive_generate(bt, pt, prompt_ids, args.max_tokens, **kw)
        if name == "autoregressive_small":
            # the draft decodes alone: the floor a speculative method should
            # beat on speed and the target's AR run on quality
            kw.update(over)
            return autoregressive_generate(bd, pd, prompt_ids, args.max_tokens, **kw)
        if name == "speculative":
            kw.update(over)
            return speculative_generate(bd, pd, bt, pt, prompt_ids, args.max_tokens,
                                        gamma=args.gamma,
                                        random_seed=args.random_seed, **kw)
        if name == "speculative_v2":
            kw.update(over)
            return speculative_generate_v2(bd, pd, bt, pt, prompt_ids,
                                           args.max_tokens, gamma=args.gamma, **kw)
        if name == "bild":
            bp = ds_p.get("bild", {})
            fb = over.pop("fallback_thres", bp.get("fallback_thres", args.fallback_thres))
            rb = over.pop("rollback_thres", bp.get("rollback_thres", args.rollback_thres))
            kw.update(over)
            return bild_generate(
                bd, pd, bt, pt, prompt_ids, args.max_tokens, gamma=max(args.gamma, 10),
                fallback_thres=fb, rollback_thres=rb, **kw)
        if name == "mjsd":
            kw.update(over)
            return mjsd_generate(bd, pd, bt, pt, prompt_ids, args.max_tokens,
                                 gamma=args.gamma, width=args.width,
                                 num_beams=args.num_beams,
                                 accept_thres=args.accept_thres, **kw)
        if name == "multi":
            mp = ds_p.get("multi", {})
            kw.update(over)
            return multi_speculative_generate(
                bd, pd, bt, pt, prompt_ids, args.max_tokens, gamma=args.gamma,
                width=mp.get("width", args.width), strategy=args.strategy,
                num_beams=mp.get("num_beams", args.num_beams), **kw)
        if name == "beam":
            width = over.pop("width", args.width)
            num_beams = over.pop("num_beams", args.num_beams)
            kw.update(over)
            return beam_speculative_generate(bd, pd, bt, pt, prompt_ids,
                                             args.max_tokens, gamma=args.gamma,
                                             width=width, num_beams=num_beams, **kw)
        if name == "beam_v2":
            width = over.pop("width", args.width)
            # the reference's sweep sets num_beams = width
            num_beams = over.pop("num_beams", args.num_beams)
            extra = over.pop("extra_sample_cnt", args.extra_sample_cnt)
            thres = over.pop("expect_thres", args.expect_thres)
            kw.update(over)
            return beam_speculative_v2_generate(
                bd, pd, bt, pt, prompt_ids, args.max_tokens, gamma=args.gamma,
                width=width, num_beams=num_beams,
                extra_sample_cnt=extra, expect_thres=thres, **kw)
        if name == "random_beam":
            kw.update(over)
            return random_width_beam_generate(bt, pt, prompt_ids, args.max_tokens,
                                              max_num_beams=args.num_beams,
                                              min_num_beams=1, **kw)
        raise ValueError(f"unknown method {name!r}")

    return run


def run_block(name, models, prompts_ids, prompt_texts, args, eos, log, *, device=None,
              **over) -> Dict:
    """One method block over the prompt set -> aggregate metrics dict.
    Prompt ``i`` draws from its own generator, seeded from ``--seed``."""
    dev = resolve_device(device)
    fn = _method_fn(name, models, args, eos, dev)
    mon = PowerMonitor().start()
    outputs: List[np.ndarray] = []
    prompt_lens: List[int] = []
    det_acc: Dict[str, float] = {"acc_len_sum": 0.0, "acc_len_n": 0,
                                 "acc_rate_sum": 0.0, "acc_rate_n": 0,
                                 "target_calls": 0, "approx_calls": 0}
    total_tokens, total_time = 0, 0.0
    t_start = time.time()
    seeds = np.random.default_rng(args.seed).integers(0, 1 << 62, size=len(prompts_ids))
    for i, ids in enumerate(prompts_ids):
        if time.time() - t_start > args.max_seconds:
            log(f"  [{name}] wall budget hit after {i} prompts")
            break
        gen = torch.Generator(device=dev).manual_seed(int(seeds[i]))
        if i == 1 and args.profile_dir:  # prompt 0 pays the warm-up; trace prompt 1
            from ..utils.profiling import trace

            with trace(os.path.join(args.profile_dir, name)):
                out, d = fn(ids, gen, **over)
        else:
            out, d = fn(ids, gen, **over)
        outputs.append(np.asarray(out))
        prompt_lens.append(len(ids))
        total_tokens += d.get("tokens_generated", len(out) - len(ids))
        total_time += d["total_time"]
        if d.get("acc_len"):
            det_acc["acc_len_sum"] += float(np.sum(d["acc_len"]))
            det_acc["acc_len_n"] += len(d["acc_len"])
        if d.get("acc_rate") is not None:
            det_acc["acc_rate_sum"] += d["acc_rate"]
            det_acc["acc_rate_n"] += 1
        det_acc["target_calls"] += d.get("target_call_times", 0) or 0
        det_acc["approx_calls"] += d.get("approx_call_times", 0) or 0
    t_end = time.time()
    mon.stop()
    energy = mon.total_energy(t_start, t_end)

    res = {
        "method": name, **{k: v for k, v in over.items()},
        "prompts": len(outputs),
        "total_tokens": int(total_tokens),
        "total_time_s": round(total_time, 3),
        "s_per_token": round(total_time / max(total_tokens, 1), 5),
        "tokens_per_s": round(total_tokens / total_time, 2) if total_time else 0.0,
        "mean_acc_len": round(det_acc["acc_len_sum"] / det_acc["acc_len_n"], 3)
        if det_acc["acc_len_n"] else None,
        "acc_rate": round(det_acc["acc_rate_sum"] / det_acc["acc_rate_n"], 4)
        if det_acc["acc_rate_n"] else None,
        "target_call_times": det_acc["target_calls"],
        "approx_call_times": det_acc["approx_calls"],
        "energy_j": round(energy, 1),
        "j_per_token": round(energy / max(total_tokens, 1), 3) if energy else None,
    }
    res["_outputs"] = outputs
    res["_prompt_lens"] = prompt_lens
    return res


def add_quality(res: Dict, ds, tokenizer, models, args, log):
    """Dataset task metric + optional target-logprob score."""
    outputs, p_lens = res.pop("_outputs"), res.pop("_prompt_lens")
    if args.score and outputs:
        _, _, bt, pt = models
        scores = [M.get_score(bt, pt, o.reshape(1, -1), pl, args.max_tokens)
                  for o, pl in zip(outputs, p_lens)]
        res["prob_score"] = round(float(np.mean(scores)), 4)
    if tokenizer is None or ds.metric is None or not outputs:
        return
    preds = [tokenizer.decode(o[pl:].tolist(), skip_special_tokens=True)
             for o, pl in zip(outputs, p_lens)]
    refs = ds.references[: len(preds)]
    if ds.metric == "rouge":
        res.update(M.rouge(preds, refs))
    elif ds.metric == "em":
        res.update(M.exact_match_references(preds, refs))
    elif ds.metric == "bleu":
        res.update(M.bleu(preds, refs))
    elif ds.metric == "exec":
        res.update(M.execution_accuracy_references(
            preds, refs, db_root=os.path.join(args.data_root, "spider/spider/database")))


def evaluate(args, device=None) -> List[Dict]:
    """Run every requested method block on ``device`` (default the card);
    returns the blocks' result dicts, each also logged as one JSON line."""
    dev = resolve_device(device)
    log = Tee(args.log_file)
    log(f"# harness config: {vars(args)}")
    bd, pd, bt, pt, tokenizer, eos = _load_models(args, dev)
    models = (bd, pd, bt, pt)

    ds = load_eval_dataset(
        args.dataset, data_root=args.data_root, limit=args.num_prompts,
        draft_family=bd.family, vocab_size=bt.cfg.vocab_size, seed=args.seed)
    if ds.prompt_ids is not None:
        prompts_ids = ds.prompt_ids
        prompt_texts = [""] * len(prompts_ids)
    else:
        if tokenizer is None:
            raise RuntimeError(
                f"dataset {args.dataset!r} is text-based; a tokenizer (real "
                "checkpoint dirs) is required — use --dataset synthetic with "
                "synthetic models")
        prompts_ids = [
            np.asarray(tokenizer.encode(t)[:512], np.int32) for t in ds.prompts
        ]  # the reference's 512-token truncation
        prompt_texts = ds.prompts

    methods = ALL_METHODS if args.methods == "all" else tuple(
        m.strip() for m in args.methods.split(","))
    results = []

    def block(m, **over):
        r = run_block(m, models, prompts_ids, prompt_texts, args, eos, log, device=dev, **over)
        add_quality(r, ds, tokenizer, models, args, log)
        results.append(r)
        log(json.dumps(r))

    for m in methods:
        if m == "bild" and args.sweep_bild:
            for fb in (0.4, 0.6, 0.8, 0.9):
                for rb in (1.0, 2.0, 5.0):
                    block(m, fallback_thres=fb, rollback_thres=rb)
            continue
        if m == "beam_v2" and args.sweep:
            for width in (2, 3, 4, 5):
                for extra in (1, 2):
                    for thres in (0.5, 0.7, 0.9):
                        block(m, width=width, num_beams=width, extra_sample_cnt=extra,
                              expect_thres=thres)
            continue
        block(m)

    baseline = next((r for r in results if r["method"] == "autoregressive"), None)
    if baseline and baseline["tokens_per_s"]:
        for r in results:
            if r["method"] != "autoregressive" and r["tokens_per_s"]:
                log(f"# {r['method']}: {r['tokens_per_s'] / baseline['tokens_per_s']:.3f}x "
                    "vs autoregressive")
    log.close()
    return results


def main(argv=None):
    args = build_parser().parse_args(argv)
    return evaluate(args)


if __name__ == "__main__":
    main()
