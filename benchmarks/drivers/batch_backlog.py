"""Driver ``batch_backlog``: a backlog of requests through the port's
``PagedEngine`` and its ``run_until_idle`` (the captured serving chunk, the
one-deep pipeline).

The queue is kept ``queue_depth`` requests beyond the rows, topped up
between calls of ``run_until_idle(max_steps=1)``, one serving chunk a call.
Set-up builds the pair and the engine, admits each prompt bucket of the mix
once at the largest admission batch it can form (so each prefill shape and
the chunk's capture come before the window), then fills every row and runs
until ``fill_completions`` requests have finished, so rows of every age
decode side by side when the window opens.

The rate (``rate_metric`` in the workload file names it: ``batch_tok_s``,
``doc_tok_s``) is the output tokens committed inside the window over the
window: a request's committed length is read at the window's two ends
(``partial_result``), a finished one's is its output. ``tpot_p90_ms`` is the
90th percentile, over requests finished in the window with two new tokens
or more, of (``latency_s`` - ``ttft_s``) / (new tokens - 1), from the
engine's stamps. Once the window closes, ``drain_requests`` hands back the
rows still running with their accepted lengths, so the step history of
every request in the window is known for the metric readers.

The readers' counts are of the work the window needed, not of how the
program split it into kernel calls: the live row-steps and the tokens they
committed (each request's accepted lengths), the prompts admitted, the
serving steps the program ran (its chunk counter ``last_chunk``: steps
called less the masked one) and, as a lower bound of the admissions'
forwards, the calls in which some request left the queue.
"""

from __future__ import annotations

import gc
import math
import time
from collections import Counter

import numpy as np
import torch

from llmspeculativesampling_tpu_torch.engine import device_loop
from llmspeculativesampling_tpu_torch.serve.paged import PagedEngine

from .. import families, traffic
from .common import (
    ROLES,
    Answer,
    AttentionTally,
    Outcome,
    log,
    memory_peak,
    step_starts,
    sync,
    tally_steps,
    w8a16_counts,
)

ENGINE_KEYS = ("batch_rows", "num_blocks", "page", "max_pages_per_req", "max_new_cap", "gamma",
               "eos_token_id", "temperature", "top_k", "top_p", "prompt_bucket",
               "steps_per_sync", "kv_quant", "prefill_token_budget")


class Book:
    """The benchmark's view of the requests it sent: prompts, finishes and
    committed lengths at chosen moments."""

    def __init__(self, engine: PagedEngine, mix: dict, seed: int):
        self.engine = engine
        self.gen = traffic.requests(mix, seed)
        self.prompt_len = {}   # rid -> prompt length
        self.prompts = {}      # rid -> prompt
        self.done = {}         # rid -> (harvest time, Completion)
        self.live = set()      # sent and not finished
        self.history = {}      # rid -> accepted length of each step (finished or drained)

    def send(self, n: int) -> None:
        for _ in range(n):
            req = next(self.gen)
            rid = self.engine.submit(req.prompt, req.max_new)
            self.prompt_len[rid] = len(req.prompt)
            self.prompts[rid] = req.prompt
            self.live.add(rid)

    def queued(self) -> int:
        """Sent, not on a row and not finished (the engine's finished ones
        not yet harvested are neither)."""
        done = sum(rid in self.live for rid in self.engine.completions)
        return len(self.live) - self.engine.num_active - done

    def top_up(self, depth: int) -> None:
        self.send(max(depth - self.queued(), 0))

    def harvest(self) -> None:
        now = time.perf_counter()
        for rid in list(self.engine.completions):
            c = self.engine.result(rid)
            if rid in self.live:
                self.live.discard(rid)
                self.done[rid] = (now, c)
                self.history[rid] = list(c.details["acc_len"])

    def snapshot(self) -> dict:
        """Each running request's committed length, and the finished ones."""
        on_row = {}
        for rid in self.live:
            got = self.engine.partial_result(rid)
            if got is not None:
                on_row[rid] = len(got)
        return {"on_row": on_row, "done": set(self.done)}

    def drain(self) -> None:
        """Take every running row back (its accepted lengths so far) and
        empty the queue."""
        for req in self.engine.drain_requests():
            if req.carry:
                self.history[req.rid] = list(req.carry["acc_len"])


class Calls:
    """What the window's ``run_until_idle`` calls ran: chunks, serving steps
    (the program's count of steps each chunk called, less its masked one),
    and the calls in which some request was admitted (each needs at least
    one prefill forward)."""

    def __init__(self):
        self.chunks = self.steps = self.admitting = 0

    def add(self, chunks: int, admitted: int) -> None:
        self.chunks += chunks
        if chunks:
            called, masked = device_loop.last_chunk
            self.steps += called - masked
        self.admitting += admitted > 0

    def frozen(self) -> dict:
        return dict(vars(self))


def _segment(book: Book, a: dict, b: dict, wall: float, calls: dict, eng: dict) -> dict:
    """The metric readers' counts between snapshots ``a`` and ``b``."""
    gamma = eng["gamma"]
    attn = {role: AttentionTally() for role in ROLES}
    needed = Counter()
    row_steps = committed = prompt_tokens = admitted = 0
    for rid, p_len in book.prompt_len.items():
        if rid in a["done"]:
            continue
        if rid in a["on_row"]:
            start = a["on_row"][rid]
        elif rid in b["on_row"] or rid in b["done"]:
            start = p_len
            admitted += 1
            prompt_tokens += p_len
        else:
            continue
        end = b["on_row"].get(rid, math.inf if rid in b["done"] else start)
        acc = book.history.get(rid, [])
        steps = [(c, n) for c, n in zip(step_starts(p_len, acc), acc) if start <= c < end]
        row_steps += len(steps)
        committed += sum(n + 1 for _, n in steps)
        tally_steps(attn, [c for c, _ in steps], gamma)
    w8 = w8a16_counts()
    for role in ROLES:
        needed[role] += prompt_tokens + row_steps * (gamma + 1)
        # a step: gamma draft forwards (a re-feed of two tokens, then single
        # ones) and one target forward of gamma+1 tokens a live row
        forwards = calls["steps"] * (gamma if role == "draft" else 1)
        w8[role]["pooled"] = [(forwards, row_steps * (gamma + 1)),
                              (calls["admitting"], prompt_tokens)]
    return {
        "segment_s": wall, "chunks": calls["chunks"], "steps": calls["steps"],
        "row_steps": row_steps, "committed_tokens": committed, "admitted": admitted,
        "attention": {role: vars(t) for role, t in attn.items()},
        "attention_family": "b3", "kv_dtype": "int8" if eng["kv_quant"] else "bfloat16",
        "needed_tokens": dict(needed), "preemptions": book.engine.preemptions, "w8a16": w8,
    }


def _warm_up(engine: PagedEngine, mix: dict, eng: dict, device) -> None:
    """Admit each bucket of the mix once at its largest admission batch (two
    new tokens each), so each prefill shape and the chunk's capture come
    before the window."""
    seen = {}
    for req in traffic.first_block(mix, 0):
        seen.setdefault(traffic.bucket_of(len(req.prompt), eng["prompt_bucket"]), req.prompt)
    for bucket, prompt in sorted(seen.items()):
        per = max(1, min(8, eng["prefill_token_budget"] // bucket, eng["batch_rows"]))
        for _ in range(per):
            engine.submit(prompt, 2)
        engine.run_until_idle()
    for rid in list(engine.completions):
        engine.result(rid)
    sync(device)


def run(cell, tracer, spans) -> Outcome:
    device, w, eng = cell.device, cell.workload, cell.workload["engine"]
    t = time.perf_counter()
    fam = families.family(cell.config, cell.base)
    pair = fam.build(cell.config, cell.seed, device)
    b = fam.bundles(pair, kv_quant=eng["kv_quant"])
    engine = PagedEngine(b["draft"], pair["draft"], b["target"], pair["target"], seed=cell.seed,
                         device=device, **{k: eng[k] for k in ENGINE_KEYS})
    sync(device)
    log(f"weights and engine {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    _warm_up(engine, w["traffic"], eng, device)
    log(f"warm-up {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    depth = w["queue_depth"]
    book = Book(engine, w["traffic"], cell.seed)
    book.send(eng["batch_rows"] + depth)
    while len(book.done) < w["fill_completions"]:
        engine.run_until_idle(1)
        book.harvest()
        book.top_up(depth)
    tracer.warm()
    log(f"fill {time.perf_counter() - t:.3f} s")

    traced, failed, error, calls = None, 0, None, Calls()
    tracer.start()
    a = book.snapshot()
    t0 = time.perf_counter()
    try:
        while True:
            with spans.span("submit"):
                book.top_up(depth)
                waiting = book.queued()
            with spans.span("run_until_idle"):
                ran = engine.run_until_idle(1)
            with spans.span("harvest"):
                calls.add(ran, waiting - book.queued())
                book.harvest()
            now = time.perf_counter()
            if traced is None and cell.trace and now - t0 >= w["trace_seconds"]:
                traced = (book.snapshot(), now - t0, calls.frozen())
                tracer.stop()
            if now - t0 >= cell.seconds:
                break
    except RuntimeError as e:  # the program failed
        failed, error = 1, str(e)
    t1 = time.perf_counter()
    end = book.snapshot()
    if traced is None and cell.trace:
        traced = (end, t1 - t0, calls.frozen())
        tracer.stop()
    peak = memory_peak(device)
    book.drain()

    in_window = {rid: c for rid, (t, c) in book.done.items() if t0 < t <= t1}
    new = 0
    for rid, p_len in book.prompt_len.items():
        if rid in a["done"] or (rid not in a["on_row"] and rid not in end["on_row"]
                                and rid not in in_window):
            continue
        start = a["on_row"].get(rid, p_len)
        stop = (len(in_window[rid].output_ids) if rid in in_window
                else end["on_row"].get(rid, start))
        new += stop - start
    tpot = [(c.details["latency_s"] - c.details["ttft_s"]) / (n - 1) * 1e3
            for c in in_window.values() if (n := len(c.output_ids) - c.prompt_len) >= 2]
    e2e = {w["rate_metric"]: new / (t1 - t0)}
    if tpot:
        e2e["tpot_p90_ms"] = float(np.percentile(tpot, 90))
    snap, wall, ran = traced or (end, t1 - t0, calls.frozen())
    counts = _segment(book, a, snap, wall, ran, eng)
    sampling = None if eng["top_k"] == 1 else {k: eng[k] for k in ("temperature", "top_k",
                                                                    "top_p")}
    answers = [Answer(book.prompts[rid], np.asarray(c.output_ids[c.prompt_len:], np.int64),
                      sampling) for rid, c in in_window.items()]
    del engine, book
    device_loop.release_graphs()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return Outcome(window_start=t0, end_to_end=e2e, counts=counts, answers=answers,
                   attempted=len(in_window) + failed, failed=failed, memory_peak_bytes=peak,
                   pair=pair, error=error)
