"""The port's span recorder (``utils/profiling.py::span``), the spans of its
two engines, their Chrome-trace export, and the benchmark's arithmetic over
them (``benchmarks/program_spans.py``).

CPU tests run anywhere, one thread, tiny shapes. Tests marked ``card``
hold the spans against the device trace on a CUDA card and skip without
one (decided inside the test): ``python -m pytest tests/test_torch_tracing.py
--noconftest -m card`` on a GPU machine (this file imports no JAX).
"""

import collections
import contextlib
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmarks import program_spans
from benchmarks.metrics import device_idle
from benchmarks.run import reader
from benchmarks.trace import Spans, Trace
from llmspeculativesampling_tpu_torch import speculative_generate
from llmspeculativesampling_tpu_torch.core.synthetic import synthetic_pair
from llmspeculativesampling_tpu_torch.engine import device_loop
from llmspeculativesampling_tpu_torch.serve.batched import DeviceClock
from llmspeculativesampling_tpu_torch.serve.paged import PagedEngine
from llmspeculativesampling_tpu_torch.utils import profiling

READERS = ("idle_prefill.decode", "idle_request.decode", "replay_ms.decode",
           "prefill_share.doc", "prefill_share.batch", "idle_admit.doc", "idle_admit.batch",
           "idle_harvest.doc", "idle_harvest.batch")


@pytest.fixture(autouse=True)
def _one_thread_and_no_spans():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.clear_spans()
    yield
    profiling.clear_spans()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return synthetic_pair("llama", hidden_size=64, num_layers=2, draft_layers=1, num_heads=4,
                          vocab_size=128, dtype="float32", damp=0.3, device="cpu")


def _generate(pair, details=True, device="cpu"):
    bd, pd, bt, pt = pair
    return speculative_generate(bd, pd, bt, pt, np.arange(3, 20), 16, gamma=3, eos_token_id=-1,
                                details=details, device=device)


def _engine(pair, device="cpu", **kw):
    bd, pd, bt, pt = pair
    kw = {**dict(batch_rows=2, num_blocks=16, page=16, max_pages_per_req=4, max_new_cap=16,
                 gamma=3, eos_token_id=-1, prompt_bucket=16, steps_per_sync=2), **kw}
    return PagedEngine(bd, pd, bt, pt, device=device, **kw)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _named(spans, name):
    return [s for s in spans if s.name == name]


# ------------------------------------------------------------- the recorder

class _CountingClock(DeviceClock):
    """The CPU's device clock, counting its marks."""

    def __init__(self):
        super().__init__(torch.device("cpu"))
        self.marks = 0

    def mark(self):
        self.marks += 1
        return super().mark()


def test_recording_off_records_nothing_and_touches_no_device(pair, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span made a CUDA call with recording off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    clock = _CountingClock()
    assert not torch.autograd.profiler._is_profiler_enabled
    first = profiling.span("a", rid=3, device=clock, rows=1)
    with first as sp:
        sp.set(rows=2)
        with profiling.span("b", device=clock) as inner:
            assert inner is sp  # one shared no-op: nothing is allocated
    assert clock.marks == 0 and profiling.spans() == []
    _generate(pair)
    eng = _engine(pair)
    eng.submit(np.arange(2, 12), 4)
    eng.run_until_idle()
    assert profiling.spans() == []


def test_span_nesting_rid_counts_and_clear():
    clock = _CountingClock()
    with _cpu_profile():
        assert torch.autograd.profiler._is_profiler_enabled
        with profiling.span("outer", rid=7, n=1) as sp:
            with profiling.span("inner", device=clock):
                pass
            with profiling.span("other", rid=(1, 2)):
                pass
            sp.set(m=2)
    outer, inner, other = profiling.spans()
    assert (outer.name, outer.parent, outer.rid) == ("outer", None, 7)
    assert outer.counts == {"n": 1, "m": 2}
    assert inner.parent == outer.id and inner.rid == 7 and other.rid == (1, 2)
    assert clock.marks == 2 and inner.device is not None and outer.device is None
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= other.start_ns <= outer.end_ns
    profiling.clear_spans()
    assert profiling.spans() == []


def test_an_aten_op_lies_inside_its_span():
    a = torch.ones(64, 64)
    with _cpu_profile() as prof:
        with profiling.span("mm"):
            torch.mm(a, a)
    (s,) = profiling.spans()
    ops = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert ops and all(s.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= s.end_ns
                       for e in ops)


def test_the_store_drops_its_oldest_spans_past_its_cap(monkeypatch):
    monkeypatch.setattr(profiling, "_SPANS", collections.deque(maxlen=4))
    with _cpu_profile():
        for i in range(6):
            with profiling.span(f"s{i}"):
                pass
    assert [s.name for s in profiling.spans()] == ["s2", "s3", "s4", "s5"]


# ------------------------------------------------------------ the engines

def test_speculative_generate_spans(pair):
    before = time.time_ns()
    with _cpu_profile():
        out, d = _generate(pair)
    after = time.time_ns()
    got = profiling.spans()
    (gen,) = _named(got, "spec.generate")
    (start,) = _named(got, "loop.start")
    (replay,) = _named(got, "loop.replay")
    assert len(got) == 3 and start.parent == gen.id and replay.parent == gen.id
    assert start.rid == replay.rid == gen.rid is not None
    assert replay.counts == {"replays": device_loop.last_steps[0]}
    assert gen.counts == {"steps": d["target_call_times"], "new_tokens": len(out) - 17}
    assert before <= gen.start_ns <= start.start_ns <= start.end_ns <= replay.start_ns
    assert replay.end_ns <= gen.end_ns <= after


def test_request_numbers_differ(pair):
    with _cpu_profile():
        _generate(pair, details=False)
        _generate(pair, details=False)
    a, b = _named(profiling.spans(), "spec.generate")
    assert b.rid == a.rid + 1


def _dispatches(eng, monkeypatch):
    """The start and end (``time.time_ns()``) and the rows of each admission
    batch's dispatch."""
    seen = []
    for name in ("_dispatch_prefill", "_dispatch_extend", "_stage_admission"):
        def wrapped(part, _f=getattr(eng, name)):
            t0 = time.time_ns()
            _f(part)
            seen.append((t0, time.time_ns(), len(part)))
        monkeypatch.setattr(eng, name, wrapped)
    return seen


def test_run_until_idle_spans(pair, monkeypatch):
    eng = _engine(pair)
    rids = [eng.submit(np.arange(2, 2 + n), 6) for n in (10, 12, 20, 9)]
    seen = _dispatches(eng, monkeypatch)
    before = time.time_ns()
    with _cpu_profile():
        chunks = eng.run_until_idle()
    after = time.time_ns()
    assert sorted(eng.completions) == rids
    got = profiling.spans()
    assert {s.name for s in got} == {"paged.admit", "paged.prefill", "paged.harvest"}
    by_id = {s.id: s for s in got}
    for s in got:
        assert before <= s.start_ns <= s.end_ns <= after and s.rid is None
        # on the CPU every admission runs eagerly: no prefill replays a graph
        assert s.counts == ({"graph": 0} if s.name == "paged.prefill" else {})
        if s.name == "paged.prefill":
            parent = by_id[s.parent]
            assert parent.name == "paged.admit"
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        else:
            assert s.parent is None
    # an admission per loop turn, the last finding the queue empty; a harvest a chunk
    assert len(_named(got, "paged.admit")) == chunks + 1
    assert len(_named(got, "paged.harvest")) == chunks
    prefills = _named(got, "paged.prefill")
    assert len(prefills) == len(seen) >= 2 and sum(n for _, _, n in seen) == len(rids)
    for s, (t0, t1, _) in zip(prefills, seen):
        assert s.start_ns <= t0 <= t1 <= s.end_ns
        assert before <= s.device[0] <= s.device[1] <= after


def test_step_span(pair):
    eng = _engine(pair)
    eng.submit(np.arange(2, 12), 4)
    n = 0
    with _cpu_profile():
        while eng.step():
            n += 1
        eng.step()
    got = profiling.spans()
    # every call admits; the calls that ran a chunk (all but the idle last) harvest it
    assert len(_named(got, "paged.admit")) == n + 2
    assert len(_named(got, "paged.harvest")) == n + 1
    assert all(s.parent is None for s in got if s.name != "paged.prefill")


def test_chrome_trace_holds_the_spans(tmp_path):
    a = torch.ones(64, 64)
    with profiling.trace(str(tmp_path)):
        with profiling.span("work", rid=5, n=1):
            torch.mm(a, a)
    assert profiling.spans() == []  # taken by the export
    (f,) = os.listdir(tmp_path)
    events = json.loads((tmp_path / f).read_text())["traceEvents"]
    (work,) = [e for e in events if e.get("cat") == "program_span"]
    assert work["name"] == "work" and work["args"]["rid"] == 5 and work["args"]["n"] == 1
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert mm and all(work["ts"] <= e["ts"] <= e["ts"] + e["dur"] <= work["ts"] + work["dur"]
                      for e in mm)
    rows = {e["tid"]: e["args"]["name"] for e in events if e.get("name") == "thread_name"
            and e["pid"] == work["pid"] and e.get("ph") == "M"}
    assert rows[work["tid"]] == "program spans"


# ------------------------------------------ the benchmark's span arithmetic

def _span(i, name, a, b, parent=None, device=None, **counts):
    return SimpleNamespace(id=i, name=name, start_ns=a, end_ns=b, parent=parent, rid=None,
                           counts=counts, device=device)


def _ctx(events, spans, monkeypatch, t0=0, t1=1000):
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    return SimpleNamespace(trace=Trace([(s, e, "k") for s, e in events], t0, t1, Spans(), {}),
                           counts={})


# device busy [100, 200], [250, 300], [600, 900]; idle [0, 100], [200, 250],
# [300, 600], [900, 1000] = 550 ns of 1000
EVENTS = [(100, 150), (140, 200), (250, 300), (600, 900)]
SPANS = [
    _span(0, "spec.generate", 50, 950, steps=3),
    _span(1, "loop.start", 60, 220, parent=0),
    _span(2, "loop.replay", 240, 700, parent=0, replays=4),
    _span(3, "paged.admit", 950, 990),
    _span(4, "paged.prefill", 960, 980, parent=3, device=(280, 650)),
]


def test_split_of_idle_is_exact(monkeypatch):
    ctx = _ctx(EVENTS, SPANS, monkeypatch)
    own, rest = program_spans.split_idle(ctx.trace, SPANS)
    # spec.generate alone: [50, 60], [220, 240] and [900, 950]; loop.start
    # [60, 100] and [200, 220]; loop.replay [240, 250] and [300, 600]; admit
    # [950, 960] and [980, 990]; prefill [960, 980]; outside every span
    # [0, 50] and [990, 1000]
    assert own == {0: 80, 1: 60, 2: 310, 3: 20, 4: 20} and rest == 60
    window_ns = ctx.trace.t1 - ctx.trace.t0
    assert sum(own.values()) + rest == window_ns - round(ctx.trace.busy_s() * 1e9)
    shares = {n: reader(n).read(ctx) for n in ("idle_prefill.decode", "idle_request.decode",
                                                "idle_admit.doc")}
    assert shares == {"idle_prefill.decode": 6.0, "idle_request.decode": 8.0,
                      "idle_admit.doc": 4.0}  # the admit's prefill included
    assert sum(shares.values()) <= device_idle.read(ctx)
    assert program_spans.idle_share(ctx, "spec.generate") == 45.0  # with its children
    assert reader("replay_ms.decode").read(ctx) == pytest.approx(460 / 4 / 1e6)
    # the prefill's device interval [280, 650] holds busy [280, 300], [600, 650]
    assert reader("prefill_share.batch").read(ctx) == 7.0
    assert reader("idle_harvest.batch").read(ctx) == 0.0


def test_spans_clip_to_the_window(monkeypatch):
    spans = [_span(0, "paged.harvest", -500, 120), _span(1, "loop.replay", -10, 50, replays=2),
             _span(2, "paged.admit", 5000, 6000)]
    ctx = _ctx(EVENTS, spans, monkeypatch)
    own, rest = program_spans.split_idle(ctx.trace, spans)
    assert own == {0: 50, 1: 50} and rest == 450
    assert reader("idle_harvest.doc").read(ctx) == 5.0
    assert reader("replay_ms.decode").read(ctx) is None  # no replay wholly inside


@pytest.mark.parametrize("case", ["no spans", "no recorder", "no trace"])
def test_readers_return_none_without_spans(monkeypatch, case):
    ctx = _ctx(EVENTS, [], monkeypatch)
    if case == "no recorder":  # a program whose profiling module has no spans
        monkeypatch.delattr(profiling, "spans")
    if case == "no trace":
        monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))
        ctx.trace = None
    assert [reader(n).read(ctx) for n in READERS] == [None] * len(READERS)


# ---------------------------------------------------------------- the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: `python -m pytest tests/test_torch_tracing.py "
                    "--noconftest -m card` on a GPU machine")
    return torch.device("cuda", 0)


@contextlib.contextmanager
def _card_profile():
    """A CUDA profiler session that has traced one kernel before the body
    runs: a session has been seen to miss the kernel launched right after
    it starts."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        yield prof


def _device_events(prof):
    from torch.autograd import DeviceType

    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA)


def _is_sleep(name: str) -> bool:
    """``torch.cuda._sleep``'s kernel (ATen's ``spin_kernel``)."""
    return "spin_kernel" in name or "sleep" in name.lower()


@pytest.mark.card
def test_card_kernel_lies_inside_its_span():
    _card()
    torch.cuda.synchronize()
    with _card_profile() as prof:
        with profiling.span("sleep"):
            torch.cuda._sleep(2_000_000)
            torch.cuda.synchronize()
    (s,) = profiling.spans()
    kernels = [e for e in _device_events(prof) if _is_sleep(e[2])]
    offsets = [((a - s.start_ns) / 1e3, (s.end_ns - b) / 1e3) for a, b, _ in kernels]
    assert kernels and all(s.start_ns <= a <= b <= s.end_ns for a, b, _ in kernels), offsets


@pytest.mark.card
def test_card_prefill_device_interval_brackets_its_kernels():
    """The kernel enqueued before the prefill (~1 s) keeps the card busy
    while the host prepares the prefill, so its device interval opens where
    that kernel ends, its first operation starts there, and the interval
    closes with its last operation: each within 50 us."""
    from llmspeculativesampling_tpu_torch.core.synthetic import (
        synthetic_opt_pair_int8_small_draft,
    )

    dev = _card()
    pair = synthetic_opt_pair_int8_small_draft(
        hidden_size=256, ffn_dim=1024, num_layers=4, num_heads=2, vocab_size=512,
        draft_hidden=128, draft_ffn=512, draft_layers=2, max_position=256, device=dev)
    eng = _engine(pair, device=dev, kv_quant=True, page=128, max_pages_per_req=2,
                  num_blocks=8, max_new_cap=32, prompt_bucket=64)
    eng.submit(np.arange(3, 70), 4)
    eng.run_until_idle()  # the prefill's shape and the chunk's capture
    eng.result(0)
    eng.submit(np.arange(3, 70), 4)
    torch.cuda.synchronize()
    with _card_profile() as prof:
        torch.cuda._sleep(2_000_000_000)  # ~1 s: longer than the host's way to the prefill
        eng.run_until_idle(1)
        torch.cuda.synchronize()
    (pre,) = _named(profiling.spans(), "paged.prefill")
    a, b = pre.device
    events = _device_events(prof)
    near = [((s - a) / 1e3, (e - a) / 1e3, n[:40]) for s, e, n in events
            if a - 2_000_000 < e and s < a + 2_000_000][:12]  # us from the interval's start
    inside = [(s, e) for s, e, n in events if a - 50_000 <= s < b and not _is_sleep(n)]
    assert inside, near
    first, last = (inside[0][0] - a) / 1e3, (max(e for _, e in inside) - b) / 1e3
    sleeps = [e for s, e, n in events if _is_sleep(n)]
    assert sleeps, near
    opened = (max(sleeps) - a) / 1e3
    assert abs(opened) <= 50 and abs(first) <= 50 and abs(last) <= 50, (opened, first, last, near)
