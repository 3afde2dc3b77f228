"""The serving engines' one-deep pipeline (``run_until_idle`` of
``serve/scheduler.py::ContinuousBatchingEngine`` and
``serve/paged.py::PagedEngine``, JAX ``serve/scheduler.py:596-633`` and
``serve/paged.py:2071-2100``) and the chunk's device-side exit
(``serve/batched.py::run_chunk``), on the CPU, on tests/test_torch_paged_*'s
tiny pair (fp32).

* Both engines: the pipelined ``run_until_idle`` gives the ids, acc_len and
  counts of a synchronous ``step()`` loop, and JAX's greedy ids, at a fixed
  gamma and ``steps_per_sync`` 1 and 8, to the budget and with an EOS id
  (JAX compiled once per engine and EOS id, in module fixtures).
* Order: a recorder on ``_dispatch_chunk`` and the metadata read
  (``_meta_np`` paged, ``_collect`` slotted) sees chunk k+1 dispatched
  before chunk k's metadata is read, reads in dispatch order; ``step()``
  reads each chunk before the next.
* The paged engine under late metadata: metadata of an earlier occupancy
  never updates or harvests a row's new occupant (a finished row refilled,
  a row preempted and refilled while its chunk is in flight); a row
  preempted while its chunk is in flight resumes from the last harvest and
  replays the unpreempted run bit for bit (top_k 10); chunked and
  monolithic prefill give the same ids under the pipeline at
  ``steps_per_sync`` 4.
* Under ``mesh=`` at dp 2 (two gloo ranks, ``tests/_torch_dp_cases.py``),
  both engines' pipelined completions equal one process's, and every rank
  keeps the dispatch-then-read order.
"""

import dataclasses

import jax
import numpy as np
import pytest

from llmspeculativesampling_tpu.core.config import LlamaConfig as JCfg
from llmspeculativesampling_tpu.engine.types import ModelBundle as JBundle
from llmspeculativesampling_tpu.models import llama as jl
from llmspeculativesampling_tpu.serve import paged as jpaged
from llmspeculativesampling_tpu.serve import scheduler as jsched
from llmspeculativesampling_tpu_torch.core.config import LlamaConfig as TCfg
from llmspeculativesampling_tpu_torch.engine.types import ModelBundle as TBundle
from llmspeculativesampling_tpu_torch.models import llama as tl
from llmspeculativesampling_tpu_torch.parallel.launch import launch
from llmspeculativesampling_tpu_torch.serve import paged as tpaged
from llmspeculativesampling_tpu_torch.serve import scheduler as tsched

import _torch_dp_cases as D
from _torch_port import one_thread, to_port  # noqa: F401 (fixture)

KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
          num_kv_heads=4, max_position=2048, dtype="float32")
PAGED = dict(batch_rows=3, num_blocks=24, page=32, max_pages_per_req=8, max_new_cap=64, gamma=3,
             top_p=0.9, prompt_bucket=32)
SLOTS = dict(num_slots=3, max_total_len=256, max_new_cap=64, gamma=3, top_p=0.9)
# five requests over three rows: two wait for a row, budgets staggered so
# rows finish in different chunks
REQS = [(list(range(5, 17)), 14), (list(range(20, 40)), 6), (list(range(41, 57)), 19),
        (list(range(60, 74)), 9), (list(range(80, 91)), 11)]
DETAIL_KEYS = ("acc_len", "accepted_count", "resample_count", "target_sample_count",
               "target_call_times", "tokens_generated")


@pytest.fixture(scope="module")
def pair():
    pt = jl.init_params(JCfg(**KW), jax.random.key(0))
    pd = {"embed": pt["embed"], "ln_final": pt["ln_final"], "lm_head": pt["lm_head"],
          "layers": jax.tree.map(lambda x: x[:1], pt["layers"])}
    return pd, pt, to_port(pd), to_port(pt)


def _engine(pair, kind, **kw):
    _, _, tpd, tpt = pair
    bd = TBundle("llama", TCfg(**{**KW, "num_layers": 1}), tl.forward)
    bt = TBundle("llama", TCfg(**KW), tl.forward)
    if kind == "paged":
        return tpaged.PagedEngine(bd, tpd, bt, tpt, device="cpu", **{**PAGED, **kw})
    return tsched.ContinuousBatchingEngine(bd, tpd, bt, tpt, device="cpu", **{**SLOTS, **kw})


def _jax_engine(pair, kind, **kw):
    jpd, jpt, _, _ = pair
    bd = JBundle("llama", JCfg(**{**KW, "num_layers": 1}), jl.forward)
    bt = JBundle("llama", JCfg(**KW), jl.forward)
    if kind == "paged":
        return jpaged.PagedEngine(bd, jpd, bt, jpt, **{**PAGED, **kw})
    return jsched.ContinuousBatchingEngine(bd, jpd, bt, jpt, **{**SLOTS, **kw})


def _serve(eng, pipelined: bool, reqs=REQS) -> list:
    rids = [eng.submit(p, n) for p, n in reqs]
    if pipelined:
        eng.run_until_idle()
    else:
        while eng._pending or eng.num_active:
            eng.step()
    return [eng.result(r) for r in rids]


def _greedy_eos(pair, kind) -> int:
    """An id the budget run generates mid-way (the 4th new token of the
    first request)."""
    c = _serve(_engine(pair, kind, top_k=1, eos_token_id=-1, steps_per_sync=8), True)[0]
    return int(c.output_ids[len(REQS[0][0]) + 3])


@pytest.fixture(scope="module")
def jax_ids(pair):
    """JAX's greedy ids, one engine a (kind, EOS id): to the budget (-1) and
    with a mid-run EOS."""
    out = {}
    for kind in ("paged", "slotted"):
        for eos in (-1, _greedy_eos(pair, kind)):
            eng = _jax_engine(pair, kind, top_k=1, eos_token_id=eos, steps_per_sync=8)
            out[kind, eos == -1] = (eos, [np.asarray(c.output_ids) for c in _serve(eng, True)])
    return out


@pytest.mark.parametrize("budget", [True, False], ids=["budget", "eos"])
@pytest.mark.parametrize("sync", [1, 8])
@pytest.mark.parametrize("kind", ["paged", "slotted"])
def test_pipelined_equals_step_loop_equals_jax(pair, jax_ids, kind, sync, budget):
    eos, want = jax_ids[kind, budget]
    runs = [_serve(_engine(pair, kind, top_k=1, eos_token_id=eos, steps_per_sync=sync), pipe)
            for pipe in (True, False)]
    for piped, stepped, ids in zip(*runs, want):
        np.testing.assert_array_equal(piped.output_ids, ids)
        np.testing.assert_array_equal(stepped.output_ids, ids)
        for k in DETAIL_KEYS:
            assert piped.details[k] == stepped.details[k], k
    if not budget:
        assert any(c.output_ids[-1] == eos for c in runs[0])


# ------------------------------------------------------------------- order

def _recorded(eng, kind) -> list:
    """Record each chunk's dispatch ("D", k) and metadata read ("R", k),
    numbering chunks by dispatch; a read takes the oldest unread chunk."""
    log, unread = [], []
    dispatch = eng._dispatch_chunk
    read_name = "_meta_np" if kind == "paged" else "_collect"
    read = getattr(eng, read_name)

    def d():
        k = sum(1 for e in log if e[0] == "D") + 1
        log.append(("D", k))
        unread.append(k)
        return dispatch()

    def r(*a):
        log.append(("R", unread.pop(0)))
        return read(*a)

    eng._dispatch_chunk = d
    setattr(eng, read_name, r)
    return log


@pytest.mark.parametrize("kind", ["paged", "slotted"])
def test_dispatch_precedes_the_previous_read(pair, kind):
    eng = _engine(pair, kind, top_k=10, eos_token_id=-1, steps_per_sync=2)
    log = _recorded(eng, kind)
    _serve(eng, True)
    n = sum(1 for e in log if e[0] == "D")
    assert n >= 6 and [k for e, k in log if e == "R"] == list(range(1, n + 1))
    for k in range(1, n):
        assert log.index(("D", k + 1)) < log.index(("R", k)), (k, log)
    assert log[:3] == [("D", 1), ("D", 2), ("R", 1)] and log[-1] == ("R", n)
    log.clear()
    eng.submit(REQS[0][0], 5)
    while eng.num_active or eng._pending:
        eng.step()
    assert log == [e for k in range(1, len(log) // 2 + 1) for e in (("D", k), ("R", k))]


# ------------------------------------------------- paged: late metadata

def test_stale_metadata_never_updates_a_new_occupant(pair):
    """One row. Request 1 finishes in its chunk and is harvested; request 2
    takes the row; request 1's metadata read again changes nothing of
    request 2's. Then request 2's row is preempted while its chunk is in
    flight and request 3 takes it: that chunk's late metadata neither
    harvests nor updates request 3, which completes as alone."""
    eng = _engine(pair, "paged", batch_rows=1, top_k=10, eos_token_id=-1, steps_per_sync=8)
    r1 = eng.submit(list(range(5, 15)), 3)
    eng._prepare_chunk()
    eng._finish_chunk(eng._start_chunk())
    stale, gens = dict(eng._last_harvest), eng._last_harvest_gens
    assert stale["done"][0] and eng.result(r1) is not None
    r2 = eng.submit(list(range(30, 40)), 40)
    eng._prepare_chunk()
    assert eng._row_req[0].rid == r2
    row_len = eng._row_len[0]
    eng._harvest(stale, gens)
    assert eng._row_req[0].rid == r2 and r2 not in eng.completions
    assert eng._row_len[0] == row_len and not eng._row_done[0]
    inflight = eng._start_chunk()  # request 2's chunk, unread
    eng._preempt_row(0)
    r3 = eng.submit(list(range(50, 62)), 5)
    eng._pending.rotate(-1)  # request 3 ahead of the resumed request 2
    eng._prepare_chunk()
    assert eng._row_req[0].rid == r3
    eng._finish_chunk(inflight)  # request 2's late metadata
    assert eng._row_req[0].rid == r3 and not eng.completions
    assert eng._row_len[0] == 12 and eng._row_steps[0] == 0
    eng.run_until_idle()
    for rid, prompt, new in ((r2, list(range(30, 40)), 40), (r3, list(range(50, 62)), 5)):
        alone = _engine(pair, "paged", batch_rows=1, top_k=10, eos_token_id=-1, steps_per_sync=8)
        alone._next_rid = rid  # the same stream
        want = _serve(alone, True, [(prompt, new)])[0]
        np.testing.assert_array_equal(eng.result(rid).output_ids, want.output_ids)


def test_preempted_in_flight_resumes_bit_identical(pair):
    """The mirror of tests/test_torch_paged_cache_mgmt.py's preemption
    replay under the pipeline, at steps_per_sync 2: every preemption takes a
    row whose chunk is in flight (the harvest is a chunk behind), resumes
    it from the last harvest's snapshot, and every request's ids, lengths
    and merged counters equal a run that never preempts."""
    prompts = [list(range(5 + 7 * i, 25 + 7 * i)) for i in range(3)]

    def run(num_blocks):
        eng = _engine(pair, "paged", on_demand=True, overcommit=2.0, num_blocks=num_blocks,
                      page=16, steps_per_sync=2, seed=3, top_k=10, eos_token_id=-1)
        seen = []
        preempt = eng._preempt_row

        def logged(row):
            hv, gens = eng._last_harvest, eng._last_harvest_gens
            seen.append((len(eng._chunk_log), gens is not None and gens[row] == eng._row_gen[row]
                         and int(hv["steps"][row]) > 0))
            preempt(row)

        eng._preempt_row = logged
        rids = [eng.submit(p, max_new_tokens=56) for p in prompts]
        eng.run_until_idle()
        return eng, seen, [eng.result(rid) for rid in rids]

    small, seen, outs_small = run(10)
    big, _, outs_big = run(24)
    assert small.preemptions > 0 and big.preemptions == 0
    assert all(in_flight == 1 for in_flight, _ in seen)
    assert any(from_snapshot for _, from_snapshot in seen)
    for cs, cb in zip(outs_small, outs_big):
        assert cs.output_ids.tolist() == cb.output_ids.tolist()
        for key in DETAIL_KEYS:
            assert cs.details[key] == cb.details[key], key
        assert cs.details["acc_rate"] == pytest.approx(cb.details["acc_rate"], rel=1e-6)
    assert small.allocator.free_blocks == 10


def test_chunked_and_monolithic_prefill_agree_under_the_pipeline(pair):
    """A 20-token request decodes, then a 120-token cold prompt and a short
    one arrive and everything drains through the pipelined loop at
    steps_per_sync 4: the staged prompt rides the chunks, and every id
    equals the monolithic engine's."""
    kw = dict(batch_rows=3, num_blocks=24, page=32, max_pages_per_req=8, max_new_cap=64,
              gamma=3, steps_per_sync=4, extend_chunk=16, seed=5, top_k=10, eos_token_id=-1)
    runs = []
    for chunked in (False, True):
        eng = _engine(pair, "paged", chunked_prefill=chunked, **kw)
        r0 = eng.submit(list(range(5, 25)), 40)
        eng.step()
        rids = [r0, eng.submit(list(range(4, 124)), 16), eng.submit(list(range(30, 44)), 12)]
        eng.run_until_idle()
        runs.append((eng.interleaved_chunks, [eng.result(r).output_ids.tolist() for r in rids]))
        assert eng.allocator.free_blocks == 24
    assert runs[0][0] == 0 and runs[1][0] >= 2
    assert runs[1][1] == runs[0][1]


# ------------------------------------------------------------------- mesh

@pytest.fixture(scope="module")
def dp_pipeline():
    pt_np = jax.tree.map(np.asarray, jl.init_params(JCfg(**D.T.LLAMA), jax.random.key(0)))
    return pt_np, launch("_torch_dp_cases:pipeline_case", 2, (pt_np,), timeout_s=120.0,
                         device="cpu")


def test_dp_pipeline_equals_one_process(dp_pipeline):
    pt_np, ranks = dp_pipeline
    pair = D.llama_pair(pt_np)
    want = {"paged": D.serve(D.paged_engine(pair)),
            "slotted": D.T.serve_all("slots", "llama", None)}
    for r in ranks:
        for kind in ("paged", "slotted"):
            got = r[kind]
            assert len(got["outs"]) == len(want[kind])
            for g, w in zip(got["outs"], want[kind]):
                np.testing.assert_array_equal(g, w)
            order = got["order"]
            n = sum(1 for e in order if e[0] == "D")
            assert n >= 2
            for k in range(1, n):
                assert order.index(("D", k + 1)) < order.index(("R", k)), (kind, order)
    assert ranks[0]["paged"]["order"] == ranks[1]["paged"]["order"]


def test_pipelined_state_is_static(pair):
    """The pipelined loop steps the engines' state in place: every buffer
    of the state a captured step reads keeps its identity across a drain."""
    from llmspeculativesampling_tpu_torch.serve.batched import state_leaves

    for kind in ("paged", "slotted"):
        eng = _engine(pair, kind, top_k=10, eos_token_id=-1, steps_per_sync=2)
        before = [id(t) for t in state_leaves(eng.state)]
        _serve(eng, True)
        assert [id(t) for t in state_leaves(eng.state)] == before
        assert dataclasses.is_dataclass(eng.state)
