"""The port's data-parallel axis (``parallel/sharding.py``'s dp placements,
``comm.gather_rows``, ``host_fetch`` across dp, both serving engines and
both lockstep drivers above dp 1) against the JAX package. The port runs on
gloo ranks on loopback (``parallel/launch.py``, the cases in
``tests/_torch_dp_cases.py``): one launch of two ranks (dp=2 x tp=1, and
dp=1 x tp=2 for adaptive gamma) and one of four (dp=2 x tp=2); JAX runs on
conftest's 8-device CPU mesh.

* The dp placements (pool blocks, tables, lengths, row lanes, slot caches)
  equal JAX's addressable shards on a dp=2 x tp=2 mesh, bit for bit; each
  pool shard carries a trash block of its own.
* Paged and slotted completions at dp=2 (and paged at dp=2 x tp=2) equal
  the one-process engine's bit for bit in fp32, Llama and OPT, at JAX's
  test_dp_sharded_paged_engine settings; greedy ids equal JAX's dp=2 x
  tp=4 ``PagedEngine``.
* Prefix pages hit only in their own shard's registry, admission tries
  every shard, preemption takes the needy shard's youngest row (and the
  fp32 replay equals the unpreempted run); every shard's pool ends free.
* Adaptive gamma under a mesh: every rank runs the same arms and holds the
  same controller stats (rank 0's clock).
* ``host_fetch`` gathers dp-split tensors whole on every rank; a chunk
  issues one dp collective (its metadata gather) and nothing else at tp 1.
* Both drivers keep the ranks' gathered token rows identical, rank 0's
  completions equal one process's, and ``recover_requests`` resumes every
  shard's rows.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as P

from llmspeculativesampling_tpu import parallel as jpar
from llmspeculativesampling_tpu.cache import paged as jcache
from llmspeculativesampling_tpu.core.config import LlamaConfig as JCfg
from llmspeculativesampling_tpu.engine.types import ModelBundle as JBundle
from llmspeculativesampling_tpu.models import llama as jl
from llmspeculativesampling_tpu.parallel.sharding import shard_paged_state as j_shard_paged_state
from llmspeculativesampling_tpu.parallel.sharding import slot_cache_place
from llmspeculativesampling_tpu.serve import paged as jpaged
from llmspeculativesampling_tpu_torch.cache import paged as tcache
from llmspeculativesampling_tpu_torch.cache.kvcache import QuantKVCache
from llmspeculativesampling_tpu_torch.parallel import sharding as ts
from llmspeculativesampling_tpu_torch.parallel.launch import launch
from llmspeculativesampling_tpu_torch.serve import paged as tpaged
from llmspeculativesampling_tpu_torch.serve.batched import BatchState
from llmspeculativesampling_tpu_torch.serve.scheduler import ContinuousBatchingEngine

import _torch_dp_cases as D
import _torch_tp_cases as C
from _torch_port import one_thread  # noqa: F401 (fixture)

RANK_LIMIT_S = 120.0
DP, TP = 2, 2


def _port_mesh(rank: int, dp: int = DP, tp: int = TP) -> ts.Mesh:
    """A mesh seen from ``rank`` without a process group: enough to place."""
    return ts.Mesh(np.arange(dp * tp).reshape(dp, tp), rank)


def _jax_params():
    return jax.tree.map(np.asarray, jl.init_params(JCfg(**C.LLAMA), jax.random.key(0)))


@pytest.fixture(scope="module")
def pt_np():
    return _jax_params()


# ----------------------------------------------------------------- placements

B, L, N, H, PAGE, HD, PMAX, T, HIST, S = 4, 2, 8, 4, 8, 4, 3, 16, 5, 4


def _random_paged():
    """One paged state's contents as numpy: (pools, row lanes)."""
    rng = np.random.default_rng(0)
    pools = {}
    for name in ("draft_cache", "target_cache"):
        pools[name] = {
            "k_q": rng.integers(-127, 128, (L, N, H, PAGE, HD)).astype(np.int8),
            "v_q": rng.integers(-127, 128, (L, N, H, PAGE, HD)).astype(np.int8),
            "k_s": rng.random((L, N, H, PAGE), np.float32),
            "v_s": rng.random((L, N, H, PAGE), np.float32),
            "block_tables": rng.integers(0, N, (B, PMAX)).astype(np.int32),
            "lengths": rng.integers(0, PMAX * PAGE, (B,)).astype(np.int32),
        }
    lanes = {f: rng.integers(0, 100, (B,)).astype(np.int32)
             for f in ("cur_len", "target_len", "prefill_to", "accepted", "resamples", "bonus",
                       "steps")}
    lanes.update(tokens=rng.integers(0, 100, (B, T)).astype(np.int32),
                 active=rng.random(B) < 0.5, done=rng.random(B) < 0.5,
                 acc_rate_sum=rng.random(B, np.float32),
                 acc_len_hist=rng.integers(0, 4, (B, HIST)).astype(np.int32))
    return pools, lanes


def _jax_paged(pools, lanes):
    caches = {name: jcache.QuantPagedKVCache(**{k: jax.numpy.asarray(v) for k, v in c.items()})
              for name, c in pools.items()}
    return jpaged.PagedBatchState(key=jax.random.split(jax.random.key(0), B), **caches,
                                  **{k: jax.numpy.asarray(v) for k, v in lanes.items()})


def _port_paged(pools, lanes):
    def pool(c):  # the port's pool carries a trash block after the N blocks
        out = {k: torch.as_tensor(v) for k, v in c.items()}
        for k in ("k_q", "v_q", "k_s", "v_s"):
            out[k] = torch.cat([out[k], torch.full_like(out[k][:, :1], 7)], 1)
        return tcache.QuantPagedKVCache(**out)

    return tpaged.PagedBatchState(key=torch.zeros((B, 2), dtype=torch.long),
                                  **{name: pool(c) for name, c in pools.items()},
                                  **{k: torch.as_tensor(v) for k, v in lanes.items()})


def _fields(x):
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}


def _check_leaf(name, got, j, devices, rank, pool):
    for shard in j.addressable_shards:
        if devices.index(shard.device) != rank:
            continue
        want, spec = np.asarray(shard.data), got.sharding.spec
        if pool:  # the rank's N/dp blocks, then its own trash block
            assert got.shape[1] == want.shape[1] + 1, name
            np.testing.assert_array_equal(got[:, -1].numpy(), np.full_like(want[:, 0], 7))
            got = got[:, :-1]
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        assert spec == tuple(j.sharding.spec) + (None,) * (got.dim() - len(j.sharding.spec)), name


def test_paged_placements_equal_jax_shards():
    """``shard_paged_state`` on a whole state: every leaf but the keys
    (typed in JAX, two words in the port) equals the data of JAX's
    addressable shard on the same (dp, tp) coordinates."""
    pools, lanes = _random_paged()
    jmesh = jpar.make_mesh(dp=DP, tp=TP, devices=jax.devices()[:DP * TP])
    devices = list(jmesh.devices.flat)
    jstate = j_shard_paged_state(_jax_paged(pools, lanes), jmesh)
    for rank in range(DP * TP):
        port = ts.shard_paged_state(_port_paged(pools, lanes), _port_mesh(rank))
        for name, x in _fields(port).items():
            if name == "key":
                continue
            j = getattr(jstate, name)
            if name.endswith("_cache"):
                jc = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
                for leaf, y in _fields(x).items():
                    _check_leaf(f"{name}.{leaf}", y, jc[leaf], devices, rank, y.dim() >= 4)
            else:
                _check_leaf(name, x, j, devices, rank, False)
        assert port.target_cache.num_blocks == N // DP  # the shard-local sentinel


def test_slot_placements_equal_jax_shards():
    """The slot engine's placements: the contiguous int8 cache
    ``[L, S, H, T, D]`` (JAX stacks slots first, ``[S, L, 1, H, T, D]``)
    and per-slot lengths as JAX's ``slot_cache_place``, and every row
    lane of ``shard_serving_state`` as its ``place_rank``."""
    rng = np.random.default_rng(1)
    jmesh = jpar.make_mesh(dp=DP, tp=TP, devices=jax.devices()[:DP * TP])
    devices = list(jmesh.devices.flat)
    data = {"k_q": rng.integers(-127, 128, (S, L, 1, H, T, HD)).astype(np.int8),
            "v_q": rng.integers(-127, 128, (S, L, 1, H, T, HD)).astype(np.int8),
            "k_s": rng.random((S, L, 1, H, T), np.float32),
            "v_s": rng.random((S, L, 1, H, T), np.float32),
            "lengths": rng.integers(0, T, (S,)).astype(np.int32)}
    jplaced = {k: slot_cache_place(jax.numpy.asarray(v), jmesh) for k, v in data.items()}
    tokens = rng.integers(0, 100, (S, T)).astype(np.int32)
    jtokens = jax.device_put(tokens, JNamedSharding(jmesh, P(ts.DP_AXIS, None)))

    def port_cache():
        parts = {k: torch.as_tensor(np.moveaxis(v[:, :, 0], 0, 1)) for k, v in data.items()
                 if k != "lengths"}
        return QuantKVCache(**parts, length=0, lengths=torch.as_tensor(data["lengths"]))

    def lane():
        return torch.zeros(S, dtype=torch.long)

    for rank in range(DP * TP):
        cache = port_cache()
        state = BatchState(tokens=torch.as_tensor(tokens), cur_len=lane(), draft_cache=cache,
                           target_cache=port_cache(), key=torch.zeros((S, 2), dtype=torch.long),
                           active=lane().bool(), done=lane().bool(), target_len=lane(),
                           accepted=lane(), resamples=lane(), bonus=lane(), steps=lane(),
                           acc_rate_sum=lane().float(), acc_len_hist=torch.zeros((S, HIST)))
        placed = ts.shard_serving_state(state, _port_mesh(rank))
        for shard in jtokens.addressable_shards:
            if devices.index(shard.device) == rank:
                np.testing.assert_array_equal(placed.tokens.numpy(), np.asarray(shard.data))
        for k, j in jplaced.items():
            got = getattr(placed.target_cache, k)
            for shard in j.addressable_shards:
                if devices.index(shard.device) != rank:
                    continue
                want = np.asarray(shard.data)
                if k != "lengths":  # [S/dp, L, 1, H/tp, T(, D)] -> [L, S/dp, H/tp, T(, D)]
                    want = np.moveaxis(want[:, :, 0], 0, 1)
                np.testing.assert_array_equal(got.numpy(), want, err_msg=k)
        assert placed.tokens.sharding.spec == (ts.DP_AXIS, None)
        assert placed.target_cache.k_q.sharding.spec == ts.cache_spec()


@pytest.mark.parametrize("what,kw,message", [
    ("slots", dict(num_slots=3), "num_slots=3 must divide over dp=2"),
    ("paged", dict(batch_rows=3), "batch_rows=3 must divide over dp=2"),
    ("paged", dict(num_blocks=15), "num_blocks=15 must divide over dp=2"),
    ("paged", dict(max_pages_per_req=None), "exceeds the 8-block pool of a dp=2 shard"),
    ("paged", dict(max_pages_per_req=9), "exceeds the 8-block pool of a dp=2 shard"),
])
def test_dp_construction_checks(what, kw, message):
    """JAX's asserts (serve/paged.py:908-918, parallel/sharding.py:162-164)
    as the port's ValueErrors: dp must divide the slots, the rows and the
    blocks, and max_pages_per_req (default: the whole pool) must fit a
    shard's half."""
    bd, pd, bt, pt = C.tiny_pair()
    mesh = _port_mesh(0, DP, 1)
    with pytest.raises(ValueError, match=message):
        if what == "slots":
            ContinuousBatchingEngine(bd, pd, bt, pt, mesh=mesh, device="cpu", **kw)
        else:
            tpaged.PagedEngine(bd, pd, bt, pt, mesh=mesh, device="cpu", **{**D.PAGED, **kw})


# ------------------------------------------------------------ two ranks, dp=2

@pytest.fixture(scope="module")
def dp(pt_np):
    return launch("_torch_dp_cases:dp_case", DP, (pt_np,), timeout_s=RANK_LIMIT_S, device="cpu")


def _equal(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("family", ["llama", "opt"])
def test_dp_paged_completions_equal_one_process(dp, pt_np, family):
    """JAX's test_dp_sharded_paged_engine: rows and the block pool split
    over dp=2 (two rows and eight blocks a rank), completions bit-identical
    to the one-process engine's, on both ranks."""
    pair = D.llama_pair(pt_np) if family == "llama" else C.tiny_pair("opt")
    want = D.serve(D.paged_engine(pair))
    for r in dp:
        _equal(r[f"paged_{family}"], want)


def test_dp_greedy_ids_equal_jax_dp_engine(dp, pt_np):
    """At top_k=1 the port's dp=2 ids equal JAX's PagedEngine on a dp=2 x
    tp=4 mesh (shard_map over dp)."""
    jcfg = JCfg(**C.LLAMA)
    pd = {k: pt_np[k] for k in ("embed", "ln_final", "lm_head")}
    pd["layers"] = {k: v[:1] for k, v in pt_np["layers"].items()}
    eng = jpaged.PagedEngine(JBundle("llama", JCfg(**{**C.LLAMA, "num_layers": 1}), jl.forward),
                             pd, JBundle("llama", jcfg, jl.forward), pt_np,
                             mesh=jpar.make_mesh(dp=2, tp=4), **{**D.PAGED, "top_k": 1})
    assert eng.dp == 2
    rids = [eng.submit(p, D.NEW) for p in D.PROMPTS]
    eng.run_until_idle()
    want = [np.asarray(eng.result(r).output_ids) for r in rids]
    for r in dp:
        _equal(r["paged_greedy"], want)


def test_dp_int8_prefix_hits_stay_in_their_shard(dp):
    """JAX's test_dp_sharded_paged_engine_int8_and_prefix: every request
    completes at its length with the int8 pool and the prefix cache; a
    prompt registered on shard 0 misses on shard 1 (shard 0's rows full)
    and hits on shard 0 again."""
    for r in dp:
        p = r["prefix"]
        assert p["rows"] == [[0], [0, 1, 2], [0]]
        assert all(g >= n for g, n in zip(p["generated"], [D.NEW, 20, 20, D.NEW, D.NEW]))
        assert p["cached"] == [0, 0, 0, 0, 32]
        assert p["hits"] == [[0, 0], [0, 0], [1, 0]]
        assert p["free"] == [True, True]


def test_dp_admission_tries_every_shard(dp):
    """Shard 0's commitment is full (a worst case of four pages on a
    four-page shard) while it still has a free row: the next request is
    admitted on shard 1 (JAX ADVICE r3 #4), not held."""
    for r in dp:
        a = r["admission"]
        assert a["rows"] == [a["x"], None, a["y"], None]
        assert len(a["outs"][0]) >= 60 + 60 and len(a["outs"][1]) >= 10 + D.NEW
        assert a["free"] == [True, True]


def test_dp_preemption_is_per_shard(dp, pt_np):
    """Shard 0 runs dry while the youngest request overall sits on shard
    1: the victim is shard 0's youngest (request 1 on row 1), and the fp32
    replay equals a one-process run that never preempts."""
    pair = D.llama_pair(pt_np)
    ref = D.paged_engine(pair, num_blocks=16)
    rids = [ref.submit(p, n) for p, n in D.PREEMPT_REQS]
    ref.run_until_idle()
    assert ref.preemptions == 0
    want = [ref.result(r).output_ids for r in rids]
    for r in dp:
        pre = r["preempt"]
        assert pre["preemptions"] >= 1 and set(pre["victims"]) == {(1, 1)}
        assert pre["free"] == [True, True]
        _equal(pre["outs"], want)


@pytest.mark.parametrize("mesh", ["adaptive_dp", "adaptive_tp"])
def test_adaptive_gamma_under_a_mesh(dp, mesh):
    """JAX's test_dp_sharded_paged_engine_adaptive_gamma at dp=2, and at
    tp=2, where the port used to raise: requests complete, the arm is one
    of (2, 3), every arm ran in the ramp, and both ranks ran the same arms
    and hold the same stats (epoch walls and rates from rank 0's clock)."""
    a, b = (r[mesh] for r in dp)
    assert a["arms"] == b["arms"] and set(a["arms"]) == set(D.ARMS)
    assert a["stats"] == b["stats"] and a["gamma"] in D.ARMS
    assert all(g >= 10 for g in a["generated"]) and a["generated"] == b["generated"]


@pytest.mark.parametrize("family", ["llama", "opt"])
def test_dp_slot_engine_equals_one_process(dp, family):
    """ContinuousBatchingEngine with its four slots over dp=2: the
    one-process completions on both ranks."""
    want = C.serve_all("slots", family)
    for r in dp:
        _equal(r["slots"][family], want)


def test_host_fetch_gathers_across_dp(dp):
    """A tensor split over dp comes back whole on every rank, on the axis
    its spec names (bool included); a replicated one stays as it is."""
    for r in dp:
        f = r["fetch"]
        np.testing.assert_array_equal(f["rows"], np.concatenate([np.arange(6).reshape(3, 2),
                                                                 np.arange(6).reshape(3, 2) + 100]))
        np.testing.assert_array_equal(f["cols"], np.concatenate([np.arange(6).reshape(2, 3),
                                                                 np.arange(6).reshape(2, 3) + 100],
                                                                1))
        np.testing.assert_array_equal(f["flags"], [True, True, False, False, True, True])
        np.testing.assert_array_equal(f["plain"][0], np.arange(4))


def test_dp_chunk_issues_one_dp_collective(dp):
    """No cross-dp collective inside a chunk, a prefill or an extend
    window: at tp 1 the only collective of a run is one metadata gather a
    chunk, of dp x (rows_local x (9 + h + t) + 2) int32 words."""
    for r in dp:
        words = 2 * (2 * (9 + 256 + D.PAGED["max_pages_per_req"] * D.PAGED["page"]) + 2)
        assert r["counts"] == {"gather_rows": [r["chunks"], r["chunks"] * words]}
    assert [r["shard"] for r in dp] == [0, 1]


def test_dp_drivers_keep_ranks_in_lockstep(dp, pt_np):
    """tests/test_multihost_lockstep.py's sharded drivers: MultiHostDriver
    over the dp=2 slot engine and PagedMultiHostDriver over the dp=2 paged
    engine hold identical token rows gathered by ``host_fetch`` on both
    ranks, and rank 0's completions (rank 1's too) equal a one-process
    driver's."""
    slot = D.slot_driver()
    rids = D.drive_slots(slot)
    want_slots = {r: slot.result(r).output_ids for r in rids}
    paged = D.paged_driver(D.llama_pair(pt_np))
    rids = D.drive_paged(paged)
    want_paged = {r: paged.result(r).output_ids for r in rids}
    for key, want in (("slot_driver", want_slots), ("paged_driver", want_paged)):
        a, b = (r[key] for r in dp)
        np.testing.assert_array_equal(a["rows"], b["rows"])
        assert a["rows"].shape[0] == 4  # both shards' rows
        for r in dp:
            assert sorted(r[key]["completions"]) == sorted(want)
            for rid, ids in want.items():
                np.testing.assert_array_equal(r[key]["completions"][rid], ids)


def test_dp_recover_requests_resumes_every_shard(dp, pt_np):
    """After one round with a row of every request on both shards, rank
    0's ``recover_requests`` hands back all four as resumable requests
    (committed tokens and stream keys from the gathered metadata), and a
    fresh engine finishes them with an unfailed run's outputs."""
    drv = D.paged_driver(D.llama_pair(pt_np), batch_cap=len(D.PROMPTS))
    rids = D.drive_paged(drv, D.RECOVER_NEW)
    rec = dp[0]["recovered"]
    assert rec["resumed"] == [0, 1, 2, 3] and "recovered" not in dp[1]
    for rid in rids:
        np.testing.assert_array_equal(rec["completions"][rid], drv.result(rid).output_ids)


# ------------------------------------------------------- four ranks, dp x tp

@pytest.fixture(scope="module")
def dp_tp(pt_np):
    return launch("_torch_dp_cases:dp_tp_case", DP * TP, (pt_np,), timeout_s=RANK_LIMIT_S,
                  device="cpu")


def test_dp_tp_paged_equals_one_process(dp_tp, pt_np):
    """The paged engine on dp=2 x tp=2: the one-process completions on all
    four ranks, the gathered token rows identical; each chunk gathers its
    metadata once over dp, and the tp all_reduces stay inside each dp
    row."""
    want = D.serve(D.paged_engine(D.llama_pair(pt_np)))
    assert sorted(r["coords"] for r in dp_tp) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in dp_tp:
        _equal(r["paged_llama"], want)
        np.testing.assert_array_equal(r["rows"], dp_tp[0]["rows"])
        assert r["counts"]["gather_rows"][0] == r["chunks"] and r["counts"]["all_reduce"][0] > 0
    for r in dp_tp:  # each dp row's tp pair issued the same all_reduces
        mate = next(m for m in dp_tp if m["coords"] == (r["coords"][0], 1 - r["coords"][1]))
        assert r["counts"] == mate["counts"]


def test_dp_tp_adaptive_gamma_arms_agree(dp_tp):
    arms = [r["adaptive"]["arms"] for r in dp_tp]
    assert all(a == arms[0] for a in arms) and set(arms[0]) == set(D.ARMS)
    assert all(r["adaptive"]["stats"] == dp_tp[0]["adaptive"]["stats"] for r in dp_tp)
