"""The rank-side cases of ``tests/test_torch_dp.py``, run on gloo ranks by
``llmspeculativesampling_tpu_torch.parallel.launch``. Like
``tests/_torch_tp_cases.py`` (whose tiny models they share), this module
imports torch and the port only, takes numpy in and gives numpy back; the
test file holds the JAX side and the one-process references."""

import torch

from llmspeculativesampling_tpu_torch.core.convert import params_from_numpy
from llmspeculativesampling_tpu_torch.parallel import comm
from llmspeculativesampling_tpu_torch.parallel.distributed import host_fetch
from llmspeculativesampling_tpu_torch.parallel.sharding import DP_AXIS, NamedSharding, make_mesh
from llmspeculativesampling_tpu_torch.serve.multihost import MultiHostDriver, PagedMultiHostDriver
from llmspeculativesampling_tpu_torch.serve.paged import PagedEngine

import _torch_tp_cases as T

# JAX's test_dp_sharded_paged_engine (tests/test_parallel.py:417-450)
PROMPTS = [list(range(5, 15)), list(range(30, 42)), list(range(50, 61)), list(range(70, 79))]
PAGED = dict(batch_rows=4, num_blocks=16, page=32, gamma=2, eos_token_id=-1, temperature=1.0,
             top_k=10, top_p=0.9, seed=3, prompt_bucket=16, steps_per_sync=2,
             max_pages_per_req=4)
NEW = 6
ARMS = (2, 3)
ROUNDS = 6


def llama_pair(pt_np: dict, kv_quant: bool = False):
    """(bundle_d, params_d, bundle_t, params_t) from JAX's target params."""
    pt = params_from_numpy(pt_np, device="cpu")
    return (T.bundle("llama", {**T.LLAMA, "num_layers": 1}), T.draft_of("llama", pt),
            T.bundle("llama", T.LLAMA, kv_quant), pt)


def paged_engine(pair, mesh=None, **kw) -> PagedEngine:
    bd, pd, bt, pt = pair
    return PagedEngine(bd, pd, bt, pt, mesh=mesh, device="cpu", **{**PAGED, **kw})


def serve(eng, prompts=PROMPTS, new: int = NEW) -> list:
    rids = [eng.submit(p, new) for p in prompts]
    eng.run_until_idle()
    return [eng.result(r).output_ids for r in rids]


RECOVER_NEW = 16


def paged_driver(pair, mesh=None, batch_cap: int = 2) -> PagedMultiHostDriver:
    return PagedMultiHostDriver(paged_engine(pair, mesh), prompt_cap=32, batch_cap=batch_cap)


def slot_driver(mesh=None) -> MultiHostDriver:
    return MultiHostDriver(T.serving_engine("slots", "llama", mesh), prompt_cap=64)


def drive_paged(drv, new: int = NEW, rounds=None) -> list:
    """Rank 0 submits; every rank runs ``rounds`` rounds (all when None)."""
    rids = [drv.submit(p, new) for p in PROMPTS] if drv.is_primary else list(range(len(PROMPTS)))
    if rounds is None:
        drv.run_until_idle()
    else:
        for _ in range(rounds):
            drv.round()
    return rids


def drive_slots(drv) -> list:
    rids = [drv.submit(p, 8) for p in PROMPTS] if drv.is_primary else list(range(len(PROMPTS)))
    for _ in range(ROUNDS):
        drv.round()
    return rids


def adaptive_run(pair, mesh) -> dict:
    """JAX's test_dp_sharded_paged_engine_adaptive_gamma, with 8 requests:
    the arm of every chunk, the controller's stats and the completions."""
    eng = paged_engine(pair, mesh, adaptive_gamma=ARMS)
    arms = []
    dispatch = eng._dispatch_chunk

    def logged():
        pack = dispatch()
        arms.append(eng._chunk_log[-1][0])
        return pack

    eng._dispatch_chunk = logged
    rids = [eng.submit(list(range(5, 15)), 10) for _ in range(8)]
    eng.run_until_idle()
    outs = [eng.result(r) for r in rids]
    return {"arms": arms, "stats": eng.adaptive_stats(), "gamma": eng.gamma,
            "generated": [c.details["tokens_generated"] for c in outs]}


def _shard_free(eng) -> list:
    return [a.available_blocks == a.num_blocks for a in eng._allocs]


def prefix_run(pair, mesh) -> dict:
    """The int8 pool with the prefix cache at dp=2 (JAX's
    test_dp_sharded_paged_engine_int8_and_prefix, plus where hits land). A
    40-token prompt A has one full page. A alone lands on shard 0 and
    registers there; A behind two requests that fill shard 0's rows lands
    on shard 1 and misses; A alone again hits in shard 0."""
    eng = paged_engine(pair, mesh, kv_quant=True, prefix_cache=True)
    a, b, c = list(range(5, 45)), list(range(50, 90)), list(range(100, 140))
    out = {"rows": [], "cached": [], "generated": []}

    def run(reqs):
        rids = [eng.submit(p, n) for p, n in reqs]
        eng._prepare_chunk()  # admitted: the rows they took
        out["rows"].append([next(i for i, r in enumerate(eng._row_req)
                                 if r is not None and r.rid == rid) for rid in rids])
        eng.run_until_idle()
        for rid in rids:
            done = eng.result(rid)
            out["cached"].append(done.details["prefix_cached_tokens"])
            out["generated"].append(done.details["tokens_generated"])
        out.setdefault("hits", []).append([al.hits for al in eng._allocs])

    run([(a, NEW)])
    run([(b, 20), (c, 20), (a, NEW)])
    run([(a, NEW)])
    out["free"] = _shard_free(eng)
    return out


def admission_run(pair, mesh) -> dict:
    """A request whose worst case commits all 4 of shard 0's pages, then a
    short one: shard 0 still has a free row but no room, so the short one
    is admitted on shard 1 (JAX ``_admit``'s shard loop)."""
    eng = paged_engine(pair, mesh, num_blocks=8)
    x = eng.submit(list(range(2, 62)), 60)
    y = eng.submit(list(range(70, 80)), NEW)
    eng._prepare_chunk()  # admitted: the rows they took
    rows = [None if r is None else r.rid for r in eng._row_req]
    eng.run_until_idle()
    return {"rows": rows, "x": x, "y": y, "outs": [eng.result(x).output_ids,
                                                   eng.result(y).output_ids],
            "free": _shard_free(eng)}


PREEMPT_REQS = [(list(range(5, 45)), 50), (list(range(50, 90)), 50),
                (list(range(100, 110)), 50), (list(range(120, 130)), 50)]


def preempt_run(pair, mesh) -> dict:
    """Overcommit 2 on 4-block shards: requests 0 and 1 (shard 0) grow to 3
    pages each and run shard 0 dry, while requests 2 and 3 (shard 1, the
    youngest overall) fit their pool. Every victim is shard 0's youngest."""
    eng = paged_engine(pair, mesh, num_blocks=8, overcommit=2.0)
    victims = []
    preempt = eng._preempt_row

    def logged(row):
        victims.append((row, eng._row_req[row].rid))
        preempt(row)

    eng._preempt_row = logged
    rids = [eng.submit(p, n) for p, n in PREEMPT_REQS]
    eng.run_until_idle()
    return {"victims": victims, "preemptions": eng.preemptions,
            "outs": [eng.result(r).output_ids for r in rids], "free": _shard_free(eng)}


def fetch_case(mesh) -> dict:
    """``host_fetch`` of dp-split tensors (rows, a second axis, bool)."""
    d = mesh.dp_rank
    rows = torch.arange(6).reshape(3, 2) + 100 * d
    cols = torch.arange(6).reshape(2, 3) + 100 * d
    flags = torch.tensor([d == 0, True, d == 1])
    for x, spec in ((rows, (DP_AXIS, None)), (cols, (None, DP_AXIS)), (flags, (DP_AXIS,))):
        x.sharding = NamedSharding(mesh, spec)
    plain = torch.arange(4)  # no placement: local
    return host_fetch({"rows": rows, "cols": cols, "flags": flags, "plain": [plain]})


def _record_order(eng, read_name: str) -> list:
    """Log each chunk's dispatch ("D", k) and metadata read ("R", k) of
    ``eng`` (chunks numbered by dispatch; a read takes the oldest unread)."""
    log, unread = [], []
    dispatch, read = eng._dispatch_chunk, getattr(eng, read_name)

    def d():
        unread.append(sum(1 for e in log if e[0] == "D") + 1)
        log.append(("D", unread[-1]))
        return dispatch()

    def r(*a):
        log.append(("R", unread.pop(0)))
        return read(*a)

    eng._dispatch_chunk = d
    setattr(eng, read_name, r)
    return log


def pipeline_case(pt_np: dict) -> dict:
    """Both engines' pipelined ``run_until_idle`` at dp=2 x tp=1: the
    completions and this rank's order of chunk dispatches and reads."""
    mesh = make_mesh(2, 1)
    eng = paged_engine(llama_pair(pt_np), mesh)
    order = _record_order(eng, "_meta_np")
    out = {"paged": {"outs": serve(eng), "order": order}}
    eng = T.serving_engine("slots", "llama", mesh)
    order = _record_order(eng, "_collect")
    rids = [eng.submit(p, 6) for p in T.SERVE_PROMPTS]
    eng.run_until_idle()
    out["slotted"] = {"outs": [eng.result(r).output_ids for r in rids], "order": order}
    return out


def dp_case(pt_np: dict) -> dict:
    """Everything at dp=2 x tp=1 on two ranks, and adaptive gamma at dp=1 x
    tp=2 on the same two: every rank returns what it holds."""
    mesh, tp_mesh = make_mesh(2, 1), make_mesh(1, 2)
    pair = llama_pair(pt_np)
    out = {"shard": mesh.dp_rank}
    eng = paged_engine(pair, mesh)
    comm.reset_counts()
    rids = [eng.submit(p, NEW) for p in PROMPTS]
    chunks = eng.run_until_idle()
    out["counts"] = {op: list(c) for op, c in comm.COUNTS.items()}
    out["chunks"] = chunks
    out["paged_llama"] = [eng.result(r).output_ids for r in rids]
    out["paged_greedy"] = serve(paged_engine(pair, mesh, top_k=1))
    out["paged_opt"] = serve(paged_engine(T.tiny_pair("opt"), mesh))
    out["slots"] = {fam: T.serve_all("slots", fam, mesh) for fam in ("llama", "opt")}
    out["prefix"] = prefix_run(llama_pair(pt_np, kv_quant=True), mesh)
    out["admission"] = admission_run(pair, mesh)
    out["preempt"] = preempt_run(pair, mesh)
    out["adaptive_dp"] = adaptive_run(pair, mesh)
    out["adaptive_tp"] = adaptive_run(pair, tp_mesh)
    out["fetch"] = fetch_case(mesh)

    drv = slot_driver(mesh)
    rids = drive_slots(drv)
    out["slot_driver"] = {"rows": host_fetch(drv.engine.state.tokens),
                          "completions": {r: drv.result(r).output_ids for r in rids}}
    drv = paged_driver(pair, mesh)
    rids = drive_paged(drv)
    out["paged_driver"] = {"rows": host_fetch(drv.engine.state.tokens),
                           "completions": {r: drv.result(r).output_ids for r in rids}}
    # recovery: after one round, the rows of both shards drained into
    # resumable requests (rank 0, as after a lost peer), finished on a
    # fresh one-process engine
    drv = paged_driver(pair, mesh, batch_cap=len(PROMPTS))
    rids = drive_paged(drv, RECOVER_NEW, rounds=1)
    pre = {r: drv.result(r) for r in rids}
    if drv.is_primary:
        drv.failed = True
        rec = drv.recover_requests()
        fresh = paged_engine(pair)
        for req in rec:
            fresh.submit_request(req)
        fresh.run_until_idle()
        out["recovered"] = {"resumed": sorted(r.rid for r in rec if r.carry),
                            "completions": {r: (pre[r] or fresh.result(r)).output_ids
                                            for r in rids}}
    return out


def dp_tp_case(pt_np: dict) -> dict:
    """dp=2 x tp=2 on four ranks: the paged engine's completions, the
    collectives it issued, and adaptive gamma's arms."""
    mesh = make_mesh(2, 2)
    pair = llama_pair(pt_np)
    eng = paged_engine(pair, mesh)
    comm.reset_counts()
    rids = [eng.submit(p, NEW) for p in PROMPTS]
    chunks = eng.run_until_idle()
    return {"coords": mesh.coords, "chunks": chunks,
            "counts": {op: list(c) for op, c in comm.COUNTS.items()},
            "paged_llama": [eng.result(r).output_ids for r in rids],
            "rows": host_fetch(eng.state.tokens),
            "adaptive": adaptive_run(pair, mesh)}
