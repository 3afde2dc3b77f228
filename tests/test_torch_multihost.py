"""The port's lockstep drivers (``serve/multihost.py``) on two gloo ranks
(``parallel/launch.py``, the cases in ``tests/_torch_tp_cases.py``): the
counterparts of tests/test_multihost_lockstep.py.

* Replicated and tp-sharded ``MultiHostDriver``: both ranks end with the
  same slot token rows, and rank 0's completions equal a one-process
  driver's (the tp-sharded one's equal the unsharded one-process run).
* ``PagedMultiHostDriver`` over a tp-sharded ``PagedEngine``: both ranks
  hold the same completions, equal to a one-process driver's.
* The kill drill: rank 1 dies mid-run; rank 0 raises ``WorkerLostError``
  within the heartbeat, and ``recover_requests`` hands back the running,
  pending and unreleased requests with their submit times; a fresh engine
  finishes them with the outputs of an unfailed run.
* A failed broadcast consumes nothing; a host-side error inside ``step()``
  is not taken for a lost peer.
"""

import numpy as np
import pytest

from llmspeculativesampling_tpu_torch.parallel.comm import CollectiveError
from llmspeculativesampling_tpu_torch.parallel.launch import RankExit, launch
from llmspeculativesampling_tpu_torch.serve import multihost

import _torch_tp_cases as C
from _torch_port import one_thread  # noqa: F401 (fixture)

RANK_LIMIT_S = 120.0


def _one_process_slots():
    drv = C.slot_driver()
    rids = [drv.submit(p, 8) for p in C.DRIVER_PROMPTS]
    for _ in range(C.ROUNDS):
        drv.round()
    return {r: drv.result(r).output_ids for r in rids}


def _one_process_paged(prompts, new_tokens):
    drv = C.paged_driver()
    rids = [drv.submit(p, new_tokens) for p in prompts]
    drv.run_until_idle()
    return {r: drv.result(r).output_ids for r in rids}


@pytest.mark.parametrize("mode", ["slots", "slots_tp"])
def test_slot_driver_lockstep(mode):
    ranks = launch("_torch_tp_cases:lockstep_case", 2, (mode,), timeout_s=RANK_LIMIT_S, device="cpu")
    np.testing.assert_array_equal(ranks[0]["rows"], ranks[1]["rows"])
    want = _one_process_slots()
    assert sorted(ranks[0]["completions"]) == sorted(want)
    for r in ranks:  # rank 1 harvests the same completions under the broadcast rids
        for rid, ids in want.items():
            np.testing.assert_array_equal(r["completions"][rid], ids)


def test_paged_driver_lockstep_tp():
    ranks = launch("_torch_tp_cases:lockstep_case", 2, ("paged_tp",), timeout_s=RANK_LIMIT_S, device="cpu")
    assert ranks[0]["rounds"] == ranks[1]["rounds"]
    want = _one_process_paged(C.SERVE_PROMPTS, 6)
    for r in ranks:
        assert sorted(r["completions"]) == sorted(want)
        for rid, ids in want.items():
            np.testing.assert_array_equal(r["completions"][rid], ids)


def test_worker_death_recovery():
    ranks = launch("_torch_tp_cases:kill_case", 2, timeout_s=RANK_LIMIT_S, device="cpu",
                   allow_exit=True)
    assert ranks[1] == RankExit(1, 17)
    res = ranks[0]
    assert res["rounds"] == C.KILL_AFTER_ROUNDS
    assert res["detect_s"] is not None and res["detect_s"] < C.HEARTBEAT_S
    rec = res["recovered"]
    assert any(carry for _, carry, _, _ in rec), "a running row resumes with its progress"
    unreleased = [(rid, t, t0) for rid, _, t, t0 in rec if t0 is not None]
    assert unreleased and all(t == t0 for _, t, t0 in unreleased), "submit times kept"
    assert sorted(res["pre_done"] + [rid for rid, _, _, _ in rec]) == list(range(len(C.KILL_PROMPTS)))
    want = _one_process_paged(C.KILL_PROMPTS, 16)
    assert sorted(res["completions"]) == sorted(want)
    for rid, ids in want.items():
        np.testing.assert_array_equal(res["completions"][rid], ids)


# --------------------------------------------------------- failure semantics

def test_failed_broadcast_consumes_nothing(monkeypatch):
    drv = C.paged_driver()
    rids = [drv.submit(p, 6) for p in C.SERVE_PROMPTS]

    def lost(tree, timeout_s=None):
        raise multihost.WorkerLostError("peer gone")

    monkeypatch.setattr(multihost, "_broadcast", lost)
    with pytest.raises(multihost.WorkerLostError):
        drv.round()
    assert drv.failed and [q[0] for q in drv._queue] == rids
    assert not drv.engine._pending and not drv.engine.num_active
    with pytest.raises(multihost.WorkerLostError, match="degraded"):
        drv.round()
    assert [r.rid for r in drv.recover_requests()] == rids


@pytest.mark.parametrize("error,lost", [(ValueError("bad request"), False),
                                        (RuntimeError("engine capacity"), False),
                                        (CollectiveError("all_reduce failed"), True)])
def test_only_transport_errors_in_step_are_peer_loss(monkeypatch, error, lost):
    """With peers (a process count above 1), a collective's failure inside
    ``step()`` is a lost peer; a host-side error surfaces as itself."""
    drv = C.paged_driver()
    drv.submit(C.SERVE_PROMPTS[0], 6)
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "_broadcast", lambda tree, timeout_s=None: tree)

    def step():
        raise error

    monkeypatch.setattr(drv.engine, "step", step)
    with pytest.raises(multihost.WorkerLostError if lost else type(error)):
        drv.round()
    assert drv.failed == lost
