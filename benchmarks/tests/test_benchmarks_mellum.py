"""The Mellum 2 family through the harness at a tiny size on the CPU (past
the harness's look for a card): its weights, the port's Mellum model and
the plain reference (``benchmarks/reference/mellum.py``) through the
``batch_backlog`` driver and ``check.py``. A sound run comes out correct;
each way of getting the architecture wrong, planted when the window opens,
comes out not correct: window layers reading the whole prefix, one expert
fewer a token (top-7 at the published size), the expert weights left
unnormalised, YaRN's attention factor dropped, and (in the damped layers
only) routes past the first k experts moved to the next expert. The
reference in float8 activations, put in the program's place, reads above
the limit that the program passes. The new readers read the counts a traced run
keeps."""

from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmarks import check, run, trace
from benchmarks.tests.test_benchmarks_faults import PlantAtWindow
from llmspeculativesampling_tpu_torch.models import llama, mellum, moe

TINY = Path(__file__).resolve().parent / "tiny"
SPEC = {"end_to_end": [{"name": "doc_tok_s", "unit": "tokens/s"},
                       {"name": "tpot_p90_ms", "unit": "ms"},
                       {"name": "setup_s", "unit": "s"}], "per_layer": []}
CELL = "tiny.mellum"


def _run(fault, monkeypatch, seed=7):
    cell = run.load_cell(CELL, seed, 1.5, False, torch.device("cpu"), base=TINY)
    monkeypatch.setattr(trace, "Tracer", lambda enabled, spans: PlantAtWindow(fault, monkeypatch))
    return run.run_cell(cell, SPEC)[0]


def windows_read_everything(mp):
    mp.setattr(mellum, "_window", lambda cfg, li: None)


def one_expert_fewer(mp):
    route = moe.route
    mp.setattr(moe, "route", lambda logits, k, norm: route(logits, k - 1, norm))


def weights_unnormalised(mp):
    route = moe.route
    mp.setattr(moe, "route", lambda logits, k, norm: route(logits, k, False))


def experts_past_top_k_moved(mp):
    """Each route to an expert past the first k lands on the next of them
    (a tile-to-expert map off by one there): the layers that hold the
    draft route only to experts below k, so only the damped layers see it."""
    route = moe.route

    def moved(logits, k, norm):
        w, ids = route(logits, k, norm)
        e = logits.shape[-1]
        return w, torch.where(ids >= k, k + (ids - k + 1) % (e - k), ids)
    mp.setattr(moe, "route", moved)


def yarn_factor_dropped(mp):
    def tables(positions, head_dim, theta, scaling=None, max_position=0):
        if scaling is not None and scaling[0] == "yarn":
            scaling = scaling[:5] + (1.0,)
        return llama.rope_tables(positions, head_dim, theta, scaling, max_position)
    mp.setattr(mellum, "rope_tables", tables)


@pytest.mark.parametrize("seed", [7, 2**31 + 17])
def test_sound_run_is_correct(seed, monkeypatch):
    res = _run(None, monkeypatch, seed)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"doc_tok_s", "tpot_p90_ms", "setup_s"}


@pytest.mark.parametrize("fault", [windows_read_everything, one_expert_fewer,
                                   weights_unnormalised, yarn_factor_dropped,
                                   experts_past_top_k_moved])
def test_fault_is_not_correct(fault, monkeypatch):
    res = _run(fault, monkeypatch)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("seed", [2, 5])
def test_control_fails_where_the_program_passes(seed):
    cell = run.load_cell(CELL, seed, 3.0, False, torch.device("cpu"), base=TINY)
    spans = trace.Spans()
    out = run.driver(cell.workload["driver"]).run(cell, trace.Tracer(False, spans), spans)
    chk = cell.workload["check"]
    got = check.gaps(out.pair, check.sample(out.answers, chk, seed), cell.device, control=True)
    assert got["served_checked"] >= chk["min_served"]
    assert got["logit_gap"] <= chk["logit_gap_limit"] < got["control_gap"], got


def test_new_readers_read_a_traced_window(monkeypatch):
    """``step_mfu.code``, ``moe_roofline``, ``attn_roofline.code`` and
    ``expert_skew`` on the counts of a tiny window, a synthetic trace of
    one B1, one B3 and one B4 kernel, and the routed totals the program
    kept over the run."""
    cell = run.load_cell(CELL, 3, 1.5, False, torch.device("cpu"), base=TINY)
    spans = trace.Spans()
    out = run.driver(cell.workload["driver"]).run(cell, trace.Tracer(False, spans), spans)
    names = ["void (anonymous namespace)::w8a16_kernel<16, __nv_bfloat16>(CUtensorMap_st)",
             "void (anonymous namespace)::flash_decode_kernel<128, __nv_bfloat16, signed char, "
             "true, (anonymous namespace)::Paged, true>",
             "void (anonymous namespace)::expert_matmul_kernel<64, float>(CUtensorMap_st)"]
    events = [(i * 10**9, (i + 1) * 10**9, n) for i, n in enumerate(names)]
    tr = trace.Trace(events, 0, 3 * 10**9, trace.Spans(), trace.load_families())
    assert tr.family_s("b1") == tr.family_s("b3") == tr.family_s("b4") == 1.0
    ctx = SimpleNamespace(counts=out.counts, trace=tr, widths=out.pair["widths"])
    for name in ("step_mfu.code", "moe_roofline.code", "attn_roofline.code", "b1_roofline.code"):
        value = run.reader(name).read(ctx)
        assert value is not None and 0 < value < 100, (name, value)
    assert run.reader("step_mfu.code").read(ctx) > run.reader("step_mfu").read(ctx)
    assert run.reader("attn_roofline.code").read(ctx) < run.reader("attn_roofline").read(ctx)
    routed = out.pair["widths"]["routed_rows"]
    assert routed is out.pair["target"]["routed_rows"]
    assert int(routed.sum()) > 0 and not routed[:, 0].eq(routed.sum(dim=1)).all()
    skew = run.reader("expert_skew.code").read(ctx)
    assert 1.0 <= skew <= routed.shape[1], skew
    even, one_hot = torch.full_like(routed[0], 4), torch.ones_like(routed[0])
    one_hot[0] = 1 + routed.shape[1]  # the mean is 2, the busiest 2 + E - 1
    routed.copy_(torch.stack([even, one_hot] * (routed.shape[0] // 2)))
    want = (1.0 + (1 + routed.shape[1]) / 2) / 2
    assert run.reader("expert_skew.code").read(ctx) == pytest.approx(want)
    assert run.reader("expert_skew.code").read(SimpleNamespace(trace=tr, widths={})) is None


@pytest.mark.card
@pytest.mark.parametrize("fault", [windows_read_everything, one_expert_fewer,
                                   weights_unnormalised, yarn_factor_dropped,
                                   experts_past_top_k_moved])
def test_fault_is_not_correct_on_card(fault, card, monkeypatch):
    """The cell at its published widths with a fault planted before its
    set-up, so that the captured steps hold it too: not correct."""
    cell = run.load_cell("mellum2.code_batch", 2**31 + 101, 10.0, False, card)
    fault(monkeypatch)
    res = run.run_cell(cell, SPEC)[0]
    print(f"[fault {fault.__name__}] {res['checks']}")
    assert not res["correct"], res["checks"]


def test_config_keeps_the_published_keys():
    """The configuration holds Mellum2-12B-A2.5B-Instruct's published
    config as it is (``reduced`` empty), and the family reads it so."""
    import json

    from benchmarks import families

    cfg = json.loads((Path(run.HERE) / "configs" / "mellum2_12b_int8_pair.json").read_text())
    published = {"hidden_size": 2304, "intermediate_size": 7168, "moe_intermediate_size": 896,
                 "num_hidden_layers": 28, "num_attention_heads": 32, "num_key_value_heads": 4,
                 "head_dim": 128, "num_experts": 64, "num_experts_per_tok": 8,
                 "norm_topk_prob": True, "sliding_window": 1024, "vocab_size": 98304,
                 "rms_norm_eps": 1e-6, "tie_word_embeddings": False, "model_type": "mellum",
                 "layer_types": (["sliding_attention"] * 3 + ["full_attention"]) * 7}
    assert cfg["reduced"] == []
    for key, value in published.items():
        assert cfg[key] == value, key
    full = cfg["rope_parameters"]["full_attention"]
    assert (full["rope_type"], full["rope_theta"], full["factor"],
            full["original_max_position_embeddings"], full["beta_fast"], full["beta_slow"]) == (
        "yarn", 500000, 16, 8192, 32, 1)
    w = families.family(cfg).widths(cfg)
    assert w["target"]["layers"] == 28 and w["target"]["experts"] == 64
    assert w["draft"]["layer_types"] == ["sliding_attention", "full_attention"]
    assert w["draft"]["hidden"] == w["target"]["hidden"] and w["draft"]["ffn"] == 7168
