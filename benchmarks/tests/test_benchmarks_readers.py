"""The metric readers and the trace's arithmetic on made-up counts and
events, and the counts a CPU run of the tiny cells hands them."""

from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmarks import roofline, run, trace

W = {"target": dict(hidden=256, ffn=1024, layers=8, heads=2, kv_heads=2, head_dim=128, vocab=512,
                  family="opt"),
     "draft": dict(hidden=128, ffn=512, layers=2, heads=1, kv_heads=1, head_dim=128, vocab=512,
                   family="opt")}
FAMS = {"b1": [([__import__("re").compile("w8a16")], [])]}


def _trace(events, t0=0, t1=1000, spans=()):
    sp = trace.Spans()
    sp.spans = list(spans)
    return trace.Trace(events, t0, t1, sp, FAMS)


def test_union_idle_and_gaps():
    tr = _trace([(100, 300, "w8a16_kernel"), (200, 400, "w8a16_kernel"), (600, 700, "copy")],
                spans=[(0, 500, "run_until_idle"), (500, 1000, "harvest")])
    assert tr.busy_s() == pytest.approx(400e-9)
    assert tr.family_s("b1") == pytest.approx(300e-9) and tr.family_s("b9") is None
    assert run.reader("device_idle.batch").read(SimpleNamespace(trace=tr)) == pytest.approx(60.0)
    gaps = dict(tr.idle_gaps())
    assert gaps == {"harvest": pytest.approx(500e-9), "run_until_idle": pytest.approx(100e-9)}
    assert tr.device_ops()[0] == ["w8a16_kernel", pytest.approx(400e-9)]


def test_readers_on_counts():
    counts = {"segment_s": 2.0, "steps": 40, "new_tokens": 320, "chunks": 4,
              "needed_tokens": {"target": 1000, "draft": 1000},
              "w8a16": {"target": {"exact": {9: 40}, "pooled": [(2, 512)]},
                        "draft": {"exact": {1: 280}, "pooled": []}},
              "attention": {"target": {"rows": 40, "prefix": 4000, "new": 360,
                                       "new_x_prefix": 36000, "causal": 1800},
                            "draft": {"rows": 0, "prefix": 0, "new": 0, "new_x_prefix": 0,
                                      "causal": 0}},
              "attention_family": "b1", "kv_dtype": "bfloat16"}
    tr = _trace([(0, 10**9, "w8a16_kernel")], 0, 2 * 10**9)
    ctx = SimpleNamespace(counts=counts, trace=tr, widths=W)
    assert run.reader("step_ms.decode").read(ctx) == pytest.approx(50.0)
    assert run.reader("chunk_ms.batch").read(ctx) == pytest.approx(500.0)
    assert run.reader("accept_len.decode").read(ctx) == pytest.approx(8.0)
    flops = 1000 * (roofline.model_flops_per_token(W["target"])
                    + roofline.model_flops_per_token(W["draft"]))
    assert run.reader("step_mfu.decode").read(ctx) == pytest.approx(100 * flops / (989e12 * 2))
    least = (40 * roofline.w8a16_forward_time(W["target"], 9)
             + roofline.w8a16_forwards_time(W["target"], 2, 512)
             + 280 * roofline.w8a16_forward_time(W["draft"], 1))
    assert run.reader("b1_roofline.decode").read(ctx) == pytest.approx(100 * least / 1.0)
    t = W["target"]
    nbytes = 4000 * roofline.kv_bytes_per_position(t, "bfloat16") + 360 * 2 * 128 * 2 * 4
    want = 8 * roofline.least_time(nbytes, 4.0 * 2 * 128 * (36000 + 1800))
    assert run.reader("attn_roofline.decode").read(ctx) == pytest.approx(100 * want)
    assert run.reader("b1_roofline.batch").read(SimpleNamespace(counts={}, trace=None)) is None


@pytest.mark.parametrize("name", ["tiny.decode", "tiny.batch"])
def test_cpu_run_counts(name):
    from benchmarks import trace as tr_mod

    cell = run.load_cell(name, 4, 1.5, False, torch.device("cpu"),
                         base=Path(__file__).resolve().parent / "tiny")
    spans = tr_mod.Spans()
    out = run.driver(cell.workload["driver"]).run(cell, tr_mod.Tracer(False, spans), spans)
    c = out.counts
    gamma = cell.workload["engine"]["gamma"]
    ctx = SimpleNamespace(counts=c, trace=None, widths=out.pair["widths"])
    assert 1.0 <= run.reader("accept_len.decode").read(ctx) <= gamma + 1
    assert run.reader("step_mfu.batch").read(ctx) > 0
    assert c["attention"]["target"]["rows"] > 0
    for t in c["attention"].values():
        # the rows themselves agree with the linear sums
        rows = t["shapes"].items()
        assert sum(n for _, n in rows) == t["rows"]
        assert sum(n * p for (p, _), n in rows) == t["prefix"]
        assert sum(n * s for (_, s), n in rows) == t["new"]
        assert sum(n * s * p for (p, s), n in rows) == t["new_x_prefix"]
        assert sum(n * s * (s + 1) // 2 for (_, s), n in rows) == t["causal"]
    assert c["needed_tokens"]["target"] == c["needed_tokens"]["draft"]
    # the W8A16 work the window needed, whatever the program's calls: a B1
    # trace time at least the least time reads a share in (0, 100]
    least = sum(n * roofline.w8a16_forward_time(out.pair["widths"][role], m)
                for role, calls in c["w8a16"].items() for m, n in calls["exact"].items())
    least += sum(roofline.w8a16_forwards_time(out.pair["widths"][role], f, m)
                 for role, calls in c["w8a16"].items() for f, m in calls["pooled"])
    assert least > 0
    ns = int(least * 2e9)
    ctx.trace = _trace([(0, ns, "w8a16_kernel")], 0, ns)
    assert 0 < run.reader("b1_roofline.batch").read(ctx) <= 100
    if "chunks" in c:
        assert c["steps"] >= c["chunks"] > 0 and c["row_steps"] > 0
