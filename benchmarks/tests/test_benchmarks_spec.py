"""BENCHMARK.json, the configuration and workload files, and the files the
harness finds by name."""

import json
import re
from pathlib import Path

import pytest

from benchmarks import run, trace

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]

# facebook/opt-13b and facebook/opt-30b config.json
PUBLISHED = {
    "opt13b_int8_pair": dict(hidden_size=5120, ffn_dim=20480, num_hidden_layers=40,
                             num_attention_heads=40, vocab_size=50272,
                             max_position_embeddings=2048, do_layer_norm_before=True,
                             activation_function="relu", word_embed_proj_dim=5120),
    "opt30b_int8_pair": dict(hidden_size=7168, ffn_dim=28672, num_hidden_layers=48,
                             num_attention_heads=56, vocab_size=50272,
                             max_position_embeddings=2048, do_layer_norm_before=True,
                             activation_function="relu", word_embed_proj_dim=7168),
}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmarks"]
    assert SPEC["command"] == ["python3", "benchmarks/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)


def test_names_units_and_lengths():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += CELLS + [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for entry in SPEC["workloads"] + SPEC["configs"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for m in SPEC["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200


def test_end_to_end_bounds():
    names = {m["name"] for m in SPEC["end_to_end"]}
    assert {"decode_tok_s", "doc_tok_s", "batch_tok_s", "tpot_p90_ms", "setup_s"} == names
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_and_metrics(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    c = run.load_cell(cell, 1, 1, False, None)
    assert entry["config"] == c.workload["config"] and entry["chips"] == c.workload["chips"] == 1
    assert entry["why"] == c.workload["why"]
    assert (ROOT / "benchmarks" / "drivers" / f"{c.workload['driver']}.py").exists()
    e2e = run.cell_metrics(SPEC, cell, "end_to_end")
    if c.workload["driver"] == "batch_backlog":
        assert c.workload["rate_metric"] in [m["name"] for m in e2e]
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    layers = run.cell_metrics(SPEC, cell, "per_layer")
    assert layers
    for m in layers:
        assert m["moves"] in [e["name"] for e in e2e]
        assert callable(run.reader(m["name"]).read)


def test_per_layer_metrics_list_their_cells():
    assert all(m.get("workloads") for m in SPEC["per_layer"])
    bare = {"end_to_end": SPEC["end_to_end"],
            "per_layer": [{k: v for k, v in SPEC["per_layer"][0].items() if k != "workloads"}]}
    with pytest.raises(ValueError):
        run.cell_metrics(bare, CELLS[0], "per_layer")


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_configs_keep_published_widths(name):
    entry = next(c for c in SPEC["configs"] if c["name"] == name)
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert entry["reduced"] == cfg["reduced"] == []
    for key, value in PUBLISHED[name].items():
        assert cfg[key] == value, key
    d = cfg["assumed"]["draft"]
    assert cfg["hidden_size"] % d["hidden_size"] == 0
    assert cfg["hidden_size"] // cfg["num_attention_heads"] == d["hidden_size"] // d[
        "num_attention_heads"] == 128


def test_kernel_families():
    fams = trace.load_families()
    assert {"b1", "b2", "b3"} <= set(fams)
    b1 = "void (anonymous namespace)::w8a16_kernel<16, __nv_bfloat16>(CUtensorMap_st)"
    b2 = "void (anonymous namespace)::flash_decode_kernel<128, __nv_bfloat16, false, Contig>"
    b3 = "void (anonymous namespace)::flash_decode_kernel<128, signed char, true, Paged>((an"
    assert trace.in_family(b1, fams["b1"]) and not trace.in_family(b1, fams["b2"])
    assert trace.in_family(b2, fams["b2"]) and not trace.in_family(b2, fams["b3"])
    assert trace.in_family(b3, fams["b3"]) and not trace.in_family(b3, fams["b2"])
    assert trace.in_family("void splitk_reduce_kernel<__nv_bfloat16>", fams["b1"])
