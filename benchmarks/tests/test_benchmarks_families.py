"""The model-family lookup: the OPT family gives the weights and readings the
harness gave before families existed, a configuration without a family
fails with the path it looked for, and a family that is a new file (OPT
under another ``model_type``) is built, bundled, served, checked and read
with no other file touched."""

import hashlib
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmarks import check, families, run, trace, weights

ROOT = Path(__file__).resolve().parents[2]
TINY = Path(__file__).resolve().parent / "tiny"
CONFIGS = ROOT / "benchmarks" / "configs"
B1 = "void (anonymous namespace)::w8a16_kernel<16, __nv_bfloat16>(CUtensorMap_st)"
B2 = "void (anonymous namespace)::flash_decode_kernel<128, __nv_bfloat16, false, Contig>"
B3 = "void (anonymous namespace)::flash_decode_kernel<128, signed char, true, Paged>((an"

# Counts of a single-stream and a serving window, and the readers' values on
# them at OPT-13B's and OPT-30B's widths, read with the harness as it was
# before the lookup (``weights.widths``, OPT's projections in the roofline).
SINGLE = {"segment_s": 2.0625, "steps": 41, "new_tokens": 355,
          "needed_tokens": {"target": 4127, "draft": 4127},
          "w8a16": {"target": {"exact": {9: 41, 187: 1, 402: 1}, "pooled": []},
                    "draft": {"exact": {2: 41, 1: 287, 187: 1, 402: 1}, "pooled": []}},
          "attention": {"target": {"rows": 41, "prefix": 12345, "new": 369,
                                   "new_x_prefix": 111105, "causal": 1845},
                        "draft": {"rows": 328, "prefix": 98701, "new": 369,
                                  "new_x_prefix": 99999, "causal": 451}},
          "attention_family": "b2", "kv_dtype": "bfloat16"}
BATCH = {"segment_s": 4.375, "steps": 96, "chunks": 12,
         "needed_tokens": {"target": 30123, "draft": 30123},
         "w8a16": {"target": {"exact": {}, "pooled": [(96, 23040), (7, 5889)]},
                   "draft": {"exact": {}, "pooled": [(384, 23040), (7, 5889)]}},
         "attention": {"target": {"rows": 4608, "prefix": 1843211, "new": 23040,
                                  "new_x_prefix": 9216055, "causal": 69120},
                       "draft": {"rows": 18432, "prefix": 7372844, "new": 23040,
                                 "new_x_prefix": 7372844 + 4608 * 300, "causal": 27648}},
         "attention_family": "b3", "kv_dtype": "int8"}
BEFORE = {
    ("opt13b_int8_pair", "b1_roofline"): 17.087607064358693,
    ("opt13b_int8_pair", "step_mfu"): 5.212762421863774,
    ("opt13b_int8_pair", "attn_roofline"): 1.6756300417910446,
    ("opt30b_int8_pair", "b1_roofline"): 86.71210189388161,
    ("opt30b_int8_pair", "step_mfu"): 41.79841201291777,
    ("opt30b_int8_pair", "attn_roofline"): 69.60197600477613,
}
# sha256 of the tiny pair's tensors (role, key path, bytes), as built before
# the lookup
TINY_SHA = {3: "3446fb2bc32c86fb7643956f0d91af466154d43bbdafbae0a968875051c427d9",
            2**31 + 17: "23503fec371d3b2bfe5fefc67184fdc5cfb8c0907759e7ff0cfe87f6b06e5115"}


def _trace(b1_ns, b2_ns, b3_ns):
    events = [(0, b1_ns, B1), (b1_ns, b1_ns + b2_ns, B2),
              (b1_ns + b2_ns, b1_ns + b2_ns + b3_ns, B3)]
    return trace.Trace(events, 0, b1_ns + b2_ns + b3_ns, trace.Spans(), trace.load_families())


def _config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        yield from _leaves(v, f"{prefix}{k}.") if isinstance(v, dict) else [(prefix + k, v)]


@pytest.mark.parametrize("config,metric", sorted(BEFORE))
def test_readers_read_as_before(config, metric):
    cfg = _config(config)
    counts, tr = ((SINGLE, _trace(10**9, 2 * 10**8, 0)) if config == "opt13b_int8_pair"
                  else (BATCH, _trace(2 * 10**9, 0, 6 * 10**8)))
    ctx = SimpleNamespace(counts=counts, trace=tr, widths=families.family(cfg).widths(cfg))
    assert run.reader(metric).read(ctx) == BEFORE[(config, metric)]


@pytest.mark.parametrize("seed", sorted(TINY_SHA))
def test_opt_family_builds_the_frozen_weights(seed):
    cfg = json.loads((TINY / "configs" / "tiny_opt_pair.json").read_text())
    fam = families.family(cfg)
    got = fam.build(cfg, seed, torch.device("cpu"))
    want = weights.build(cfg, seed, torch.device("cpu"))
    h = hashlib.sha256()
    for role in ("draft", "target"):
        a, b = list(_leaves(got[role])), list(_leaves(want[role]))
        assert [k for k, _ in a] == [k for k, _ in b]
        for (key, x), (_, y) in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y), (role, key)
            h.update(f"{role}.{key}".encode())
            h.update(x.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == TINY_SHA[seed]
    for role, w in got["widths"].items():
        assert w == dict(want["widths"][role], kv_heads=w["heads"], family="opt")


def test_a_configuration_without_model_type_names_the_path(tmp_path):
    with pytest.raises(ValueError, match=str(tmp_path / "families")):
        families.family({"name": "bare", "hidden_size": 8}, tmp_path)


def test_an_unknown_model_type_names_the_paths(tmp_path):
    with pytest.raises(FileNotFoundError) as e:
        families.family({"name": "x", "model_type": "no_such_family"}, tmp_path)
    msg = str(e.value)
    assert str(tmp_path / "families" / "no_such_family.py") in msg
    assert str(ROOT / "benchmarks" / "families" / "no_such_family.py") in msg


STUB = '''"""OPT under another model_type, recording which of its parts ran."""
from types import SimpleNamespace

from benchmarks.families import opt

FAMILY = "stub_opt"
CALLED = set()


def widths(cfg):
    return {role: dict(w, family=FAMILY) for role, w in opt.widths(cfg).items()}


def build(cfg, seed, device):
    CALLED.add("build")
    pair = opt.build(cfg, seed, device)
    pair["widths"] = widths(cfg)
    return pair


def bundles(pair, kv_quant):
    CALLED.add("bundles")
    return opt.bundles(pair, kv_quant)


def _final_hidden(params, w, seqs, act_quant=None):
    CALLED.add("reference")
    return opt.reference.final_hidden(params, w, seqs, act_quant)


reference = SimpleNamespace(setup_precision=opt.reference.setup_precision,
                            head_weight=opt.reference.head_weight,
                            final_hidden=_final_hidden, logits=opt.reference.logits)


def projections(w, m):
    CALLED.add("projections")
    return opt.projections(w, m)
'''


@pytest.fixture
def stub_base(tmp_path):
    """A base holding the stub family and the tiny cells on a copy of the
    tiny configuration that names it; nothing of the harness is touched."""
    (tmp_path / "families").mkdir()
    (tmp_path / "families" / "stub_opt.py").write_text(STUB)
    (tmp_path / "configs").mkdir()
    cfg = json.loads((TINY / "configs" / "tiny_opt_pair.json").read_text())
    cfg.update(name="tiny_stub_pair", model_type="stub_opt")
    (tmp_path / "configs" / "tiny_stub_pair.json").write_text(json.dumps(cfg))
    (tmp_path / "workloads").mkdir()
    for cell in ("tiny.decode", "tiny.batch"):
        w = json.loads((TINY / "workloads" / f"{cell}.json").read_text())
        w["config"] = "tiny_stub_pair"
        (tmp_path / "workloads" / f"{cell}.json").write_text(json.dumps(w))
    yield tmp_path
    sys.modules.pop("benchmarks.families.stub_opt", None)


@pytest.mark.parametrize("name", ["tiny.decode", "tiny.batch"])
def test_a_new_family_is_new_files(name, stub_base):
    harness = sorted(p.relative_to(ROOT) for p in (ROOT / "benchmarks").rglob("*.py"))
    cell = run.load_cell(name, 6, 1.5, False, torch.device("cpu"), base=stub_base)
    spans = trace.Spans()
    out = run.driver(cell.workload["driver"]).run(cell, trace.Tracer(False, spans), spans)
    stub = sys.modules["benchmarks.families.stub_opt"]
    assert Path(stub.__file__) == stub_base / "families" / "stub_opt.py"
    assert {w["family"] for w in out.pair["widths"].values()} == {"stub_opt"}
    chk = cell.workload["check"]
    measured = check.gaps(out.pair, check.sample(out.answers, chk, cell.seed), cell.device)
    correct, checks = check.judge(measured, chk, out.failed)
    assert correct, checks
    ctx = SimpleNamespace(counts=out.counts, trace=_trace(10**9, 10**8, 10**8),
                          widths=out.pair["widths"])
    for metric in ("b1_roofline", "step_mfu", "attn_roofline"):
        assert run.reader(metric).read(ctx) > 0, metric
    assert stub.CALLED == {"build", "bundles", "reference", "projections"}
    assert sorted(p.relative_to(ROOT) for p in (ROOT / "benchmarks").rglob("*.py")) == harness
