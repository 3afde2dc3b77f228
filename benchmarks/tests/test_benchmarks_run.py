"""The run path: the result line's keys, no run without a card, and the
import guard."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmarks import run

ROOT = Path(__file__).resolve().parents[2]


def test_result_line_has_exactly_the_result_keys():
    checks = {"logit_gap": {"value": 0.01, "limit": 0.1}}
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
              "memory_peak_bytes": 1}
    plain = run.result_line(True, 3, 0, {"x": {"value": 1.5, "unit": "ms"}}, device, checks)
    assert list(plain) == list(run.RESULT_KEYS) + ["checks"]
    traced = run.result_line(False, 3, 1, {}, dict(device, busy_s=1.0, window_s=2.0), checks,
                             {"device_ops": [["k", 0.5]], "idle_gaps": [["harvest", 0.1]]})
    assert list(traced) == list(run.RESULT_KEYS) + ["breakdown", "checks"]
    assert json.loads(json.dumps(traced)) == traced


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "opt13b.decode_spec", "--seed", "1", "--seconds", "1",
                  "--trace", "0"])
    assert e.value.code == 2
    assert capsys.readouterr().out == ""


def test_fewer_cards_than_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(SystemExit) as e:
        run.require_card(1)
    assert e.value.code == 2


def test_command_without_a_card_exits_nonzero():
    out = subprocess.run([sys.executable, "benchmarks/run.py", "--workload",
                          "opt13b.decode_spec", "--seed", "5", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "llmspeculativesampling_tpu_torch_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]


_GUARD = r"""
import importlib, sys
from pathlib import Path
sys.path.insert(0, {root!r})
import benchmarks.run as run
for p in sorted(Path({root!r}, "benchmarks", "drivers").glob("*.py")):
    importlib.import_module("benchmarks.drivers." + p.stem)
for p in sorted(Path({root!r}, "benchmarks", "metrics").glob("*.py")):
    run.reader(p.stem)
import benchmarks.control, benchmarks.check, benchmarks.trace
found = run.forbidden_modules()
assert not found, found
assert "llmspeculativesampling_tpu_torch" in {{m.split(".")[0] for m in sys.modules}}
print("ok")
"""

_REFERENCE = r"""
import json, sys
from pathlib import Path
sys.path.insert(0, {root!r})
import benchmarks.check, benchmarks.weights, benchmarks.roofline
from benchmarks import families
for p in sorted(Path({root!r}, "benchmarks", "configs").glob("*.json")):
    families.family(json.loads(p.read_text())).reference
tops = {{m.split(".")[0] for m in sys.modules}}
bad = tops & {{"jax", "jaxlib", "flax", "llmspeculativesampling_tpu", "llmspeculativesampling_tpu_torch"}}
assert not bad, bad
print("ok")
"""


def test_import_guard():
    for code in (_GUARD, _REFERENCE):
        out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
