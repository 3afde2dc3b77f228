"""The port's utility sidecars (``llmspeculativesampling_tpu_torch/utils``)
against the JAX package's: ``PhaseTimer``, ``benchmark``'s keys, the
``torch.profiler`` trace on the CPU, ``PowerMonitor``'s API, its energy
rule and its null path, and the ``Decoder`` singleton."""

import inspect
import json
import os
import time

import pytest

from llmspeculativesampling_tpu.utils import decoder as jdec
from llmspeculativesampling_tpu.utils import power as jpow
from llmspeculativesampling_tpu.utils import profiling as jprof
from llmspeculativesampling_tpu_torch import utils as tutils
from llmspeculativesampling_tpu_torch.utils import decoder as tdec
from llmspeculativesampling_tpu_torch.utils import power as tpow
from llmspeculativesampling_tpu_torch.utils import profiling as tprof
from _torch_port import one_thread  # noqa: F401


def test_phase_timer_accumulates():
    timer = tprof.PhaseTimer()
    for _ in range(2):
        with timer.phase("draft"):
            time.sleep(0.01)
    with pytest.raises(ValueError):
        with timer.phase("verify"):
            raise ValueError("the phase still counts")
    totals = timer.as_dict()
    assert set(totals) == {"draft", "verify"} and totals["draft"] >= 0.02
    totals["draft"] = 0.0
    assert timer.as_dict()["draft"] >= 0.02  # a copy
    assert set(totals) == set(_jax_timer_keys())


def _jax_timer_keys():
    timer = jprof.PhaseTimer()
    with timer.phase("draft"):
        pass
    try:
        with timer.phase("verify"):
            raise ValueError
    except ValueError:
        pass
    return timer.as_dict()


@pytest.mark.parametrize("tokens", [None, 16])
def test_benchmark_keys_match_jax(tokens):
    calls = []
    got = tprof.benchmark(lambda: calls.append(1), repeats=3, warmup=2, tokens_per_call=tokens)
    ref = jprof.benchmark(lambda: None, repeats=3, warmup=2, tokens_per_call=tokens)
    assert set(got) == set(ref) and len(calls) == 5 and got["repeats"] == 3
    assert got["best_s"] <= got["mean_s"] <= got["worst_s"]
    assert (inspect.signature(tprof.benchmark).parameters.keys()
            == inspect.signature(jprof.benchmark).parameters.keys())


def test_trace_writes_a_chrome_trace_on_cpu(tmp_path):
    import torch

    out = tmp_path / "prof"
    with tprof.trace(str(out)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(out)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(out / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    got = tprof.benchmark(lambda: torch.ones(8).sum(), repeats=2, warmup=0,
                          trace_dir=str(tmp_path / "bench"))
    assert got["repeats"] == 2 and len(os.listdir(tmp_path / "bench")) == 1


def test_power_monitor_api_and_energy_rule():
    names = ("start", "stop", "total_energy", "samples", "interval")
    for cls in (tpow.PowerMonitor, jpow.PowerMonitor):
        mon = cls(interval=0.5)
        assert all(hasattr(mon, n) for n in names)
    assert (inspect.signature(tpow.PowerMonitor.total_energy).parameters.keys()
            == inspect.signature(jpow.PowerMonitor.total_energy).parameters.keys())
    samples = [(0.5, 100.0), (1.5, 50.0), (2.5, 70.0), (3.5, 90.0), (9.0, 1e6)]
    got, ref = tpow.PowerMonitor(interval=1.0), jpow.PowerMonitor(interval=1.0)
    got.samples, ref.samples = list(samples), list(samples)
    for t1, t2 in ((0.0, 4.0), (1.0, 4.0), (1.0, 2.0), (0.0, 10.0), (3.0, 3.1)):
        assert got.total_energy(t1, t2) == ref.total_energy(t1, t2)
    assert got.total_energy(0.0, 4.0) == 50.0 + 70.0 + 90.0  # the first sample skipped


def test_power_monitor_null_path():
    """With no nvidia-smi and no RAPL counters the monitor samples nothing
    and reports 0 J; a present nvidia-smi that answers nothing falls back."""
    mon = tpow.PowerMonitor(interval=0.01)
    mon._smi, mon._rapl, mon.source = None, [], None
    mon.start()
    time.sleep(0.05)
    mon.stop()
    assert mon.samples == [] and mon.total_energy(0.0, time.time() + 1) == 0.0
    broken = tpow.PowerMonitor(interval=0.01)
    broken._smi, broken._rapl, broken.source = "/nonexistent/nvidia-smi", [], "nvidia-smi"
    assert broken._read_watts() is None and broken.source is None


def test_power_monitor_reads_rapl(tmp_path):
    counter = tmp_path / "energy_uj"
    counter.write_text("1000000")
    mon = tpow.PowerMonitor(interval=0.01)
    mon._smi, mon._rapl, mon.source = None, [str(counter)], "rapl"
    assert mon._read_watts() is None  # the first read sets the baseline
    time.sleep(0.05)
    counter.write_text("3000000")
    assert mon._read_watts() > 0


def test_decoder_singleton():
    class Tok:
        def encode(self, text, **kw):
            return [ord(c) for c in text]

        def decode(self, ids, **kw):
            return "".join(chr(i) for i in ids)

    a, b = tdec.Decoder(), tdec.Decoder()
    assert a is b and tutils.Decoder is tdec.Decoder
    assert tdec.Singleton._instances is not jdec.Singleton._instances
    assert tdec.Decoder() is not jdec.Decoder()
    saved = a.tokenizer
    try:
        a.set_tokenizer(Tok())
        assert b.decode(b.encode("hi")) == "hi"
    finally:
        a.set_tokenizer(saved)
    assert set(tutils.__all__) == set(__import__(
        "llmspeculativesampling_tpu.utils", fromlist=["__all__"]).__all__)
