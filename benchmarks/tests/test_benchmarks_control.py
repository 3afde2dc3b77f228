"""The control at a size a test run holds: the plain reference in float8
activations put in the program's place fails the check that the program
passes. At the tiny size, with 800 served tokens checked, the batch cell
separates the two on every seed tried (control 0.91-1.53 against at most
0.06 over seeds 1-8; limit 0.5), the single stream's does not (0.10 on one
seed of six; its sampled draws 0.0-1.64 against the program's 0.0 on seeds
1-10), so the kept case is the batch cell's. On the card,
``test_control_on_card`` reads both at each cell's own size
(``benchmarks/control.py``): the control has to fail one of the cell's
numbers."""

from pathlib import Path

import pytest
import torch

from benchmarks import check, run, trace

TINY = Path(__file__).resolve().parent / "tiny"
CELLS = ["opt13b.decode_spec", "opt30b.batch_prefill", "opt30b.batch_decode"]


def _read(name, seed, device, base=None, seconds=1.5):
    kw = {} if base is None else {"base": base}
    cell = run.load_cell(name, seed, seconds, False, device, **kw)
    spans = trace.Spans()
    outcome = run.driver(cell.workload["driver"]).run(cell, trace.Tracer(False, spans), spans)
    chosen = check.sample(outcome.answers, cell.workload["check"], seed)
    return cell, check.gaps(outcome.pair, chosen, device, control=True)


@pytest.mark.parametrize("name,seed", [("tiny.batch", 2), ("tiny.batch", 5)])
def test_control_fails_where_the_program_passes(name, seed):
    cell, got = _read(name, seed, torch.device("cpu"), TINY, seconds=5.0)
    limit = cell.workload["check"]["logit_gap_limit"]
    assert got["served_checked"] >= cell.workload["check"]["min_served"]
    assert got["logit_gap"] <= limit < got["control_gap"], got


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_on_card(name, card):
    for seed in (11, 12, 13):
        cell, got = _read(name, seed, card, seconds=20.0)
        chk = cell.workload["check"]
        assert got["logit_gap"] <= chk["logit_gap_limit"], (seed, got)
        failed = [got["control_gap"] > chk["logit_gap_limit"]]
        if "sample_gap_limit" in chk:
            assert got["sample_gap"] <= chk["sample_gap_limit"], (seed, got)
            failed.append(got["control_sample_gap"] > chk["sample_gap_limit"])
        assert any(failed), (seed, got)
