"""A run at a tiny size on the CPU, past the harness's look for a card: sound,
it comes out correct; with the timed path broken underneath (planted when
the window opens), it comes out not correct, once for each fault the cell
can have, and in the single stream's sampling (a skipped nucleus, a
swapped residual). One chip: no exchange between chips to leave out."""

from pathlib import Path

import pytest
import torch

from benchmarks import run
from llmspeculativesampling_tpu_torch.engine import speculative
from llmspeculativesampling_tpu_torch.ops import sampling
from llmspeculativesampling_tpu_torch.ops.sampling import dist_map
from llmspeculativesampling_tpu_torch.serve import paged

TINY = Path(__file__).resolve().parent / "tiny"
SPEC = {"end_to_end": [{"name": "decode_tok_s", "unit": "tokens/s", "workloads": ["tiny.decode"]},
                       {"name": "batch_tok_s", "unit": "tokens/s", "workloads": ["tiny.batch"]},
                       {"name": "tpot_p90_ms", "unit": "ms", "workloads": ["tiny.batch"]},
                       {"name": "setup_s", "unit": "s"}], "per_layer": []}
VOCAB = 512


class PlantAtWindow:
    """A tracer whose window start plants ``fault`` (a callable taking the
    monkeypatch fixture)."""

    def __init__(self, fault, monkeypatch):
        self.fault, self.mp = fault, monkeypatch

    def warm(self):
        pass

    def start(self):
        if self.fault is not None:
            self.fault(self.mp)

    def stop(self):
        pass

    def read(self):
        return None


def _run(name, fault, monkeypatch, seed=7):
    from benchmarks import trace

    cell = run.load_cell(name, seed, 1.5, False, torch.device("cpu"), base=TINY)
    monkeypatch.setattr(trace, "Tracer", lambda enabled, spans: PlantAtWindow(fault, monkeypatch))
    return run.run_cell(cell, SPEC)[0]


def state_unchanged_single(mp):
    mp.setattr(speculative, "_spec_step", lambda *a, **k: None)


def token_altered_single(mp):
    orig = speculative.accept_rows_core

    def altered(*a, **k):
        t, n, all_acc, acc = orig(*a, **k)
        return (t + 1) % VOCAB, n, all_acc, acc
    mp.setattr(speculative, "accept_rows_core", altered)


def nucleus_skipped_single(mp):
    """Top-p left out of the sampled requests' filter: tokens past the
    nucleus are served."""
    mp.setattr(sampling, "_nucleus", lambda probs, top_p: probs)


def residual_swapped_single(mp):
    """The rejection's residual taken as max(q - p) instead of max(p - q)."""
    mp.setattr(speculative, "dist_residual", lambda p, q: sampling.dist_residual(q, p))


def state_unchanged_batch(mp):
    mp.setattr(paged, "_paged_spec_step", lambda *a, **k: a[7])  # the state, untouched


def token_altered_batch(mp):
    orig = paged.accept_rows

    def altered(*a, **k):
        tokens, new_len, n, all_acc, acc, keys = orig(*a, **k)
        col = (new_len - 1).clamp(0, tokens.shape[1] - 1)[:, None]
        tokens = tokens.scatter(1, col, (tokens.gather(1, col) + 1) % VOCAB)
        return tokens, new_len, n, all_acc, acc, keys
    mp.setattr(paged, "accept_rows", altered)


def half_rows_left_out(mp):
    orig = paged.verify_phase_batched

    def half(*a, **k):
        p_stack, cache = orig(*a, **k)

        def copy_first_half(x):
            h = x.shape[0] // 2
            return torch.cat([x[:x.shape[0] - h], x[:h]])
        return dist_map(copy_first_half, p_stack), cache
    mp.setattr(paged, "verify_phase_batched", half)


@pytest.mark.parametrize("name", ["tiny.decode", "tiny.batch"])
def test_sound_run_is_correct(name, monkeypatch):
    res = _run(name, None, monkeypatch)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("name,fault", [
    ("tiny.decode", state_unchanged_single),
    ("tiny.decode", token_altered_single),
    ("tiny.decode", nucleus_skipped_single),
    ("tiny.decode", residual_swapped_single),
    ("tiny.batch", state_unchanged_batch),
    ("tiny.batch", token_altered_batch),
    ("tiny.batch", half_rows_left_out),
])
def test_fault_is_not_correct(name, fault, monkeypatch):
    res = _run(name, fault, monkeypatch)
    assert not res["correct"], res["checks"]
