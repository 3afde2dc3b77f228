"""The device-resident generation loop of ``speculative_generate`` and
``autoregressive_generate`` (counterpart of JAX's ``_spec_generate_device``
and ``_ar_generate_device``, whose ``lax.while_loop`` runs the whole
generation as one device program).

A generation's state lives on the device (:class:`SpecState`,
:class:`ARState`): every field is a static buffer that one step updates in
place (``copy_``, ``scatter_``, ``add_``), so a step is a function of
tensors only, with no host read. A step taken once the state is finished
(``done``, or ``cur_len`` at its budget) changes nothing the caller reads:
``lax.while_loop``'s ``cond``, written as masking, because a replayed graph
cannot skip itself.

:func:`run` drives the steps:

* on the CPU (the tests), and under a ``tp_mesh`` (a gloo collective cannot
  be captured), it calls the step eagerly and reads ``stop`` once a step;
* on the card it captures the step once into a ``torch.cuda.CUDAGraph``
  per static key (the params, gamma, the buffer length, the sampling
  config, EOS, the dtypes) and replays it until ``stop``. The first step of
  a new entry runs eagerly on a side stream (B2's ticket counters grow, B1's
  library loads, the allocator settles): it is the generation's real first
  step. The host reads ``stop`` one step behind: it enqueues replay k+1,
  then waits on an event for step k's flag, copied into pinned memory, so at
  most one masked step is spent a generation. A capture that fails raises;
  nothing falls back to the eager loop.

The prompt's prefill stays eager (its length varies) and writes into the
entry's static caches. An entry holds strong references to the params it
captured (and to B2's ticket counters), so no tensor a graph points at is
freed while the graph lives; :func:`release_graphs` drops every entry, and
at most ``MAX_ENTRIES`` are kept, the least recently used going first.
Replacing a tensor inside a param dict that a graph was captured on is not
seen by that graph: pass a new dict.

The kernel wrappers count their launches in Python, so a replay would count
nothing: :func:`run` records each counter's delta during the capture (which
launches nothing) and adds it on every replay.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import OrderedDict
from typing import Callable, Optional

import torch

from ..ops.sampling import row_keys

MAX_ENTRIES = 4
_ENTRIES: "OrderedDict[tuple, _Entry]" = OrderedDict()
_FORCE_EAGER = [0]
# seconds of each capture, oldest first (chip_smoke.py and the profile read them)
capture_seconds: list = []


@dataclasses.dataclass
class SpecState:
    """A speculative generation on the device (JAX ``SpecState``)."""

    tokens: torch.Tensor        # [1, T] int64
    cur_len: torch.Tensor       # [] int32: committed positions
    total: torch.Tensor         # [] int32: prompt length + max_new_tokens
    draft_cache: object         # a contiguous cache with per-row device lengths [1]
    target_cache: object
    key: torch.Tensor           # [1, 2] int64 counter-stream key (ops/sampling.py::row_keys)
    fixed_r: Optional[torch.Tensor]  # [1, gamma] f32 accept uniforms (random_seed), or None
    done: torch.Tensor          # [] bool: EOS among the committed tokens
    accepted: torch.Tensor      # [] int32 accepted drafts
    resamples: torch.Tensor     # [] int32 reject-resample steps
    bonus: torch.Tensor         # [] int32 all-accept bonus steps
    steps: torch.Tensor         # [] int32 = target_call_times = approx_call_times
    acc_rate_sum: torch.Tensor  # [] f32 sum of min(1, p/q) over the drafted tokens
    acc_len_hist: torch.Tensor  # [max_new_tokens] int32 accepted drafts a step
    stop: torch.Tensor          # [] bool: done or cur_len >= total (what the host reads)


@dataclasses.dataclass
class ARState:
    """An autoregressive generation on the device (the carry of JAX's
    ``_ar_generate_device`` loop)."""

    tokens: torch.Tensor        # [1, T] int64
    cur_len: torch.Tensor       # [] int32
    total: torch.Tensor         # [] int32
    cache: object               # per-row device lengths [1]
    key: torch.Tensor           # [1, 2] int64
    last_logits: torch.Tensor   # [1, V] f32: the logits the next token is drawn from
    done: torch.Tensor          # [] bool: EOS drawn
    stop: torch.Tensor          # [] bool


@dataclasses.dataclass
class _Entry:
    state: object
    refs: tuple                 # what the graph points into: params, counters
    graph: Optional[torch.cuda.CUDAGraph] = None
    deltas: tuple = ()          # launches a replay makes, per counted wrapper
    flags: Optional[torch.Tensor] = None    # [2] pinned host copies of ``stop``
    events: tuple = ()


def scalar(value, dtype, device) -> torch.Tensor:
    return torch.full((), value, dtype=dtype, device=device)


def stream_key(generator: torch.Generator, device) -> torch.Tensor:
    """The key [1, 2] of a generation's counter-based stream
    (``ops/sampling.py::row_keys``), seeded by one 32-bit draw from
    ``generator`` (read on the host, before the loop)."""
    seed = int(torch.randint(0, 1 << 32, (1,), generator=generator, device=generator.device))
    return row_keys(seed, [0], device=device)


def check_positions(bundle, n: int) -> None:
    """A learned position table (OPT's) must hold the ``n`` positions a
    generation's forwards reach: over per-row device lengths the forward
    cannot check them on the host, and the card would assert."""
    if bundle.family == "opt" and n > bundle.cfg.max_position:
        raise ValueError(f"positions up to {n - 1} exceed the learned table of "
                         f"{bundle.cfg.max_position} positions")


def finished(st) -> torch.Tensor:
    """``stop`` of a state whose ``done``/``cur_len`` were just updated."""
    return st.done | (st.cur_len >= st.total)


def scatter_where_(row: torch.Tensor, pos: torch.Tensor, values: torch.Tensor,
                   write: torch.Tensor) -> None:
    """``row[pos] = values`` where ``write``, in place; other positions keep
    their values (a gather of the old ones, so the write is unconditional)."""
    row.scatter_(0, pos, torch.where(write, values.to(row.dtype), row.gather(0, pos)))


def _counted():
    from ..kernels.flash_decode import flash_decode_attention
    from ..kernels.int8_matmul import int8_matmul
    from ..kernels.paged_flash_decode import paged_flash_decode_attention

    return (int8_matmul, flash_decode_attention, paged_flash_decode_attention)


def graph_launches() -> list:
    """(kind, {wrapper: launches one replay makes}) of every captured step,
    least recently used first; ``kind`` is "spec" or "ar"."""
    names = [f.__name__ for f in _counted()]
    return [(key[0], dict(zip(names, e.deltas))) for key, e in _ENTRIES.items()
            if e.graph is not None]


def release_graphs() -> None:
    """Drop every captured step and its state (and with them the references
    to the params they were captured on)."""
    _ENTRIES.clear()


@contextlib.contextmanager
def eager_steps():
    """Within this block :func:`run` calls every step eagerly on the card too,
    reading ``stop`` once a step: the same step function at the host loop's
    pace, which a replay is held against (chip_smoke.py, the profile)."""
    _FORCE_EAGER[0] += 1
    try:
        yield
    finally:
        _FORCE_EAGER[0] -= 1


def _entry(key, refs, build: Callable) -> _Entry:
    entry = _ENTRIES.pop(key, None)
    if entry is None:
        while len(_ENTRIES) >= MAX_ENTRIES:
            _ENTRIES.popitem(last=False)
        entry = _Entry(build(), refs)
    _ENTRIES[key] = entry
    return entry


def _capture(entry: _Entry, step: Callable) -> None:
    from ..kernels import flash_decode

    st = entry.state
    dev = st.tokens.device
    fns = _counted()
    before = [f.launches for f in fns]
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        step(st)
    capture_seconds.append(time.perf_counter() - t0)
    entry.deltas = tuple(f.launches - b for f, b in zip(fns, before))
    for f, b in zip(fns, before):  # the capture launched nothing
        f.launches = b
    entry.graph = graph
    entry.refs = entry.refs + (flash_decode._COUNTERS.get(dev),)
    entry.flags = torch.zeros(2, dtype=torch.bool, pin_memory=True)
    entry.events = (torch.cuda.Event(), torch.cuda.Event())


def _replay(entry: _Entry) -> None:
    entry.graph.replay()
    for f, d in zip(_counted(), entry.deltas):
        f.launches += d


def _run_graph(entry: _Entry, step: Callable, max_steps: int) -> None:
    st = entry.state
    cur = torch.cuda.current_stream(st.tokens.device)
    if entry.graph is None:
        side = torch.cuda.Stream(st.tokens.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            step(st)  # the real first step, eager
        cur.wait_stream(side)
        _capture(entry, step)
    else:
        _replay(entry)
    flags, events = entry.flags, entry.events
    flags[0].copy_(st.stop, non_blocking=True)
    events[0].record(cur)
    for k in range(1, max_steps + 1):
        _replay(entry)
        flags[k % 2].copy_(st.stop, non_blocking=True)
        events[k % 2].record(cur)
        events[(k - 1) % 2].synchronize()
        if bool(flags[(k - 1) % 2]):
            break
    else:
        raise RuntimeError(f"the generation did not finish within {max_steps} steps")
    cur.synchronize()


def run(key, refs: tuple, build: Callable, start: Callable, step: Callable, max_steps: int,
        replay: bool):
    """Run a generation to its end and return its state.

    ``build()`` makes a fresh state; ``start(state)`` prefills the prompt
    into it and resets every field (eagerly); ``step(state)`` advances it one
    step in place and is a no-op on a finished state. At most ``max_steps``
    steps may be needed. ``replay`` (CUDA tensors, no tp collective)
    captures the step under ``key`` (``refs``: what it points into) and
    replays it; otherwise, or inside :func:`eager_steps`, each step runs
    eagerly and ``stop`` is read once a step."""
    with torch.no_grad():
        if not replay or _FORCE_EAGER[0]:
            st = build()
            start(st)
            for _ in range(max_steps + 1):
                if bool(st.stop):
                    return st
                step(st)
            raise RuntimeError(f"the generation did not finish within {max_steps} steps")
        entry = _entry(key, refs, build)
        start(entry.state)
        if max_steps > 0:
            _run_graph(entry, step, max_steps)
        return entry.state
