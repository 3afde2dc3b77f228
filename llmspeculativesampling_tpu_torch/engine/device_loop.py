"""The device-resident generation loop of ``speculative_generate``,
``autoregressive_generate``, ``speculative_generate_v2``,
``multi_speculative_generate`` (iid and beam), ``mjsd_generate``,
``random_width_beam_generate``, ``beam_speculative_generate``,
``beam_speculative_v2_generate`` and ``bild_generate`` (counterpart of
JAX's ``_spec_generate_device``, ``_ar_generate_device``,
``_spec_v2_device``, ``_multi_device``, ``_beam_spec_device``,
``_random_beam_device``, ``_beam_tree_device`` and ``_bild_device``, whose
``lax.while_loop`` runs the whole generation as one device program), and
the captured step of the serving engines' chunks (:func:`serve_chunk`, the
counterpart of the ``lax.while_loop`` inside JAX's serving chunks).

A generation's state lives on the device (:class:`SpecState`,
:class:`ARState`, :class:`WinnerState`, random beam's, the tree engines'
and BiLD's): every field is a
static buffer that one step updates in place (``copy_``, ``scatter_``,
``add_``), so a step is a function of tensors only, with no host read. A
step taken once the state is finished (``done``, or ``cur_len`` at its
budget) changes nothing the caller reads: ``lax.while_loop``'s ``cond``,
written as masking, because a replayed graph cannot skip itself.

:func:`run` drives the steps:

* on the CPU (the tests), and under a ``tp_mesh`` (a gloo collective cannot
  be captured), it calls the step eagerly and reads ``stop`` once a step;
* on the card it captures the step once into a ``torch.cuda.CUDAGraph``
  per static key (the engine, the param leaves, gamma, the buffer length,
  the sampling config, EOS, ...) and replays it until ``stop``. The first
  step of a new entry runs eagerly on a side stream (B2's ticket counters
  grow, B1's library loads, the allocator settles): it is the generation's
  real first step. The host reads ``stop`` one step behind: it enqueues
  replay k+1, then waits on an event for step k's flag, copied into pinned
  memory, so at most one masked step is spent a generation. A capture that
  fails raises; nothing falls back to the eager loop.

:func:`serve_chunk` drives a serving engine's chunk the same way over the
engine's own static state: up to ``steps_per_sync`` replays of one captured
step, each writing a device ``live`` flag (some row active and not done)
that the host reads one step behind, so a chunk whose rows have all
finished spends at most one masked step, and the last step stays in flight
when the call returns (the engines' one-deep pipeline harvests the
previous chunk meanwhile). Its entries are keyed on the identities of the
state's buffers and the param leaves, and dropped when either is collected.
:func:`run_once` replays a graph over static buffers once a call (the paged
engine's admission prefill, whose entries the engine keeps, outside the
LRU below).

The prompt's prefill stays eager (its length varies) and writes into the
entry's static caches. An entry is keyed on the identities of the param
leaves its graph reads (JAX's jit reads the leaves it is given), so a leaf
replaced in a dict gets a new capture, while an in-place ``copy_`` into a
leaf is read by the old graph. The entry holds those leaves by weak
reference only: when one is collected, the entry and its graph go with it,
so a pair the caller drops is freed and no graph outlives a tensor it
points at. It holds B2's ticket counters strongly. :func:`release_graphs`
drops every entry, and at most ``MAX_ENTRIES`` are kept, the least
recently used going first (an evicted step is captured again when next
run).

The kernel wrappers count their launches in Python, so a replay would count
nothing: :func:`run` records each counter's delta during the capture (which
launches nothing) and adds it on every replay.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
import weakref
from collections import OrderedDict
from typing import Callable, Optional

import torch

from ..ops.sampling import row_keys
from ..utils.profiling import span
from .types import first_eos_truncate

# the ten generation kinds (spec, AR, spec v2, multi, multi-beam, MJSD,
# random beam, beam v1, beam v2, BiLD) run in a row without thrashing, with
# room for a serving engine's captured chunk steps (one per gamma arm and
# prefill width). A generation's entry holds its state and its graph's pool:
# 0.15-1.32 GiB on an H100 at the 13B-int8 pair's tree settings (beam v1's,
# with its 4-row target cache, the most); a serving entry its pool only
MAX_ENTRIES = 16
_ENTRIES: "OrderedDict[tuple, _Entry]" = OrderedDict()
_FORCE_EAGER = [0]
# seconds of each capture, oldest first (chip_smoke.py and the profile read them)
capture_seconds: list = []
# the steps the last run called or replayed (its masked last replay included)
last_steps = [0]
# the last serving chunk's (steps called, masked steps): serve_chunk's
last_chunk = [0, 0]


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
class WinnerState:
    """A multi-candidate generation on the device (the carry of JAX's
    ``_multi_device`` and ``_beam_spec_device`` loops): candidates are
    drafted in the caches' rows, one wins, and the winner's row is
    re-broadcast into every row."""

    tokens: torch.Tensor        # [1, T] int64
    cur_len: torch.Tensor       # [] int32
    total: torch.Tensor         # [] int32
    draft_cache: object         # per-row device lengths: width (multi) or num_beams rows
    target_cache: object        # width rows
    key: torch.Tensor           # [R, 2]: one stream a draft row (multi), or [1, 2]
    fixed_r: Optional[torch.Tensor]  # [width, gamma] f32 accept uniforms, or None
    done: torch.Tensor          # [] bool
    accepted: torch.Tensor      # [] int32
    steps: torch.Tensor         # [] int32
    rate_sum: torch.Tensor      # [] f32: the acc_rate numerator
    acc_len_hist: torch.Tensor  # [max_new_tokens] int32
    stop: torch.Tensor          # [] bool


def winner_state(bundle_d, bundle_t, draft_rows: int, width: int, gamma: int, key_rows: int,
                 max_total: int, max_new: int, fixed: bool, device) -> WinnerState:
    """A zeroed :class:`WinnerState` of ``max_total`` positions."""
    i32 = torch.int32

    def cache(bundle, rows):
        c = bundle.make_cache(rows, max_total, device=device)
        return dataclasses.replace(c, lengths=torch.zeros((rows,), dtype=i32, device=device))

    return WinnerState(
        tokens=torch.zeros((1, max_total), dtype=torch.long, device=device),
        cur_len=scalar(0, i32, device), total=scalar(0, i32, device),
        draft_cache=cache(bundle_d, draft_rows), target_cache=cache(bundle_t, width),
        key=torch.zeros((key_rows, 2), dtype=torch.long, device=device),
        fixed_r=torch.zeros((width, gamma), dtype=torch.float32, device=device) if fixed else None,
        done=scalar(False, torch.bool, device), accepted=scalar(0, i32, device),
        steps=scalar(0, i32, device), rate_sum=scalar(0.0, torch.float32, device),
        acc_len_hist=torch.zeros((max(max_new, 1),), dtype=i32, device=device),
        stop=scalar(False, torch.bool, device),
    )


def winner_start(bundle_d, params_d, bundle_t, params_t, prompt_t, p_len: int, total: int, key,
                 fixed_r, tp_mesh, st: WinnerState) -> None:
    """Reset ``st`` and prefill the padded prompt ``prompt_t`` [1, P] into
    every row of both caches (eager: the bucket varies)."""
    st.tokens.zero_()
    st.tokens[:, :prompt_t.shape[1]] = prompt_t
    for bundle, params, cache in ((bundle_d, params_d, st.draft_cache),
                                  (bundle_t, params_t, st.target_cache)):
        cache.lengths.zero_()
        bundle.forward(params, bundle.cfg, prompt_t.expand(cache.lengths.shape[0], -1), cache,
                       tp_mesh=tp_mesh)
    st.cur_len.fill_(p_len)
    st.total.fill_(total)
    st.key.copy_(key)
    if fixed_r is not None:
        st.fixed_r.copy_(fixed_r)
    for t in (st.done, st.accepted, st.steps, st.rate_sum, st.acc_len_hist):
        t.zero_()
    st.stop.copy_(finished(st))


def commit_winner(st: WinnerState, cur: torch.Tensor, cw: torch.Tensor, active: torch.Tensor,
                  win: torch.Tensor, max_l: torch.Tensor, t: torch.Tensor, rate: torch.Tensor,
                  key: torch.Tensor, eos_token_id: int) -> None:
    """The masked commit of a winner-row step: the winner's ``max_l``
    accepted drafts ``win`` [gamma] and the next token ``t`` at [cw, cw +
    max_l], the counters, the histogram, the key and ``stop``. On a
    finished state (``active`` false) nothing the caller reads changes."""
    gamma = win.shape[0]
    j = torch.arange(gamma + 1, device=cw.device)
    window = torch.where(j < max_l, torch.cat([win, t.reshape(1)]), t)
    write = active & (j <= max_l)
    scatter_where_(st.tokens[0], cw + j, window, write)
    eos_now = (write & (window == eos_token_id)).any()
    col = st.steps.long().clamp(max=st.acc_len_hist.shape[0] - 1).reshape(1)
    scatter_where_(st.acc_len_hist, col, max_l.reshape(1), active)
    st.cur_len.copy_(torch.where(active, cw + max_l + 1, cur))
    st.done.copy_(st.done | (active & eos_now))
    st.accepted.add_(torch.where(active, max_l, torch.zeros_like(max_l)).to(torch.int32))
    st.steps.add_(active.to(torch.int32))
    st.rate_sum.copy_(torch.where(active, st.rate_sum + rate, st.rate_sum))
    st.key.copy_(torch.where(active, key, st.key))
    st.stop.copy_(finished(st))


def winner_result(st: WinnerState, p_len: int, eos_token_id: int):
    """What a finished :class:`WinnerState` returns, in one read: (ids
    int32 [T] cut after the first generated EOS, steps, accepted drafts,
    acc_len list, acc_rate numerator)."""
    tokens = st.tokens.cpu().numpy()
    cur_len, steps, accepted = torch.stack([st.cur_len, st.steps, st.accepted]).tolist()
    out = first_eos_truncate(tokens, p_len, cur_len, eos_token_id).astype("int32")
    return out, steps, accepted, st.acc_len_hist[:steps].tolist(), float(st.rate_sum)


@dataclasses.dataclass
class _Entry:
    state: object
    leaves: list                # weak references to the param leaves the graph reads
    refs: tuple = ()            # what else the graph points into: B2's counters
    graph: Optional[torch.cuda.CUDAGraph] = None
    deltas: tuple = ()          # launches a replay makes, per counted wrapper
    flags: Optional[torch.Tensor] = None    # [2] pinned host copies of ``stop`` / ``live``
    events: tuple = ()
    live: Optional[torch.Tensor] = None     # [] bool a serving step writes


def scalar(value, dtype, device) -> torch.Tensor:
    return torch.full((), value, dtype=dtype, device=device)


def stream_key(generator: torch.Generator, device, rows: int = 1) -> torch.Tensor:
    """The keys [rows, 2] of a generation's counter-based streams
    (``ops/sampling.py::row_keys``), seeded by one 32-bit draw from
    ``generator`` (read on the host, before the loop)."""
    seed = int(torch.randint(0, 1 << 32, (1,), generator=generator, device=generator.device))
    return row_keys(seed, range(rows), device=device)


def param_leaves(*trees) -> list:
    """The tensors of param trees (dicts, lists), depth first."""
    out = []
    for t in trees:
        if isinstance(t, torch.Tensor):
            out.append(t)
        elif isinstance(t, dict):
            out.extend(param_leaves(*t.values()))
        elif isinstance(t, (list, tuple)):
            out.extend(param_leaves(*t))
    return out


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
    from ..kernels.moe_matmul import expert_align, grouped_int8_matmul
    from ..kernels.paged_flash_decode import paged_flash_decode_attention

    return (int8_matmul, flash_decode_attention, paged_flash_decode_attention,
            grouped_int8_matmul, expert_align)


def graph_launches() -> list:
    """(kind, {wrapper: launches one replay makes}) of every captured step,
    least recently used first; ``kind`` is "spec", "ar", "spec_v2", "multi",
    "beam", "mjsd", "random_beam", "beam_v1", "beam_v2" or "bild", or a
    serving engine's "serve_slots" or "serve_paged"."""
    names = [f.__name__ for f in _counted()]
    return [(key[0], dict(zip(names, e.deltas))) for key, e in _ENTRIES.items()
            if e.graph is not None]


def release_graphs() -> None:
    """Drop every captured step and its state."""
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


def entry_key(key, params: tuple) -> tuple:
    """``key`` followed by the identities of the leaves of ``params``."""
    return tuple(key) + tuple(id(t) for t in param_leaves(*params))


def _forget(key, entry_ref, _leaf_ref) -> None:
    """A leaf of the entry under ``key`` was collected: drop that entry (not
    a newer one that took its key)."""
    if _ENTRIES.get(key) is entry_ref():
        _ENTRIES.pop(key, None)


def _entry(key, leaves: list, build: Callable) -> _Entry:
    entry = _ENTRIES.pop(key, None)
    if entry is None:
        while len(_ENTRIES) >= MAX_ENTRIES:
            _ENTRIES.popitem(last=False)
        entry = _Entry(build(), [])
        forget = functools.partial(_forget, key, weakref.ref(entry))
        entry.leaves = [weakref.ref(t, forget) for t in leaves]
    _ENTRIES[key] = entry
    return entry


def _capture(entry: _Entry, fn: Callable, dev, pool=None) -> None:
    """Capture ``fn()`` into the entry's graph (it launches nothing), in
    the memory pool ``pool`` (a private one when None), and record the
    launches a replay makes, per counted wrapper."""
    from ..kernels import flash_decode

    fns = _counted()
    before = [f.launches for f in fns]
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        fn()
    capture_seconds.append(time.perf_counter() - t0)
    entry.deltas = tuple(f.launches - b for f, b in zip(fns, before))
    for f, b in zip(fns, before):  # the capture launched nothing
        f.launches = b
    entry.graph = graph
    entry.refs = (flash_decode._COUNTERS.get(dev),)


def _first_then_capture(entry: _Entry, fn: Callable, dev, pool=None) -> None:
    """A new entry's first step: ``fn()`` eagerly on a side stream (it is a
    real step), then its capture (in ``pool``)."""
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        fn()
    cur.wait_stream(side)
    _capture(entry, fn, dev, pool)


def run_once(entry: _Entry, fn: Callable, dev, replay: bool, pool=None) -> bool:
    """``fn()``, a function of the static buffers the entry's ``state``
    holds, once (the entry is its caller's, outside the LRU). ``replay``
    (CUDA tensors, no collective): replayed from the entry's graph, which
    the first call captures, in ``pool``, after running ``fn()`` eagerly on
    a side stream; the launch counters add a replay's deltas. Otherwise, or
    inside :func:`eager_steps`, eagerly. Graphs that never run at once may
    share a pool (``torch.cuda.graph_pool_handle()``) when nothing they
    allocate outlives a replay. Returns whether it replayed."""
    with torch.no_grad():
        if not replay or _FORCE_EAGER[0]:
            fn()
            return False
        if entry.graph is None:
            _first_then_capture(entry, fn, dev, pool)
            return False
        _replay(entry)
        return True


def _host_flags(entry: _Entry) -> None:
    if entry.flags is None:
        entry.flags = torch.zeros(2, dtype=torch.bool, pin_memory=True)
        entry.events = (torch.cuda.Event(), torch.cuda.Event())


def _replay(entry: _Entry) -> None:
    entry.graph.replay()
    for f, d in zip(_counted(), entry.deltas):
        f.launches += d


def _run_graph(entry: _Entry, step: Callable, max_steps: int) -> None:
    st = entry.state
    dev = st.stop.device
    cur = torch.cuda.current_stream(dev)
    _host_flags(entry)
    if entry.graph is None:
        _first_then_capture(entry, functools.partial(step, st), dev)
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
    last_steps[0] = k + 1
    cur.synchronize()


def run(key, params: tuple, build: Callable, start: Callable, step: Callable, max_steps: int,
        replay: bool):
    """Run a generation to its end and return its state.

    ``build()`` makes a fresh state; ``start(state)`` prefills the prompt
    into it and resets every field (eagerly); ``step(state)`` advances it one
    step in place and is a no-op on a finished state. At most ``max_steps``
    steps may be needed. ``replay`` (CUDA tensors, no tp collective)
    captures the step under ``key`` and the identities of the leaves of
    ``params`` (the param trees the step reads) and replays it; otherwise,
    or inside :func:`eager_steps`, each step runs eagerly and ``stop`` is
    read once a step. The prefill and the steps are the spans
    ``loop.start`` and ``loop.replay`` (``replays``: :data:`last_steps`)."""
    with torch.no_grad():
        if not replay or _FORCE_EAGER[0]:
            st = build()
            with span("loop.start"):
                start(st)
            with span("loop.replay") as sp:
                _run_eager(st, step, max_steps)
                sp.set(replays=last_steps[0])
            return st
        entry = _entry(entry_key(key, params), param_leaves(*params), build)
        with span("loop.start"):
            start(entry.state)
        last_steps[0] = 0
        if max_steps > 0:
            with span("loop.replay") as sp:
                _run_graph(entry, step, max_steps)
                sp.set(replays=last_steps[0])
        return entry.state


def _run_eager(st, step: Callable, max_steps: int) -> None:
    for k in range(max_steps + 1):
        if bool(st.stop):
            last_steps[0] = k
            return
        step(st)
    raise RuntimeError(f"the generation did not finish within {max_steps} steps")


def serve_chunk(key, leaves: list, step: Callable, live: Callable, n_steps: int,
                replay: bool) -> tuple:
    """Up to ``n_steps`` calls of ``step()``, a serving engine's batched
    step over its static state (in place, a no-op on rows not live), while
    ``live()`` (a device bool: some row active and not done) holds before
    the call. Returns (steps called, masked steps).

    ``replay`` (CUDA tensors, no collective): the step and the flag's
    update are captured once under ``key`` and the identities of
    ``leaves`` (the param leaves and the state's buffers), and replayed;
    the host reads the flag one step behind, so the chunk ends after at
    most one masked step, and the call returns with its last step still
    in flight. Otherwise, or inside :func:`eager_steps`, ``live()`` is
    read before each step and no step is masked. The counts also land in
    :data:`last_chunk`."""
    last_chunk[:] = _serve_chunk(key, leaves, step, live, n_steps, replay)
    return tuple(last_chunk)


def _serve_chunk(key, leaves, step, live, n_steps, replay):
    with torch.no_grad():
        if not replay or _FORCE_EAGER[0]:
            for k in range(n_steps):
                if not bool(live()):
                    return k, 0
                step()
            return n_steps, 0
        entry = _entry(tuple(key) + tuple(id(t) for t in leaves), leaves, lambda: None)
        dev = leaves[0].device
        if entry.live is None:
            entry.live = torch.zeros((), dtype=torch.bool, device=dev)
        _host_flags(entry)
        flag, flags, events = entry.live, entry.flags, entry.events

        def body():
            step()
            flag.copy_(live())

        cur = torch.cuda.current_stream(dev)
        flag.copy_(live())  # admission and harvest changed the rows since the last step
        flags[0].copy_(flag, non_blocking=True)
        events[0].record(cur)
        for k in range(1, n_steps + 1):
            if entry.graph is None:
                _first_then_capture(entry, body, dev)
            else:
                _replay(entry)
            flags[k % 2].copy_(flag, non_blocking=True)
            events[k % 2].record(cur)
            events[(k - 1) % 2].synchronize()
            if not bool(flags[(k - 1) % 2]):
                return k, 1
        return n_steps, 0
