"""Serving endpoint (counterpart of ``llmspeculativesampling_tpu/serve/server.py``).

A stdlib ``ThreadingHTTPServer`` with ``POST /predict`` (JSON, ids in and
ids out, optional SSE streaming with ``"stream": true``), ``GET /health``
and ``GET /stats`` (request counts, tokens/s, TTFT and latency p50/p95 over
the last 1024 requests, and the card's memory from ``torch.cuda``).

Two front ends, as in the JAX package: :class:`InferenceServer` runs one
request at a time through ``speculative_generate`` under a lock;
:class:`BatchedInferenceServer` puts an engine with the scheduler interface
behind concurrent requests: the slotted ``ContinuousBatchingEngine``
(``--num_slots N``), or the paged engine (``--paged``).
``InferenceServer.from_pretrained`` loads two local checkpoint directories
(Llama, Qwen2, Mistral or OPT; local files only) or the synthetic pair.

    python -m llmspeculativesampling_tpu_torch.serve.server --num_slots 16 --max_total_len 256
    python -m llmspeculativesampling_tpu_torch.serve.server --paged --kv_quant
"""

from __future__ import annotations

import argparse
import collections
import json
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ..core.config import resolve_device
from ..engine.speculative import speculative_generate
from ..engine.types import ModelBundle


@dataclass
class ServerConfig:
    num_tokens: int = 40
    top_k: int = 10
    top_p: float = 0.9
    temperature: float = 1.0
    gamma: int = 4
    eos_token_id: int = 2


@dataclass
class ServerStats:
    requests: int = 0
    tokens_generated: int = 0
    total_time_s: float = 0.0
    window: int = 1024            # last-N window for the percentiles
    _ttfts: collections.deque = None
    _lats: collections.deque = None
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def __post_init__(self):
        self._ttfts = collections.deque(maxlen=self.window)
        self._lats = collections.deque(maxlen=self.window)

    def record(self, tokens: int, dt: float, ttft_s: Optional[float] = None):
        with self._lock:
            self.requests += 1
            self.tokens_generated += tokens
            self.total_time_s += dt
            self._lats.append(dt)
            if ttft_s is not None:
                self._ttfts.append(ttft_s)

    @staticmethod
    def _pct(xs, q):
        return round(float(np.percentile(list(xs), q)), 4) if xs else None

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "requests": self.requests,
                "tokens_generated": self.tokens_generated,
                "total_time_s": round(self.total_time_s, 3),
                "tokens_per_s": round(self.tokens_generated / self.total_time_s, 2)
                if self.total_time_s else 0.0,
                # TTFT comes from the batching engine's admission stamps and
                # is null on the lock-serialized single-request path
                "ttft_p50_s": self._pct(self._ttfts, 50),
                "ttft_p95_s": self._pct(self._ttfts, 95),
                "latency_p50_s": self._pct(self._lats, 50),
                "latency_p95_s": self._pct(self._lats, 95),
            }


def _prompt_ids(request: dict, tokenizer) -> np.ndarray:
    if "prompt_ids" in request:
        return np.asarray(request["prompt_ids"], np.int32).reshape(-1)
    if tokenizer is None:
        raise ValueError("text prompt requires a tokenizer; send prompt_ids")
    return np.asarray(tokenizer.encode(request["prompt"]), np.int32)


def _local_tokenizer(path: str):
    """The tokenizer saved in ``path``, from local files only, or None where
    ``transformers`` is absent or the directory holds none."""
    try:
        from transformers import AutoTokenizer
    except ImportError:
        return None
    try:
        return AutoTokenizer.from_pretrained(path, local_files_only=True)
    except (OSError, ValueError, TypeError):  # TypeError: a config naming absent vocab files
        return None


class InferenceServer:
    """One request at a time through ``speculative_generate``."""

    def __init__(self, bundle_d: ModelBundle, params_d, bundle_t: ModelBundle, params_t,
                 tokenizer=None, config: Optional[ServerConfig] = None, seed: int = 0,
                 device=None):
        self.bundle_d, self.params_d = bundle_d, params_d
        self.bundle_t, self.params_t = bundle_t, params_t
        self.tokenizer = tokenizer
        self.config = config or ServerConfig()
        self.stats = ServerStats()
        self.device = resolve_device(device)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._lock = threading.Lock()

    @classmethod
    def from_pretrained(cls, approx_model_name: str, target_model_name: str,
                        config: Optional[ServerConfig] = None, device=None):
        """Two local checkpoint directories (``core/loader.py::load_pretrained``),
        or ``"synthetic"`` for the random pair of ``core/synthetic.py``. The
        tokenizer is the draft directory's where one loads from local files
        (``transformers`` is optional): it sets the eos id and serves text
        prompts; without one the server takes ``prompt_ids`` only."""
        if "synthetic" in (approx_model_name, target_model_name):
            from ..core.synthetic import synthetic_pair

            bd, pd, bt, pt = synthetic_pair(device=device)
            return cls(bd, pd, bt, pt, None, config, device=device)
        from ..core.loader import load_pretrained
        from ..models import llama, opt

        fwd = {"llama": llama.forward, "opt": opt.forward}
        fam_d, cfg_d, pd = load_pretrained(approx_model_name, device=device)
        fam_t, cfg_t, pt = load_pretrained(target_model_name, device=device)
        tokenizer = _local_tokenizer(approx_model_name)
        config = config or ServerConfig()
        if tokenizer is not None and tokenizer.eos_token_id is not None:
            config.eos_token_id = tokenizer.eos_token_id
        return cls(ModelBundle(fam_d, cfg_d, fwd[fam_d]), pd, ModelBundle(fam_t, cfg_t, fwd[fam_t]),
                   pt, tokenizer, config, device=device)

    def process_request(self, request: dict):
        """Returns (text or None, output ids)."""
        c = self.config
        ids = _prompt_ids(request, self.tokenizer)
        num_tokens = int(request.get("max_tokens", c.num_tokens))
        t0 = time.perf_counter()
        with self._lock:
            out = speculative_generate(
                self.bundle_d, self.params_d, self.bundle_t, self.params_t, ids, num_tokens,
                gamma=c.gamma, eos_token_id=c.eos_token_id, temperature=c.temperature,
                top_k=c.top_k, top_p=c.top_p, generator=self._generator, device=self.device)
        out = np.asarray(out)
        self.stats.record(len(out) - len(ids), time.perf_counter() - t0)
        text = None
        if self.tokenizer is not None:
            text = self.tokenizer.decode(out.tolist(), skip_special_tokens=True)
        return text, out


class BatchedInferenceServer:
    """Continuous-batching front end: concurrent ``process_request`` calls
    share the rows of ``engine`` (any engine with ``submit`` / ``step`` /
    ``result`` / ``completions`` / ``_pending`` / ``num_active`` /
    ``partial_result``, the paged engine among them), or, when none is
    given, of a slotted ``ContinuousBatchingEngine`` of ``num_slots`` slots
    of ``max_total_len`` positions built from the server's config. A daemon
    thread steps the engine while work is queued; request threads wait on
    a condition until their rid completes."""

    def __init__(self, server: InferenceServer, num_slots: int = 4, max_total_len: int = 1024,
                 max_new_cap: int = 256, engine=None):
        c = server.config
        self.tokenizer = server.tokenizer
        self.config = c
        self.stats = server.stats
        if engine is None:
            from .scheduler import ContinuousBatchingEngine

            engine = ContinuousBatchingEngine(
                server.bundle_d, server.params_d, server.bundle_t, server.params_t,
                num_slots=num_slots, max_total_len=max_total_len, max_new_cap=max_new_cap,
                gamma=c.gamma, eos_token_id=c.eos_token_id, temperature=c.temperature,
                top_k=c.top_k, top_p=c.top_p, device=server.device)
        self.engine = engine
        self._cv = threading.Condition()
        self._results: dict = {}
        self._abandoned: set = set()  # rids whose streaming client went away
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop:
            with self._cv:
                if not (self.engine._pending or self.engine.num_active):
                    self._cv.wait(timeout=0.05)
                    continue
                self.engine.step()
                for rid in list(self.engine.completions):
                    comp = self.engine.result(rid)
                    if rid in self._abandoned:
                        self._abandoned.discard(rid)
                    else:
                        self._results[rid] = comp
                # wake after every step: streams poll partial_result
                self._cv.notify_all()
            # hand the lock to a woken waiter before the next step
            time.sleep(0.001)

    def shutdown(self):
        self._stop = True
        self._thread.join(timeout=5)

    def _record(self, comp, t0: float):
        self.stats.record(comp.details["tokens_generated"], time.perf_counter() - t0,
                          ttft_s=comp.details.get("ttft_s"))

    def process_request(self, request: dict):
        ids = _prompt_ids(request, self.tokenizer)
        num_tokens = int(request.get("max_tokens", self.config.num_tokens))
        t0 = time.perf_counter()
        with self._cv:
            rid = self.engine.submit(ids, num_tokens)
            self._cv.notify_all()
            while rid not in self._results:
                self._cv.wait(timeout=1.0)
            comp = self._results.pop(rid)
        self._record(comp, t0)
        text = None
        if self.tokenizer is not None:
            text = self.tokenizer.decode(comp.output_ids.tolist(), skip_special_tokens=True)
        return text, comp.output_ids

    def process_request_stream(self, request: dict):
        """Yields arrays of new token ids as the engine commits them (several
        per verify step), ending after the final chunk; EOS ends the stream."""
        eos = self.config.eos_token_id
        ids = _prompt_ids(request, self.tokenizer)
        num_tokens = int(request.get("max_tokens", self.config.num_tokens))
        t0 = time.perf_counter()
        sent = len(ids)
        rid = comp = None
        try:
            with self._cv:
                rid = self.engine.submit(ids, num_tokens)
                self._cv.notify_all()
                while rid not in self._results:
                    part = self.engine.partial_result(rid)
                    if part is None or len(part) <= sent:
                        self._cv.wait(timeout=0.05)
                        continue
                    chunk = np.asarray(part[sent:])
                    # committed tokens can trail the EOS; the stream ends there
                    eos_at = np.nonzero(chunk == eos)[0]
                    if eos_at.size:
                        chunk = chunk[: int(eos_at[0]) + 1]
                    sent += len(chunk)
                    self._cv.release()  # the consumer writes without the lock
                    try:
                        yield chunk
                    finally:
                        self._cv.acquire()
                    if eos_at.size:
                        while rid not in self._results:
                            self._cv.wait(timeout=0.05)
                comp = self._results.pop(rid)
            out = np.asarray(comp.output_ids)
            if len(out) > sent:
                yield out[sent:]
        finally:
            # a client that disconnects closes the generator at a yield:
            # account the request, and never park its completion forever
            if comp is not None:
                self._record(comp, t0)
            elif rid is not None:
                with self._cv:
                    if rid in self._results:
                        self._record(self._results.pop(rid), t0)
                    else:
                        self._abandoned.add(rid)


def _device_memory() -> dict:
    """The card's memory occupancy for /stats ({} without a card)."""
    if not torch.cuda.is_available():
        return {}
    free, total = torch.cuda.mem_get_info()
    return {"device": torch.cuda.get_device_name(0),
            "hbm_bytes_in_use": total - free,
            "hbm_bytes_limit": total,
            "torch_bytes_allocated": torch.cuda.memory_allocated(),
            "torch_bytes_reserved": torch.cuda.memory_reserved()}


def make_http_server(server, host: str = "0.0.0.0", port: int = 5000) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {"status": "ok"})
            elif self.path == "/stats":
                self._send(200, {**server.stats.snapshot(), **_device_memory()})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "not found"})
                return
            if "application/json" not in self.headers.get("Content-Type", ""):
                self._send(200, {"error": "Invalid content type"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                if req.get("stream"):
                    self._stream(req)
                    return
                text, ids = server.process_request(req)
                resp = {"output_ids": ids.tolist()}
                if text is not None:
                    resp["text"] = text
                self._send(200, resp)
            except Exception as e:  # noqa: BLE001 -- surfaced to the client as JSON
                self._send(500, {"error": str(e)})

        def _stream(self, req):
            """SSE: one ``data:`` event per committed chunk of new tokens,
            then a ``done`` event. With a tokenizer each event also carries
            the new text: the suffix of the cumulative decode, with a
            trailing incomplete character (U+FFFD) held back. When the
            decode rewrites text already sent, the event's text is empty and
            the next event continues from the rewritten text (token ids stay
            the ground truth)."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()

            def emit(obj):
                self.wfile.write(f"data: {json.dumps(obj)}\n\n".encode())
                self.wfile.flush()

            tok = getattr(server, "tokenizer", None)
            try:
                if hasattr(server, "process_request_stream"):
                    all_ids: list = []
                    prev_text = ""
                    for chunk in server.process_request_stream(req):
                        ev = {"token_ids": np.asarray(chunk).tolist()}
                        if tok is not None:
                            all_ids.extend(ev["token_ids"])
                            safe = tok.decode(all_ids, skip_special_tokens=True).rstrip("�")
                            ev["text"] = safe[len(prev_text):] if safe.startswith(prev_text) else ""
                            prev_text = safe
                        emit(ev)
                    if tok is not None and all_ids:
                        full = tok.decode(all_ids, skip_special_tokens=True)
                        if full.startswith(prev_text) and len(full) > len(prev_text):
                            emit({"token_ids": [], "text": full[len(prev_text):]})
                else:
                    text, ids = server.process_request(req)
                    ev = {"token_ids": np.asarray(ids).tolist()}
                    if text is not None:
                        ev["text"] = text
                    emit(ev)
                emit({"done": True})
            except Exception as e:  # noqa: BLE001 -- headers are sent: a terminal event
                try:
                    emit({"error": str(e), "done": True})
                except OSError:
                    pass  # the client is gone

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    p = argparse.ArgumentParser(description="speculative-decoding server (PyTorch/CUDA)")
    p.add_argument("--approx_model_name", default="synthetic")
    p.add_argument("--target_model_name", default="synthetic")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--num_tokens", type=int, default=40)
    p.add_argument("--gamma", type=int, default=4)
    p.add_argument("--num_slots", type=int, default=0,
                   help=">0 serves through the slotted continuous-batching engine with that "
                        "many slots; with --paged: the engine's batch rows (default 8)")
    p.add_argument("--max_total_len", type=int, default=1024,
                   help="the slotted engine's positions a slot")
    p.add_argument("--paged", action="store_true", help="serve through the paged-KV engine")
    p.add_argument("--prefix_cache", action="store_true",
                   help="with --paged: automatic prefix caching; a repeated page-aligned prompt "
                        "prefix skips its prefill")
    p.add_argument("--kv_quant", action="store_true", help="with --paged: int8 KV pools")
    p.add_argument("--num_blocks", type=int, default=64, help="with --paged: pool blocks")
    p.add_argument("--page", type=int, default=128)
    args = p.parse_args(argv)
    srv = InferenceServer.from_pretrained(
        args.approx_model_name, args.target_model_name,
        ServerConfig(num_tokens=args.num_tokens, gamma=args.gamma))
    if args.paged:
        from .paged import PagedEngine

        c = srv.config
        engine = PagedEngine(
            srv.bundle_d, srv.params_d, srv.bundle_t, srv.params_t,
            batch_rows=args.num_slots or 8, num_blocks=args.num_blocks, page=args.page,
            gamma=c.gamma, eos_token_id=c.eos_token_id, temperature=c.temperature,
            top_k=c.top_k, top_p=c.top_p, kv_quant=args.kv_quant,
            prefix_cache=args.prefix_cache, device=srv.device)
        srv = BatchedInferenceServer(srv, engine=engine)
    elif args.num_slots > 0:
        srv = BatchedInferenceServer(srv, num_slots=args.num_slots,
                                     max_total_len=args.max_total_len)
    httpd = make_http_server(srv, args.host, args.port)
    print(f"serving on {args.host}:{args.port}")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
