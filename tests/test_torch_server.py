"""The port's serving front end (``serve/server.py``) on the CPU: the paged
engine behind ``BatchedInferenceServer`` and the HTTP routes on a loopback
port (``/health``, ``/stats``, ``/predict`` and its SSE stream), the
slotted engine that ``BatchedInferenceServer`` and ``--num_slots`` build,
and the single-request ``InferenceServer``. Tiny random fp32 models, so
only shapes, counts and the prompt are checked here; the engines' outputs
are held to the JAX engines in tests/test_torch_paged_engine.py and
tests/test_torch_scheduler.py."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from llmspeculativesampling_tpu_torch.core.config import LlamaConfig
from llmspeculativesampling_tpu_torch.engine.types import ModelBundle
from llmspeculativesampling_tpu_torch.models import llama
from llmspeculativesampling_tpu_torch.serve import server as srv
from llmspeculativesampling_tpu_torch.serve.paged import PagedEngine
from llmspeculativesampling_tpu_torch.serve.scheduler import ContinuousBatchingEngine

VOCAB = 128


def _pair():
    cfg = LlamaConfig(vocab_size=VOCAB, hidden_size=64, intermediate_size=128, num_layers=2,
                      num_heads=2, num_kv_heads=2, max_position=1024, dtype="float32")
    pt = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    pd = {**{k: v for k, v in pt.items() if k != "layers"},
          "layers": {k: v[:1] for k, v in pt["layers"].items()}}
    return (ModelBundle("llama", LlamaConfig(**{**cfg.__dict__, "num_layers": 1}), llama.forward),
            pd, ModelBundle("llama", cfg, llama.forward), pt)


@pytest.fixture(scope="module")
def served():
    """A paged engine behind the batched front end and an HTTP server on an
    ephemeral loopback port."""
    bd, pd, bt, pt = _pair()
    config = srv.ServerConfig(num_tokens=8, top_k=10, gamma=3, eos_token_id=-1)
    base = srv.InferenceServer(bd, pd, bt, pt, config=config, device="cpu")
    engine = PagedEngine(bd, pd, bt, pt, batch_rows=3, num_blocks=16, page=16,
                         max_pages_per_req=4, max_new_cap=16, gamma=3, eos_token_id=-1,
                         prompt_bucket=16, steps_per_sync=2, kv_quant=True, device="cpu")
    batched = srv.BatchedInferenceServer(base, engine=engine)
    httpd = srv.make_http_server(batched, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield batched, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    batched.shutdown()
    thread.join(timeout=5)
    assert not thread.is_alive()


def _post(url, body, content_type="application/json"):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": content_type})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read().decode()


def _check_output(ids, prompt, max_new, gamma=3):
    ids = np.asarray(ids)
    assert np.array_equal(ids[:len(prompt)], prompt)
    assert max_new <= len(ids) - len(prompt) <= max_new + gamma
    assert ids.min() >= 0 and ids.max() < VOCAB


def test_concurrent_requests_share_the_engine(served):
    batched, _ = served
    prompts = [list(range(3 + i, 14 + 2 * i)) for i in range(5)]
    outs = [None] * 5

    def call(i):
        _, ids = batched.process_request({"prompt_ids": prompts[i], "max_tokens": 6 + i})
        outs[i] = ids

    threads = [threading.Thread(target=call, args=(i,)) for i in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for i in range(5):
        _check_output(outs[i], prompts[i], 6 + i)
    assert batched.engine.allocator.free_blocks == 16


def test_http_routes(served):
    _, url = served
    assert json.loads(urllib.request.urlopen(url + "/health", timeout=30).read()) == {"status": "ok"}
    prompt = list(range(10, 30))
    out = json.loads(_post(url + "/predict", {"prompt_ids": prompt, "max_tokens": 9}))
    _check_output(out["output_ids"], prompt, 9)
    stats = json.loads(urllib.request.urlopen(url + "/stats", timeout=30).read())
    assert stats["requests"] >= 1 and stats["ttft_p50_s"] is not None
    assert stats["tokens_per_s"] > 0
    assert "Invalid content type" in _post(url + "/predict", {}, content_type="text/plain")
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(url + "/nope", timeout=30)


def test_http_stream(served):
    _, url = served
    prompt = list(range(40, 52))
    body = _post(url + "/predict", {"prompt_ids": prompt, "max_tokens": 10, "stream": True})
    events = [json.loads(line[len("data: "):]) for line in body.split("\n\n") if line]
    assert events[-1] == {"done": True}
    new = [t for e in events[:-1] for t in e["token_ids"]]
    _check_output(prompt + new, prompt, 10)


class _RewritingTokenizer:
    """Decodes id i as a letter, except that id 7 reads "x" at the end of
    the text and "y" inside it: the next chunk rewrites text already sent."""

    def decode(self, ids, skip_special_tokens=True):
        return "".join("y" if i == 7 and j < len(ids) - 1 else "x" if i == 7 else chr(97 + i % 20)
                       for j, i in enumerate(ids))


class _FakeStreamServer:
    tokenizer = _RewritingTokenizer()
    stats = srv.ServerStats()

    def process_request_stream(self, request):
        yield from (np.asarray(c) for c in ([1, 7], [2, 3], [4]))


def test_stream_text_resyncs_after_a_rewrite():
    """After the decode rewrites sent text, the stream goes on from the
    rewritten text (the JAX server stops emitting text there for good)."""
    httpd = srv.make_http_server(_FakeStreamServer(), "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        body = _post(f"http://127.0.0.1:{httpd.server_address[1]}/predict", {"stream": True})
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=5)
    texts = [json.loads(line[len("data: "):]).get("text") for line in body.split("\n\n") if line]
    assert texts == ["bx", "", "e", None]


def test_single_request_server():
    bd, pd, bt, pt = _pair()
    s = srv.InferenceServer(bd, pd, bt, pt, config=srv.ServerConfig(num_tokens=7, eos_token_id=-1),
                            device="cpu")
    prompt = list(range(5, 15))
    text, ids = s.process_request({"prompt_ids": prompt})
    assert text is None
    _check_output(ids, prompt, 7, gamma=4)
    assert s.stats.snapshot()["requests"] == 1
    with pytest.raises(ValueError, match="tokenizer"):
        s.process_request({"prompt": "hello"})


def _capture_main(monkeypatch, argv):
    """Run ``main(argv)`` with the tiny pair and without serving: returns
    the front end it built."""
    bd, pd, bt, pt = _pair()
    monkeypatch.setattr(srv.InferenceServer, "from_pretrained", classmethod(
        lambda cls, a, b, config: cls(bd, pd, bt, pt, config=config, device="cpu")))
    made = []

    class Httpd:
        def serve_forever(self):
            pass

    def make(server, host, port):
        made.append(server)
        return Httpd()

    monkeypatch.setattr(srv, "make_http_server", make)
    srv.main(argv)
    return made[0]


def test_later_slices_raise(monkeypatch):
    """The slices these options waited for are in: ``BatchedInferenceServer``
    without an engine builds the slotted engine from the server's config,
    and so does ``--num_slots`` without ``--paged``, with
    ``--max_total_len`` reaching it. Checkpoints load from local files: a
    missing directory raises."""
    with pytest.raises(FileNotFoundError):  # checkpoint loading exists: the directory must
        srv.InferenceServer.from_pretrained("/models/a", "/models/b")
    bd, pd, bt, pt = _pair()
    config = srv.ServerConfig(gamma=3, top_k=7, eos_token_id=-1)
    base = srv.InferenceServer(bd, pd, bt, pt, config=config, device="cpu")
    batched = srv.BatchedInferenceServer(base)
    try:
        eng = batched.engine
        assert isinstance(eng, ContinuousBatchingEngine)
        assert (eng.num_slots, eng.max_total_len, eng.max_new_cap) == (4, 1024, 256)
        assert eng.gamma == 3 and eng.scfg.top_k == 7 and eng.eos_token_id == -1
        assert eng.device.type == "cpu"
    finally:
        batched.shutdown()
    batched = _capture_main(monkeypatch, ["--num_slots", "4", "--max_total_len", "256",
                                          "--port", "0"])
    try:
        eng = batched.engine
        assert isinstance(eng, ContinuousBatchingEngine)
        assert eng.num_slots == 4 and eng.max_total_len == 256
        _, ids = batched.process_request({"prompt_ids": list(range(3, 40)), "max_tokens": 5})
        _check_output(ids, list(range(3, 40)), 5, gamma=4)
    finally:
        batched.shutdown()


def test_slotted_server_concurrent_requests():
    """tests/test_serve.py:140 on the port: concurrent requests share the
    slot batch of the engine ``BatchedInferenceServer`` builds."""
    bd, pd, bt, pt = _pair()
    base = srv.InferenceServer(bd, pd, bt, pt, config=srv.ServerConfig(eos_token_id=-1),
                               device="cpu")
    batched = srv.BatchedInferenceServer(base, num_slots=3, max_total_len=256)
    try:
        rng = np.random.default_rng(1)
        prompts = [rng.integers(5, VOCAB, n).tolist() for n in (12, 20, 7, 16)]
        outs = [None] * len(prompts)

        def work(i):
            _, outs[i] = batched.process_request({"prompt_ids": prompts[i], "max_tokens": 6 + i})

        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        for i, out in enumerate(outs):
            _check_output(out, prompts[i], 6 + i, gamma=4)
        assert batched.stats.snapshot()["requests"] == len(prompts)
        assert batched.engine.num_active == 0
    finally:
        batched.shutdown()


def test_streaming_on_slotted_engine():
    """tests/test_serve.py:274 on the port: the stream runs on the slotted
    engine (``partial_result``); its chunks are the completion's tokens."""
    bd, pd, bt, pt = _pair()
    base = srv.InferenceServer(bd, pd, bt, pt, config=srv.ServerConfig(eos_token_id=-1),
                               device="cpu")
    batched = srv.BatchedInferenceServer(base, num_slots=2, max_total_len=256)
    try:
        prompt = list(range(10, 26))
        chunks = list(batched.process_request_stream({"prompt_ids": prompt, "max_tokens": 16}))
        assert len(chunks) >= 1
        _check_output(prompt + [int(t) for c in chunks for t in c], prompt, 16, gamma=4)
        st = batched.stats.snapshot()
        assert st["requests"] == 1 and st["ttft_p50_s"] is not None
    finally:
        batched.shutdown()


def test_main_builds_the_paged_engine_from_its_flags(monkeypatch):
    """``--paged --prefix_cache --num_blocks`` reach the engine: a
    prefix-caching pool of that many blocks behind the batched front end."""
    batched = _capture_main(monkeypatch, ["--paged", "--prefix_cache", "--num_blocks", "12",
                                          "--kv_quant", "--port", "0"])
    try:
        eng = batched.engine
        assert eng.prefix_cache and eng.on_demand and eng.allocator.num_blocks == 12
        assert eng.allocator.available_blocks == 12 and eng.allocator.hits == 0
        _, ids = batched.process_request({"prompt_ids": list(range(3, 40)), "max_tokens": 5})
        _check_output(ids, list(range(3, 40)), 5, gamma=4)
    finally:
        batched.shutdown()


def test_from_pretrained_serves_local_opt_directories(tmp_path):
    """Two tiny OPT checkpoints written by ``save_pretrained`` (no
    tokenizer in them): the server loads both on the CPU, keeps its eos id
    and answers a ``prompt_ids`` request."""
    from transformers import OPTConfig, OPTForCausalLM

    dirs = []
    for name, layers in (("draft", 1), ("target", 2)):
        torch.manual_seed(layers)
        model = OPTForCausalLM(OPTConfig(
            vocab_size=VOCAB, hidden_size=32, ffn_dim=64, num_hidden_layers=layers,
            num_attention_heads=2, max_position_embeddings=64, word_embed_proj_dim=32))
        model.save_pretrained(str(tmp_path / name))
        dirs.append(str(tmp_path / name))
    s = srv.InferenceServer.from_pretrained(
        *dirs, srv.ServerConfig(num_tokens=6, eos_token_id=-1), device="cpu")
    assert s.bundle_d.family == s.bundle_t.family == "opt" and s.tokenizer is None
    assert s.bundle_t.cfg.num_layers == 2 and s.config.eos_token_id == -1
    prompt = [5, 9, 2, 33, 7]
    text, ids = s.process_request({"prompt_ids": prompt})
    assert text is None
    _check_output(ids, prompt, 6, gamma=4)
