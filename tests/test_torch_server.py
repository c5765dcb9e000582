"""Port parity: the HTTP serving front end (`pb_llm_tpu_torch.runtime.server`)
and the serving API (logprobs, stop tokens, streaming), against the JAX
package, plus `cli.serve`'s flags that reach them.

The ports of tests/test_server.py (all five tests) and of the HTTP,
logprobs and stop tests of tests/test_serving_api.py (its multi-host test
waits for the port of multi-host serving).  The tiny model is JAX's
`init_params` carried over with `interop.from_jax_params`
(`tests/_torch_serving.TinyLlama`); greedy output over HTTP equals JAX's
`ServingLoop.generate` on the same parameters and prompts.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from _torch_serving import TinyLlama, greedy
from pb_llm_tpu.runtime import batching as jbatching
from pb_llm_tpu.runtime.server import ServingLoop as JServingLoop
from pb_llm_tpu_torch.data.synthetic import ByteTokenizer
from pb_llm_tpu_torch.runtime import batching as tbatching
from pb_llm_tpu_torch.runtime.batching import ContinuousBatcher, Request
from pb_llm_tpu_torch.runtime.server import ServingLoop, serve_http

torch.set_num_threads(2)

ECFG = dict(n_slots=2, max_seq=48, prefill_buckets=(8,))
PROMPTS = [[5, 17, 99, 3], [42, 7, 11, 23], [1, 2, 3]]


@pytest.fixture(scope="module")
def model():
    return TinyLlama(kv_heads=4)


@pytest.fixture(scope="module")
def engine(model):
    """One port engine shared by the tests: every request retires and
    releases its slot, so each test starts from an idle engine."""
    return model.port_engine(**ECFG)


@pytest.fixture(scope="module")
def jax_streams(model):
    """JAX's ServingLoop.generate on the same parameters: 6 greedy tokens of
    each prompt in PROMPTS, and 10 of the first."""
    loop = JServingLoop(model.jax_engine(**ECFG)).start()
    try:
        six = [loop.generate(p, max_new_tokens=6, timeout=300).output_ids for p in PROMPTS]
        ten = loop.generate(PROMPTS[0], max_new_tokens=10, timeout=300).output_ids
    finally:
        loop.shutdown()
    return six, ten


def _url(server, path):
    return f"http://127.0.0.1:{server.server_address[1]}{path}"


def _post(server, payload, raw=None):
    req = urllib.request.Request(_url(server, "/generate"),
                                 data=raw if raw is not None else json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        body = r.read().decode()
    return body


def _get(server, path):
    with urllib.request.urlopen(_url(server, path), timeout=30) as r:
        return json.loads(r.read())


@pytest.fixture
def server(engine):
    srv = serve_http(engine, host="127.0.0.1", port=0, encode=ByteTokenizer().encode,
                     decode=ByteTokenizer().decode)
    yield srv
    srv.shutdown()
    srv.server_close()
    srv.serving_loop.shutdown()
    assert not srv.serving_loop._thread.is_alive()


# ---------------------------------------------------------------------------
# tests/test_server.py
# ---------------------------------------------------------------------------

def test_http_generate_matches_jax_serving_loop(engine, server, jax_streams):
    """Three concurrent connections share the batcher; each answer equals
    JAX's ServingLoop and the port's own direct greedy run."""
    want = jax_streams[0]
    assert _get(server, "/health")["status"] == "ok"
    results = [None] * len(PROMPTS)

    def worker(i):
        results[i] = json.loads(_post(server, {"prompt_ids": PROMPTS[i], "max_new_tokens": 6}))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for i, res in enumerate(results):
        assert res is not None and res["output_ids"] == want[i], (i, res, want[i])
        assert res["text"] == ByteTokenizer().decode(want[i])
    stats = _get(server, "/stats")
    assert stats["generated_tokens"] == 18 and stats["prefills"] == 3
    assert stats["decode_steps"] > 0 and stats["tokens_per_second"] > 0


def test_http_direct_greedy_equals_the_serving_loop(engine, jax_streams):
    for p, w in zip(PROMPTS, jax_streams[0]):
        assert greedy(engine, p, 6)[0] == w


@pytest.mark.parametrize("raw", [b'{"nope": 1}', b'{"prompt_ids": [1, 2', b'{"prompt_ids": ["x"]}',
                                 b'{"prompt_ids": [1], "max_new_tokens": "many"}'])
def test_http_bad_request(server, raw):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server, None, raw=raw)
    assert ei.value.code == 400 and "error" in json.loads(ei.value.read())


def test_http_unknown_paths_are_404(server):
    for fn in (lambda: _get(server, "/nope"), lambda: urllib.request.urlopen(
            urllib.request.Request(_url(server, "/generated"), data=b"{}"), timeout=30)):
        with pytest.raises(urllib.error.HTTPError) as ei:
            fn()
        assert ei.value.code == 404


def test_serving_loop_library_surface(engine, jax_streams):
    loop = ServingLoop(engine).start()
    try:
        req = loop.generate(PROMPTS[0], max_new_tokens=4, timeout=120)
        assert req.done and req.output_ids == jax_streams[0][0][:4]
    finally:
        loop.shutdown()


def test_http_streaming(server, jax_streams):
    """stream=true: one NDJSON line per token over a Connection: close
    response; the streamed tokens equal the final output_ids and JAX's."""
    want = jax_streams[0][0]
    body = _post(server, {"prompt_ids": PROMPTS[0], "max_new_tokens": 6, "stream": True})
    lines = [json.loads(line) for line in body.splitlines()]
    toks = [line["token"] for line in lines if "token" in line]
    tail = lines[-1]
    assert toks == want, (toks, want)
    assert tail["done"] and tail["output_ids"] == want and tail["request_id"] >= 1
    assert all(isinstance(line["text"], str) for line in lines[:-1])


def test_http_per_request_sampling(server, jax_streams):
    """A top_k=1 sampled request is exactly greedy; mixing greedy and
    sampled requests leaves the greedy one exact."""
    want = jax_streams[0][0]
    res_g = json.loads(_post(server, {"prompt_ids": PROMPTS[0], "max_new_tokens": 6}))
    res_k1 = json.loads(_post(server, {"prompt_ids": PROMPTS[0], "max_new_tokens": 6,
                                       "temperature": 1.0, "top_k": 1}))
    res_s = json.loads(_post(server, {"prompt_ids": [42, 7, 11], "max_new_tokens": 6,
                                      "temperature": 0.9, "top_p": 0.8}))
    assert res_g["output_ids"] == want and res_k1["output_ids"] == want
    assert len(res_s["output_ids"]) == 6 and all(0 <= t < 128 for t in res_s["output_ids"])


def test_http_prompt_text_through_the_tokenizer(server, engine):
    """A text prompt is encoded by the server's tokenizer (bytes here) and
    the answer decoded: the same tokens as the ids posted directly."""
    by_text = json.loads(_post(server, {"prompt": "hi!", "max_new_tokens": 3}))
    by_ids = json.loads(_post(server, {"prompt_ids": list(b"hi!"), "max_new_tokens": 3}))
    assert by_text["output_ids"] == by_ids["output_ids"]
    assert by_text["text"] == ByteTokenizer().decode(by_ids["output_ids"])


# ---------------------------------------------------------------------------
# tests/test_serving_api.py: logprobs and stop tokens
# ---------------------------------------------------------------------------

def _run(model, reqs, mod=tbatching, **ekw):
    eng = (model.jax_engine if mod is jbatching else model.port_engine)(
        **dict(ECFG, max_seq=64), **ekw)
    mod.ContinuousBatcher(eng).run(reqs)
    return reqs


def test_logprobs_match_teacher_forced_nll(model):
    (req,) = _run(model, [Request(request_id=0, prompt_ids=PROMPTS[0], max_new_tokens=8,
                                  logprobs=True)])
    assert len(req.output_logprobs) == len(req.output_ids) == 8
    fresh = model.port_engine(**dict(ECFG, max_seq=64))
    fresh.prefill(0, PROMPTS[0])
    nll = fresh.forced_decode_nll(0, req.output_ids)
    assert nll == pytest.approx(-float(np.mean(req.output_logprobs)), rel=1e-4)
    (jreq,) = _run(model, [jbatching.Request(request_id=0, prompt_ids=PROMPTS[0],
                                             max_new_tokens=8, logprobs=True)], mod=jbatching)
    assert req.output_ids == jreq.output_ids
    np.testing.assert_allclose(req.output_logprobs, jreq.output_logprobs, rtol=1e-4, atol=1e-5)


def test_spec_logprobs_match_plain(model):
    prompt = [7, 8, 9, 7, 8, 9, 7, 8]  # repetitive: prompt lookup fires

    def run(gamma):
        (req,) = _run(model, [Request(request_id=0, prompt_ids=prompt, max_new_tokens=12,
                                      logprobs=True)], spec_gamma=gamma)
        return req

    plain, spec = run(0), run(3)
    assert spec.output_ids == plain.output_ids
    np.testing.assert_allclose(spec.output_logprobs, plain.output_logprobs, rtol=1e-4, atol=1e-5)


def test_stop_token_ids_retire(model, jax_streams):
    plain = jax_streams[1]
    stop = plain[3]  # the 4th greedy token
    (req,) = _run(model, [Request(request_id=0, prompt_ids=PROMPTS[0], max_new_tokens=10,
                                  stop_token_ids=[stop])])
    assert req.output_ids == plain[: plain.index(stop) + 1]


def test_http_logprobs_and_stop(server):
    base = json.loads(_post(server, {"prompt_ids": PROMPTS[0], "max_new_tokens": 8}))
    stop = base["output_ids"][2]
    res = json.loads(_post(server, {"prompt_ids": PROMPTS[0], "max_new_tokens": 8,
                                    "logprobs": True, "stop_token_ids": [stop]}))
    assert res["output_ids"] == base["output_ids"][: base["output_ids"].index(stop) + 1]
    assert len(res["logprobs"]) == len(res["output_ids"])
    assert all(lp <= 0.0 for lp in res["logprobs"])
    streamed = _post(server, {"prompt_ids": PROMPTS[0], "max_new_tokens": 8, "logprobs": True,
                              "stream": True})
    tail = json.loads(streamed.splitlines()[-1])
    np.testing.assert_allclose(tail["logprobs"][: len(res["logprobs"])], res["logprobs"],
                               rtol=1e-6)


def test_on_token_streams_python_ints(model, jax_streams):
    """Request.on_token gets each token as it is emitted, as a Python int
    (a handler thread never holds a device tensor), before retirement."""
    seen = []
    req = Request(request_id=0, prompt_ids=PROMPTS[0], max_new_tokens=6,
                  on_token=lambda t: seen.append((type(t), t, req.done)))
    ContinuousBatcher(model.port_engine(**ECFG)).run([req])
    assert [t for _, t, _ in seen] == req.output_ids == jax_streams[0][0]
    assert all(tp is int and not done for tp, _, done in seen)


def test_device_work_runs_on_the_scheduler_thread(model, monkeypatch):
    """Every forward of a ServingLoop runs on its scheduler thread, inside
    inference mode and the engine's KernelConfig (both thread-local, entered
    by the engine in each call), whatever the submitting thread has set."""
    from pb_llm_tpu_torch.models import llama as tllama
    from pb_llm_tpu_torch.ops import kernel_config as tkc

    seen = []
    cached = tllama.cached_attention

    def spy(*a, **k):
        seen.append((threading.current_thread(), torch.is_inference_mode_enabled(),
                     tkc.current().decode_attention))
        return cached(*a, **k)

    monkeypatch.setattr(tllama, "cached_attention", spy)
    eng = model.port_engine(kernels=tkc.KernelConfig(decode_attention="pallas_interpret"), **ECFG)
    loop = ServingLoop(eng).start()
    try:
        with tkc.use_kernels(tkc.KernelConfig(decode_attention="xla")):
            req = loop.generate(PROMPTS[0], max_new_tokens=3, timeout=120)
    finally:
        loop.shutdown()
    assert req.done and seen
    assert all(t is loop._thread and inf and arm == "pallas_interpret" for t, inf, arm in seen)


def test_serving_loop_surfaces_a_dead_scheduler(model):
    """A failing step stops the loop; waiting and submitting then raise."""
    eng = model.port_engine(**ECFG)

    def boom():
        raise RuntimeError("device lost")

    eng.decode_step = boom
    loop = ServingLoop(eng).start()
    try:
        req = loop.submit(PROMPTS[0], max_new_tokens=4)
        with pytest.raises(RuntimeError, match="serving loop died"):
            loop.wait(req, timeout=60)
        with pytest.raises(RuntimeError, match="device lost"):
            loop.submit(PROMPTS[1])
    finally:
        loop.shutdown()


# ---------------------------------------------------------------------------
# cli.serve: --http and the flags of JAX's parser
# ---------------------------------------------------------------------------

def _engines(monkeypatch):
    """Record every Engine the CLI builds."""
    from pb_llm_tpu_torch.runtime import engine as teng

    built = []

    class Recording(teng.Engine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            built.append(self)

    monkeypatch.setattr(teng, "Engine", Recording)
    return built


CLI = ["--model_id", "llama", "--synthetic", "--device", "cpu", "--n_requests", "3",
       "--max_new_tokens", "4"]


@pytest.mark.parametrize("flags,dtype", [
    (["--kv_dtype", "bf16"], torch.bfloat16),
    (["--kv_dtype", "bf16", "--page_size", "8", "--prefix_cache", "--prefill_chunk", "16"],
     torch.bfloat16),
    (["--kv_int8"], torch.int8),
    (["--kv_dtype", "f32", "--kv_int8"], torch.int8),
    (["--attention_impl", "flash_interpret", "--kv_dtype", "f32"], torch.float32),
])
def test_serve_cli_new_flags_on_cpu(capsys, monkeypatch, flags, dtype):
    from pb_llm_tpu_torch.cli import serve

    built = _engines(monkeypatch)
    assert serve.main(CLI + flags) == 0
    assert "requests=3 tokens=12" in capsys.readouterr().out
    assert built[0].cache_dtype == dtype
    if "--attention_impl" in flags:
        assert built[0].ecfg.kernels.attention == "flash_interpret"


def test_serve_cli_parser_has_every_flag_of_jax(capsys):
    from pb_llm_tpu.cli.serve import build_parser as jax_parser
    from pb_llm_tpu_torch.cli.serve import build_parser

    def flags(p):
        return {o for a in p._actions for o in a.option_strings}

    assert flags(jax_parser()) <= flags(build_parser())
    kv = next(a for a in build_parser()._actions if "--kv_dtype" in a.option_strings)
    assert set(kv.choices) == {"auto", "int8", "bf16", "f32"}


@pytest.mark.parametrize("tp", [2, 4])
def test_serve_cli_tp_raises_naming_its_roadmap_item(tp):
    from pb_llm_tpu_torch.cli import serve

    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 5"):
        serve.main(CLI + ["--tp", str(tp)])


def test_serve_cli_checkpoint_gives_jax_stream(tmp_path, monkeypatch):
    """A dense checkpoint saved by the JAX package, served by the port's
    CLI (`--synthetic --checkpoint`), gives JAX's greedy streams for the
    CLI's built-in prompts."""
    from pb_llm_tpu.models import llama as jllama
    from pb_llm_tpu.models.registry import family_for as jfamily_for
    from pb_llm_tpu.runtime.engine import Engine as JEngine, EngineConfig as JEngineConfig
    from pb_llm_tpu.utils.checkpoint import save_dense_checkpoint
    from pb_llm_tpu_torch.cli import serve

    cfg = jllama.LlamaConfig(vocab_size=259, hidden_size=64, intermediate_size=128,
                             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                             max_position_embeddings=256)
    params = jllama.init_params(cfg, jax.random.PRNGKey(7))
    save_dense_checkpoint(str(tmp_path / "ck"), params)
    tok = ByteTokenizer()
    prompts = [tok.encode(f"request {i}: the quick brown fox")[:64] for i in range(3)]
    jeng = JEngine(params, cfg, jfamily_for("llama"),
                   JEngineConfig(n_slots=8, max_seq=128, prefill_buckets=(32, 128)))
    jreqs = [jbatching.Request(request_id=i, prompt_ids=p, max_new_tokens=6)
             for i, p in enumerate(prompts)]
    jbatching.ContinuousBatcher(jeng).run(jreqs)

    served = []
    run = ContinuousBatcher.run
    monkeypatch.setattr(ContinuousBatcher, "run",
                        lambda self, reqs: served.extend(reqs) or run(self, reqs))
    assert serve.main(["--model_id", "llama", "--synthetic", "--checkpoint", str(tmp_path / "ck"),
                       "--device", "cpu", "--kv_dtype", "f32", "--n_requests", "3",
                       "--max_new_tokens", "6"]) == 0
    assert [r.output_ids for r in served] == [r.output_ids for r in jreqs]


def test_serve_cli_http_serves_until_interrupted(capsys, monkeypatch):
    """`serve --http 0` binds a free port, answers /health and /generate
    (bf16 strips), and on interrupt shuts the server and the loop down."""
    from pb_llm_tpu_torch.cli import serve

    seen = {}

    def drive(server):
        seen["health"] = _get(server, "/health")
        seen["gen"] = json.loads(_post(server, {"prompt": "hello", "max_new_tokens": 5}))
        seen["server"] = server
        raise KeyboardInterrupt

    monkeypatch.setattr(serve, "_until_interrupted", drive)
    built = _engines(monkeypatch)
    assert serve.main(CLI + ["--http", "0", "--host", "127.0.0.1", "--kv_dtype", "bf16"]) == 0
    port = seen["server"].server_address[1]
    assert f"serving on http://127.0.0.1:{port}" in capsys.readouterr().out
    assert seen["health"] == {"status": "ok"} and len(seen["gen"]["output_ids"]) == 5
    assert built[0].cache_dtype == torch.bfloat16
    assert not seen["server"].serving_loop._thread.is_alive()
