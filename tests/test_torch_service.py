"""The port's async stream, HTTP server and client, readers and engine
settings against the JAX package, on the CPU.

``async_stream_generate`` under ``asyncio.run`` gives ``generate``'s
tokens; the stdlib server (port 0, an ephemeral port) answers health,
metrics, plain and streaming requests, greedy and sampled, equal to the
engine's own ``generate`` and to the JAX package's server on the same
weights, also under concurrent clients and the load generator; the readers
give the JAX package's results on the same files, and ``dummy_requests``
the same requests for a seed.
"""

import asyncio
import json
import threading
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from painlessinferenceacceleration_tpu.config import EngineConfig as JEngineConfig
from painlessinferenceacceleration_tpu.config import ModelConfig as JModelConfig
from painlessinferenceacceleration_tpu.engine.llm import LLM as JLLM
from painlessinferenceacceleration_tpu.models.base import init_params as j_init_params
from painlessinferenceacceleration_tpu.service.server import StdlibServer as JServer
from painlessinferenceacceleration_tpu.utils import reader as jreader

from painlessinferenceacceleration_tpu_torch.config import EngineConfig as TEngineConfig
from painlessinferenceacceleration_tpu_torch.config import ModelConfig as TModelConfig
from painlessinferenceacceleration_tpu_torch.engine.llm import LLM as TLLM
from painlessinferenceacceleration_tpu_torch.engine.request import SamplingParams
from painlessinferenceacceleration_tpu_torch.models.convert import params_from_jax
from painlessinferenceacceleration_tpu_torch.service import client
from painlessinferenceacceleration_tpu_torch.service.server import (
    StdlibServer,
    _sampling_from,
    launch_server,
)
from painlessinferenceacceleration_tpu_torch.utils import reader as treader

ECFG = dict(page_size=16, max_seq_len=256, max_concurrency=4, eos_token_id=-2, decode_burst=4,
            decode_burst_idle=8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs. Its engine runs are
    thousands of tiny ops; beside a parallel run's other workers, a pool of
    threads per op spends most of their time waiting for one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jc, tc = JModelConfig.tiny(), TModelConfig.tiny()
    jp = j_init_params(jc, jax.random.PRNGKey(1), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jc, jp, tc, tp


def port_llm(model, **over):
    _, _, tc, tp = model
    return TLLM(cfg=tc, params=tp, ecfg=TEngineConfig(**dict(ECFG, **over)),
                dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def server(model):
    srv = StdlibServer(port_llm(model), host="127.0.0.1", port=0)
    srv.start()
    yield srv
    srv.stop()


def _url(srv):
    return f"http://127.0.0.1:{srv.port}"


SAMPLED = dict(temperature=0.9, top_k=40, top_p=0.9, seed=21)


def test_async_stream_generate(model):
    llm = port_llm(model)
    want = llm.generate([[5, 6, 7]], SamplingParams(max_new_tokens=8, **SAMPLED))[0].output_ids
    with pytest.raises(RuntimeError):
        asyncio.run(llm.async_stream_generate([5, 6, 7]).__anext__())
    llm.launch()
    try:
        async def collect():
            return [t async for t in llm.async_stream_generate(
                [5, 6, 7], SamplingParams(max_new_tokens=8, **SAMPLED))]

        assert asyncio.run(collect()) == want
    finally:
        llm.shutdown()


def test_health_and_metrics(server):
    with urllib.request.urlopen(_url(server) + "/health") as r:
        assert json.load(r)["status"] == "ok"
    with urllib.request.urlopen(_url(server) + "/metrics") as r:
        assert "generated_tokens" in json.load(r)


@pytest.mark.parametrize("sampling", [{}, SAMPLED], ids=["greedy", "sampled"])
def test_client_streams_equal_generate_and_jax(model, server, sampling):
    """The port's server and the JAX package's on the same weights: the
    same greedy tokens; sampled requests repeat the engine's own stream
    (JAX's noise differs)."""
    url = _url(server)
    out = client.generate(url, input_ids=[5, 6, 7], max_new_tokens=6, **sampling)
    assert out["finish_reason"] == "length" and len(out["output_ids"]) == 6
    toks = [c["token"] for c in client.stream_generate(url, input_ids=[5, 6, 7],
                                                       max_new_tokens=6, **sampling)]
    assert toks == out["output_ids"]
    want = port_llm(model).generate([[5, 6, 7]], SamplingParams(max_new_tokens=6, **sampling))
    assert toks == want[0].output_ids
    if not sampling:
        jc, jp, _, _ = model
        jsrv = JServer(JLLM(cfg=jc, params=jp, ecfg=JEngineConfig(**ECFG), dtype=jnp.float32),
                       host="127.0.0.1", port=0)
        jsrv.start()
        try:
            jout = client.generate(_url(jsrv), input_ids=[5, 6, 7], max_new_tokens=6)
        finally:
            jsrv.stop()
        assert jout["output_ids"] == toks


def test_concurrent_streams_equal_generate(model, server):
    """Four streams at once, two greedy and two sampled with their own
    seeds: each equals the engine's generate of the same request."""
    url = _url(server)
    reqs = [([5, 6, 7], {}), ([8, 9], {}), ([5, 6, 7], dict(SAMPLED, seed=1)),
            ([40, 41, 42, 43], dict(SAMPLED, seed=2, min_p=0.02))]
    got = {}

    def go(i):
        ids, sp = reqs[i]
        got[i] = [c["token"] for c in client.stream_generate(url, input_ids=ids,
                                                             max_new_tokens=10, **sp)]

    ts = [threading.Thread(target=go, args=(i,)) for i in range(len(reqs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    llm = port_llm(model)
    want = [llm.generate([ids], SamplingParams(max_new_tokens=10, **sp))[0].output_ids
            for ids, sp in reqs]
    assert [got[i] for i in range(len(reqs))] == want
    assert want[0] != want[2]


def test_bench_service(server):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(5, 200, 6).tolist() for _ in range(6)]
    rep = client.bench_service(_url(server), prompts, max_new_tokens=5, concurrency=3)
    assert rep["requests"] == 6 and rep["generated_tokens"] == 30
    assert rep["p50_latency_s"] > 0


def test_sampling_from_a_body_and_launch_server(model):
    sp = _sampling_from({"temperature": 0.5, "top_k": 3, "top_p": 0.8, "min_p": 0.1,
                         "repetition_penalty": 1.1, "seed": 4, "max_new_tokens": 9,
                         "eos_token_id": 7})
    assert (sp.temperature, sp.top_k, sp.top_p, sp.min_p, sp.repetition_penalty, sp.seed,
            sp.max_new_tokens, sp.eos_token_id) == (0.5, 3, 0.8, 0.1, 1.1, 4, 9, 7)
    assert _sampling_from({}) == SamplingParams()
    srv = launch_server(port_llm(model), host="127.0.0.1", port=0)  # no fastapi: stdlib
    try:
        assert isinstance(srv, StdlibServer)
        assert len(client.generate(_url(srv), input_ids=[3, 4], max_new_tokens=3)
                   ["output_ids"]) == 3
    finally:
        srv.stop()


def test_readers_equal_jax(tmp_path):
    p = tmp_path / "d.jsonl"
    rows = [{"prompt": f"q{i}", "answer": f"a{i}"} for i in range(5)]
    p.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    for kw in (dict(output_key="answer"), dict(limit=2), {}):
        assert list(treader.read_jsonl(str(p), **kw)) == list(jreader.read_jsonl(str(p), **kw))
    sg = tmp_path / "sg.json"
    sg.write_text(json.dumps([
        {"conversations": [{"from": "system", "value": "s"}, {"from": "human", "value": "hi"},
                           {"from": "gpt", "value": "hello"}]},
        {"conversations": [{"from": "gpt", "value": "orphan"}]},
        {"conversations": [{"from": "human", "value": "q2"}, {"from": "gpt", "value": "a2"}]},
    ]))
    for limit in (0, 1):
        assert treader.read_sharegpt(str(sg), limit) == jreader.read_sharegpt(str(sg), limit)
    assert treader.read_sharegpt(str(sg)) == [("hi", "hello"), ("q2", "a2")]


@pytest.mark.parametrize("seed", [0, 3])
def test_dummy_requests_equal_jax(seed):
    kw = dict(vocab=512, prompt_len=(4, 64), output_len=(8, 32), seed=seed)
    assert treader.dummy_requests(20, **kw) == jreader.dummy_requests(20, **kw)


def test_engine_settings():
    for pol in ("pingpong", "mix", "timely"):
        assert TEngineConfig(schedule_policy=pol).schedule_policy == pol
    with pytest.raises(ValueError):
        TEngineConfig(schedule_policy="fifo")
    e = TEngineConfig(temperature=0.7, top_k=5, top_p=0.9)  # inert defaults
    assert (e.temperature, e.top_k, e.top_p) == (0.7, 5, 0.9)
    # context parallelism is ported: the page count rounds to a multiple of
    # lcm(16, model axis)
    assert TEngineConfig(context_parallel=True, num_pages=17).num_pages == 32
