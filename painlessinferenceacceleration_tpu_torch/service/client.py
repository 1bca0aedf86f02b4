"""HTTP client and concurrent load generator for the serving endpoint.

Port of ``painlessinferenceacceleration_tpu/service/client.py``, on the
standard library (``urllib`` and threads). Both request functions also take
the sampling fields the port's server reads (``min_p``,
``repetition_penalty``, ``seed``); the streaming one takes them all.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Iterator, List, Optional


def _post(url: str, body: dict, timeout: float):
    req = urllib.request.Request(
        url.rstrip("/") + "/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    return urllib.request.urlopen(req, timeout=timeout)


def _body(prompt, input_ids, max_new_tokens, stream, sampling) -> dict:
    body = dict(sampling, max_new_tokens=max_new_tokens, stream=stream)
    if input_ids is not None:
        body["input_ids"] = [int(x) for x in input_ids]
    else:
        body["prompt"] = prompt
    return body


def generate(
    url: str,
    prompt=None,
    input_ids: Optional[List[int]] = None,
    max_new_tokens: int = 64,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    timeout: float = 300.0,
    **sampling,
) -> dict:
    """One non-streaming request; returns the response JSON."""
    body = _body(prompt, input_ids, max_new_tokens, False,
                 dict(sampling, temperature=temperature, top_k=top_k, top_p=top_p))
    with _post(url, body, timeout) as r:
        return json.loads(r.read())


def stream_generate(
    url: str,
    prompt=None,
    input_ids: Optional[List[int]] = None,
    max_new_tokens: int = 64,
    timeout: float = 300.0,
    **sampling,
) -> Iterator[dict]:
    """A streaming request; yields one JSON object per chunk line.
    ``sampling``: temperature, top_k, top_p, min_p, repetition_penalty,
    seed, eos_token_id."""
    with _post(url, _body(prompt, input_ids, max_new_tokens, True, sampling), timeout) as r:
        for line in r:
            line = line.strip()
            if line:
                yield json.loads(line)


def bench_service(
    url: str,
    prompts: List[List[int]],
    max_new_tokens: int = 64,
    concurrency: int = 8,
) -> dict:
    """Concurrent load: ``concurrency`` worker threads over the prompt
    list; returns throughput and per-request latency percentiles."""
    lock = threading.Lock()
    it = iter(prompts)
    lat: List[float] = []
    toks = [0]

    def worker():
        while True:
            with lock:
                p = next(it, None)
            if p is None:
                return
            t0 = time.perf_counter()
            out = generate(url, input_ids=p, max_new_tokens=max_new_tokens)
            dt = time.perf_counter() - t0
            with lock:
                lat.append(dt)
                toks[0] += len(out.get("output_ids", ()))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    lat.sort()
    n = len(lat)
    return {
        "requests": n,
        "generated_tokens": toks[0],
        "throughput_tok_s": round(toks[0] / wall, 2) if wall else 0.0,
        "wall_s": round(wall, 2),
        "p50_latency_s": round(lat[n // 2], 3) if n else 0.0,
        "p95_latency_s": round(lat[min(n - 1, int(n * 0.95))], 3) if n else 0.0,
    }


if __name__ == "__main__":
    import sys

    url = sys.argv[1] if len(sys.argv) > 1 else "http://127.0.0.1:8000"
    print(generate(url, input_ids=[5, 6, 7, 8], max_new_tokens=16))
