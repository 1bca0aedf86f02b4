"""Streaming HTTP server over the ``LLM`` engine.

Port of ``painlessinferenceacceleration_tpu/service/server.py``. The
engine's per-request stream queues serve the concurrent streams. FastAPI
serves when it is installed (``make_fastapi_app``, behind an import guard);
otherwise ``StdlibServer``, on ``http.server`` threads, serves the same
endpoints.

Endpoints:
  POST /generate   {"prompt": str | "input_ids": [int], "max_new_tokens": N,
                    "temperature": f, "top_k": n, "top_p": f, "min_p": f,
                    "repetition_penalty": f, "seed": n, "eos_token_id": n,
                    "stream": bool}
  GET  /health
  GET  /metrics
"""

from __future__ import annotations

import json
import socketserver
import threading
import time
from http import server as http_server
from typing import Optional

from painlessinferenceacceleration_tpu_torch.engine.llm import LLM
from painlessinferenceacceleration_tpu_torch.engine.request import SamplingParams


def _sampling_from(body: dict) -> SamplingParams:
    """A request body's sampling fields (the JAX package's, plus min_p,
    repetition_penalty and seed)."""
    return SamplingParams(
        temperature=float(body.get("temperature", 0.0)),
        top_k=int(body.get("top_k", 0)),
        top_p=float(body.get("top_p", 1.0)),
        min_p=float(body.get("min_p", 0.0)),
        repetition_penalty=float(body.get("repetition_penalty", 1.0)),
        seed=int(body.get("seed", 0)),
        max_new_tokens=int(body.get("max_new_tokens", 256)),
        eos_token_id=body.get("eos_token_id"),
    )


def _ids_from(llm: LLM, body: dict):
    if "input_ids" in body:
        return [int(x) for x in body["input_ids"]]
    return llm.encode(body["prompt"])


def _piece(llm: LLM, tok: int) -> str:
    return llm.decode_text([tok]) if llm.tokenizer else str(tok)


def make_fastapi_app(llm: LLM):
    """A FastAPI app with the same endpoints (needs ``fastapi``)."""
    import asyncio

    from fastapi import FastAPI
    from fastapi.responses import StreamingResponse

    app = FastAPI()

    @app.get("/health")
    def health():
        return {"status": "ok"}

    @app.get("/metrics")
    def metrics():
        return llm.metrics.summary()

    @app.post("/generate")
    async def generate(body: dict):
        ids = _ids_from(llm, body)
        sampling = _sampling_from(body)
        if body.get("stream", True):
            async def gen():
                async for tok in llm.async_stream_generate(ids, sampling):
                    yield json.dumps({"token": tok, "text": _piece(llm, tok)}) + "\n"

            return StreamingResponse(gen(), media_type="application/jsonl")
        req = llm.add_request(ids, sampling)
        while req.state != "finished":
            await asyncio.sleep(0.002)
        text = llm.decode_text(req.output_ids) if llm.tokenizer else None
        return {"output_ids": req.output_ids, "text": text,
                "finish_reason": req.finish_reason}

    return app


class _ThreadingHTTPServer(socketserver.ThreadingMixIn, http_server.HTTPServer):
    daemon_threads = True


class StdlibServer:
    """The server on the standard library, with chunked streaming. Port 0
    takes an ephemeral port (``self.port`` says which)."""

    def __init__(self, llm: LLM, host: str = "0.0.0.0", port: int = 8000):
        outer = self

        class Handler(http_server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path == "/health":
                    self._json({"status": "ok"})
                elif self.path == "/metrics":
                    self._json(outer.llm.metrics.summary())
                else:
                    self.send_error(404)

            def do_POST(self):
                if self.path != "/generate":
                    self.send_error(404)
                    return
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                ids = _ids_from(outer.llm, body)
                sampling = _sampling_from(body)
                if body.get("stream", True):
                    self.send_response(200)
                    self.send_header("Content-Type", "application/jsonl")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    for tok in outer.llm.stream_generate(ids, sampling):
                        line = (json.dumps({"token": tok, "text": _piece(outer.llm, tok)})
                                + "\n").encode()
                        self.wfile.write(b"%x\r\n%s\r\n" % (len(line), line))
                    self.wfile.write(b"0\r\n\r\n")
                else:
                    req = outer.llm.add_request(ids, sampling)
                    while req.state != "finished":
                        time.sleep(0.002)
                    out = {"output_ids": req.output_ids, "finish_reason": req.finish_reason}
                    if outer.llm.tokenizer:  # a text prompt's answer as text too
                        out["text"] = outer.llm.decode_text(req.output_ids)
                    self._json(out)

            def _json(self, obj):
                data = json.dumps(obj).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.llm = llm
        self.httpd = _ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self):
        """Start the engine's background loop and the server thread."""
        self.llm.launch()
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self):
        """Stop serving, close the socket and stop the engine's loop."""
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self.llm.shutdown()


def launch_server(llm: LLM, host: str = "0.0.0.0", port: int = 8000,
                  prefer_fastapi: bool = True):
    """Serve ``llm``: under uvicorn + FastAPI when both are installed (runs
    until stopped, returns None), else on ``StdlibServer`` (started; returned).
    A ``DistLLM`` binds on rank 0 only: every other rank runs its follower
    loop (``DistLLM.launch``) until rank 0 stops, and returns None."""
    if llm.rank != 0:
        llm.launch()
        return None
    if prefer_fastapi:
        try:
            import uvicorn

            app = make_fastapi_app(llm)
        except ImportError:
            pass
        else:
            llm.launch()
            uvicorn.run(app, host=host, port=port)
            return None
    srv = StdlibServer(llm, host, port)
    srv.start()
    return srv
