"""HTTP front end: OpenAI-style completions over the paged engine, plain or
speculative (counterpart of grasp_tpu/serving/server.py).

- ``POST /v1/completions``: prompt as a string (needs a tokenizer), a list of
  token ids, or a batch of either; ``max_tokens``, ``temperature``,
  ``top_k``, ``top_p``, ``seed``; ``"stream": true`` serves tokens as
  Server-Sent Events.
- ``GET /v1/models`` and ``GET /health``.
- One scheduler thread owns the device and loops ``engine.step()``; HTTP
  handler threads only enqueue requests and wait on a per-request queue.

``/v1/chat/completions`` and ``/metrics`` are not ported yet (501), and so are
the request fields for logprobs, penalties, logit bias, stop strings, n > 1
and guided decoding (400).
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from grasp_tpu_torch.serving.paged import ServingEngine

logger = logging.getLogger("grasp_tpu_torch")


class _Delivery:
    """Per-request token stream the scheduler fills and a handler drains."""

    __slots__ = ("q", "sent", "final", "native_finish")

    def __init__(self):
        self.q: "queue.Queue[tuple]" = queue.Queue()
        self.sent = 0          # tokens pushed so far (scheduler-side cursor)
        self.final: Optional[List[int]] = None
        self.native_finish = "length"  # engine's cause: "eos"/"length"/"cancel"


class GraspServer:
    """Scheduler + request registry around one :class:`ServingEngine` (or
    its speculative subclass, whose steps emit several tokens a row).
    ``start()`` launches the scheduler thread; ``close()`` stops it after the
    current step."""

    def __init__(self, engine: ServingEngine, tokenizer=None, model_id: str = "grasp-tpu-torch"):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_id = model_id
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._deliveries: Dict[int, _Delivery] = {}
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.started_at = time.time()

    def start(self) -> "GraspServer":
        self._thread = threading.Thread(target=self._loop, name="grasp-scheduler", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        with self._wake:
            self._stop = True
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)

    def submit(self, prompt_ids, max_new_tokens: int, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0, seed: Optional[int] = None) -> tuple:
        """Enqueue one request; returns (rid, delivery). Raises ValueError on
        requests the engine could never admit."""
        with self._wake:
            rid = self.engine.submit(prompt_ids, max_new_tokens, temperature=temperature,
                                     top_k=top_k, top_p=top_p, seed=seed)
            d = _Delivery()
            self._deliveries[rid] = d
            self._wake.notify_all()
        return rid, d

    def iter_tokens(self, delivery: _Delivery, timeout: float = 600.0):
        """Yield token ids as the scheduler produces them; returns on done."""
        deadline = time.time() + timeout
        while True:
            try:
                kind, val = delivery.q.get(timeout=max(0.0, deadline - time.time()))
            except queue.Empty:
                raise TimeoutError("generation timed out") from None
            if kind == "tok":
                yield val
            elif kind == "done":
                return
            else:  # "err"
                raise RuntimeError(val)

    def wait(self, delivery: _Delivery, timeout: float = 600.0) -> List[int]:
        out = list(self.iter_tokens(delivery, timeout=timeout))
        return delivery.final if delivery.final is not None else out

    def cancel(self, rid: int) -> bool:
        with self._wake:
            return self.engine.cancel(rid)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            live = sum(1 for r in self.engine._live if r is not None)
            pending = len(self.engine._pending)
            free = self.engine.pool.free_pages
        return {"status": "ok", "model": self.model_id, "live": live, "pending": pending,
                "free_pages": free, "uptime_s": round(time.time() - self.started_at, 1)}

    def _loop(self) -> None:
        while True:
            with self._wake:
                while not self._stop and not self.engine.has_work():
                    self._wake.wait(timeout=0.05)
                if self._stop:
                    for d in self._deliveries.values():
                        if d.final is None:
                            d.q.put(("err", "server shutting down"))
                    self._deliveries.clear()
                    return
                try:
                    self.engine.step()
                except Exception as e:  # an engine failure must not strand waiters
                    logger.exception("engine.step failed")
                    for d in self._deliveries.values():
                        if d.final is None:
                            d.q.put(("err", f"{type(e).__name__}: {e}"))
                    self._deliveries.clear()
                    continue
                for r in self.engine._live:
                    if r is not None and r.rid in self._deliveries:
                        self._push_new(self._deliveries[r.rid], r)
                for r in self.engine.collect_requests():
                    d = self._deliveries.pop(r.rid, None)
                    if d is None:
                        continue
                    self._push_new(d, r)
                    d.final = list(r.out)
                    d.native_finish = r.finish
                    d.q.put(("done", None))

    @staticmethod
    def _push_new(d: _Delivery, r) -> None:
        while d.sent < len(r.out):
            d.q.put(("tok", int(r.out[d.sent])))
            d.sent += 1


def _usage(prompt_ids: List[int], out: List[int]) -> Dict[str, int]:
    return {"prompt_tokens": len(prompt_ids), "completion_tokens": len(out),
            "total_tokens": len(prompt_ids) + len(out)}


_MAX_CHOICES = 16  # cap on the number of prompts per HTTP request

# request fields the port does not serve yet, with the value that means "off"
_UNSUPPORTED_FIELDS = {
    "logprobs": (None, 0), "n": (None, 1), "stop": (None,),
    "presence_penalty": (None, 0, 0.0), "frequency_penalty": (None, 0, 0.0),
    "repetition_penalty": (None, 1, 1.0), "min_p": (None, 0, 0.0),
    "logit_bias": (None,), "guided_regex": (None,), "response_format": (None,),
}


def _parse_prompts(server: GraspServer, prompt) -> List[List[int]]:
    """OpenAI prompt forms: a string, a token-id list, or a batch of either."""
    def one(p):
        if isinstance(p, str):
            if server.tokenizer is None:
                raise ValueError("string prompt needs a tokenizer; send token ids")
            return server.tokenizer.encode(p, add_special_tokens=True)
        if isinstance(p, list) and all(isinstance(t, int) for t in p):
            return p
        raise ValueError("prompt must be a string or a list of token ids")

    if isinstance(prompt, list) and prompt and all(
            isinstance(p, (str, list)) for p in prompt) and not all(
            isinstance(t, int) for t in prompt):
        return [one(p) for p in prompt]
    return [one(prompt)]


class _Handler(BaseHTTPRequestHandler):
    server_version = "grasp-tpu-torch"
    grasp: GraspServer = None  # set by serve()

    def log_message(self, fmt, *args):  # route the per-request lines through logging
        logger.debug("http: " + fmt, *args)

    def _json(self, code: int, obj: Dict[str, Any]) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _text(self, out: List[int]) -> str:
        tok = self.grasp.tokenizer
        return tok.decode(out, skip_special_tokens=True) if tok is not None else ""

    def do_GET(self):  # noqa: N802 (http.server API)
        g = self.grasp
        if self.path == "/health":
            return self._json(200, g.stats())
        if self.path == "/v1/models":
            return self._json(200, {"object": "list", "data": [
                {"id": g.model_id, "object": "model", "owned_by": "grasp-tpu-torch"}]})
        if self.path == "/metrics":
            return self._json(501, {"error": {"message": "/metrics is not ported yet"}})
        return self._json(404, {"error": {"message": f"no route {self.path}"}})

    def do_POST(self):  # noqa: N802
        g = self.grasp
        if self.path in ("/v1/chat/completions", "/chat/completions"):
            return self._json(501, {"error": {"message": "chat completions are not ported yet"}})
        if self.path not in ("/v1/completions", "/completions"):
            return self._json(404, {"error": {"message": f"no route {self.path}"}})
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError):
            return self._json(400, {"error": {"message": "invalid JSON body"}})
        for name, off in _UNSUPPORTED_FIELDS.items():
            if req.get(name) not in off:
                return self._json(400, {"error": {
                    "message": f"{name!r} is not supported by grasp_tpu_torch yet"}})
        try:
            prompts = _parse_prompts(g, req.get("prompt", ""))
        except ValueError as e:
            return self._json(400, {"error": {"message": str(e)}})
        if any(not p for p in prompts):
            return self._json(400, {"error": {"message": "empty prompt"}})
        try:
            max_new = int(req.get("max_tokens", 16))
            temperature = float(req.get("temperature", 0.0))
            top_k = int(req.get("top_k", 0))
            top_p = float(req.get("top_p", 1.0))
            seed = req.get("seed")
            seed = int(seed) if seed is not None else None
            stream = bool(req.get("stream", False))
            timeout = float(req.get("timeout_s", 600.0))
            if len(prompts) > _MAX_CHOICES:
                raise ValueError
        except (TypeError, ValueError):
            return self._json(400, {"error": {"message": "bad sampling parameter"}})
        if stream and len(prompts) > 1:
            return self._json(400, {"error": {"message": "stream supports a single prompt"}})

        subs = []
        try:
            for p_ids in prompts:
                rid, d = g.submit(p_ids, max_new, temperature=temperature, top_k=top_k,
                                  top_p=top_p, seed=seed)
                subs.append((p_ids, rid, d))
        except (ValueError, MemoryError) as e:
            for _, rid, _d in subs:  # don't strand the already-admitted part
                g.cancel(rid)
            return self._json(400, {"error": {"message": str(e)}})

        if not stream:
            choices = []
            usage = {"prompt_tokens": 0, "completion_tokens": 0, "total_tokens": 0}
            for idx, (p_ids, rid, d) in enumerate(subs):
                try:
                    out = g.wait(d, timeout=timeout)
                except (TimeoutError, RuntimeError) as e:
                    for _, r2, _d2 in subs:
                        g.cancel(r2)
                    return self._json(500, {"error": {"message": str(e)}})
                finish = "stop" if d.native_finish == "eos" else "length"
                for k, v in _usage(p_ids, out).items():
                    usage[k] += v
                choices.append({"text": self._text(out), "index": idx, "token_ids": out,
                                "logprobs": None, "finish_reason": finish})
            return self._json(200, {"id": f"cmpl-{subs[0][1]}", "object": "text_completion",
                                    "created": int(time.time()), "model": g.model_id,
                                    "choices": choices, "usage": usage})

        _, rid, delivery = subs[0]
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        try:
            for tok in g.iter_tokens(delivery, timeout=timeout):
                chunk = {"id": f"cmpl-{rid}", "object": "text_completion", "model": g.model_id,
                         "choices": [{"text": self._text([tok]), "index": 0,
                                      "token_ids": [tok], "finish_reason": None}]}
                self.wfile.write(f"data: {json.dumps(chunk)}\n\n".encode())
                self.wfile.flush()
        except (TimeoutError, RuntimeError) as e:
            self.wfile.write(f"data: {json.dumps({'error': {'message': str(e)}})}\n\n".encode())
        except BrokenPipeError:  # client went away; the request runs to its end
            return
        finish = "stop" if delivery.native_finish == "eos" else "length"
        final = {"id": f"cmpl-{rid}", "object": "text_completion", "model": g.model_id,
                 "choices": [{"text": "", "index": 0, "token_ids": [],
                              "finish_reason": finish}]}
        try:
            self.wfile.write(f"data: {json.dumps(final)}\n\n".encode())
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
        except BrokenPipeError:
            pass


def serve(engine: ServingEngine, host: str = "127.0.0.1", port: int = 8000,
          tokenizer=None, model_id: str = "grasp-tpu-torch", block: bool = True):
    """Start the scheduler + HTTP server. With ``block=False`` returns
    ``(GraspServer, ThreadingHTTPServer, thread)``; stop with
    ``httpd.shutdown()``, ``httpd.server_close()`` then ``gserver.close()``."""
    gserver = GraspServer(engine, tokenizer=tokenizer, model_id=model_id).start()
    handler = type("BoundHandler", (_Handler,), {"grasp": gserver})
    httpd = ThreadingHTTPServer((host, port), handler)
    httpd.daemon_threads = True
    logger.info("serving %s on http://%s:%d", model_id, host, httpd.server_address[1])
    if block:
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
            gserver.close()
        return None
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return gserver, httpd, t
