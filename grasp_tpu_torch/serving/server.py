"""HTTP front end: OpenAI-style completions and chat completions over the
paged engine, plain or speculative (counterpart of
grasp_tpu/serving/server.py).

- ``POST /v1/completions``: prompt as a string (needs a tokenizer), a list of
  token ids, or a batch of either; ``max_tokens``, ``temperature``,
  ``top_k``, ``top_p``, ``seed``, ``n`` (sample j at seed + j),
  ``logprobs`` (the model's top-N per token), ``stop`` (host-side stop
  strings, up to 4), ``presence_penalty``, ``frequency_penalty``,
  ``repetition_penalty``, ``min_p``, ``logit_bias`` and ``guided_regex`` or
  ``response_format`` (``json_object``, ``json_schema``, ``text``);
  ``"stream": true`` serves tokens as Server-Sent Events (a single prompt
  with n = 1).
- ``POST /v1/chat/completions``: messages rendered by :func:`render_chat`
  (the tokenizer's own chat template, or the server's ``chat_template``:
  llama2, chatml, phi3, gemma or a generic transcript), answered as
  ``chat.completion`` objects or streamed ``chat.completion.chunk`` deltas.
- ``GET /v1/models``, ``GET /health`` and ``GET /metrics`` (request, token,
  completion and step counters, live and pending requests, free pages, and
  with the prefix cache the prompt tokens it saved of those admitted).
- One scheduler thread owns the device and loops ``engine.step()``; HTTP
  handler threads only enqueue requests and wait on a per-request queue; a
  request's grammar compiles on its handler thread, outside the scheduler's
  lock.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from grasp_tpu_torch.serving.guided import json_regex, schema_regex
from grasp_tpu_torch.serving.paged import ServingEngine

logger = logging.getLogger("grasp_tpu_torch")


class _Delivery:
    """Per-request token stream the scheduler fills and a handler drains."""

    __slots__ = ("q", "sent", "final", "lps", "stop", "stop_cut", "stopped", "native_finish")

    def __init__(self, stop: Optional[List[str]] = None):
        self.q: "queue.Queue[tuple]" = queue.Queue()
        self.sent = 0          # tokens pushed so far (scheduler-side cursor)
        self.final: Optional[List[int]] = None
        self.lps: List[tuple] = []     # (chosen_lp, top_ids, top_lps) per token
        self.stop = stop or []         # host-side stop strings
        self.stop_cut: Optional[int] = None  # char index of the matched stop
        self.stopped = False           # finished by a stop string
        self.native_finish = "length"  # engine's cause: "eos"/"length"/"cancel"


class GraspServer:
    """Scheduler + request registry around one :class:`ServingEngine` (or
    its speculative subclass, whose steps emit several tokens a row).
    ``start()`` launches the scheduler thread; ``close()`` stops it after the
    current step."""

    def __init__(self, engine: ServingEngine, tokenizer=None, model_id: str = "grasp-tpu-torch",
                 chat_template: Optional[str] = None):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_id = model_id
        self.chat_template = chat_template  # None: the tokenizer's template, else generic
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._deliveries: Dict[int, _Delivery] = {}
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.started_at = time.time()
        # written under the lock (requests by submit, the rest by the
        # scheduler), read by /metrics without it
        self.counters = {"requests_total": 0, "completions_total": 0,
                         "tokens_generated_total": 0, "engine_steps_total": 0}

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
               top_k: int = 0, top_p: float = 1.0, seed: Optional[int] = None,
               logprobs: int = 0, stop: Optional[List[str]] = None, **sampling) -> tuple:
        """Enqueue one request; returns (rid, delivery). Raises ValueError on
        requests the engine could never admit. ``stop``: host-side stop
        strings; the request is cancelled once its decoded output holds one
        (needs a tokenizer). Other keyword arguments (penalties, min_p,
        logit_bias, guided_regex) go to the engine, which validates them."""
        if stop and self.tokenizer is None:
            raise ValueError("stop strings need a tokenizer")
        if sampling.get("guided_regex"):
            # a first compile lifts the grammar to the whole vocabulary in
            # Python (seconds at 32k): here, so that decoding goes on; the
            # engine's cache makes the locked submit a lookup
            self.engine._compile_guided(sampling["guided_regex"])
        with self._wake:
            rid = self.engine.submit(prompt_ids, max_new_tokens, temperature=temperature,
                                     top_k=top_k, top_p=top_p, seed=seed, logprobs=logprobs,
                                     **sampling)
            d = _Delivery(stop=stop)
            self._deliveries[rid] = d
            self.counters["requests_total"] += 1
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
            admitting = len(self.engine._admitting)
            free = self.engine.pool.free_pages
        return {"status": "ok", "model": self.model_id, "live": live, "pending": pending,
                "admitting": admitting, "free_pages": free,
                "uptime_s": round(time.time() - self.started_at, 1)}

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
                    self.counters["engine_steps_total"] += 1
                except Exception as e:  # an engine failure must not strand waiters
                    logger.exception("engine.step failed")
                    for d in self._deliveries.values():
                        if d.final is None:
                            d.q.put(("err", f"{type(e).__name__}: {e}"))
                    self._deliveries.clear()
                    continue
                # push the live rows' new tokens and check their stop
                # strings, then drain the finished rows
                for r in self.engine._live:
                    d = self._deliveries.get(r.rid) if r is not None else None
                    if d is None:
                        continue
                    self._push_new(d, r)
                    if d.stop and not d.stopped:
                        text = self.tokenizer.decode(r.out, skip_special_tokens=True)
                        hits = [i for i in (text.find(s) for s in d.stop) if i >= 0]
                        if hits:
                            d.stop_cut, d.stopped = min(hits), True
                            self.engine.cancel(r.rid)
                for r in self.engine.collect_requests():
                    d = self._deliveries.pop(r.rid, None)
                    if d is None:
                        continue
                    self._push_new(d, r)
                    d.final = list(r.out)
                    d.native_finish = r.finish
                    self.counters["completions_total"] += 1
                    d.q.put(("done", None))

    def _push_new(self, d: _Delivery, r) -> None:
        while d.sent < len(r.out):
            if r.logprobs and d.sent < len(r.lp):
                d.lps.append(r.lp[d.sent])
            d.q.put(("tok", int(r.out[d.sent])))
            d.sent += 1
            self.counters["tokens_generated_total"] += 1


def render_chat(messages: List[Dict[str, str]], tokenizer=None,
                template: Optional[str] = None) -> List[int]:
    """An OpenAI-style messages list as prompt token ids.

    ``template=None``: a tokenizer with a chat template renders through
    ``apply_chat_template(add_generation_prompt=True)``, any other through
    the generic transcript. "llama2": [INST] blocks pairing user and
    assistant turns, the system prompt in the first block's <<SYS>>;
    "chatml": <|im_start|>role ... <|im_end|>; "phi3": <|role|> ... <|end|>;
    "gemma": <start_of_turn>user/model, a system prompt folded into the first
    user turn; "generic": SYSTEM/USER/ASSISTANT lines. Every template ends
    with the assistant's cue."""
    for m in messages:
        if not isinstance(m, dict) or "role" not in m or "content" not in m:
            raise ValueError("each message needs 'role' and 'content'")
        if m["role"] not in ("system", "user", "assistant"):
            raise ValueError(f"unknown role {m['role']!r}")

    if template is None and tokenizer is not None and \
            getattr(tokenizer, "chat_template", None) and \
            hasattr(tokenizer, "apply_chat_template"):
        return list(tokenizer.apply_chat_template(messages, tokenize=True,
                                                  add_generation_prompt=True))

    if template == "llama2":
        text, pending = "", ""
        for m in messages:  # the last system prompt rides in the first open block
            if m["role"] == "system":
                pending = f"<<SYS>>\n{m['content']}\n<</SYS>>\n\n"
        for m in messages:
            if m["role"] == "user":
                pending += m["content"]
            elif m["role"] == "assistant":
                text += f"[INST] {pending} [/INST] {m['content']} "
                pending = ""
        if pending:
            text += f"[INST] {pending} [/INST]"
        else:
            text = text.rstrip()
    elif template == "chatml":
        text = "".join(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n"
                       for m in messages) + "<|im_start|>assistant\n"
    elif template == "phi3":
        text = "".join(f"<|{m['role']}|>\n{m['content']}<|end|>\n"
                       for m in messages) + "<|assistant|>\n"
    elif template == "gemma":
        sys_pending = "\n".join(m["content"] for m in messages if m["role"] == "system")
        text = ""
        for m in messages:
            if m["role"] == "system":
                continue
            role = "model" if m["role"] == "assistant" else "user"
            content = m["content"]
            if role == "user" and sys_pending:
                content, sys_pending = f"{sys_pending}\n\n{content}", ""
            text += f"<start_of_turn>{role}\n{content}<end_of_turn>\n"
        text += "<start_of_turn>model\n"
    else:
        role = {"system": "SYSTEM", "user": "USER", "assistant": "ASSISTANT"}
        text = "\n".join(f"{role[m['role']]}: {m['content']}" for m in messages) + "\nASSISTANT:"

    if tokenizer is None:
        raise ValueError("chat completions need a tokenizer")
    return tokenizer.encode(text, add_special_tokens=True)


def _usage(prompt_ids: List[int], out: List[int]) -> Dict[str, int]:
    return {"prompt_tokens": len(prompt_ids), "completion_tokens": len(out),
            "total_tokens": len(prompt_ids) + len(out)}


_MAX_CHOICES = 16  # cap on len(prompts) * n per HTTP request
_MAX_STOPS = 4     # stop strings per request (OpenAI's cap)

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


def _finish_and_text(server: GraspServer, delivery: _Delivery, out: List[int]) -> tuple:
    """(finish_reason, text): eos or a matched stop string give "stop", and
    the text ends before the stop string's match (token_ids stay whole)."""
    text = ""
    if server.tokenizer is not None:
        text = server.tokenizer.decode(out, skip_special_tokens=True)
    if delivery.stopped:
        return "stop", text[:delivery.stop_cut]
    # the engine never emits an eos token: it records the cause instead
    return ("stop" if delivery.native_finish == "eos" else "length", text)


def _lp_block(server: GraspServer, delivery: _Delivery,
              out: List[int]) -> Optional[Dict[str, Any]]:
    """OpenAI's logprobs block: per generated token, the model's logprob of
    the chosen token and its top N alternatives, keyed by their text."""
    if not delivery.lps:
        return None

    def piece(i):
        if server.tokenizer is None:
            return str(i)
        return server.tokenizer.decode([i], skip_special_tokens=True) or str(i)

    def top_block(e):
        # two ids can decode to one text: keep the first (most probable) entry,
        # so that the dict's max is the rank-1 logprob
        d: Dict[str, float] = {}
        for i, lp in zip(e[1], e[2]):
            d.setdefault(piece(i), lp)
        return d

    return {"tokens": [piece(t) for t in out[:len(delivery.lps)]],
            "token_logprobs": [e[0] for e in delivery.lps],
            "top_logprobs": [top_block(e) for e in delivery.lps]}


def _guided(req: Dict[str, Any]) -> Optional[str]:
    """The request's output grammar: ``guided_regex``, or ``response_format``
    ``json_object`` (any JSON value of nesting 2 or less) or ``json_schema``
    (the schema as a regex; ValueError on a schema it cannot express)."""
    guided = req.get("guided_regex")
    rf = req.get("response_format")
    if rf is not None:
        if not (isinstance(rf, dict) and rf.get("type") in ("json_object", "json_schema", "text")):
            raise ValueError("bad response_format")
        if rf["type"] != "text" and guided is not None:
            raise ValueError("guided_regex and response_format together")
        if rf["type"] == "json_object":
            guided = json_regex()
        elif rf["type"] == "json_schema":
            js = rf.get("json_schema")
            schema = js.get("schema", js) if isinstance(js, dict) else None
            if not isinstance(schema, dict):
                raise ValueError("json_schema needs a schema object")
            guided = schema_regex(schema)
    if guided is not None and (not isinstance(guided, str) or not guided):
        raise ValueError("bad guided_regex")
    return guided


def _sampling(req: Dict[str, Any], n_prompts: int) -> Dict[str, Any]:
    """The request's sampling fields, validated; ValueError or TypeError on a
    bad one. ``engine`` holds the fields the engine takes beyond the plain
    sampler's (it validates their ranges)."""
    stop = req.get("stop")
    if isinstance(stop, str):
        stop = [stop]
    if stop is not None and (not isinstance(stop, list) or len(stop) > _MAX_STOPS
                             or not all(isinstance(x, str) and x for x in stop)):
        raise ValueError("bad stop")
    seed = req.get("seed")
    engine = {"presence_penalty": float(req.get("presence_penalty", 0.0)),
              "frequency_penalty": float(req.get("frequency_penalty", 0.0)),
              "repetition_penalty": float(req.get("repetition_penalty", 1.0)),
              "min_p": float(req.get("min_p", 0.0))}
    bias = req.get("logit_bias")
    if bias is not None:
        if not isinstance(bias, dict):
            raise ValueError("bad logit_bias")
        # OpenAI sends {"token id as a string": bias}; int keys pass too
        engine["logit_bias"] = {int(t): float(v) for t, v in bias.items()}
    guided = _guided(req)
    if guided is not None:
        engine["guided_regex"] = guided
    out = {"max_new": int(req.get("max_tokens", 16)),
           "temperature": float(req.get("temperature", 0.0)),
           "top_k": int(req.get("top_k", 0)), "top_p": float(req.get("top_p", 1.0)),
           "seed": int(seed) if seed is not None else None,
           "logprobs": int(req.get("logprobs") or 0), "stop": stop,
           "n": int(req.get("n", 1)), "stream": bool(req.get("stream", False)),
           "timeout": float(req.get("timeout_s", 600.0)), "engine": engine}
    if out["n"] < 1 or out["n"] * n_prompts > _MAX_CHOICES:
        raise ValueError("bad n")
    return out


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

    def _piece(self, tok: int) -> str:
        t = self.grasp.tokenizer
        return t.decode([tok], skip_special_tokens=True) if t is not None else ""

    def do_GET(self):  # noqa: N802 (http.server API)
        g = self.grasp
        if self.path == "/health":
            return self._json(200, g.stats())
        if self.path == "/v1/models":
            return self._json(200, {"object": "list", "data": [
                {"id": g.model_id, "object": "model", "owned_by": "grasp-tpu-torch"}]})
        if self.path == "/metrics":
            s = g.stats()
            lines = [f"grasp_{k} {v}" for k, v in g.counters.items()]
            lines += [f"grasp_live_requests {s['live']}", f"grasp_pending_requests {s['pending']}",
                      f"grasp_free_kv_pages {s['free_pages']}",
                      f"grasp_uptime_seconds {s['uptime_s']}"]
            if g.engine.prefix_cache:
                lines += [f"grasp_prefix_tokens_saved {g.engine.prefix_tokens_saved}",
                          f"grasp_prefix_tokens_total {g.engine.prefix_tokens_total}"]
            body = ("\n".join(lines) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return None
        return self._json(404, {"error": {"message": f"no route {self.path}"}})

    def do_POST(self):  # noqa: N802
        g = self.grasp
        chat = self.path in ("/v1/chat/completions", "/chat/completions")
        if not chat and self.path not in ("/v1/completions", "/completions"):
            return self._json(404, {"error": {"message": f"no route {self.path}"}})
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError):
            return self._json(400, {"error": {"message": "invalid JSON body"}})
        if chat:
            messages = req.get("messages")
            if not isinstance(messages, list) or not messages:
                return self._json(400, {"error": {"message": "messages must be a non-empty list"}})
            try:
                prompts = [render_chat(messages, tokenizer=g.tokenizer, template=g.chat_template)]
            except (ValueError, TypeError, KeyError) as e:
                return self._json(400, {"error": {"message": str(e)}})
        else:
            try:
                prompts = _parse_prompts(g, req.get("prompt", ""))
            except ValueError as e:
                return self._json(400, {"error": {"message": str(e)}})
        if any(not p for p in prompts):
            return self._json(400, {"error": {"message": "empty prompt"}})
        try:
            opt = _sampling(req, len(prompts))
        except (TypeError, ValueError):
            return self._json(400, {"error": {"message": "bad sampling parameter"}})
        if opt["stream"] and (opt["n"] > 1 or len(prompts) > 1):
            return self._json(400, {"error": {
                "message": "stream supports a single prompt with n=1"}})

        # one engine request a (prompt, sample); choice index = prompt * n + j.
        # An explicit seed gives sample j seed + j (one seed would repeat a stream).
        subs = []
        try:
            for p_ids in prompts:
                for j in range(opt["n"]):
                    seed = opt["seed"] + j if opt["seed"] is not None else None
                    rid, d = g.submit(p_ids, opt["max_new"], temperature=opt["temperature"],
                                      top_k=opt["top_k"], top_p=opt["top_p"], seed=seed,
                                      logprobs=opt["logprobs"], stop=opt["stop"],
                                      **opt["engine"])
                    subs.append((p_ids, rid, d))
        except (ValueError, MemoryError) as e:
            for _, rid, _d in subs:  # don't strand the already-admitted part
                g.cancel(rid)
            return self._json(400, {"error": {"message": str(e)}})
        if not opt["stream"]:
            return self._answer(subs, chat, opt["timeout"])
        return self._stream(subs[0], chat, opt["timeout"])

    def _answer(self, subs, chat: bool, timeout: float):
        g = self.grasp
        choices = []
        usage = {"prompt_tokens": 0, "completion_tokens": 0, "total_tokens": 0}
        for idx, (p_ids, rid, d) in enumerate(subs):
            try:
                out = g.wait(d, timeout=timeout)
            except (TimeoutError, RuntimeError) as e:
                for _, r2, _d2 in subs:  # nobody reads the rest: free their rows now
                    g.cancel(r2)
                return self._json(500, {"error": {"message": str(e)}})
            finish, text = _finish_and_text(g, d, out)
            lp = _lp_block(g, d, out)
            for k, v in _usage(p_ids, out).items():
                usage[k] += v
            if chat:
                choices.append({"index": idx, "finish_reason": finish, "logprobs": lp,
                                "message": {"role": "assistant", "content": text,
                                            "token_ids": out}})
            else:
                choices.append({"text": text, "index": idx, "token_ids": out, "logprobs": lp,
                                "finish_reason": finish})
        return self._json(200, {"id": f"{'chatcmpl' if chat else 'cmpl'}-{subs[0][1]}",
                                "object": "chat.completion" if chat else "text_completion",
                                "created": int(time.time()), "model": g.model_id,
                                "choices": choices, "usage": usage})

    def _stream(self, sub, chat: bool, timeout: float):
        """Server-Sent Events: one chunk a token, a final chunk with the
        finish reason, then [DONE]. A stop string's match is found only after
        its tokens went out, so streamed text may hold it."""
        g = self.grasp
        _, rid, delivery = sub
        kind, obj = ("chatcmpl", "chat.completion.chunk") if chat else ("cmpl", "text_completion")

        def chunk(tok: Optional[int], finish: Optional[str]) -> bytes:
            if chat:
                delta = {} if tok is None else {"content": self._piece(tok), "token_ids": [tok]}
                choice = {"index": 0, "finish_reason": finish, "delta": delta}
            else:
                choice = {"text": "" if tok is None else self._piece(tok), "index": 0,
                          "token_ids": [] if tok is None else [tok], "finish_reason": finish}
            body = {"id": f"{kind}-{rid}", "object": obj, "model": g.model_id,
                    "choices": [choice]}
            return f"data: {json.dumps(body)}\n\n".encode()

        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        try:
            for tok in g.iter_tokens(delivery, timeout=timeout):
                self.wfile.write(chunk(tok, None))
                self.wfile.flush()
        except (TimeoutError, RuntimeError) as e:
            self.wfile.write(f"data: {json.dumps({'error': {'message': str(e)}})}\n\n".encode())
        except BrokenPipeError:  # client went away; the request runs to its end
            return None
        finish = "stop" if delivery.stopped or delivery.native_finish == "eos" else "length"
        try:
            self.wfile.write(chunk(None, finish))
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
        except BrokenPipeError:
            pass
        return None


def serve(engine: ServingEngine, host: str = "127.0.0.1", port: int = 8000,
          tokenizer=None, model_id: str = "grasp-tpu-torch",
          chat_template: Optional[str] = None, block: bool = True):
    """Start the scheduler + HTTP server. With ``block=False`` returns
    ``(GraspServer, ThreadingHTTPServer, thread)``; stop with
    ``httpd.shutdown()``, ``httpd.server_close()`` then ``gserver.close()``."""
    gserver = GraspServer(engine, tokenizer=tokenizer, model_id=model_id,
                          chat_template=chat_template).start()
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
