"""Async REST job API over the port's Engine.

Counterpart of the JAX package's `server/api.py`, with the same routes,
JSON fields and error strings (reference: pkg/server/server.go:67-80,
300-407):

  POST /jobs/            {"id": <uuid4>, "prompt": str}
                         -> {"id", "prompt", "created", "status"}
  GET  /jobs/status/:id  -> {"status"}
  GET  /jobs/:id         -> {"id", "prompt", "output", "created",
                             "started", "finished", "model", "status"}

400 on a malformed UUID, a duplicate id, or a prompt with more characters
than the context size. Beyond the reference: "failed" jobs with an
"error" field, GET /health, GET /metrics, GET /jobs/stream/:id (SSE), the
OpenAI-style /v1/completions, /v1/chat/completions, /v1/embeddings and
/v1/models, and POST /tokenize and /detokenize.

The HTTP handlers run on the server's threads; the engine steps on its
own thread (runtime/engine.py), which owns every kernel launch except an
embedding request's forward pass. Under a mesh rank 0 alone owns HTTP and
the lockstep tick steps the engine (parallel/multihost.py); an embedding
request then rides the tick's broadcast (Engine.embed_routed).
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from llamago_tpu_torch.config import GenerateConfig, ServerConfig
from llamago_tpu_torch.runtime.engine import Engine, Job, JobStatus


def render_chat(messages: list[dict], template: str | None = None,
                default: str | None = None) -> tuple[str, tuple[str, ...]]:
    """Render OpenAI-style chat `messages` to a single prompt.

    Chat templates are a property of the fine-tune, not the file format,
    and ggjt/GGUF v1-era checkpoints carry no template metadata — so the
    server ships three: "plain" (a role-prefixed transcript; right default
    for the base-model checkpoints the reference targets), "llama2"
    (the [INST]/<<SYS>> format of LLaMA-2-chat fine-tunes), and "llama3"
    (the <|start_header_id|> header format of LLaMA-3-Instruct). Selection
    order: per-request "chat_template" key, LLAMAGO_CHAT_TEMPLATE, then
    `default` (the serving layer passes the vocab's template hint — BPE
    vocabs with the LLaMA-3 header controls imply "llama3").

    Returns (prompt, implicit stop sequences that end the turn).
    """
    template = (template or os.environ.get("LLAMAGO_CHAT_TEMPLATE")
                or default or "plain")
    if template == "llama3":
        # LLaMA-3-Instruct header format. <|begin_of_text|> is NOT
        # rendered (the tokenizer adds bos), and the turn is ended by the
        # <|eot_id|> CONTROL TOKEN, not a text stop sequence — decode()
        # strips control tokens from output text, so the engine stops on
        # the id instead (vocab.stop_ids includes eot; the chat handler
        # forces stop_at_eos). Hence the empty stop tuple here.
        parts = []
        for m in messages:
            role, content = m.get("role", "user"), str(m.get("content", ""))
            parts.append(f"<|start_header_id|>{role}<|end_header_id|>"
                         f"\n\n{content}<|eot_id|>")
        parts.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
        return "".join(parts), ()
    if template == "llama2":
        system = next((str(m.get("content", "")) for m in messages
                       if m.get("role") == "system"), "")
        parts: list[str] = []
        pending_user: str | None = None
        first_user = True
        for m in messages:
            role, content = m.get("role", "user"), str(m.get("content", ""))
            if role == "user":
                if pending_user is not None:
                    parts.append(f"[INST] {pending_user} [/INST]")
                if first_user and system:
                    # canonical LLaMA-2-chat format: the <<SYS>> block
                    # lives inside the FIRST [INST], not the last
                    content = f"<<SYS>>\n{system}\n<</SYS>>\n\n{content}"
                first_user = False
                pending_user = content
            elif role == "assistant":
                user = pending_user if pending_user is not None else ""
                parts.append(f"[INST] {user} [/INST] {content}")
                pending_user = None
        parts.append(f"[INST] {pending_user or ''} [/INST]")
        return " ".join(parts), ("[INST]",)
    if template != "plain":
        raise ValueError(
            f"unknown chat template {template!r} "
            "(expected 'plain', 'llama2', or 'llama3')")
    # plain transcript
    lines = [f"{m.get('role', 'user')}: {m.get('content', '')}"
             for m in messages]
    return "\n".join(lines) + "\nassistant:", ("\nuser:", "\nsystem:")


def validate_gen_overrides(o: dict) -> str | None:
    """Range-check client sampling params BEFORE they reach the sampler.
    Out-of-range values there are not errors but NaN factories: top_p=0
    masks every nucleus candidate (probs/0 -> NaN -> a draw over NaN
    emits garbage tokens), and repeat_penalty=0 divides positive logits
    by zero. The reference
    implicitly clamps by always keeping >=1 candidate (llama.go:618-634);
    an HTTP server must reject, not poison a slot. Returns an error
    message, or None if every present key is valid."""
    def _num(k: str) -> bool:
        v = o[k]
        return (isinstance(v, (int, float)) and not isinstance(v, bool)
                and math.isfinite(v))

    def _int(k: str) -> bool:
        return isinstance(o[k], int) and not isinstance(o[k], bool)

    if "temp" in o and not (_num("temp") and o["temp"] >= 0):
        return "'temperature' must be a finite number >= 0"
    if "top_p" in o and not (_num("top_p") and 0 < o["top_p"] <= 1):
        return "'top_p' must be in (0, 1]"
    if "top_k" in o and not (_int("top_k") and o["top_k"] >= 0):
        return "'top_k' must be an integer >= 0 (0 = full vocab)"
    if "repeat_penalty" in o and not (_num("repeat_penalty")
                                      and o["repeat_penalty"] > 0):
        return "'repeat_penalty' must be a finite number > 0"
    if "max_tokens" in o and not (_int("max_tokens") and o["max_tokens"] >= 1):
        return "'max_tokens' must be an integer >= 1"
    if "seed" in o and not _int("seed"):
        return "'seed' must be an integer"
    if "deadline_s" in o and not (_num("deadline_s") and o["deadline_s"] >= 0):
        return "'deadline_s' must be a finite number >= 0"
    if "stop_at_eos" in o and not isinstance(o["stop_at_eos"], bool):
        return "'stop_at_eos' must be a boolean"
    if "stop" in o and not all(isinstance(s, str) for s in o["stop"]):
        return "'stop' must be a string or list of strings"
    return None


def _holdback(text: str, stops: tuple[str, ...]) -> int:
    """Chars at the END of `text` that are a proper prefix of some stop
    sequence — a streaming endpoint must hold these back, or a stop
    match completed on the next engine step truncates job.output BELOW
    what was already streamed (the classic OpenAI-server holdback)."""
    h = 0
    for s in stops:
        for p in range(min(len(s) - 1, len(text)), 0, -1):
            if text.endswith(s[:p]):
                h = max(h, p)
                break
    return h


def _finish_reason(job: Job) -> str:
    if job.status == JobStatus.FAILED:
        return "error"
    if len(job.output_tokens) >= job.gen.max_tokens:
        return "length"
    return "stop"


def _valid_uuid(s: str) -> bool:
    try:
        uuid.UUID(s)
        return True
    except (ValueError, AttributeError, TypeError):
        return False


class JobServer:
    """HTTP frontend over an Engine. Own the engine's lifecycle."""

    def __init__(self, engine: Engine, server_config: ServerConfig,
                 gen_defaults: GenerateConfig, model_name: str = "model"):
        self.engine = engine
        self.config = server_config
        self.gen_defaults = gen_defaults
        self.model_name = model_name
        # vocab-implied chat template (LLaMA-3 vocabs hint "llama3");
        # per-request keys and LLAMAGO_CHAT_TEMPLATE still override
        self.chat_template_default = getattr(
            getattr(engine, "vocab", None), "chat_template_hint", None)
        self.jobs: dict[str, Job] = {}
        self._lock = threading.Lock()
        self._httpd: ThreadingHTTPServer | None = None

    # ----------------------------------------------------------- actions

    def place_job(self, job_id: str, prompt: str,
                  gen: GenerateConfig | None = None) -> Job:
        """reference: PlaceJob, server.go:282-305."""
        job = self.engine.submit(prompt, gen or self.gen_defaults, job_id=job_id)
        with self._lock:
            self.jobs[job_id] = job
        return job

    def new_job(self, payload: dict) -> tuple[int, object]:
        job_id = payload.get("id", "")
        prompt = payload.get("prompt", "")
        if not _valid_uuid(job_id):
            return 400, "Wrong UUID4 id for request!"
        with self._lock:
            if job_id in self.jobs:
                return 400, "Duplicated ID for the same request?"
        if len(prompt) >= self.gen_defaults.ctx_size:
            return 400, (
                f"Prompt length {len(prompt)} is more than allowed "
                f"{self.gen_defaults.ctx_size} chars!"
            )
        # per-request sampling overrides (beyond reference parity)
        overrides = {
            k: payload[k]
            for k in ("temp", "top_k", "top_p", "repeat_penalty",
                      "max_tokens", "seed", "stop_at_eos", "deadline_s")
            if k in payload
        }
        if payload.get("stop"):
            stop = payload["stop"]
            overrides["stop"] = tuple([stop] if isinstance(stop, str) else stop)
        err = validate_gen_overrides(overrides)
        if err is not None:
            return 400, err
        gen = self.gen_defaults.replace(**overrides) if overrides else None
        job = self.place_job(job_id, prompt, gen)
        return 200, {
            "id": job.id,
            "prompt": job.prompt,
            "created": int(job.created),
            "status": job.status.value,
        }

    def get_status(self, job_id: str) -> tuple[int, object]:
        if not _valid_uuid(job_id):
            return 400, "Wrong UUID4 id for request!"
        job = self.jobs.get(job_id)
        if job is None:
            return 400, "Request ID was not found!"
        return 200, {"status": job.status.value}

    def get_job(self, job_id: str) -> tuple[int, object]:
        if not _valid_uuid(job_id):
            return 400, "Wrong UUID4 id for request!"
        job = self.jobs.get(job_id)
        if job is None:
            return 400, "Request ID was not found!"
        body = {
            "id": job.id,
            "prompt": job.prompt,
            "output": job.output,
            "created": int(job.created),
            "started": int(job.started),
            "finished": int(job.finished),
            "model": self.model_name,
            "status": job.status.value,
        }
        if job.status == JobStatus.FAILED:
            body["error"] = job.error
        return 200, body

    def health(self) -> tuple[int, object]:
        with self._lock:
            counts: dict[str, int] = {}
            for j in self.jobs.values():
                counts[j.status.value] = counts.get(j.status.value, 0) + 1
        return 200, {
            "slots": self.engine.n_slots,
            "jobs": counts,
            "model": self.model_name,
        }

    def metrics(self) -> tuple[int, object]:
        """Aggregate per-request latency/throughput metrics (SURVEY.md §5:
        the reference prints per-job tables to the console only,
        server.go:248-274; this is the queryable equivalent)."""
        with self._lock:
            done = [j for j in self.jobs.values() if j.status == JobStatus.FINISHED]
            counts: dict[str, int] = {}
            for j in self.jobs.values():
                counts[j.status.value] = counts.get(j.status.value, 0) + 1

        def pct(vals: list[float], q: float) -> float:
            """Linear-interpolated percentile (numpy 'linear' method)."""
            if not vals:
                return 0.0
            vals = sorted(vals)
            idx = q * (len(vals) - 1)
            lo = int(idx)
            hi = min(lo + 1, len(vals) - 1)
            return vals[lo] + (vals[hi] - vals[lo]) * (idx - lo)

        ttfts = [j.ttft_ms for j in done if j.ttft_ms > 0]
        tps = [j.tokens_per_second for j in done if j.output_tokens]
        # queue wait = submission -> admission; ttft_ms above starts at
        # admission, so under saturation the user-visible latency is
        # queue_wait + ttft (soak benches report both)
        waits = [(j.started - j.created) * 1000.0 for j in done if j.started]
        return 200, {
            "jobs": counts,
            "slots": self.engine.n_slots,
            "generated_tokens": sum(len(j.output_tokens) for j in done),
            "reused_prompt_tokens": sum(j.reused_tokens for j in done),
            "ttft_ms": {"p50": round(pct(ttfts, 0.5), 1),
                        "p95": round(pct(ttfts, 0.95), 1),
                        "p99": round(pct(ttfts, 0.99), 1)},
            "queue_wait_ms": {"p50": round(pct(waits, 0.5), 1),
                              "p95": round(pct(waits, 0.95), 1),
                              "p99": round(pct(waits, 0.99), 1)},
            "tokens_per_second": {"p50": round(pct(tps, 0.5), 2),
                                  "p95": round(pct(tps, 0.95), 2)},
        }

    # ------------------------------------------------------------- serve

    def serve_forever(self) -> None:
        """Run engine thread + HTTP server (reference: Run, server.go:67-80)."""
        self.engine.start()
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((self.config.host, self.config.port), handler)
        try:
            self._httpd.serve_forever()
        finally:
            self.engine.stop()

    def start_background(self, start_engine: bool = True) -> None:
        """Engine thread + HTTP server thread; returns at once.
        start_engine=False leaves the stepping to an outer loop (lockstep
        serving, parallel/multihost.py:serve_lockstep)."""
        if start_engine:
            self.engine.start()
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((self.config.host, self.config.port), handler)
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()

    def shutdown(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
        self.engine.stop()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self.config.port


def _make_handler(server: JobServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code: int, body: object) -> None:
            if isinstance(body, str):
                data = body.encode()
                ctype = "text/plain; charset=utf-8"
            else:
                data = json.dumps(body).encode()
                ctype = "application/json"
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_POST(self):
            path = self.path.rstrip("/")
            if path not in ("/jobs", "/v1/completions", "/v1/chat/completions",
                            "/v1/embeddings", "/tokenize", "/detokenize"):
                return self._send(404, "Not found")
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError):
                return self._send(400, "Malformed JSON body")
            if path == "/v1/completions":
                return self._completions(payload)
            if path == "/v1/chat/completions":
                return self._chat_completions(payload)
            if path == "/v1/embeddings":
                return self._embeddings(payload)
            if path in ("/tokenize", "/detokenize"):
                return self._tokenize(path, payload)
            self._send(*server.new_job(payload))

        def _tokenize(self, path: str, payload: dict) -> None:
            """llama.cpp-server-style tokenizer endpoints: POST /tokenize
            {"content": str} -> {"tokens": [...]}; POST /detokenize
            {"tokens": [...]} -> {"content": str}. Useful for clients
            budgeting prompts against --context without a local copy of
            the vocab."""
            from llamago_tpu_torch.tokenizer import detokenize, tokenize

            vocab = server.engine.vocab
            if path == "/tokenize":
                content = payload.get("content")
                if not isinstance(content, str):
                    return self._send(400, "'content' must be a string")
                prefix = " " if getattr(vocab, "space_prefix", True) else ""
                ids = tokenize(vocab, prefix + content,
                               bos=bool(payload.get("add_bos", True)))
                return self._send(200, {"tokens": ids})
            toks = payload.get("tokens")
            if (not isinstance(toks, list)
                    or not all(isinstance(t, int) for t in toks)):
                return self._send(400, "'tokens' must be a list of ints")
            if any(t < 0 or t >= len(vocab) for t in toks):
                return self._send(400, "token id out of range")
            return self._send(200, {"content": detokenize(vocab, toks)})

        def _embeddings(self, payload: dict) -> None:
            """OpenAI-compatible embeddings: the final-norm hidden state
            at the last prompt position (the reference computes exactly
            this but never serves it — llama.go:412-419 behind a
            never-set flag)."""
            inputs = payload.get("input", "")
            if isinstance(inputs, str):
                inputs = [inputs]
            if (not isinstance(inputs, list) or not inputs
                    or not all(isinstance(s, str) for s in inputs)):
                return self._send(400, {"error": {
                    "message": "'input' must be a string or list of strings",
                    "type": "invalid_request_error"}})
            if len(inputs) > 64:
                return self._send(400, {"error": {
                    "message": f"too many inputs ({len(inputs)} > 64)",
                    "type": "invalid_request_error"}})
            data, total = [], 0
            try:
                for i, text in enumerate(inputs):
                    emb, n_tok = server.engine.embed_routed(text)
                    total += n_tok
                    data.append({"object": "embedding", "index": i,
                                 "embedding": [float(v) for v in emb]})
            except ValueError as e:
                return self._send(400, {"error": {
                    "message": str(e), "type": "invalid_request_error"}})
            self._send(200, {
                "object": "list",
                "model": server.model_name,
                "data": data,
                "usage": {"prompt_tokens": total, "total_tokens": total},
            })

        def _gen_overrides(self, payload: dict) -> dict:
            overrides = {}
            for src, dst in (("max_tokens", "max_tokens"),
                             ("temperature", "temp"), ("top_p", "top_p"),
                             ("seed", "seed")):
                if payload.get(src) is not None:
                    overrides[dst] = payload[src]
            if payload.get("stop"):
                stop = payload["stop"]
                overrides["stop"] = tuple(
                    [stop] if isinstance(stop, str) else stop)
            return overrides

        def _sse_job(self, job, chunk_body, final_body) -> None:
            """Stream a job's output deltas as SSE, ending with [DONE].

            Text that could be the start of a stop sequence is held back
            until it either completes the match (the engine then
            truncates job.output — the held text is never sent) or turns
            out not to be one (sent with the next delta)."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.end_headers()
            stops = tuple(job.gen.stop or ())
            shown = 0
            try:
                while True:
                    out = job.output
                    done = job.status in (JobStatus.FINISHED, JobStatus.FAILED)
                    limit = len(out) if done else \
                        len(out) - _holdback(out, stops)
                    if limit > shown:
                        chunk = chunk_body(out[shown:limit])
                        shown = limit
                        self.wfile.write(
                            f"data: {json.dumps(chunk)}\n\n".encode())
                        self.wfile.flush()
                    if done:
                        final = final_body(_finish_reason(job))
                        self.wfile.write(
                            f"data: {json.dumps(final)}\n\n".encode())
                        self.wfile.write(b"data: [DONE]\n\n")
                        self.wfile.flush()
                        return
                    time.sleep(0.05)
            except (BrokenPipeError, ConnectionResetError):
                return

        def _chat_completions(self, payload: dict) -> None:
            """OpenAI-compatible chat completions (beyond reference
            parity). Messages render through `render_chat` (plain
            transcript by default; "llama2" [INST] template via env or
            the "chat_template" key); the template's turn delimiters are
            added as implicit stop sequences."""
            messages = payload.get("messages")
            if not isinstance(messages, list) or not messages:
                return self._send(400, {"error": {
                    "message": "'messages' must be a non-empty list",
                    "type": "invalid_request_error"}})
            try:
                prompt, turn_stops = render_chat(
                    messages, payload.get("chat_template"),
                    default=server.chat_template_default)
            except ValueError as e:
                return self._send(400, {"error": {
                    "message": str(e), "type": "invalid_request_error"}})
            overrides = self._gen_overrides(payload)
            err = validate_gen_overrides(overrides)
            if err is not None:
                return self._send(400, {"error": {
                    "message": err, "type": "invalid_request_error"}})
            overrides["stop"] = tuple(overrides.get("stop", ())) + turn_stops
            overrides.setdefault("stop_at_eos", True)
            gen = server.gen_defaults.replace(**overrides)
            if len(prompt) >= gen.ctx_size:
                return self._send(400, {"error": {
                    "message": f"rendered chat of {len(prompt)} chars "
                               f"exceeds context {gen.ctx_size}",
                    "type": "invalid_request_error"}})
            job_id = str(uuid.uuid4())
            job = server.place_job(job_id, prompt, gen)

            if payload.get("stream"):
                def chunk_body(delta_text):
                    return {
                        "id": f"chatcmpl-{job_id}",
                        "object": "chat.completion.chunk",
                        "created": int(job.created),
                        "model": server.model_name,
                        "choices": [{"index": 0,
                                     "delta": {"content": delta_text},
                                     "finish_reason": None}],
                    }

                def final_body(finish):
                    b = chunk_body("")
                    b["choices"][0] = {"index": 0, "delta": {},
                                       "finish_reason": finish}
                    return b

                return self._sse_job(job, chunk_body, final_body)

            while job.status not in (JobStatus.FINISHED, JobStatus.FAILED):
                time.sleep(0.02)
            if job.status == JobStatus.FAILED:
                return self._send(500, {"error": {
                    "message": job.error, "type": "server_error"}})
            self._send(200, {
                "id": f"chatcmpl-{job_id}",
                "object": "chat.completion",
                "created": int(job.created),
                "model": server.model_name,
                "choices": [{"index": 0,
                             "message": {"role": "assistant",
                                         "content": job.output.strip()},
                             "finish_reason": _finish_reason(job)}],
                "usage": {
                    "prompt_tokens": job.prompt_tokens,
                    "completion_tokens": len(job.output_tokens),
                    "total_tokens": (job.prompt_tokens
                                     + len(job.output_tokens)),
                },
            })

        def _completions(self, payload: dict) -> None:
            """OpenAI-compatible completions (beyond reference parity):
            blocking by default, SSE chunks with "stream": true — so
            standard OpenAI-API clients can point at this server."""
            prompt = payload.get("prompt", "")
            if isinstance(prompt, list):
                prompt = prompt[0] if prompt else ""
            overrides = self._gen_overrides(payload)
            err = validate_gen_overrides(overrides)
            if err is not None:
                return self._send(400, {"error": {
                    "message": err, "type": "invalid_request_error"}})
            gen = server.gen_defaults.replace(**overrides) \
                if overrides else server.gen_defaults
            if len(prompt) >= gen.ctx_size:
                return self._send(400, {"error": {
                    "message": f"prompt of {len(prompt)} chars exceeds "
                               f"context {gen.ctx_size}", "type": "invalid_request_error"}})
            job_id = str(uuid.uuid4())
            job = server.place_job(job_id, prompt, gen)

            def body(text, finish):
                return {
                    "id": f"cmpl-{job_id}",
                    "object": "text_completion",
                    "created": int(job.created),
                    "model": server.model_name,
                    "choices": [{"text": text, "index": 0,
                                 "logprobs": None, "finish_reason": finish}],
                }

            if payload.get("stream"):
                return self._sse_job(
                    job, lambda d: body(d, None), lambda f: body("", f))
            # blocking completion (the OpenAI default)
            while job.status not in (JobStatus.FINISHED, JobStatus.FAILED):
                time.sleep(0.02)
            if job.status == JobStatus.FAILED:
                return self._send(500, {"error": {
                    "message": job.error, "type": "server_error"}})
            resp = body(job.output, _finish_reason(job))
            resp["usage"] = {
                "prompt_tokens": job.prompt_tokens,
                "completion_tokens": len(job.output_tokens),
                "total_tokens": job.prompt_tokens + len(job.output_tokens),
            }
            self._send(200, resp)

        def do_GET(self):
            parts = [p for p in self.path.split("/") if p]
            if parts == ["health"]:
                return self._send(*server.health())
            if parts == ["v1", "models"]:  # OpenAI client startup probe
                return self._send(200, {"object": "list", "data": [
                    {"id": server.model_name, "object": "model",
                     "owned_by": "llamago_tpu_torch"}]})
            if parts == ["metrics"]:
                return self._send(*server.metrics())
            if len(parts) == 3 and parts[:2] == ["jobs", "status"]:
                return self._send(*server.get_status(parts[2]))
            if len(parts) == 3 and parts[:2] == ["jobs", "stream"]:
                return self._stream(parts[2])
            if len(parts) == 2 and parts[0] == "jobs":
                return self._send(*server.get_job(parts[1]))
            self._send(404, "Not found")

        def _stream(self, job_id: str) -> None:
            """Server-sent events: output deltas as `data:` events while
            the job runs, then one `event: done` with the final record.
            (Beyond reference parity — its client polls GET /jobs/:id
            every 100 ms and diffs, main.go:137-147; this pushes the
            same deltas without the polling.)"""
            if not _valid_uuid(job_id) or job_id not in server.jobs:
                return self._send(400, "Request ID was not found!")
            job = server.jobs[job_id]
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            stops = tuple(job.gen.stop or ())
            shown = 0
            try:
                while True:
                    out = job.output
                    done = job.status in (JobStatus.FINISHED, JobStatus.FAILED)
                    # hold back a possible stop-sequence prefix (see
                    # _sse_job): keeps streamed deltas == final output
                    limit = len(out) if done else \
                        len(out) - _holdback(out, stops)
                    if limit > shown:
                        delta = out[shown:limit]
                        shown = limit
                        payload = json.dumps({"delta": delta})
                        self.wfile.write(f"data: {payload}\n\n".encode())
                        self.wfile.flush()
                    if done:
                        _, body = server.get_job(job_id)
                        self.wfile.write(
                            f"event: done\ndata: {json.dumps(body)}\n\n".encode())
                        self.wfile.flush()
                        return
                    time.sleep(0.05)
            except (BrokenPipeError, ConnectionResetError):
                return  # client hung up; the job keeps running

    return Handler
