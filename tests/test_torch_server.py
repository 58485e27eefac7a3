"""Port parity: the REST job API (server/api.py) against the JAX JobServer.

Both servers front a tiny CPU engine with the same weights; one scripted
HTTP transcript runs against each. Status codes, JSON keys and error
strings must be the same (and, the jobs being greedy, the outputs too).
"""

import json
import time
import urllib.error
import urllib.request
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.checkpoint.params import host_parameters
from llamago_tpu.config import MODEL_PRESETS as JPRESETS
from llamago_tpu.config import GenerateConfig as JGen
from llamago_tpu.config import ServerConfig as JServerConfig
from llamago_tpu.runtime.engine import Engine as JEngine
from llamago_tpu.server.api import JobServer as JJobServer
from llamago_tpu_torch.checkpoint.params import params_from_numpy
from llamago_tpu_torch.config import MODEL_PRESETS, GenerateConfig, ServerConfig
from llamago_tpu_torch.runtime.engine import Engine
from llamago_tpu_torch.server.api import JobServer
from llamago_tpu_torch.tokenizer import Vocab

from conftest import make_test_vocab, random_ggjt_tensors

torch.set_num_threads(1)

BUCKETS = (16, 32, 64)


@pytest.fixture(scope="module")
def servers():
    jcfg = JPRESETS["tiny"].replace(dtype="float32", weight_dtype="float32", max_seq_len=64)
    host = host_parameters(jcfg, random_ggjt_tensors(jcfg, seed=4))
    jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32)), host)
    cfg = MODEL_PRESETS["tiny"].replace(dtype="float32", weight_dtype="float32",
                                        max_seq_len=64)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jsrv = JJobServer(JEngine(jcfg, jp, make_test_vocab(), slots=2, buckets=BUCKETS),
                      JServerConfig(host="127.0.0.1", port=0, max_pods=2),
                      JGen(max_tokens=6, ctx_size=64, temp=0.0), model_name="tiny-test")
    srv = JobServer(Engine(cfg, tp, Vocab(list(make_test_vocab().tokens)), slots=2,
                           buckets=BUCKETS, device="cpu"),
                    ServerConfig(host="127.0.0.1", port=0, max_pods=2),
                    GenerateConfig(max_tokens=6, ctx_size=64, temp=0.0),
                    model_name="tiny-test")
    jsrv.start_background()
    srv.start_background()
    yield jsrv, srv
    srv.shutdown()
    jsrv.shutdown()


def req(port, method, path, body=None, raw=None):
    data = raw if raw is not None else (json.dumps(body).encode() if body is not None
                                        else None)
    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method)
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _shape(body):
    """What a transcript compares: the text of an error, the keys of JSON."""
    if isinstance(body, dict):
        return sorted(body)
    return body


def _transcript(port):
    out = []
    jid = str(uuid.uuid4())
    code, body = req(port, "POST", "/jobs/", {"id": jid, "prompt": "hello world"})
    out.append(("post", code, _shape(body), body["status"], body["prompt"]))
    deadline = time.time() + 60
    while time.time() < deadline:
        code, st = req(port, "GET", f"/jobs/status/{jid}")
        if st["status"] == "finished":
            break
        time.sleep(0.05)
    out.append(("status", code, _shape(st), st["status"]))
    code, job = req(port, "GET", f"/jobs/{jid}")
    out.append(("fetch", code, _shape(job), job["output"], job["model"], job["status"]))
    out.append(("dup", *req(port, "POST", "/jobs/", {"id": jid, "prompt": "a"})))
    for name, path in (("status-bad", "/jobs/status/not-a-uuid"),
                       ("fetch-bad", "/jobs/not-a-uuid"),
                       ("unknown", f"/jobs/{uuid.uuid4()}")):
        out.append((name, *req(port, "GET", path)))
    out.append(("bad-uuid", *req(port, "POST", "/jobs/", {"id": "nope", "prompt": "x"})))
    out.append(("too-long", *req(port, "POST", "/jobs/",
                                 {"id": str(uuid.uuid4()), "prompt": "x" * 5000})))
    out.append(("bad-temp", *req(port, "POST", "/jobs/",
                                 {"id": str(uuid.uuid4()), "prompt": "x", "temp": -1})))
    out.append(("malformed", *req(port, "POST", "/jobs/", raw=b"{invalid")))
    out.append(("404", *req(port, "GET", "/nope")))
    code, body = req(port, "GET", "/health")
    out.append(("health", code, _shape(body), body["slots"], body["model"]))
    code, body = req(port, "GET", "/metrics")
    out.append(("metrics", code, _shape(body), _shape(body["ttft_ms"]),
                body["generated_tokens"]))
    code, body = req(port, "POST", "/tokenize", {"content": "hello world"})
    out.append(("tokenize", code, body))
    code, body = req(port, "GET", "/v1/models")
    out.append(("models", code, _shape(body), _shape(body["data"][0])))
    return out


def test_http_transcript_matches_jax(servers):
    jsrv, srv = servers
    want = _transcript(jsrv.port)
    got = _transcript(srv.port)
    assert got == want
    assert got[0][1] == 200 and got[3][1] == 400 and "Duplicated" in got[3][2]


def test_concurrent_jobs_finish(servers):
    _, srv = servers
    ids = [str(uuid.uuid4()) for _ in range(4)]
    for jid in ids:
        assert req(srv.port, "POST", "/jobs/", {"id": jid, "prompt": "hello"})[0] == 200
    deadline = time.time() + 60
    done = set()
    while time.time() < deadline and len(done) < len(ids):
        for jid in ids:
            if req(srv.port, "GET", f"/jobs/status/{jid}")[1]["status"] == "finished":
                done.add(jid)
        time.sleep(0.05)
    assert done == set(ids)


def test_openai_completion_and_embeddings(servers):
    jsrv, srv = servers
    for s in (jsrv, srv):
        code, body = req(s.port, "POST", "/v1/completions",
                         {"prompt": "hello", "max_tokens": 3, "temperature": 0})
        assert code == 200 and body["usage"]["completion_tokens"] == 3
    code, body = req(srv.port, "POST", "/v1/embeddings", {"input": ["hello", "world"]})
    assert code == 200 and len(body["data"]) == 2
    assert len(body["data"][0]["embedding"]) == MODEL_PRESETS["tiny"].dim
