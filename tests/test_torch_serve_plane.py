"""The port's serving plane beyond the controller and the model worker, on
the CPU, on 127.0.0.1: the web UI (its page, the list and chat proxy to a
controller, the in-process mode over the port's ModelWorker, vote logging,
the body cap) against the JAX package's handler; the endpoint-backed worker
against a stub OpenAI-compatible endpoint; the register_worker and
test_message mains against a stub controller; and a short churn soak of
the paged broker behind the worker (JAX's tests/test_serve_soak.py, on
the CPU).

Everything compared is exact: pages, JSON answers, streamed chunks, the
requests the stubs saw, the mains' printed output.
"""
import json
import socket
import sys
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_like_tokenizer import SPLikeTokenizer
from streammind_torch import api as tapi
from streammind_torch import config as tconfig
from streammind_torch.serve import controller as tctl
from streammind_torch.serve import endpoint_worker as tep
from streammind_torch.serve import register_worker as treg
from streammind_torch.serve import test_message as tmsg
from streammind_torch.serve import web_server as tweb
from streammind_torch.serve.model_worker import ModelWorker, serve_worker
from streammind_torch.utils.from_jax import params_from_numpy
from streammind_tpu import api as japi
from streammind_tpu.config import tiny_streammind_config
from streammind_tpu.models.meta import init_streammind_params
from streammind_tpu.serve import endpoint_worker as jep
from streammind_tpu.serve import register_worker as jreg
from streammind_tpu.serve import test_message as jmsg
from streammind_tpu.serve import web_server as jweb
from streammind_tpu.serve.model_worker import ModelWorker as JWorker

TIMEOUT = 120
PROMPT = "[INST] <video>\n describe the play [/INST]"


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _serve(handler):
    server = ThreadingHTTPServer(("127.0.0.1", _free_port()), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _stop(*servers):
    for s in servers:
        s.shutdown()
        s.server_close()


def _post(url, payload, raw=None):
    data = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        return resp.read()


def _chunks(body: bytes):
    return [json.loads(c.decode()) for c in body.split(b"\0") if c]


@pytest.fixture(scope="module")
def models():
    cfg = tiny_streammind_config()
    jp = init_streammind_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tok = SPLikeTokenizer()
    jm, _, _, _ = japi.model_init(cfg=cfg, params=jp, tokenizer=tok, dtype=jnp.float32)
    tm, _, _, _ = tapi.model_init(cfg=tconfig.tiny_streammind_config(), params=tp,
                                  tokenizer=tok, dtype=torch.float32, device="cpu")
    return jm, tm, tok


def _video(n=3, seed=1):
    s = tiny_streammind_config().vision.image_size
    return np.random.default_rng(seed).standard_normal((n, 3, s, s)).astype(np.float32)


def test_web_server_in_process_mode_matches_jax(models, tmp_path, monkeypatch):
    """The page, /api/list_models, /api/generate straight off an in-process
    worker, /api/vote and the 413 body cap: the port's handler over its
    ModelWorker against JAX's over its own, on one tree."""
    jm, tm, tok = models
    monkeypatch.chdir(tmp_path)  # votes.jsonl lands under ./log_dir
    tw = ModelWorker("", "", model_path="", model_name="tiny", model=tm, tokenizer=tok,
                     no_register=True, device="cpu")
    jw = JWorker(controller_addr="", worker_addr="", model_path="", model_name="tiny",
                 model=jm, tokenizer=tok, no_register=True)
    tsrv, turl = _serve(tweb.make_handler(worker=tw))
    jsrv, jurl = _serve(jweb.make_handler(worker=jw))
    try:
        tpage = urllib.request.urlopen(turl + "/", timeout=TIMEOUT).read()
        jpage = urllib.request.urlopen(jurl + "/", timeout=TIMEOUT).read()
        assert tpage == jpage.replace(b"StreamMind-TPU", b"StreamMind")
        for url in (turl, jurl):
            assert json.loads(_post(url + "/api/list_models", {})) == {"models": ["tiny"]}
        payload = {"prompt": PROMPT, "video": _video().tolist(), "max_new_tokens": 5,
                   "temperature": 0.0}
        got = _chunks(_post(turl + "/api/generate", payload))
        want = _chunks(_post(jurl + "/api/generate", payload))
        assert [c["text"] for c in got] == [c["text"] for c in want] and len(got) == 5
        vote = {"type": "upvote", "model": "tiny", "history": [["USER", "hi"]]}
        for url in (turl, jurl):
            assert json.loads(_post(url + "/api/vote", vote)) == {"ok": True}
            assert json.loads(_post(url + "/api/vote", [1, 2])) == {
                "ok": False, "error": "bad vote payload"}
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(url + "/api/list_models", None, raw=b" " * (64 * 1024 + 1))
            assert e.value.code == 413
        lines = [json.loads(x) for x in (tmp_path / "log_dir" / "votes.jsonl").read_text()
                 .splitlines()]
        assert len(lines) == 2 and all({k: v for k, v in x.items() if k != "tstamp"} == vote
                                       for x in lines)
    finally:
        _stop(tsrv, jsrv)


def test_web_server_proxies_the_controller(models):
    """Proxy mode: the list and the chat stream come from the controller and
    its worker, the same bytes as JAX's handler relays."""
    _, tm, tok = models
    ctrl = tctl.serve("127.0.0.1", _free_port())
    threading.Thread(target=ctrl.serve_forever, daemon=True).start()
    curl = f"http://127.0.0.1:{ctrl.server_address[1]}"
    wport = _free_port()
    worker = ModelWorker(curl, f"http://127.0.0.1:{wport}", model_path="", model_name="tiny",
                         model=tm, tokenizer=tok, device="cpu")
    wsrv = serve_worker(worker, "127.0.0.1", wport)
    threading.Thread(target=wsrv.serve_forever, daemon=True).start()
    tsrv, turl = _serve(tweb.make_handler(controller_url=curl))
    jsrv, jurl = _serve(jweb.make_handler(controller_url=curl))
    try:
        for url in (turl, jurl):
            assert json.loads(_post(url + "/api/list_models", {})) == {"models": ["tiny"]}
        payload = {"model": "tiny", "prompt": PROMPT, "video": _video().tolist(),
                   "max_new_tokens": 4, "temperature": 0.0}
        got = _post(turl + "/api/generate", payload)
        assert got == _post(jurl + "/api/generate", payload)
        assert got == _post(curl + "/worker_generate_stream", payload)
        assert len(_chunks(got)) == 4
    finally:
        _stop(tsrv, jsrv, wsrv, ctrl)
        worker.shutdown()


class _Stub:
    """An HTTP stub recording each POST (path, headers, JSON body) and
    answering from ``answer(path, body) -> bytes``."""

    def __init__(self, answer):
        self.seen = []
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):  # noqa: N802
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                stub.seen.append((self.path, dict(self.headers), body))
                out = answer(self.path, body)
                self.send_response(200)
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

        self.server, self.url = _serve(Handler)


SSE = (b": keep-alive\n\n"
       b'data: {"choices": []}\n\n'
       b'data: {"choices": [{"delta": {"role": "assistant"}}]}\n\n'
       b'data: {"choices": [{"delta": {"content": "A goal"}}]}\n\n'
       b'data: {"choices": [{"delta": {"content": " is"}}]}\n\n'
       b'data: {"choices": [{"delta": {"content": " scored."}}]}\n\n'
       b"data: [DONE]\n\n"
       b'data: {"choices": [{"delta": {"content": "after the end"}}]}\n\n')


def test_endpoint_worker_streams_a_stub_openai_endpoint():
    """The OpenAI-compatible stream becomes the worker's \\0-framed chunks,
    as JAX's endpoint worker makes them, in process and over the worker's
    HTTP route; the request carries the model, the prompt, the limits and
    the bearer key."""
    stub = _Stub(lambda path, body: SSE)
    params = {"prompt": "What happened?", "max_new_tokens": 7, "temperature": 0.3}
    try:
        tw = tep.EndpointWorker("", "", stub.url, "m-1", api_key="k", no_register=True)
        jw = jep.EndpointWorker("", "", stub.url, "m-1", api_key="k", no_register=True)
        got = b"".join(tw.generate_stream(params))
        assert got == b"".join(jw.generate_stream(params))
        assert [c["text"] for c in _chunks(got)] == ["A goal", "A goal is", "A goal is scored."]
        wport = _free_port()
        wsrv = serve_worker(tw, "127.0.0.1", wport)
        threading.Thread(target=wsrv.serve_forever, daemon=True).start()
        try:
            assert _post(f"http://127.0.0.1:{wport}/worker_generate_stream", params) == got
            status = json.loads(_post(f"http://127.0.0.1:{wport}/worker_get_status", {}))
            assert status == {"model_names": ["endpoint:m-1"], "speed": 1, "queue_length": 0}
        finally:
            _stop(wsrv)
        assert len(stub.seen) == 3
        for path, headers, body in stub.seen:
            assert path == "/v1/chat/completions" and headers["Authorization"] == "Bearer k"
            assert body == {"model": "m-1", "messages": [{"role": "user",
                                                          "content": "What happened?"}],
                            "max_tokens": 7, "temperature": 0.3, "stream": True}
    finally:
        _stop(stub.server)


def _controller_answer(path, body):
    if path == "/list_models":
        return json.dumps({"models": ["tiny", "other"]}).encode()
    if path == "/get_worker_address":
        return json.dumps({"address": "http://127.0.0.1:1"}).encode()
    if path == "/register_worker":
        return json.dumps(True).encode()
    if path == "/worker_generate_stream":
        return b"".join(json.dumps({"text": t, "error_code": 0}).encode() + b"\0"
                        for t in ("It", "It rains", "It rains."))
    raise AssertionError(path)


@pytest.mark.parametrize("which", ["register_worker", "test_message"])
def test_serve_mains_against_a_stub_controller(monkeypatch, capsys, which):
    """register_worker's and test_message's mains: the requests the
    controller sees and what they print, the same as JAX's mains."""
    stub = _Stub(_controller_answer)
    argv = {"register_worker": ["--worker-name", "http://w:1", "--check-heart-beat"],
            "test_message": ["--message", "Who scored?", "--max-new-tokens", "5",
                             "--video-path", "/v.mp4"]}[which]
    mains = {"register_worker": (treg.main, jreg.main), "test_message": (tmsg.main, jmsg.main)}
    outs, seen = [], []
    try:
        for main in mains[which]:
            monkeypatch.setattr(sys, "argv", [which, "--controller-address", stub.url, *argv])
            main()
            outs.append(capsys.readouterr().out)
            seen.append([(p, b) for p, _, b in stub.seen])
            stub.seen.clear()
    finally:
        _stop(stub.server)
    assert outs[0] == outs[1] and seen[0] == seen[1]
    if which == "register_worker":
        assert seen[0] == [("/register_worker", {"worker_name": "http://w:1",
                                                 "check_heart_beat": True,
                                                 "worker_status": None})]
        assert outs[0] == "True\n"
    else:
        assert [p for p, _ in seen[0]] == ["/list_models", "/get_worker_address",
                                           "/worker_generate_stream"]
        gen = seen[0][2][1]
        assert gen["model"] == "tiny" and gen["video_path"] == "/v.mp4"
        assert gen["max_new_tokens"] == 5 and gen["prompt"].endswith("Who scored? [/INST]")
        assert outs[0].endswith("\rIt rains.\n") and "worker: http://127.0.0.1:1" in outs[0]


def test_broker_session_churn_soak(models):
    """Six clients (capacity 4) churn sessions through the worker's paged
    broker (24 pages of 8): starts, frames, stops and evictions from many
    threads.  Every answer is well formed, nothing deadlocks, and once all
    is closed the pool holds every page again."""
    _, tm, tok = models
    worker = ModelWorker("", "", model_path="", model_name="tiny", model=tm, tokenizer=tok,
                         no_register=True, multistream_capacity=4, kv_mode="paged",
                         num_pages=24, page_size=8, prewarm=True, device="cpu")
    size = tiny_streammind_config().vision.image_size
    errors, malformed = [], []

    def client(ci):
        rng = np.random.default_rng(ci)
        sid = None
        try:
            for f in range(10):
                if sid is None or rng.random() < 0.15:
                    if sid is not None:
                        worker.stream_session_stop({"session_id": sid})
                    out = worker.stream_session_start({
                        "session_id": f"c{ci}-{f}",
                        "gate_threshold": -1.0 if ci % 2 else 2.0,  # half fire every frame
                        "max_new_tokens": 3})
                    if "session_id" not in out:
                        if out.get("error_code") != 2:  # a full pool refuses: valid
                            malformed.append((ci, f, out))
                        sid = None
                        continue
                    sid = out["session_id"]
                r = worker.stream_session_frame({
                    "session_id": sid,
                    "pixels": rng.standard_normal((1, 3, size, size)).tolist()})
                if not (r.get("error_code") in (0, 1, 4) and ("fire" in r or "error" in r)):
                    malformed.append((ci, f, r))
                if r.get("error_code") == 4:
                    sid = None  # evicted by another client's start: rejoin
            if sid is not None:
                worker.stream_session_stop({"session_id": sid})
        except Exception as e:  # noqa: BLE001
            errors.append((ci, repr(e)))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads), "soak deadlocked"
    assert not errors, errors[:3]
    assert not malformed, malformed[:3]
    broker = worker.broker
    for slot in list(broker.server.slots):
        if slot is not None:
            broker.remove(slot.stream_id)
    pd = broker.server.paged
    assert pd.tables == {} and pd.lengths == {} and pd.free_pages() == 24
    assert broker.active() == 0
    worker.shutdown()
