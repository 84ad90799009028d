"""The port's serving plane: the controller's registry, dispatch and
expiry; a controller → worker streamed generation over real sockets on
127.0.0.1 (device="cpu"), whose text must equal the JAX worker's on the
carried-over tree; the HTTP session endpoints, one StreamSession each and
through the broker (paged); the temporal-aug grid route.

Every request has a timeout, every server is shut down in a ``finally``,
and every thread is a daemon, so no test can hang the run.
"""
import base64
import io
import json
import socket
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_like_tokenizer import SPLikeTokenizer
from streammind_torch import api as tapi
from streammind_torch import config as tconfig
from streammind_torch.serve import controller as tctl
from streammind_torch.serve.model_worker import ModelWorker, serve_worker
from streammind_torch.utils.from_jax import params_from_numpy
from streammind_tpu import api as japi
from streammind_tpu.config import tiny_streammind_config
from streammind_tpu.models.meta import init_streammind_params
from streammind_tpu.serve.model_worker import ModelWorker as JWorker

TIMEOUT = 120
PROMPT = "[INST] <video>\n describe [/INST]"


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        return resp.read()


def _chunks(body: bytes):
    return [json.loads(c.decode()) for c in body.split(b"\0") if c]


def _serve(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _npz_b64(pixels):
    buf = io.BytesIO()
    np.savez(buf, pixels=pixels)
    return base64.b64encode(buf.getvalue()).decode()


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


def _pixels(n, seed=0):
    s = tiny_streammind_config().vision.image_size
    return np.random.default_rng(seed).standard_normal((n, 3, s, s)).astype(np.float32)


def test_controller_registry_and_dispatch():
    c = tctl.Controller("shortest_queue")
    assert c.register_worker("http://w1", False, {"model_names": ["m"], "speed": 1,
                                                  "queue_length": 0})
    c.register_worker("http://w2", False, {"model_names": ["m"], "speed": 1, "queue_length": 5})
    assert c.list_models() == ["m"]
    assert c.get_worker_address("m") == "http://w1"  # the shorter queue
    assert c.get_worker_address("missing") == ""
    assert not c.receive_heart_beat("http://w3", 0)  # unknown: must re-register
    assert c.receive_heart_beat("http://w1", 2)
    c.remove_worker("http://w1")
    assert c.get_worker_address("m") == "http://w2"
    lottery = tctl.Controller("lottery")
    lottery.register_worker("http://a", False, {"model_names": ["x"], "speed": 1})
    assert lottery.get_worker_address("x") == "http://a"


def test_controller_expires_silent_workers():
    c = tctl.Controller()
    c.register_worker("http://checked", True, {"model_names": ["m"]})
    c.register_worker("http://unchecked", False, {"model_names": ["m"]})
    now = c.worker_info["http://checked"].last_heart_beat
    assert c.remove_expired_workers(now + tctl.CONTROLLER_HEART_BEAT_EXPIRATION - 1) == []
    assert c.remove_expired_workers(now + tctl.CONTROLLER_HEART_BEAT_EXPIRATION + 1) == [
        "http://checked"]
    assert set(c.worker_info) == {"http://unchecked"}


def test_controller_worker_stream_matches_jax(models):
    """Register over HTTP, stream one greedy generation through the
    controller's relay (video as a base64 npz), and compare the final text
    with the JAX worker's generate_stream on the same tree and frames."""
    jm, tm, tok = models
    cport, wport = _free_port(), _free_port()
    ctrl = _serve(tctl.serve("127.0.0.1", cport))
    worker = wserver = None
    try:
        worker = ModelWorker(f"http://127.0.0.1:{cport}", f"http://127.0.0.1:{wport}",
                             model_path="", model_name="tiny", model=tm, tokenizer=tok,
                             device="cpu")
        wserver = _serve(serve_worker(worker, "127.0.0.1", wport))
        models_listed = json.loads(_post(f"http://127.0.0.1:{cport}/list_models", {}))
        assert models_listed["models"] == ["tiny"]
        status = json.loads(_post(f"http://127.0.0.1:{wport}/worker_get_status", {}))
        assert status == {"model_names": ["tiny"], "speed": 1, "queue_length": 0}

        video = _pixels(3, seed=1)
        payload = {"model": "tiny", "prompt": PROMPT, "video_b64": _npz_b64(video),
                   "max_new_tokens": 6, "temperature": 0.0}
        chunks = _chunks(_post(f"http://127.0.0.1:{cport}/worker_generate_stream", payload))
        assert chunks and all(c["error_code"] == 0 and c["frames"] == 3 for c in chunks)
        lengths = [len(c["text"]) for c in chunks]
        assert lengths == sorted(lengths)

        jworker = JWorker(controller_addr="", worker_addr="", model_path="", model=jm,
                          tokenizer=tok, no_register=True)
        jchunks = _chunks(b"".join(jworker.generate_stream(payload)))
        assert [c["text"] for c in chunks] == [c["text"] for c in jchunks]

        # the same frames as a nested list with a stop string: the stream ends
        # at the first chunk holding it, cut before it
        stop = chunks[1]["text"].split()[-1]
        plain = dict(payload, video=video.tolist(), stop=stop)
        del plain["video_b64"]
        stopped = _chunks(_post(f"http://127.0.0.1:{wport}/worker_generate_stream", plain))
        first = next(i for i, c in enumerate(chunks) if stop in c["text"])
        assert [c["text"] for c in stopped[:-1]] == [c["text"] for c in chunks[:first]]
        assert stopped[-1]["text"] == chunks[first]["text"].split(stop)[0]
        sampled = _chunks(_post(f"http://127.0.0.1:{cport}/worker_generate_stream",
                                dict(payload, temperature=0.8, top_p=0.9, top_k=5)))
        assert sampled and all(c["error_code"] == 0 for c in sampled)
        missing = _chunks(_post(f"http://127.0.0.1:{wport}/worker_generate_stream",
                                {"prompt": PROMPT}))
        assert missing == [{"text": "(no video provided)", "error_code": 1}]
    finally:
        ctrl.shutdown()
        ctrl.server_close()
        if wserver is not None:
            wserver.shutdown()
            wserver.server_close()
        if worker is not None:
            worker.shutdown()


@pytest.mark.parametrize("capacity", [0, 2])
def test_http_session_endpoints(models, capacity):
    """start → frames (silence, a forced fire) → stop, one StreamSession a
    session (capacity 0) or through the paged broker (capacity 2).  The
    fired turn's text equals the JAX worker's session on the same frames."""
    jm, tm, tok = models
    wport = _free_port()
    worker = ModelWorker("http://none", f"http://127.0.0.1:{wport}", model_path="",
                         model_name="tiny", model=tm, tokenizer=tok, no_register=True,
                         multistream_capacity=capacity, kv_mode="paged", page_size=16,
                         device="cpu")
    server = _serve(serve_worker(worker, "127.0.0.1", wport))
    url = f"http://127.0.0.1:{wport}"
    try:
        def post(path, payload):
            return json.loads(_post(url + path, payload))

        start = {"prompt": PROMPT, "gate_threshold": 2.0, "max_new_tokens": 4}
        sid = post("/stream_session/start", dict(start, session_id="a"))["session_id"]
        other = post("/stream_session/start", start)["session_id"]
        assert sid == "a" and other != sid
        frames = _pixels(4, seed=2)
        outs = []
        for i, f in enumerate(frames):
            if i == 2:  # force a fire through the knob the request set
                _set_threshold(worker, sid, -1.0)
            body = ({"pixels_b64": _npz_b64(f[None])} if i % 2 else {"pixels": f[None].tolist()})
            outs.append(post("/stream_session/frame", dict(body, session_id=sid)))
            _set_threshold(worker, sid, 2.0)
            assert post("/stream_session/frame",
                        {"session_id": other, "pixels": f[None].tolist()})["fire"] is False
        assert [o["fire"] for o in outs] == [False, False, True, False]
        assert [o["frame_idx"] for o in outs] == [1, 2, 3, 4]
        assert all(o["error_code"] == 0 for o in outs) and isinstance(outs[2]["text"], str)

        jworker = JWorker(controller_addr="", worker_addr="", model_path="", model=jm,
                          tokenizer=tok, no_register=True)
        jsid = jworker.stream_session_start(start)["session_id"]
        jtexts = []
        for i, f in enumerate(frames):
            jworker._sessions[jsid][0].gate_threshold = -1.0 if i == 2 else 2.0
            jtexts.append(jworker.stream_session_frame({"session_id": jsid,
                                                        "pixels": f[None].tolist()})["text"])
        assert [o["text"] for o in outs] == jtexts

        stopped = post("/stream_session/stop", {"session_id": sid})
        assert stopped["error_code"] == 0
        if capacity == 0:
            assert stopped["turns"] == [outs[2]["text"]]
        assert post("/stream_session/frame",
                    {"session_id": "nope", "pixels": frames[0][None].tolist()})["error_code"] == 4
        assert post("/stream_session/frame", {"session_id": other})["error_code"] == 1
        assert post("/stream_session/stop", {"session_id": "nope"})["error_code"] == 4
    finally:
        server.shutdown()
        server.server_close()
        worker.shutdown()


def _set_threshold(worker, sid, value):
    if worker.broker is not None:
        for slot in worker.broker.server.slots:
            if slot is not None and slot.stream_id == sid:
                slot.gate_threshold = value
    else:
        worker._sessions[sid][0].gate_threshold = value


def test_worker_taug_grid_route(models):
    """Raw (T, H, W, 3) frames: a taug worker resamples them to 8·2·2,
    pastes 8 photo grids and splices 8 frames; without taug every frame is
    spliced; float frames in 0..1 are rescaled, not truncated.  The texts
    equal the JAX worker's."""
    jm, tm, tok = models
    assert ModelWorker("", "", "/ckpt/StreamMind-7B-use_taug", model=tm, tokenizer=tok,
                       no_register=True).use_taug
    assert not ModelWorker("", "", "/ckpt/StreamMind-7B-use_taug", model=tm, tokenizer=tok,
                           no_register=True, use_taug=False).use_taug
    worker = ModelWorker("", "", "", model=tm, tokenizer=tok, no_register=True, use_taug=True)
    jworker = JWorker(controller_addr="", worker_addr="", model_path="", model=jm,
                      tokenizer=tok, no_register=True, use_taug=True)
    raw = (np.random.default_rng(3).random((12, 20, 20, 3)) * 255).astype(np.uint8)
    for taug, video, frames in ((True, raw.tolist(), 8), (False, raw.tolist(), 12),
                                (False, (raw / 255.0).tolist(), 12)):
        worker.use_taug = jworker.use_taug = taug
        payload = {"prompt": PROMPT, "video": video, "max_new_tokens": 2}
        ours = _chunks(b"".join(worker.generate_stream_gate(payload)))
        theirs = _chunks(b"".join(jworker.generate_stream_gate(payload)))
        assert ours and ours[-1]["frames"] == frames
        assert [c["text"] for c in ours] == [c["text"] for c in theirs]


def test_controller_relays_each_chunk_as_it_arrives():
    """The relay hands on a worker's first chunk before the worker has
    written the next (a 4 KiB read would hold small chunks back)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    release = threading.Event()

    class SlowWorker(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):  # noqa: N802
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            if self.path.rstrip("/") == "/worker_get_status":
                body = json.dumps({"model_names": ["slow"], "speed": 1,
                                   "queue_length": 0}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            self.send_response(200)
            self.end_headers()
            self.wfile.write(json.dumps({"text": "first", "error_code": 0}).encode() + b"\0")
            self.wfile.flush()
            release.wait(timeout=TIMEOUT)
            self.wfile.write(json.dumps({"text": "second", "error_code": 0}).encode() + b"\0")

    cport, wport = _free_port(), _free_port()
    ctrl = _serve(tctl.serve("127.0.0.1", cport))
    wserver = _serve(ThreadingHTTPServer(("127.0.0.1", wport), SlowWorker))
    try:
        assert ctrl.controller.register_worker(f"http://127.0.0.1:{wport}", False, None)
        req = urllib.request.Request(
            f"http://127.0.0.1:{cport}/worker_generate_stream",
            data=json.dumps({"model": "slow", "prompt": "p"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            first = resp.read1(4096)
            assert _chunks(first) == [{"text": "first", "error_code": 0}]
            release.set()
            assert _chunks(resp.read()) == [{"text": "second", "error_code": 0}]
    finally:
        release.set()
        for server in (ctrl, wserver):
            server.shutdown()
            server.server_close()
