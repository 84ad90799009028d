"""Serving controller: worker registry, heartbeat expiry, dispatch, relay.

The JAX package's controller protocol, on the standard library's
ThreadingHTTPServer:
  POST /register_worker {worker_name, check_heart_beat, worker_status}
  POST /refresh_all_workers
  POST /list_models
  POST /get_worker_address {model}
  POST /receive_heart_beat {worker_name, queue_length}
  POST /worker_generate_stream {...}  → relayed \\0-framed JSON chunks
  POST /worker_get_status
Dispatch: 'lottery' (speed-weighted random) or 'shortest_queue'.  It holds
no model and touches no device.

    python -m streammind_torch.serve.controller --host 127.0.0.1 --port 10000
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

from ..constants import CONTROLLER_HEART_BEAT_EXPIRATION
from ..utils.logging import build_logger

logger = logging.getLogger("controller")  # main() adds its log file

SERVER_ERROR_MSG = (
    "**NETWORK ERROR DUE TO HIGH TRAFFIC. PLEASE REGENERATE OR REFRESH THIS PAGE.**"
)


@dataclasses.dataclass
class WorkerInfo:
    model_names: List[str]
    speed: float
    queue_length: int
    check_heart_beat: bool
    last_heart_beat: float


class Controller:
    def __init__(self, dispatch_method: str = "shortest_queue"):
        assert dispatch_method in ("lottery", "shortest_queue")
        self.dispatch_method = dispatch_method
        self.worker_info: Dict[str, WorkerInfo] = {}
        self._lock = threading.Lock()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True
        )
        self._hb_thread.start()

    # -- registry ---------------------------------------------------------
    def register_worker(
        self, worker_name: str, check_heart_beat: bool, worker_status: Optional[dict]
    ) -> bool:
        if worker_status is None:
            worker_status = self._fetch_worker_status(worker_name)
        if worker_status is None:
            return False
        with self._lock:
            self.worker_info[worker_name] = WorkerInfo(
                model_names=worker_status["model_names"],
                speed=worker_status.get("speed", 1.0),
                queue_length=worker_status.get("queue_length", 0),
                check_heart_beat=check_heart_beat,
                last_heart_beat=time.time(),
            )
        logger.info(f"Register worker: {worker_name}")
        return True

    def _fetch_worker_status(self, worker_name: str) -> Optional[dict]:
        try:
            return http_post_json(worker_name + "/worker_get_status", {}, timeout=5)
        except Exception as e:  # noqa: BLE001
            logger.info(f"Get status fails: {worker_name}, {e}")
            return None

    def remove_worker(self, worker_name: str):
        with self._lock:
            self.worker_info.pop(worker_name, None)

    def refresh_all_workers(self):
        with self._lock:
            old = dict(self.worker_info)
            self.worker_info.clear()
        for name, info in old.items():
            if not self.register_worker(name, info.check_heart_beat, None):
                logger.info(f"Remove stale worker: {name}")

    def list_models(self) -> List[str]:
        models = set()
        with self._lock:
            for info in self.worker_info.values():
                models.update(info.model_names)
        return sorted(models)

    # -- dispatch ---------------------------------------------------------
    def get_worker_address(self, model_name: str) -> str:
        with self._lock:
            candidates = [
                (name, info)
                for name, info in self.worker_info.items()
                if model_name in info.model_names
            ]
        if not candidates:
            return ""
        if self.dispatch_method == "lottery":
            speeds = np.asarray([i.speed for _, i in candidates], np.float32)
            total = float(speeds.sum())
            if total <= 0:
                return ""
            pt = np.random.uniform(0, total)
            idx = int(np.searchsorted(np.cumsum(speeds), pt))
            return candidates[min(idx, len(candidates) - 1)][0]
        # shortest_queue, speed-normalized
        qlens = [i.queue_length / max(i.speed, 1e-6) for _, i in candidates]
        idx = int(np.argmin(qlens))
        name = candidates[idx][0]
        with self._lock:
            if name in self.worker_info:
                self.worker_info[name].queue_length += 1
        return name

    def receive_heart_beat(self, worker_name: str, queue_length: int) -> bool:
        with self._lock:
            info = self.worker_info.get(worker_name)
            if info is None:
                return False  # worker must re-register
            info.queue_length = queue_length
            info.last_heart_beat = time.time()
            return True

    def _heartbeat_loop(self):
        while True:
            time.sleep(CONTROLLER_HEART_BEAT_EXPIRATION)
            self.remove_expired_workers()

    def remove_expired_workers(self, now: Optional[float] = None) -> List[str]:
        """Drop the heartbeat-checked workers silent for longer than
        CONTROLLER_HEART_BEAT_EXPIRATION; returns their names."""
        expire = (time.time() if now is None else now) - CONTROLLER_HEART_BEAT_EXPIRATION
        with self._lock:
            dead = [name for name, info in self.worker_info.items()
                    if info.check_heart_beat and info.last_heart_beat < expire]
        for name in dead:
            logger.info(f"Expire worker: {name}")
            self.remove_worker(name)
        return dead

    # -- relay ------------------------------------------------------------
    def worker_api_generate_stream(self, params: dict):
        addr = self.get_worker_address(params["model"])
        if not addr:
            yield json.dumps(
                {"text": SERVER_ERROR_MSG, "error_code": 2}
            ).encode() + b"\0"
            return
        try:
            req = urllib.request.Request(
                addr + "/worker_generate_stream",
                data=json.dumps(params).encode(),
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=120) as resp:
                # verbatim relay: framing (\0 delimiters) passes through.
                # read1 hands on whatever has arrived (up to 4 KiB); read(4096)
                # would hold a stream's small chunks back until 4 KiB had
                # come, so a client would see the first tokens late
                while True:
                    chunk = resp.read1(4096)
                    if not chunk:
                        break
                    yield chunk
        except Exception:  # noqa: BLE001
            self.remove_worker(addr)
            yield json.dumps(
                {"text": SERVER_ERROR_MSG, "error_code": 3}
            ).encode() + b"\0"


def http_post_json(url: str, payload: dict, timeout: float = 30) -> dict:
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def make_handler(controller: Controller):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            logger.info("%s - %s" % (self.address_string(), fmt % args))

        def _json(self, payload: dict, status: int = 200):
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):  # noqa: N802
            length = int(self.headers.get("Content-Length", 0))
            data = json.loads(self.rfile.read(length) or b"{}")
            path = self.path.rstrip("/")
            if path == "/register_worker":
                ok = controller.register_worker(
                    data["worker_name"],
                    data["check_heart_beat"],
                    data.get("worker_status"),
                )
                self._json({"exist": ok})
            elif path == "/refresh_all_workers":
                controller.refresh_all_workers()
                self._json({})
            elif path == "/list_models":
                self._json({"models": controller.list_models()})
            elif path == "/get_worker_address":
                self._json({"address": controller.get_worker_address(data["model"])})
            elif path == "/receive_heart_beat":
                exist = controller.receive_heart_beat(
                    data["worker_name"], data["queue_length"]
                )
                self._json({"exist": exist})
            elif path == "/worker_generate_stream":
                if "model" not in data:
                    # validate BEFORE committing the 200 + stream headers —
                    # a KeyError after them aborts the connection and the
                    # client sees a successful-looking empty stream
                    self._json({"text": "missing 'model' in request",
                                "error_code": 2}, status=400)
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.end_headers()
                try:
                    for chunk in controller.worker_api_generate_stream(data):
                        self.wfile.write(chunk)
                        self.wfile.flush()
                except OSError:
                    # relay/worker failures already arrive as framed
                    # error_code chunks from worker_api_generate_stream; the
                    # only exceptions reaching here are CLIENT-socket write
                    # failures — the peer is gone, nothing to send
                    pass
            elif path == "/worker_get_status":
                models = controller.list_models()
                with controller._lock:
                    speed = sum(i.speed for i in controller.worker_info.values())
                    qlen = sum(i.queue_length for i in controller.worker_info.values())
                self._json(
                    {"model_names": models, "speed": speed, "queue_length": qlen}
                )
            else:
                self._json({"error": f"unknown path {path}"}, status=404)

    return Handler


def serve(host: str = "0.0.0.0", port: int = 10000,
          dispatch_method: str = "shortest_queue") -> ThreadingHTTPServer:
    controller = Controller(dispatch_method)
    server = ThreadingHTTPServer((host, port), make_handler(controller))
    server.controller = controller
    return server


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", type=str, default="localhost")
    parser.add_argument("--port", type=int, default=10000)
    parser.add_argument(
        "--dispatch-method",
        type=str,
        choices=["lottery", "shortest_queue"],
        default="shortest_queue",
    )
    args = parser.parse_args()
    build_logger("controller", "controller.log")
    server = serve(args.host, args.port, args.dispatch_method)
    logger.info(f"controller listening on {args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
