"""Endpoint-backed worker: speaks the model worker's protocol but forwards
each generation to an external OpenAI-compatible chat endpoint instead of
holding weights (to set the card's worker beside any hosted backend).

    python -m streammind_torch.serve.endpoint_worker --endpoint-url http://host:8000 \\
        --endpoint-model name --controller-address http://127.0.0.1:10000
"""
from __future__ import annotations

import argparse
import json
import logging
import threading
import urllib.request

from ..utils.logging import build_logger
from .model_worker import ModelWorker, serve_worker

logger = logging.getLogger("endpoint_worker")  # main() adds its log file


class EndpointWorker(ModelWorker):
    """A ModelWorker without a model: /worker_generate_stream streams the
    endpoint's /v1/chat/completions deltas as the worker's \\0-framed
    chunks (the text so far); the session routes have no model to run."""

    def __init__(self, controller_addr, worker_addr, endpoint_url, endpoint_model,
                 model_name=None, api_key="", limit_model_concurrency=5, no_register=False):
        self.endpoint_url = endpoint_url.rstrip("/")
        self.endpoint_model = endpoint_model
        self.api_key = api_key
        self.worker_id = "ep"
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.model_name = model_name or f"endpoint:{endpoint_model}"
        self.semaphore = threading.Semaphore(limit_model_concurrency)
        self.limit = limit_model_concurrency
        self._waiting = 0
        self._sessions = {}
        self._sessions_lock = threading.Lock()
        self._stop = threading.Event()
        self.model = self.tokenizer = self.processor = self.broker = None
        self.version = "llama_2"
        if not no_register:
            self.register_to_controller()
            threading.Thread(target=self._heartbeat_loop, daemon=True).start()

    def generate_stream(self, params: dict):
        body = {
            "model": self.endpoint_model,
            "messages": [{"role": "user", "content": params["prompt"]}],
            "max_tokens": int(params.get("max_new_tokens", 256)),
            "temperature": float(params.get("temperature", 0.0)),
            "stream": True,
        }
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        req = urllib.request.Request(self.endpoint_url + "/v1/chat/completions",
                                     data=json.dumps(body).encode(), headers=headers)
        text = ""
        with urllib.request.urlopen(req, timeout=300) as resp:
            for raw in resp:
                line = raw.decode().strip()
                if not line.startswith("data:"):
                    continue
                payload = line[5:].strip()
                if payload == "[DONE]":
                    break
                choices = json.loads(payload).get("choices") or []
                # content-filter and preamble chunks carry no choices
                delta = choices[0].get("delta", {}).get("content") if choices else None
                if delta:
                    text += delta
                    yield json.dumps({"text": text, "error_code": 0}).encode() + b"\0"


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="localhost")
    parser.add_argument("--port", type=int, default=21003)
    parser.add_argument("--controller-address", default="http://localhost:10000")
    parser.add_argument("--worker-address", default="http://localhost:21003")
    parser.add_argument("--endpoint-url", required=True)
    parser.add_argument("--endpoint-model", required=True)
    parser.add_argument("--api-key", default="")
    parser.add_argument("--no-register", action="store_true")
    args = parser.parse_args()
    build_logger("endpoint_worker", "endpoint_worker.log")
    worker = EndpointWorker(args.controller_address, args.worker_address, args.endpoint_url,
                            args.endpoint_model, api_key=args.api_key,
                            no_register=args.no_register)
    server = serve_worker(worker, args.host, args.port)
    logger.info(f"endpoint worker on {args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
