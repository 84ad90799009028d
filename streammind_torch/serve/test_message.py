"""Smoke client: list the models through the controller and stream one
completion.

    python -m streammind_torch.serve.test_message --controller-address http://127.0.0.1:10000
"""
from __future__ import annotations

import argparse
import json
import urllib.request

from .controller import http_post_json


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--controller-address", default="http://localhost:10000")
    parser.add_argument("--model-name", default=None)
    parser.add_argument("--video-path", default=None)
    parser.add_argument("--message", default="Describe the video.")
    parser.add_argument("--max-new-tokens", type=int, default=32)
    args = parser.parse_args()

    models = http_post_json(args.controller_address + "/list_models", {})["models"]
    print("models:", models)
    model = args.model_name or (models[0] if models else None)
    if model is None:
        print("no workers registered")
        return
    addr = http_post_json(args.controller_address + "/get_worker_address",
                          {"model": model})["address"]
    print("worker:", addr)

    prompt = ("[INST] <<SYS>>\nA chat between a curious user and an artificial intelligence "
              "assistant. The assistant gives helpful, detailed, and polite answers to the "
              f"user's questions.\n<</SYS>>\n\n<video>\n{args.message} [/INST]")
    payload = {"model": model, "prompt": prompt, "max_new_tokens": args.max_new_tokens,
               "temperature": 0.0}
    if args.video_path:
        payload["video_path"] = args.video_path
    req = urllib.request.Request(args.controller_address + "/worker_generate_stream",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        buf = b""
        while True:
            b1 = resp.read(1)
            if not b1:
                break
            if b1 == b"\0":
                print("\r" + json.loads(buf.decode())["text"], end="", flush=True)
                buf = b""
            else:
                buf += b1
    print()


if __name__ == "__main__":
    main()
