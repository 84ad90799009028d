"""Register a model worker with the controller by hand.

    python -m streammind_torch.serve.register_worker \\
        --controller-address http://127.0.0.1:10000 --worker-name http://127.0.0.1:21002
"""
from __future__ import annotations

import argparse

from .controller import http_post_json


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--controller-address", required=True)
    parser.add_argument("--worker-name", required=True)
    parser.add_argument("--check-heart-beat", action="store_true")
    args = parser.parse_args()
    out = http_post_json(args.controller_address + "/register_worker",
                         {"worker_name": args.worker_name,
                          "check_heart_beat": args.check_heart_beat, "worker_status": None})
    print(out)


if __name__ == "__main__":
    main()
