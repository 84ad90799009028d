"""Browser chat UI on the standard library: one HTML page with
fetch-streaming JS, served next to a JSON proxy to the controller.

  python -m streammind_torch.serve.web_server --controller-url http://127.0.0.1:10000

In-process mode (no controller, no worker): ``--model-path`` loads the
model in this process through the port's ``ModelWorker`` on ``--device``
(default ``cuda``) and serves the same page straight off it.

  python -m streammind_torch.serve.web_server --model-path ckpt/ --device cuda

POST /api/list_models, /api/generate (\\0-framed JSON chunks, relayed from
the controller's /worker_generate_stream or the in-process worker) and
/api/vote (appended to ``votes.jsonl`` under ``constants.LOGDIR``); each
body is capped before it is read.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..constants import LOGDIR
from ..utils.logging import build_logger
from .controller import http_post_json

logger = logging.getLogger("web_server")  # main() adds its log file

_PAGE = """<!DOCTYPE html>
<html><head><title>StreamMind</title>
<style>
 body { font-family: sans-serif; max-width: 760px; margin: 2em auto; }
 #log { border: 1px solid #ccc; padding: 1em; min-height: 280px; white-space: pre-wrap; }
 textarea, input, select, button { font-size: 1em; margin: 0.2em 0; }
 textarea { width: 100%; height: 4em; }
</style></head>
<body>
<h2>StreamMind</h2>
<div>model: <select id="model"></select>
 temperature <input id="temp" type="number" value="0.2" step="0.1" style="width:4em">
 max tokens <input id="maxtok" type="number" value="256" style="width:5em"></div>
<div>video path (server-side): <input id="video" style="width:60%"></div>
<div id="log"></div>
<textarea id="msg" placeholder="Ask about the video..."></textarea>
<button onclick="send()">Send</button>
<button onclick="vote('upvote')">&#128077;</button>
<button onclick="vote('downvote')">&#128078;</button>
<script>
async function vote(kind) {
  await fetch('/api/vote', {method:'POST', body: JSON.stringify({
    type: kind, model: document.getElementById('model').value,
    history: history})});
}
async function refresh() {
  const r = await fetch('/api/list_models', {method:'POST'});
  const d = await r.json();
  const sel = document.getElementById('model');
  sel.innerHTML = '';
  for (const m of d.models) { const o = document.createElement('option'); o.text = m; sel.add(o); }
}
let history = [];
async function send() {
  const msg = document.getElementById('msg').value;
  const log = document.getElementById('log');
  history.push(['USER', msg]);
  log.textContent += 'USER: ' + msg + '\\n';
  const payload = {
    model: document.getElementById('model').value,
    prompt: buildPrompt(),
    video_path: document.getElementById('video').value,
    temperature: parseFloat(document.getElementById('temp').value),
    max_new_tokens: parseInt(document.getElementById('maxtok').value),
  };
  const resp = await fetch('/api/generate', {method:'POST', body: JSON.stringify(payload)});
  const reader = resp.body.getReader();
  const dec = new TextDecoder();
  let buf = '', text = '';
  log.textContent += 'ASSISTANT: ';
  const base = log.textContent;
  while (true) {
    const {done, value} = await reader.read();
    if (done) break;
    buf += dec.decode(value, {stream: true});
    const parts = buf.split('\\u0000');
    buf = parts.pop();
    for (const p of parts) {
      if (!p) continue;
      const d = JSON.parse(p);
      text = d.text;
      log.textContent = base + text;
    }
  }
  history.push(['ASSISTANT', text]);
  log.textContent += '\\n';
  document.getElementById('msg').value = '';
}
function buildPrompt() {
  const sys = "A chat between a curious user and an artificial intelligence assistant. " +
    "The assistant gives helpful, detailed, and polite answers to the user's questions.";
  let out = '';
  for (let i = 0; i < history.length; i++) {
    const [role, m] = history[i];
    if (role === 'USER') {
      let text = m;
      if (i === 0) text = "<<SYS>>\\n" + sys + "\\n<</SYS>>\\n\\n<video>\\n" + text;
      out += "[INST] " + text + " [/INST]";
    } else { out += ' ' + m + ' </s>'; }
  }
  return out;
}
refresh();
</script></body></html>
"""


def make_handler(controller_url=None, worker=None):
    """controller_url: proxy to the controller and its workers; worker: the
    in-process mode, served straight off that ModelWorker."""

    class Handler(BaseHTTPRequestHandler):
        # per-route body caps, checked before the body is read: the server
        # is unauthenticated, and only /api/generate carries video
        BODY_CAPS = {"/api/generate": 512 * 1024 * 1024}
        DEFAULT_BODY_CAP = 64 * 1024

        def log_message(self, fmt, *args):
            logger.info("%s - %s" % (self.address_string(), fmt % args))

        def _send(self, status: int, ctype: str, body: bytes, close: bool = False):
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            if close:
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        def _json(self, out: dict, status: int = 200, close: bool = False):
            self._send(status, "application/json", json.dumps(out).encode(), close)

        def do_GET(self):  # noqa: N802
            self._send(200, "text/html; charset=utf-8", _PAGE.encode())

        def do_POST(self):  # noqa: N802
            length = int(self.headers.get("Content-Length", 0))
            route = self.path.split("?", 1)[0]
            if length > self.BODY_CAPS.get(route, self.DEFAULT_BODY_CAP):
                self._json({"ok": False, "error": "payload too large"}, 413, close=True)
                return
            data = json.loads(self.rfile.read(length) or b"{}")
            if route == "/api/list_models":
                if worker is not None:
                    self._json({"models": [worker.model_name]})
                else:
                    self._json(http_post_json(controller_url + "/list_models", {}))
            elif route == "/api/vote":
                if not isinstance(data, dict):
                    self._json({"ok": False, "error": "bad vote payload"})
                    return
                os.makedirs(LOGDIR, exist_ok=True)
                with open(os.path.join(LOGDIR, "votes.jsonl"), "a") as f:
                    f.write(json.dumps({"tstamp": time.time(), **data}) + "\n")
                self._json({"ok": True})
            elif route == "/api/generate":
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.end_headers()
                if worker is not None:
                    chunks = worker.generate_stream_gate(data)
                else:
                    chunks = _relay(controller_url + "/worker_generate_stream", data)
                for chunk in chunks:
                    self.wfile.write(chunk)
                    self.wfile.flush()
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def _relay(url: str, payload: dict):
    """The controller's stream, as it arrives."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        while True:
            chunk = resp.read(256)
            if not chunk:
                return
            yield chunk


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--controller-url", default="http://localhost:10000")
    parser.add_argument("--model-path", default=None,
                        help="in-process mode: load the model here and serve it directly "
                             "(no controller or worker)")
    parser.add_argument("--device", default="cuda",
                        help="in-process mode: the device the model runs on")
    args = parser.parse_args()
    build_logger("web_server", "web_server.log")
    if args.model_path:
        from .model_worker import ModelWorker

        worker = ModelWorker(controller_addr="", worker_addr="", model_path=args.model_path,
                             no_register=True, device=args.device)
        handler = make_handler(worker=worker)
        logger.info(f"web ui (in-process model on {args.device}) on "
                    f"http://{args.host}:{args.port}")
    else:
        handler = make_handler(controller_url=args.controller_url)
        logger.info(f"web ui on http://{args.host}:{args.port}")
    ThreadingHTTPServer((args.host, args.port), handler).serve_forever()


if __name__ == "__main__":
    main()
