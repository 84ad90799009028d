"""HTTP model worker: hosts one StreamMind model on the card and streams
generations.

The JAX package's worker protocol:
  - registers with the controller at startup and heartbeats every
    WORKER_HEART_BEAT_INTERVAL seconds, re-registering if the controller
    forgot it;
  - POST /worker_generate_stream {prompt, video_b64 | video | video_path |
    images, temperature, top_p, top_k, max_new_tokens, stop} → \\0-framed
    JSON chunks {"text", "error_code", "frames"}, one a decoded token
    (``StreamMindEngine.decode_stream``);
  - POST /worker_get_status → {model_names, speed, queue_length};
  - POST /stream_session/start | frame | stop: live event-gated sessions,
    one StreamSession each, or (multistream_capacity > 0) all in one
    BatchedSessionBroker over the paged KV pool;
  - a semaphore bounds concurrent generations.

Pixels arrive as a base64 npz ({"pixels": (T, 3, H, W)}: ``video_b64``, and
for session frames ``pixels_b64``, which the JAX worker lacks) or as nested
lists; the JPEG routes (``images``, ``frame_b64``, raw frames through
``process_video``) need PIL.  The tokenizer is passed in or loaded by
``api.model_init`` through ``transformers``.

    python -m streammind_torch.serve.model_worker --model-path ckpt/ \\
        --controller-address http://127.0.0.1:10000 --port 21002
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import logging
import os
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ..constants import MMODAL_TOKEN_INDEX, NUM_FRAMES, WORKER_HEART_BEAT_INTERVAL
from ..mm_utils import tokenizer_multimodal_token
from ..utils.logging import build_logger
from .controller import SERVER_ERROR_MSG, http_post_json

logger = logging.getLogger("model_worker")  # main() adds its log file


def _npz_pixels(data: str) -> np.ndarray:
    arr = np.load(io.BytesIO(base64.b64decode(data)))
    return arr["pixels"] if hasattr(arr, "files") else np.asarray(arr)


def _chunk(payload: dict) -> bytes:
    return json.dumps(payload).encode() + b"\0"


class ModelWorker:
    def __init__(
        self,
        controller_addr: str,
        worker_addr: str,
        model_path: str,
        model_name: Optional[str] = None,
        limit_model_concurrency: int = 5,
        no_register: bool = False,
        model=None,
        tokenizer=None,
        quantize_gate=False,
        fast_vision=False,
        load_8bit: bool = False,
        load_4bit=False,
        multistream_capacity: int = 0,
        kv_mode: str = "paged",
        num_pages: Optional[int] = None,
        page_size: int = 64,
        prewarm: bool = False,
        model_base: Optional[str] = None,  # base decoder for LoRA / adapter checkpoints
        use_taug: Optional[bool] = None,  # temporal-aug photo grid; None: "use_taug" in the path
        vit_attn: str = "auto",  # the engine's ViT attention (api.model_init)
        device="cuda",
    ):
        """With ``model`` (an api.StreamMindModel) the worker serves it as it
        is; otherwise it loads ``model_path`` through api.model_init with the
        tier knobs on ``device``."""
        self.worker_id = str(uuid.uuid4())[:6]
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.model_name = model_name or (model_path.split("/")[-1] if model_path else "streammind")
        self.semaphore = threading.Semaphore(limit_model_concurrency)
        self.limit = limit_model_concurrency
        self._waiting = 0
        self._sessions = {}
        self._sessions_lock = threading.Lock()
        self._stop = threading.Event()

        if model is None:
            from ..api import model_init

            model, self.processor, tokenizer, self.version = model_init(
                model_path, quantize_gate=quantize_gate, fast_vision=fast_vision,
                load_8bit=load_8bit, load_4bit=load_4bit, model_base=model_base,
                vit_attn=vit_attn, device=device)
        else:
            self.processor, self.version = None, "llama_2"
        self.model = model
        self.tokenizer = tokenizer
        self.use_taug = "use_taug" in (model_path or "") if use_taug is None else use_taug

        self.broker = None
        if multistream_capacity > 0:
            from .broker import BatchedSessionBroker

            self.broker = BatchedSessionBroker(
                self.model.engine, capacity=multistream_capacity, kv_mode=kv_mode,
                num_pages=num_pages, page_size=page_size)
            if prewarm:
                self._prewarm_broker()

        if not no_register:
            self.register_to_controller()
            threading.Thread(target=self._heartbeat_loop, daemon=True).start()

    def _prewarm_broker(self):
        """One silent tick through the batched server before serving, so the
        kernels are built before the first client's frame."""
        size = self.model.cfg.vision.image_size
        srv = self.broker.server
        t0 = time.time()
        with self.broker._step_lock, self.broker._cv:
            srv.add_stream("__warm__", self.tokenizer, gate_threshold=2.0)
        with self.broker._step_lock:
            srv.step({"__warm__": np.zeros((1, 3, size, size), np.float32)})
        with self.broker._step_lock, self.broker._cv:
            srv.remove_stream("__warm__")
        logger.info(f"prewarm done in {time.time() - t0:.1f}s")

    # -- controller plumbing ---------------------------------------------
    def register_to_controller(self):
        logger.info("Register to controller")
        http_post_json(self.controller_addr + "/register_worker",
                       {"worker_name": self.worker_addr, "check_heart_beat": True,
                        "worker_status": self.get_status()})

    def shutdown(self):
        """Stop the heartbeats and the broker's tick thread (the HTTP server
        is the caller's to shut down)."""
        self._stop.set()
        if self.broker is not None:
            self.broker.shutdown()

    def _heartbeat_loop(self):
        while not self._stop.wait(WORKER_HEART_BEAT_INTERVAL):
            try:
                exist = http_post_json(
                    self.controller_addr + "/receive_heart_beat",
                    {"worker_name": self.worker_addr, "queue_length": self.get_queue_length()},
                    timeout=5)["exist"]
                if not exist:
                    self.register_to_controller()
            except Exception as e:  # noqa: BLE001
                logger.error(f"heart beat error: {e}")

    def get_queue_length(self) -> int:
        # in flight (holding the semaphore) + blocked waiting for it
        return (self.limit - self.semaphore._value) + self._waiting

    def get_status(self) -> dict:
        return {"model_names": [self.model_name], "speed": 1,
                "queue_length": self.get_queue_length()}

    # -- one-shot generation ---------------------------------------------
    def _decode_video_param(self, params: dict):
        """video_b64 (base64 npz of pixels) / video_path (server-side file) /
        video (pixels, or raw (T, H, W, 3) frames to preprocess) / images."""
        if "video_b64" in params:
            return _npz_pixels(params["video_b64"])
        cfg = self.model.cfg
        size, nf = cfg.vision.image_size, cfg.num_frames or NUM_FRAMES
        if "video_path" in params and self.processor is not None:
            if self.use_taug:
                from ..mm_utils import process_video_taug

                # the processor's knobs, so a video preprocesses the same way
                # whichever route it takes
                return process_video_taug(params["video_path"], num_frames=nf,
                                          aspect_ratio=None, image_size=size)
            return self.processor(params["video_path"])
        if "video" in params:
            arr = np.asarray(params["video"])
            if arr.ndim == 4 and arr.shape[-1] == 3 and arr.shape[1] != 3:
                # raw (T, H, W, 3) frames: the worker's video preprocessing
                from ..mm_utils import process_video, process_video_taug

                if np.issubdtype(arr.dtype, np.floating):
                    # float frames: 0..1-normalized or already 0..255
                    if arr.max() <= 1.0 + 1e-6:
                        arr = arr * 255.0
                    arr = np.clip(np.round(arr), 0, 255).astype(np.uint8)
                else:
                    # JSON transport widens uint8 to int64
                    arr = np.clip(arr, 0, 255).astype(np.uint8)
                if self.use_taug:
                    return process_video_taug(arr, num_frames=nf, aspect_ratio=None,
                                              image_size=size)
                return process_video(arr, num_frames=nf, aspect_ratio=None, image_size=size)
            return arr.astype(np.float32)
        if "images" in params:
            from PIL import Image

            from ..mm_utils import clip_preprocess

            frames = []
            for img in params["images"]:
                if isinstance(img, str):
                    frames.append(Image.open(io.BytesIO(base64.b64decode(img))))
                else:
                    frames.append(Image.fromarray(np.asarray(img, np.uint8)))
            return clip_preprocess(frames, image_size=size)
        return None

    def generate_stream(self, params: dict):
        from .. import api
        from .safety import SAFETY_MSG, safety_check

        prompt = params["prompt"]
        temperature = float(params.get("temperature", 0.0))
        top_p = float(params.get("top_p", 1.0))
        top_k = int(params.get("top_k", 0))
        max_new_tokens = min(int(params.get("max_new_tokens", 256)), 1024)
        stop_str = params.get("stop")

        video = self._decode_video_param(params)
        if video is None:
            yield _chunk({"text": "(no video provided)", "error_code": 1})
            return

        model, tokenizer = self.model, self.tokenizer
        engine = model.engine
        input_ids = tokenizer_multimodal_token(prompt, tokenizer, MMODAL_TOKEN_INDEX["VIDEO"])
        with torch.no_grad():
            pixels = api._pixels(model, video)
            n_frames = int(pixels.shape[0])  # spliced frames (a taug grid counts once)
            plan, mem_buf = api.splice_inputs(model, input_ids, api.encode_memory(model, pixels))
            # one-shot request: a right-sized cache
            cache = engine.new_kv_cache(
                dtype=mem_buf.dtype,
                capacity=engine.cache_capacity_for(len(plan.token_ids), max_new_tokens))
            last, cache = engine.prefill(plan, mem_buf, cache)

        generator = None
        if temperature > 0:  # fresh randomness for each request
            generator = torch.Generator(device=engine.device).manual_seed(
                int.from_bytes(os.urandom(4), "little"))
        generated: list = []
        for tok in engine.decode_stream(last, cache, max_new_tokens=max_new_tokens,
                                        temperature=temperature, top_k=top_k, top_p=top_p,
                                        generator=generator):
            generated.append(tok)
            try:
                text = tokenizer.decode(generated, skip_special_tokens=True)
            except TypeError:
                text = tokenizer.decode(generated)
            # periodic keyword safety scan
            if len(generated) % 8 == 0 and not safety_check(text):
                yield _chunk({"text": SAFETY_MSG, "error_code": 1})
                return
            if stop_str and stop_str in text:
                yield _chunk({"text": text.split(stop_str)[0], "error_code": 0,
                              "frames": n_frames})
                return
            yield _chunk({"text": text, "error_code": 0, "frames": n_frames})

    def generate_stream_gate(self, params: dict):
        try:
            self._waiting += 1
            with self.semaphore:
                self._waiting -= 1
                yield from self.generate_stream(params)
        except Exception as e:  # noqa: BLE001
            logger.exception("generate error")
            yield _chunk({"text": f"{SERVER_ERROR_MSG}\n\n({e})", "error_code": 1})

    # -- live streaming-video sessions (the event-gated loop) ---------------
    MAX_SESSIONS = 16
    SESSION_TTL_S = 1800.0

    def _sweep_sessions(self) -> None:
        """Evict idle sessions past TTL, then the oldest idle beyond the cap:
        each session holds a KV cache and a memory ring."""
        now = time.time()
        with self._sessions_lock:
            for sid in [s for s, (_, _, used) in self._sessions.items()
                        if now - used > self.SESSION_TTL_S]:
                del self._sessions[sid]
            while len(self._sessions) >= self.MAX_SESSIONS:
                oldest = min(self._sessions, key=lambda s: self._sessions[s][2])
                del self._sessions[oldest]

    def stream_session_start(self, params: dict) -> dict:
        self._sweep_sessions()
        sid = params.get("session_id") or str(uuid.uuid4())[:8]
        prompt = params.get("prompt")
        prompt_ids = (tokenizer_multimodal_token(prompt, self.tokenizer,
                                                 MMODAL_TOKEN_INDEX["VIDEO"])
                      if prompt else None)
        kw = dict(
            prompt_ids=prompt_ids,
            max_new_tokens=int(params.get("max_new_tokens", 128)),
            gate_threshold=params.get("gate_threshold"),
            temperature=float(params.get("temperature", 0.0)),
            top_k=int(params.get("top_k", 0)),
            top_p=float(params.get("top_p", 0.0)),
            # memory-token subsampling before the splice
            sample_type=str(params.get("sample_type", "all")),
            sample_per=float(params.get("sample_per", 0.5)),
        )
        if self.broker is not None:
            try:
                self.broker.add(sid, self.tokenizer, **kw)
            except (RuntimeError, ValueError) as e:
                return {"error": str(e), "error_code": 2}
            return {"session_id": sid}
        from ..streaming.engine import StreamSession

        session = StreamSession(self.model.engine, self.tokenizer, **kw)
        with self._sessions_lock:
            self._sessions[sid] = (session, threading.Lock(), time.time())
        return {"session_id": sid}

    def _decode_frame(self, params: dict) -> Optional[torch.Tensor]:
        """One frame's (1, 3, H, W) fp32 pixels: pixels_b64 (base64 npz),
        pixels (nested list) or frame_b64 (an encoded image, through PIL)."""
        if "pixels_b64" in params:
            return torch.from_numpy(np.asarray(_npz_pixels(params["pixels_b64"]), np.float32))
        if "pixels" in params:
            return torch.from_numpy(np.asarray(params["pixels"], np.float32))
        if "frame_b64" in params:
            from ..mm_utils import clip_preprocess, load_image_from_base64

            img = load_image_from_base64(params["frame_b64"])
            return torch.from_numpy(clip_preprocess(
                [img], image_size=self.model.cfg.vision.image_size))
        return None

    def stream_session_frame(self, params: dict) -> dict:
        sid = params.get("session_id")
        if self.broker is not None:
            try:
                pixels = self._decode_frame(params)
                if pixels is None:
                    return {"error": "no frame provided (pixels_b64, pixels or frame_b64)",
                            "error_code": 1}
                out = self.broker.submit(sid, pixels)
                if out.pop("closed", False):
                    return {"error": f"session {sid} closed", "error_code": 4}
                if out.get("error"):
                    return {"error": out.pop("error"), "error_code": 1, **out}
                return {**out, "error_code": 0}
            except KeyError:
                return {"error": f"unknown session {sid}", "error_code": 4}
            except Exception as e:  # noqa: BLE001
                logger.exception("batched stream_session_frame error")
                return {"error": f"{type(e).__name__}: {e}", "error_code": 1}
        with self._sessions_lock:
            entry = self._sessions.get(sid)
        if entry is None:
            return {"error": f"unknown session {sid}", "error_code": 4}
        session, lock, _ = entry
        try:
            pixels = self._decode_frame(params)
            if pixels is None:
                return {"error": "no frame provided (pixels_b64, pixels or frame_b64)",
                        "error_code": 1}
            # one frame of a session at a time: its state and ring are
            # updated in place
            with lock:
                text = session.process_frame(pixels)
                with self._sessions_lock:
                    if sid in self._sessions:
                        self._sessions[sid] = (session, lock, time.time())
            return {"fire": text is not None, "text": text,
                    "frame_idx": int(session.state.frame_idx), "error_code": 0}
        except Exception as e:  # noqa: BLE001
            logger.exception("stream_session_frame error")
            return {"error": f"{type(e).__name__}: {e}", "error_code": 1}

    def stream_session_stop(self, params: dict) -> dict:
        sid = params.get("session_id")
        if self.broker is not None:
            try:
                out = self.broker.remove(sid)
            except KeyError:
                return {"error": f"unknown session {sid}", "error_code": 4}
            return {**out, "error_code": 0}
        with self._sessions_lock:
            entry = self._sessions.pop(sid, None)
        if entry is None:
            return {"error": f"unknown session {sid}", "error_code": 4}
        session, lock, _ = entry
        with lock:  # let an in-flight frame finish
            return {"turns": session.turns, "intervals": session.interval_ids,
                    "error_code": 0}


def make_handler(worker: ModelWorker):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
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
            if path == "/worker_generate_stream":
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.end_headers()
                for chunk in worker.generate_stream_gate(data):
                    self.wfile.write(chunk)
                    self.wfile.flush()
            elif path == "/worker_get_status":
                self._json(worker.get_status())
            elif path == "/stream_session/start":
                self._json(worker.stream_session_start(data))
            elif path == "/stream_session/frame":
                self._json(worker.stream_session_frame(data))
            elif path == "/stream_session/stop":
                self._json(worker.stream_session_stop(data))
            else:
                self._json({"error": f"unknown path {path}"}, status=404)

    return Handler


def serve_worker(worker: ModelWorker, host: str, port: int) -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), make_handler(worker))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", type=str, default="localhost")
    parser.add_argument("--port", type=int, default=21002)
    parser.add_argument("--controller-address", type=str, default="http://localhost:10000")
    parser.add_argument("--worker-address", type=str, default="http://localhost:21002")
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--model-base", type=str, default=None,
                        help="base decoder dir for LoRA / mm_projector.bin checkpoints")
    parser.add_argument("--model-name", type=str, default=None)
    parser.add_argument("--limit-model-concurrency", type=int, default=5)
    parser.add_argument("--no-register", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--quantize-gate", nargs="?", const="int8", choices=["int8", "int4"],
                        default=None,
                        help="weight-only quantized gate: int8 (bare flag) or int4, read by "
                             "the int8 / int4 matvec kernels (default: full precision)")
    parser.add_argument("--fast-vision", choices=["bf16", "int8"], default=None,
                        help="fast ViT tier: bf16 softmax, or that and int8 linears "
                             "(default: fp32 softmax)")
    parser.add_argument("--load-8bit", action="store_true",
                        help="the decoder rests int8, per channel")
    parser.add_argument("--load-4bit", action="store_true",
                        help="the decoder rests packed int4, groups of 64")
    parser.add_argument("--multistream-capacity", type=int, default=0,
                        help="> 0: live sessions share one batched MultiStreamServer of this "
                             "capacity through the broker")
    parser.add_argument("--kv-mode", choices=["paged", "dense"], default="paged",
                        help="multistream KV memory: one shared page pool (paged) or a ring "
                             "a dialogue (dense)")
    parser.add_argument("--num-pages", type=int, default=None,
                        help="paged pool size in pages")
    parser.add_argument("--page-size", type=int, default=64, help="tokens per KV page")
    parser.add_argument("--vit-attn", choices=["auto", "exact", "flash", "bf16"], default="auto",
                        help="ViT attention: auto = plain fp32 softmax; exact = the whole-row "
                             "fp32-softmax kernel; flash = the online-softmax kernel; bf16 = "
                             "the fast tier's softmax")
    parser.add_argument("--use-taug", action=argparse.BooleanOptionalAction, default=None,
                        help="temporal-aug photo grids for one-shot video requests (default: "
                             "when 'use_taug' is in the model path)")
    parser.add_argument("--prewarm", action="store_true",
                        help="run one silent batched tick at startup, so the kernels are "
                             "built before the first client frame")
    args = parser.parse_args()
    build_logger("model_worker", "model_worker.log")
    worker = ModelWorker(
        args.controller_address, args.worker_address, args.model_path, args.model_name,
        args.limit_model_concurrency, args.no_register,
        quantize_gate=args.quantize_gate,
        fast_vision={None: False, "bf16": True, "int8": "int8"}[args.fast_vision],
        load_8bit=args.load_8bit, load_4bit=args.load_4bit,
        multistream_capacity=args.multistream_capacity, kv_mode=args.kv_mode,
        num_pages=args.num_pages, page_size=args.page_size, prewarm=args.prewarm,
        model_base=args.model_base, use_taug=args.use_taug, vit_attn=args.vit_attn,
        device=args.device)
    server = serve_worker(worker, args.host, args.port)
    logger.info(f"worker listening on {args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
