"""ctypes binding for the native video-ingest library (``native/ingest.cpp``).

One C++ pass (libavformat/avcodec/swscale) decodes a frame, letterboxes it
with the CLIP mean fill, resizes it and CLIP-normalizes it into (3, S, S)
fp32.  The library is built from ``native/ingest.cpp`` at first use with
the flags and libraries of ``native/Makefile`` into
``streammind_torch/_kernels/``, named by a hash of the source and the
flags, through a temporary file renamed into place (so concurrent builders
never see a half-written library, and nothing is written into
``native/``).  ``available()`` is False when the library cannot be built or
loaded (no compiler, no libav headers or libraries): callers then read
video through ``mm_utils``' Python path.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_REPO = Path(__file__).resolve().parent.parent
SOURCE = _REPO / "native" / "ingest.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_kernels"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")  # native/Makefile's
LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")

_lock = threading.Lock()
_lib = None
_load_failed = False


def lib_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode() + b"\0" + SOURCE.read_bytes())
    return BUILD_DIR / f"libsm_ingest_{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it is built already; raise if the compiler
    fails.  Returns its path."""
    out = lib_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native ingest build failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:  # a failure is remembered: no rebuild per call
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            _load_failed = True
            return None
        lib.sm_open.restype = ctypes.c_void_p
        lib.sm_open.argtypes = [ctypes.c_char_p]
        lib.sm_info.restype = ctypes.c_int
        lib.sm_info.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.sm_close.restype = None
        lib.sm_close.argtypes = [ctypes.c_void_p]
        lib.sm_read_frames.restype = ctypes.c_int
        lib.sm_read_frames.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.sm_write_test_video.restype = ctypes.c_int
        lib.sm_write_test_video.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


class NativeVideoReader:
    """One open container; sequential or sparse indexed reads, each returning
    model-ready (N, 3, size, size) float32 CLIP pixel values."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("native ingest library unavailable")
        self._lib = lib
        self._h = lib.sm_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open video: {path}")
        fps = ctypes.c_double()
        nframes = ctypes.c_longlong()
        w = ctypes.c_int()
        h = ctypes.c_int()
        lib.sm_info(self._h, ctypes.byref(fps), ctypes.byref(nframes),
                    ctypes.byref(w), ctypes.byref(h))
        self.fps = float(fps.value)
        self.num_frames = int(nframes.value)
        self.width, self.height = int(w.value), int(h.value)

    def read(self, indices: Sequence[int], size: int = 336,
             pad_square: bool = True, strict: bool = True) -> np.ndarray:
        """Decode the requested frames, returned in the requested order (the
        decoder visits them ascending).  strict=True raises when the
        container yields fewer frames than asked (a corrupt tail, or a frame
        count that the metadata overestimates); strict=False returns the
        frames decoded, in their requested relative order."""
        req = [int(i) for i in indices]
        order = np.argsort(req, kind="stable")
        idx = np.asarray([req[i] for i in order], np.int64)
        out = np.empty((len(idx), 3, size, size), np.float32)
        n = self._lib.sm_read_frames(
            self._h,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            len(idx), size, int(pad_square),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if n < 0:
            raise IOError("native frame read failed")
        if n < len(idx):
            if strict:
                raise IOError(
                    f"short read: requested {len(idx)} frames, decoded {n} "
                    f"(frame count metadata may overestimate; pass strict=False "
                    f"to accept)"
                )
            out = out[:n]
            order = order[:n]
        return out[np.argsort(order, kind="stable")]

    def close(self):
        if self._h:
            self._lib.sm_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass


def write_test_video(path: str, w: int = 224, h: int = 160,
                     n_frames: int = 30, fps: int = 10) -> None:
    """A synthetic MPEG-4 clip (a luma gradient shifting each frame), in the
    container that ``path``'s extension names."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native ingest library unavailable")
    rc = lib.sm_write_test_video(path.encode(), w, h, n_frames, fps)
    if rc != 0:
        raise IOError(f"test video write failed: {rc}")


def native_process_video(
    video_path: str,
    num_frames: int = 8,
    sample_scheme: str = "uniform",
    size: int = 336,
    pad_square: bool = True,
) -> np.ndarray:
    """``mm_utils.process_video`` on the native path: (num_frames, 3, size,
    size) fp32, the last decoded frame repeated where the container holds
    fewer frames than its metadata says."""
    from .mm_utils import frame_sample

    with NativeVideoReader(video_path) as vr:
        ids = frame_sample(vr.num_frames, sample_scheme, num_frames, vr.fps)
        out = vr.read(ids, size=size, pad_square=pad_square, strict=False)
        if 0 < len(out) < len(ids):
            pad = np.repeat(out[-1:], len(ids) - len(out), axis=0)
            out = np.concatenate([out, pad], axis=0)
        return out
