"""Build and load the hand-written CUDA kernels under ``streammind_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
its own with ``nvcc`` for ``sm_90a`` into a shared library, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries go
into ``streammind_torch/_kernels/``, named by a hash of their source, the
``csrc`` headers it includes and the flags, at first use; ``build_all``
starts one ``nvcc`` per source, all at once.
Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_kernels"
KERNELS = ("flash_attention", "exact_attention", "int4_matvec", "paged_attention",
           "flash_bwd_dq", "flash_bwd_dkv", "int8_matvec", "selective_scan",
           "int4_grouped_gemm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time, "log": nvcc/ptxas output}
build_logs: Dict[str, dict] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                           "with the CUDA toolkit")
    return path


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def _sources(name: str, csrc: Path = CSRC) -> list:
    """``csrc/<name>.cu`` and every header beside it that it includes, directly
    or through another header."""
    todo, seen = [csrc / f"{name}.cu"], []
    while todo:
        path = todo.pop()
        if path not in seen:
            seen.append(path)
            todo += [path.parent / inc for inc in _INCLUDE.findall(path.read_text())
                     if (path.parent / inc).exists()]
    return seen


def _lib_path(name: str, csrc: Path = CSRC) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name, csrc):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def _start(name: str, out: Path) -> subprocess.Popen:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every kernel not built yet, one nvcc process per source, all
    started together.  Returns ``build_logs``; raises if any build fails."""
    names = list(KERNELS if names is None else names)
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for name in names:
            out = _lib_path(name)
            if not out.exists():
                procs[name] = (out, _start(name, out))
        failed = []
        for name, (out, proc) in procs.items():
            log, _ = proc.communicate()
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            build_logs[name] = {"seconds": time.perf_counter() - t0, "log": log}
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return build_logs


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry point and argument types of each kernel (see the .cu files)
SIGNATURES = {
    "flash_attention": ("sm_flash_attention", [_P] * 7 + [_I] * 8 + [_L] * 9 + [_F, _P]),
    "exact_attention": ("sm_exact_attention", [_P] * 4 + [_I] * 7 + [_L] * 9 + [_F, _P]),
    "int4_matvec": ("sm_int4_matvec", [_P] * 4 + [_I] * 6 + [_P, _P]),
    "paged_attention": ("sm_paged_attention", [_P] * 11 + [_I] * 9 + [_F, _P]),
    "flash_bwd_dq": ("sm_flash_bwd_dq", [_P] * 8 + [_I] * 8 + [_L] * 12 + [_F, _P]),
    "flash_bwd_dkv": ("sm_flash_bwd_dkv", [_P] * 9 + [_I] * 8 + [_L] * 12 + [_F, _P]),
    "int8_matvec": ("sm_int8_matvec", [_P] * 4 + [_I] * 5 + [_P]),
    "selective_scan": ("sm_selective_scan", [_P] * 11 + [_I] * 6 + [_L] * 15 + [_P]),
    "int4_grouped_gemm": ("sm_int4_grouped_gemm", [_P] * 9 + [_I] * 4 + [_P]),
}


def kernel(name: str):
    """The C entry point of kernel ``name`` (built and loaded at first use),
    with its argument types declared so pointers pass as 64-bit values."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        with _lock:
            if name not in _libs:
                lib = ctypes.CDLL(str(path))
                symbol, argtypes = SIGNATURES[name]
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _libs[name] = lib
            lib = _libs[name]
    return getattr(lib, SIGNATURES[name][0])


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (the wrappers size grids by it)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
