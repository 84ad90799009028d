#!/usr/bin/env python3
"""Probe where the paged attention and int8 matvec kernels spend their time,
on one CUDA card, by building variants of their sources in which one part
is changed or removed, and timing each with chip_smoke.py's cases.

    python3 tools/_probe_decode_kernels.py [--variants NAME ...]

Variants (text replacements in ``streammind_torch/csrc/*.cu``; one that no
longer applies to the source is reported and skipped):
  paged_attention: base; no_scores (no q.k products), no_pv (no p.V
  products), no_math (neither: the loads, the ring, the softmax pass and
  the merge alone); stages4, stages6 (a deeper cp.async ring);
  int8_matvec: base; u2, u4, u8 (2, 4 or 8 steps of 64 columns a batch at
  every B); ldg
  (weights through __ldg, kept in L1).
Paged attention is timed at K 1 [8192], K 8 over PAGED_LENGTHS and the
serving phase's K 3 [37, 37, 37] at spans 256 and 512; the int8 matvec at
INT8_SHAPES for B 1 and 8, bf16 x.  The no_* variants compute wrong values
(their ``ok`` is False): they are timings only.  Builds go to
``streammind_torch/_kernels/probe/``.  Fails without a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SCORES = "for (int c = 0; c < Lt::kChunks; ++c) {"
PV = "for (int j = 0; j < kBK; j += 4) {"
STAGES = "constexpr int kStages = 3;"
UNROLL = "constexpr int kUnrollB1 = 2, kUnroll = 4;"
VARIANTS = {
    "paged_attention": {
        "base": [],
        "no_scores": [(SCORES, SCORES.replace("Lt::kChunks", "0"))],
        "no_pv": [(PV, PV.replace("kBK", "0"))],
        "no_math": [(SCORES, SCORES.replace("Lt::kChunks", "0")), (PV, PV.replace("kBK", "0"))],
        "stages4": [(STAGES, STAGES.replace("3", "4"))],
        "stages6": [(STAGES, STAGES.replace("3", "6"))],
    },
    "int8_matvec": {
        "base": [],
        "u2": [(UNROLL, "constexpr int kUnrollB1 = 2, kUnroll = 2;")],
        "u4": [(UNROLL, "constexpr int kUnrollB1 = 4, kUnroll = 4;")],
        "u8": [(UNROLL, "constexpr int kUnrollB1 = 8, kUnroll = 8;")],
        "ldg": [("ld_stream(w0 + c0 + col)", "__ldg(reinterpret_cast<const uint4*>(w0 + c0 + col))"),
                ("ld_stream(w1 + c0 + col)", "__ldg(reinterpret_cast<const uint4*>(w1 + c0 + col))")],
    },
}


def build(out: Path, wanted) -> dict:
    from streammind_torch.ops import _build

    procs, built = {}, {}
    for kern, variants in VARIANTS.items():
        src = (_build.CSRC / f"{kern}.cu").read_text()
        for name, reps in variants.items():
            if wanted and name not in wanted:
                continue
            text = src
            for old, new in reps:
                if old not in text:
                    print(f"{kern} {name}: does not apply to the source, skipped", flush=True)
                    break
                text = text.replace(old, new)
            else:
                cu = out / f"{kern}_{name}.cu"
                cu.write_text(text)
                lib = out / f"lib{kern}_{name}.so"
                procs[(kern, name)] = (lib, subprocess.Popen(
                    [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(cu)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{key}: build failed\n{log}")
        built[key] = lib
    return built


def use(kern: str, lib: Path) -> None:
    from streammind_torch.ops import _build

    symbol, argtypes = _build.SIGNATURES[kern]
    handle = ctypes.CDLL(str(lib))
    getattr(handle, symbol).argtypes = argtypes
    getattr(handle, symbol).restype = ctypes.c_int
    _build._libs[kern] = handle


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="*", default=None)
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from streammind_torch.ops import _build
    from streammind_torch.ops import int8_matvec as I8
    from streammind_torch.ops import paged_attention as PA

    if not torch.cuda.is_available():
        raise SystemExit("_probe_decode_kernels: no CUDA device")
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    built = build(out, args.variants)
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.empty(shape, device=dev, dtype=torch.bfloat16).normal_(generator=g)

    pool_k, pool_v = cs.paged_pool(randn)
    default_span = PA._span
    for (kern, name), lib in built.items():
        if kern != "paged_attention":
            continue
        use(kern, lib)
        for span in PA.SPANS:
            PA._span = lambda rows, width, device, span=span: span
            for lengths in ([8192], cs.PAGED_LENGTHS, [37, 37, 37]):
                c = cs.paged_attention_case(dev, randn, pool_k, pool_v, lengths)
                print(f"paged_attention {name} span={span} K={len(lengths)} ms={c['ms']:.4f} "
                      f"ok={c['ok']}", flush=True)
    PA._span = default_span
    del pool_k, pool_v
    torch.cuda.empty_cache()
    for (kern, name), lib in built.items():
        if kern != "int8_matvec":
            continue
        use(kern, lib)
        for c in cs.int8_cases(dev, g, dtypes=(torch.bfloat16,), batches=(1, 8)):
            print(f"int8_matvec {name} {c['shape']} ms={c['ms']:.4f} ok={c['ok']}", flush=True)
    _build._libs.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
