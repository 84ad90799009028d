#!/usr/bin/env python3
"""Probe where the paged attention, int8 and int4 matvec kernels spend their time,
on one CUDA card, by building variants of their sources in which one part
is changed or removed, and timing each with chip_smoke.py's cases.

    python3 tools/_probe_decode_kernels.py [--variants NAME ...] [--kernels NAME ...]

Variants (text replacements in ``streammind_torch/csrc/*.cu``; one that no
longer applies to the source is reported and skipped):
  paged_attention: base; no_scores (no q.k products), no_pv (no p.V
  products), no_math (neither: the loads, the ring, the softmax pass and
  the merge alone); stages4, stages6 (a deeper cp.async ring);
  int8_matvec: base; u2, u4, u8 (2, 4 or 8 steps of 64 columns a batch at
  every B); ldg
  (weights through __ldg, kept in L1);
  int4_matvec: base; one_chain (every product of a tile into one
  accumulator); no_stage (x not staged: the weights and the products
  alone); u1, u4 (1 or 4 steps a batch); lb2 (at most 128 registers, two
  blocks an SM); b1_as_b4, b1_as_b8 (B
  1 through the B 4 or B 8 instantiation); chunk16, chunk64 (x staged in
  chunks of 16 or 64 KB);
  selective_scan: base; g2, g4, g16 (2, 4 or 16 lanes share a channel's
  states, not 8); branch (each state slot past N a branch instead of
  the select); chunk16 (16 steps staged at a time); lb1, lb4 (registers
  capped for 1 or 4 blocks an SM, not 2); no_exp (the exp of each state's
  step left out), no_softplus, no_silu (y times z), no_reduce (no sum over
  a channel's lanes); no_all (N 16 through the path for any N: scalar
  loads of B and C, a select a state).
Paged attention is timed at K 1 [8192], K 8 over PAGED_LENGTHS and the
serving phase's K 3 [37, 37, 37] at spans 256 and 512; the int8 matvec at
INT8_SHAPES for B 1 and 8, bf16 x; the int4 matvec at the gate's four
linears for B 1, 4 and 8, bf16 x, at each grid of INT4_GRIDS (tiles a
warp, warps a tile); the selective scan at chip_smoke.py's bf16 cases with a
carried state.  The no_* variants compute wrong values (their ``ok`` is
False): they are timings only.  Builds go to
``streammind_torch/_kernels/probe/``.  Fails without a CUDA card, and exits
1 after the timings where a variant did not build.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SCORES = "for (int c = 0; c < Lt::kChunks; ++c) {"
PV = "for (int j = 0; j < kBK; j += 4) {"
STAGES = "constexpr int kStages = 3;"
UNROLL = "constexpr int kUnrollB1 = 2, kUnroll = 4;"
I4_CHUNK = "constexpr int kTcChunkBytes = 32768;"
I4_STAGE = "stage_x(xs, x, B, din, 0, min(kCols, half), xrow, width);"
I4_B1 = "if (B == 1) SM_INT4_TC(1, 1);"
I4_KU = "constexpr int kSteps = 2;"
I4_LB = "__launch_bounds__(kThreads)\nint4_matvec_tc_kernel"
SC_SELECT = "p = (kAll || own[k]) ? q : p;"
SC_EXP = "const float dA = expf(__fmul_rn(dv, a[k]));"
SC_LB = "__launch_bounds__(kCh * kGroup, 2)"
SC_GROUP = "constexpr int kGroup = 8;"
SC_CHUNK = "constexpr int kChunk = 32;"
SC_SOFTPLUS = "if (p.flags & kSoftplus) dv = softplus_f(dv);"
SC_SILU = "yv = __fmul_rn(yv, __fdiv_rn(zv, __fadd_rn(1.f, expf(-zv))));"
SC_REDUCE = "reduce_scatter<G / 2, kChunk / 2>(yp, g);"

# (tiles a warp, warps splitting a tile's columns); two tiles a warp from B 3
INT4_GRIDS = tuple((tw, wk) for tw in (1, 2) for wk in (8, 4, 2, 1))
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
    "int4_matvec": {
        "base": [],
        "one_chain": [("mma_bf16(acc[j][q], ", "mma_bf16(acc[j][0], ")],
        "no_stage": [(I4_STAGE, "")],
        "u1": [(I4_KU, I4_KU.replace("2", "1"))],
        "u4": [(I4_KU, I4_KU.replace("2", "4"))],
        "lb2": [(I4_LB, I4_LB.replace("(kThreads)", "(kThreads, 2)"))],
        "b1_as_b4": [(I4_B1, I4_B1.replace("(1, 1)", "(4, 1)"))],
        "b1_as_b8": [(I4_B1, I4_B1.replace("(1, 1)", "(8, 1)"))],
        "chunk16": [(I4_CHUNK, I4_CHUNK.replace("32768", "16384"))],
        "chunk64": [(I4_CHUNK, I4_CHUNK.replace("32768", "65536"))],
    },
    "selective_scan": {
        "base": [],
        **{f"g{grp}": [(SC_GROUP, SC_GROUP.replace("8", str(grp)))] for grp in (2, 4, 16)},
        "branch": [(SC_SELECT, "p = q;"),
                   (SC_EXP, "if (!kAll && !own[k]) continue;\n        " + SC_EXP)],
        "chunk16": [(SC_CHUNK, SC_CHUNK.replace("32", "16"))],
        "lb1": [(SC_LB, "__launch_bounds__(kCh * kGroup)")],
        "lb4": [(SC_LB, "__launch_bounds__(kCh * kGroup, 4)")],
        "no_exp": [(SC_EXP, "const float dA = __fmul_rn(dv, a[k]);")],
        "no_softplus": [(SC_SOFTPLUS, "")],
        "no_silu": [(SC_SILU, "yv = __fmul_rn(yv, zv);")],
        "no_reduce": [(SC_REDUCE, "")],
        "no_all": [("if (a.N == kMaxN)", "if (false)")],
    },
}


def build(out: Path, wanted, kernels=None) -> tuple:
    """Every variant named in ``wanted`` (all where it is empty) of the
    kernels in ``kernels`` (all where empty): the libraries built, and the
    (kernel, variant) pairs that failed to build."""
    from streammind_torch.ops import _build

    procs, built, failed = {}, {}, []
    for kern, variants in VARIANTS.items():
        if kernels and kern not in kernels:
            continue
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
            print(f"{key[0]} {key[1]}: build failed, skipped\n{log[-3000:]}", flush=True)
            failed.append(key)
            continue
        built[key] = lib
        # registers and spill bytes of each entry point, in ptxas order
        print(f"{key[0]} {key[1]}: registers {re.findall(r'Used (\d+) registers', log)}, spill "
              f"stores {re.findall(r'(\d+) bytes spill stores', log)}", flush=True)
    return built, failed


def use(kern: str, lib: Path) -> None:
    from streammind_torch.ops import _build

    symbol, argtypes = _build.SIGNATURES[kern]
    handle = ctypes.CDLL(str(lib))
    getattr(handle, symbol).argtypes = argtypes
    getattr(handle, symbol).restype = ctypes.c_int
    _build._libs[kern] = handle


def int4_probe(cs, built, dev, g) -> None:
    """Each int4 variant at the gate's four linears, B 1 and 8, at each
    grid of INT4_GRIDS: the kernel alone, by graph replay, on one set of
    weights per shape (cycled to read them cold from HBM)."""
    import torch

    from streammind_torch.ops import int4_matvec as I4
    from streammind_torch.utils.quantize import quantize_linear_weight_int4_pc

    libs = {name: lib for (kern, name), lib in built.items() if kern == "int4_matvec"}
    if not libs:
        return
    default = I4._grid
    for shape, dout, din in cs.INT4_SHAPES:
        packs = [quantize_linear_weight_int4_pc(torch.empty((dout, din), device=dev).normal_(
            0.0, 0.02, generator=g)) for _ in range(cs.n_sets(dout * din / 2))]
        for b in (1, 4, 8):
            x = torch.empty((b, din), device=dev, dtype=torch.bfloat16).normal_(generator=g)
            ref = I4.int4_matvec_ref(x, packs[0]["w_int4pc"], packs[0]["scale"])
            for name, lib in libs.items():
                use("int4_matvec", lib)
                line = []
                for tw, wk in INT4_GRIDS:
                    if tw > 1 and b <= 2:
                        continue
                    I4._grid = lambda b_, d_, sms, tw=tw, wk=wk: (tw, 8 * tw // wk)
                    out = I4.int4_matvec(x, packs[0]["w_int4pc"], packs[0]["scale"])
                    ok = cs.excess(out, ref, *cs.INT4_TOL)[1] <= 0
                    ms = cs.cuda_ms([lambda p=p: I4.int4_matvec(x, p["w_int4pc"], p["scale"])
                                     for p in packs], graph=True)
                    line.append(f"tw{tw}wk{wk}={ms:.4f}{'' if ok else '!'}")
                print(f"int4_matvec {name} {shape} B {b}: " + " ".join(line), flush=True)
        del packs
        torch.cuda.empty_cache()
    I4._grid = default


def scan_probe(cs, built, dev, g) -> None:
    """Each selective-scan variant at chip_smoke.py's bf16 cases with a
    carried state, by graph replay."""
    import torch

    libs = {name: lib for (kern, name), lib in built.items() if kern == "selective_scan"}
    cases = tuple(c for c in cs.SCAN_CASES if c[0] == torch.bfloat16 and c[3])
    for name, lib in libs.items():
        use("selective_scan", lib)
        for c in cs.scan_cases(dev, g, cases=cases):
            print(f"selective_scan {name} {c['shape']} ms={c['ms']:.4f} ok={c['ok']}",
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="*", default=None)
    ap.add_argument("--kernels", nargs="*", default=None)
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
    built, failed = build(out, args.variants, args.kernels)
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
    int4_probe(cs, built, dev, g)
    scan_probe(cs, built, dev, g)
    _build._libs.clear()
    if failed:
        print(f"failed to build: {failed}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
