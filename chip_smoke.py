#!/usr/bin/env python3
"""Drive the PyTorch / H100 port (``streammind_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:
  1. the card (nvidia-smi name and power limit) and the torch build;
  2. the kernel build: every ``streammind_torch/csrc/*.cu`` with nvcc for
     sm_90a, one process per source, all at once; ptxas registers and
     spills; the count of HGMMA (wgmma) instructions in the SASS of the four
     tensor-core sources (flash, exact, dQ, dK/dV), none of which may be 0;
  3. each kernel against its plain PyTorch version on the card at the main
     paths' shapes, with its tolerance; times of the kernel, its plain
     version and one PyTorch yardstick call, beside the card's bound (the
     bf16 flash forward, lse forward, dQ, dK/dV and exact attention,
     tensor-core kernels, paged attention, the int8 and int4 matvecs, the
     selective scan, and their yardsticks are timed by replaying a CUDA
     graph of the launches, and eagerly too; their kernel / bound is
     printed, and dQ + dK/dV beside SDPA's backward); the int4 matvec at
     the gate's four linears, B 1, 4 and 8, bf16 and fp32 x; the scan first
     with u laid out as the burst hands it (bf16, L 32, a carried state),
     then at L 1, 8, 32 and 64, bf16 and fp32, with and without a carried
     state, and (bf16) at L 256 and at B 4; the GQA group of 7 (Qwen2-7B's
     28 / 4 heads) runs the flash forward at bucket 64 over the ring and the three
     training kernels at 2048; paged attention must give the same bits twice
     (its splits merge in a fixed order), and after phase 5 it is checked and
     timed once more at the lengths the serving phase's K = 3 turn gave it;
     with the decode step's token write folded into its launch, pools and
     output must be bitwise those of the plain write then the write-free
     kernel, twice, at the serving turn's K = 3, K 1 and K 8 with a row that
     writes the sink page;
  4. the full-width StreamMind-7B session (random bf16 weights from a seed):
     ViT-L/14-336 under attn_impl="exact", Mamba d_model 4096, the 4-layer
     gate under quantize_gate="int4", Mistral-7B; 10 frames with two forced
     gate fires and 16 new tokens a turn; the launch counts show the path ran
     through the flash, exact and int4 kernels (their tensor-core
     instantiations: 23 exact a frame, 32 flash a turn);
  5. multi-stream serving on the same engine: a BatchedSessionBroker over
     MultiStreamServer(kv_mode="paged", page_size=64) with four client
     threads for 8 ticks; three gates fire together on one tick (one
     batched paged turn, K = 3) and one alone on a later tick (K = 1); the
     launch counts show the path ran through all four inference kernels
     (exact, int4, flash, and paged attention, which writes each step's
     token in the same launch: one launch a layer a step, no separate write);
  6. a reduced-depth parity run at the published widths in fp32 (TF32 off):
     the same seeded weights and frames through the plain versions on the
     CPU and through the kernels on the card, for the session and for the
     multi-stream server (paged on the CPU and the card, dense on the
     card); then the session on the card once more with TF32 on, which must
     break at least one limit (the limits see a matmul that loses fp32
     precision);
  7. training at full width: ``train()`` on StreamMind-7B (bf16, random
     weights from seed 0), the ``adapter`` stage, remat, one sample a
     microbatch and two microbatches a step, 6 optimizer steps over a
     synthetic MatchTime-shaped set (pre-extracted (64, 577, 1024) features,
     1,900-1,980-token prompts with one <video> slot and a 129-token
     supervised answer, so every microbatch splices into the 2048 bucket);
     step time, supervised tokens/s, losses, peak memory and launches per
     microbatch (64 lse forwards, 32 dQ, 32 dK/dV, all of them on the
     tensor-core instantiations); frozen leaves bitwise
     unchanged, trainable leaves moved, the adapter checkpoint read back
     bitwise; then 2 steps of the ``cls`` stage resumed from it;
  8. training parity in fp32 (TF32 off) at the published widths, depth cut
     (text 2, gate 2 layers, features in): the same seeded tree and batch
     through the plain versions on the CPU and the kernels on the card —
     loss, grad norm, every trainable gradient, the params after two
     optimizer steps — and a TF32-on control that must break a limit;
  9. (run after phase 5, on its own engine) the fast serving tier at full
     width: a bf16 StreamMind-7B tree from seed 0, the decoder through the
     load_8bit transform (``quantize_text_params(bits=8)``), then
     StreamMindEngine(quantize_gate="int8", fast_vision="int8"): the session
     of phase 4 (launches exactly 20 int8_matvec a tick, 128 a one-token
     decode forward, 32 flash a turn, no exact and no int4), then
     ``perceive_burst`` of 32 frames on the same stream (one selective_scan,
     20 int8_matvec), timed, and the same frames as single steps;
 10. the fast tier in fp32 at reduced depth on the CPU (plain versions) and
     the card (kernels), TF32 off, with a burst of 16 frames and, on the
     card, the burst against single steps; a TF32-on control that must break
     a limit; the int8 ViT on its own (one linear on identical inputs, and
     the tower's features);
 11. (after phase 5, on the session's tree) the public API: ``model_init``,
     greedy ``infer`` on 16 frames with 32 new tokens, ``decode_stream``
     against ``generate_from_prefill`` on the same plan, ``infer_beams``
     with 5 beams (sorted scores, one beam greedy); then a synthetic
     full-SFT ``.bin`` under the released key names and shapes at full
     widths, the decoder cut to 2 layers, loaded by ``model_init(path,
     load_4bit="pc")`` (every leaf bitwise the written bf16) and answered
     the same way through the int4 kernel; exact launch counts;
 12. the HTTP plane: a Controller and a ModelWorker (multistream_capacity
     4) on 127.0.0.1, one streamed generation through the controller equal
     to decode_stream in-process, two HTTP sessions of 6 frames through
     the paged broker with one forced fire;
 13. ``infer`` and ``beam_generate`` in fp32 at reduced depth on the CPU and
     the card, TF32 off (identical tokens, text and beams; memory, logits
     and beam scores within limits), and a TF32-on control;
then the ``kernels`` JSON line (``launches`` from the serving phase for the
inference kernels, from the training phase for the training kernels and from
the fast phase for int8_matvec and selective_scan; ``tc_launches``, ``hgmma``
and ``ms_over_bound`` for the five tensor-core kernels, ``ms_over_bound`` for
paged attention, the int8 and int4 matvecs, the scan and the paged write,
whose launches are the paged attention's launches that wrote a token;
``launches_by_path`` of every kernel: session, serving, fast, train, api,
worker) and, last,
the ``ok`` JSON line.  The fp32 parity phases must launch no tensor-core kernel.  It
uses nothing of JAX; without a CUDA card it exits with an error before any
result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_FLOPS = 989e12           # dense tensor-core bf16
FP32_FLOPS = 67e12            # fp32 outside the tensor cores

# flash and exact (bf16 out) against their plain versions: |err| <= atol + rtol*|ref|.
# rtol covers one bf16 rounding step (2**-8 relative) either way; atol is about
# twice the largest error measured on an H100 (1.95e-3 flash at Sq 2048, 9.8e-4
# exact), a tenth of a typical output (~0.04 at 2048 keys, ~0.07 at 577).
BF16_TOL = (4e-3, 1e-2)
BF16_TOL_TEXT = "|err| <= 4e-3 + 1e-2*|ref| (bf16 output)"

# (source of the CUDA kernel, file:line of the TPU kernel it replaces in the JAX package)
KERNEL_META = {
    "flash_attention": ("streammind_torch/csrc/flash_attention.cu", "ops/attention.py:76"),
    "exact_attention": ("streammind_torch/csrc/exact_attention.cu", "ops/attention.py:255"),
    "int4_matvec": ("streammind_torch/csrc/int4_matvec.cu", "ops/int4_matvec.py:37"),
    # the token write, folded into the paged attention's launch (its write phase)
    "paged_write": ("streammind_torch/csrc/paged_attention.cu", "streaming/paged.py:89"),
    "paged_attention": ("streammind_torch/csrc/paged_attention.cu", "streaming/paged.py:250"),
    "flash_attention_lse": ("streammind_torch/csrc/flash_attention.cu", "ops/attention.py:86"),
    "flash_bwd_dq": ("streammind_torch/csrc/flash_bwd_dq.cu", "ops/attention.py:363"),
    "flash_bwd_dkv": ("streammind_torch/csrc/flash_bwd_dkv.cu", "ops/attention.py:407"),
    "int8_matvec": ("streammind_torch/csrc/int8_matvec.cu", "ops/int8_matvec.py:39"),
    "selective_scan": ("streammind_torch/csrc/selective_scan.cu", "ops/scan.py:150"),
}
# wrapper of each kernel, as (module, attribute), for its launch count, which
# it keeps in .launches (the paged write: the paged attention wrapper's
# .write_launches, its launches that also wrote the step's token)
WRAPPERS = {
    "flash_attention": ("streammind_torch.ops.attention", "flash_attention"),
    "exact_attention": ("streammind_torch.ops.attention", "exact_attention"),
    "int4_matvec": ("streammind_torch.ops.int4_matvec", "int4_matvec"),
    "paged_write": ("streammind_torch.ops.paged_attention", "paged_decode_attention"),
    "paged_attention": ("streammind_torch.ops.paged_attention", "paged_decode_attention"),
    "flash_attention_lse": ("streammind_torch.ops.attention", "flash_attention_lse"),
    "flash_bwd_dq": ("streammind_torch.ops.attention", "flash_bwd_dq"),
    "flash_bwd_dkv": ("streammind_torch.ops.attention", "flash_bwd_dkv"),
    "int8_matvec": ("streammind_torch.ops.int8_matvec", "int8_matvec"),
    "selective_scan": ("streammind_torch.ops.scan", "selective_scan_kernel"),
}
TRAIN_KERNELS = ("flash_attention_lse", "flash_bwd_dq", "flash_bwd_dkv")
COUNTERS = {"paged_write": "write_launches"}
# CUDA-core kernels that are timed by graph replay too, their kernel / bound
# in the kernels line
GRAPH_TIMED = ("paged_attention", "int8_matvec", "int4_matvec", "paged_write", "selective_scan")
FAST_KERNELS = ("int8_matvec", "selective_scan")
# the kernels with a bf16 tensor-core (wgmma) instantiation beside the fp32
# CUDA-core one; each wrapper counts its bf16 launches again in .tc_launches,
# read here as "<name>_tc"
TC_KERNELS = ("flash_attention", "exact_attention", "flash_attention_lse", "flash_bwd_dq",
              "flash_bwd_dkv")
# the libraries that hold them, each of which must hold HGMMA instructions
TC_LIBRARIES = ("flash_attention", "exact_attention", "flash_bwd_dq", "flash_bwd_dkv")


def log(tag: str, msg: str) -> None:
    print(f"[{tag}] {msg}", flush=True)


def wrappers():
    import importlib

    return {n: getattr(importlib.import_module(m), a) for n, (m, a) in WRAPPERS.items()}


def reset_launches() -> None:
    for n, fn in wrappers().items():
        setattr(fn, COUNTERS.get(n, "launches"), 0)
        if n in TC_KERNELS:
            fn.tc_launches = 0


def read_launches() -> dict:
    fns = wrappers()
    return {**{n: getattr(fn, COUNTERS.get(n, "launches")) for n, fn in fns.items()},
            **{f"{n}_tc": fns[n].tc_launches for n in TC_KERNELS}}


def kernel_of(count: str) -> str:
    """The kernel a launch count belongs to ("flash_attention_tc" -> "flash_attention")."""
    return count[:-3] if count.endswith("_tc") else count


def fp32_only(counts: dict, what: str) -> None:
    """An fp32 run on the card must launch the CUDA-core instantiations only."""
    tc = {n: counts[f"{n}_tc"] for n in TC_KERNELS}
    log(what, f"fp32 instantiation launches {({n: counts[n] - tc[n] for n in TC_KERNELS})}, "
              f"tensor-core {tc}")
    if any(tc.values()):
        raise RuntimeError(f"{what}: an fp32 run launched a tensor-core kernel: {tc}")


def hgmma_count(name: str) -> int:
    """HGMMA (wgmma) instructions in the SASS of kernel ``name``'s library."""
    from streammind_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(_build._lib_path(name))], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    return sum("HGMMA" in line for line in sass.splitlines())


def sync() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def cuda_ms(fns, iters: int = 20, warmup: int = 3, graph: bool = False) -> float:
    """Mean ms per call over ``iters`` calls cycling through ``fns`` (several
    buffers where one would sit in L2), timed with CUDA events.  With
    ``graph`` the calls are captured once into a CUDA graph and the graph is
    replayed, so the time is the device's alone: a kernel that runs in less
    time than its wrapper's host work is otherwise timed by the host."""
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if not graph:
        start.record()
        for i in range(warmup, warmup + iters):
            fns[i % len(fns)]()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(iters):
            fns[i % len(fns)]()
    g.replay()
    start.record()
    for _ in range(GRAPH_REPLAYS):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * GRAPH_REPLAYS)


GRAPH_REPLAYS = 3


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def n_sets(nbytes: float) -> int:
    """Input sets to cycle through so that each launch reads its bytes cold
    from HBM (more than twice the 50 MB L2), as each frame and layer does."""
    return max(1, math.ceil(120e6 / nbytes))


def excess(out, ref, atol: float, rtol: float):
    """(max |out - ref|, max of |out - ref| - (atol + rtol |ref|))."""
    d = (out.float() - ref.float()).abs()
    return float(d.max()), float((d - (atol + rtol * ref.float().abs())).max())


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------
def check_kernels(dev):
    from streammind_torch.ops import attention as A

    g = torch.Generator(device=dev).manual_seed(1234)
    bf16 = torch.bfloat16
    results = {}

    def randn(*shape, std=1.0):
        return torch.empty(shape, device=dev, dtype=bf16).normal_(0.0, std, generator=g)

    # flash: Mistral-7B prefill over a capacity-8192 cache (H 32/8, D 128) at
    # the buckets 64 and 2048 (B 1), and 32 and 512 with B 2 and a ragged,
    # nonzero q_offset (the second row's bucket padded by a few tokens); then
    # bucket 64 with a GQA group of 7 (Qwen2-7B's 28 / 4 heads); then the
    # api's one-shot prefill, bucket 128 from an empty cache.  Sets
    # of inputs: the caches are overlapping views of one buffer, each
    # starting past the rows the previous one reads, so nothing is read warm.
    # Kernel and library are timed by graph replay (the bf16 kernel runs in
    # less time than its wrapper's host work), the kernel eagerly as well.
    cases = []
    for sq, q_offs, kv_lens, h, hkv in ((64, [100], [150], 32, 8), (2048, [0], [2048], 32, 8),
                                        (32, [100, 1517], [132, 1544], 32, 8),
                                        (512, [388, 2000], [900, 2505], 32, 8),
                                        (64, [100], [150], 28, 4),
                                        (128, [0], [65], 32, 8)):
        b = len(q_offs)
        visible = sum(min(n, off + i + 1) for off, n in zip(q_offs, kv_lens) for i in range(sq))
        rows = [min(n, off + sq) for off, n in zip(q_offs, kv_lens)]
        nbytes = 2 * (2 * b * sq * h * 128 + 2 * sum(rows) * hkv * 128)
        n, step = n_sets(nbytes), 64 * math.ceil(max(rows) / 64)
        kbuf, vbuf = (randn(b, (n - 1) * step + 8192, hkv, 128) for _ in range(2))
        sets = [(randn(b, sq, h, 128), kbuf[:, i * step:i * step + 8192],
                 vbuf[:, i * step:i * step + 8192]) for i in range(n)]
        lens = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
        offs = torch.tensor(q_offs, dtype=torch.int32, device=dev)
        q, kc, vc = sets[0]
        out = A.flash_attention(q, kc, vc, causal=True, kv_len=lens, q_offset=offs)
        ref = A.flash_attention_ref(q, kc, vc, causal=True, kv_len=lens, q_offset=offs)
        err, over = excess(out, ref, *BF16_TOL)
        fns = [lambda s=s: A.flash_attention(*s, True, lens, offs) for s in sets]
        ms, eager = cuda_ms(fns, graph=True), cuda_ms(fns)
        plain = cuda_ms([lambda s=s: A.flash_attention_ref(*s, True, lens, offs) for s in sets],
                        iters=5)
        # yardstick: SDPA on the keys up to the longest kv_len, with the same
        # causal-offset and length mask
        top = max(kv_lens)
        kpos = torch.arange(top, device=dev)[None, None, :]
        qpos = torch.arange(sq, device=dev)[None, :, None] + offs[:, None, None]
        mask = ((kpos <= qpos) & (kpos < lens[:, None, None]))[:, None]
        lib_sets = [(q.transpose(1, 2),
                     *(c[:, :top].repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()
                       for c in (kc, vc))) for q, kc, vc in sets]
        lib = cuda_ms([lambda s=s: F.scaled_dot_product_attention(*s, attn_mask=mask)
                       for s in lib_sets], graph=True)
        del sets, lib_sets, kbuf, vbuf
        b_ms, b_by = bound(nbytes, 4.0 * 128 * h * visible, BF16_FLOPS)
        cases.append(dict(shape=f"q({b},{sq},{h},128) cache({b},8192,{hkv},128) q_offset={q_offs} "
                                f"kv_len={kv_lens}", max_abs_err=err, ok=over <= 0, ms=ms,
                          eager_ms=eager, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                          bound_by=b_by))
    results["flash_attention"] = (cases, BF16_TOL_TEXT)

    # exact: the ViT-L/14-336 attention, q/k/v strided views of the fused qkv,
    # at B 1 (a session's frame), 4 (the serving tick) and 8
    cases = []
    for b in (1, 4, 8):
        nbytes = 4 * 2 * b * 577 * 16 * 64
        qkvs = [randn(b, 577, 3, 16, 64) for _ in range(n_sets(nbytes))]
        sets = [(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]) for qkv in qkvs]
        out = A.exact_attention(*sets[0])
        ref = A.exact_attention_ref(*sets[0])
        err, over = excess(out, ref, *BF16_TOL)
        fns = [lambda s=s: A.exact_attention(*s) for s in sets]
        ms, eager = cuda_ms(fns, graph=True), cuda_ms(fns)
        plain = cuda_ms([lambda s=s: A.exact_attention_ref(*s) for s in sets])
        lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in s) for s in sets]
        lib = cuda_ms([lambda s=s: F.scaled_dot_product_attention(*s) for s in lib_sets],
                      graph=True)
        # what the second pass costs: the one-pass flash forward (non-causal:
        # one Q K^T and one ex2 a score, P rounded before the division) on the
        # same inputs
        one_pass = cuda_ms([lambda s=s: A.flash_attention(*s) for s in sets], graph=True)
        del qkvs, sets, lib_sets
        b_ms, b_by = bound(nbytes, 4.0 * b * 16 * 577 * 577 * 64, BF16_FLOPS)
        cases.append(dict(shape=f"({b},577,16,64)", max_abs_err=err, ok=over <= 0, ms=ms,
                          eager_ms=eager, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                          bound_by=b_by, one_pass_flash_ms=one_pass))
    results["exact_attention"] = (cases, BF16_TOL_TEXT)

    results["int4_matvec"] = (int4_cases(dev, g) + int4_cases(
        dev, g, shapes=INT4_DECODER_SHAPES, dtypes=(bf16,), batches=(1, API_BEAMS)) + int4_cases(
        dev, g, shapes=INT4_DECODER_UNFUSED, dtypes=(bf16,), batches=(API_BEAMS,)),
        INT4_TOL_TEXT)
    results.update(check_paged_kernels(dev, randn))
    results.update(check_train_kernels(dev, randn))
    results.update(check_fast_kernels(dev, g))

    for name, (cases, tol) in results.items():
        for c in cases:
            lib = "none" if c["library_ms"] is None else f"{c['library_ms']:.4f} ms"
            eager = f" (eager {c['eager_ms']:.4f} ms)" if "eager_ms" in c else ""
            if "library_eager_ms" in c:
                lib += f" (eager {c['library_eager_ms']:.4f} ms)"
            log("kernel", f"{name} {c['shape']}: max_abs_err={c['max_abs_err']:.3e} "
                          f"{'(each output: ' + str(c['errs']) + ') ' if 'errs' in c else ''}"
                          f"within [{tol}]={c['ok']} kernel={c['ms']:.4f} ms{eager} "
                          f"plain={c['plain_ms']:.4f} ms library={lib} "
                          f"bound={c['bound_ms']:.4f} ms ({c['bound_by']})"
                          + (f" kernel/bound={c['ms_over_bound']:.2f}"
                             if "ms_over_bound" in c else ""))
    for name in TC_KERNELS:
        for c in results[name][0]:
            c["ms_over_bound"] = c["ms"] / c["bound_ms"]
            one_pass = (f"; the one-pass flash forward on the same inputs: "
                        f"{c['one_pass_flash_ms']:.4f} ms" if "one_pass_flash_ms" in c else "")
            log("kernel", f"{name} {c['shape']}: kernel / bound = {c['ms_over_bound']:.2f} "
                          f"(tensor-core kernel, graph-timed){one_pass}")
    bad = [(n, c["shape"]) for n, (cs, _) in results.items() for c in cs if not c["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: {bad}")
    return results


PAGED_SHAPE = dict(hkv=8, h=32, d=128, page=64, maxp=128, n_pages=1024)


def paged_pool(randn):
    """A pool of 1024 pages (268 MB of K and V, five times the L2) at the
    serving path's shapes: Mistral-7B (32 q / 8 kv heads, D 128), page 64."""
    sh = PAGED_SHAPE
    return tuple(randn(sh["hkv"], sh["n_pages"] + 1, sh["page"], sh["d"]) for _ in range(2))


def paged_attention_case(dev, randn, pool_k, pool_v, lengths):
    """paged_decode_attention at one list of row lengths over 128-page tables,
    against its plain version; kernel and yardstick timed by graph replay
    (the kernel runs in less time than its wrapper's host work) and
    eagerly."""
    from streammind_torch.ops import paged_attention as PA

    hkv, h, d, page, maxp, n_pages = (PAGED_SHAPE[k] for k in ("hkv", "h", "d", "page", "maxp",
                                                               "n_pages"))
    K = len(lengths)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    visible = sum(min(n, maxp * page) for n in lengths)
    nbytes = 2 * (2 * visible * hkv * d + 2 * K * h * d) + 4 * (K + -(-visible // page))
    # each set draws its tables from a fresh permutation of the pool, so
    # successive launches read other pages, cold from HBM
    sets = []
    for _ in range(n_sets(nbytes)):
        perm = torch.randperm(n_pages, device=dev)[: K * maxp] + 1
        sets.append((randn(K, 1, h, d), perm.reshape(K, maxp).to(torch.int32)))
    q, table = sets[0]
    out = PA.paged_decode_attention(q, pool_k, pool_v, table, lens)
    ref = PA.paged_decode_attention_ref(q, pool_k, pool_v, table, lens)
    err, over = excess(out, ref, *BF16_TOL)
    # the split kernel merges its partial sums in a fixed order: same bits twice
    same = torch.equal(out, PA.paged_decode_attention(q, pool_k, pool_v, table, lens))
    fns = [lambda s=s: PA.paged_decode_attention(s[0], pool_k, pool_v, s[1], lens) for s in sets]
    ms, eager = cuda_ms(fns, graph=True), cuda_ms(fns)
    plain = cuda_ms([lambda s=s: PA.paged_decode_attention_ref(s[0], pool_k, pool_v, s[1], lens)
                     for s in sets], iters=5)
    # yardstick: SDPA over each row's pages gathered contiguous beforehand
    # (untimed), kv heads repeated, with a length mask
    mask = (torch.arange(maxp * page, device=dev)[None, :] < lens[:, None])[:, None, None]
    lib_sets = [(q.transpose(1, 2), *(PA.gather_seq(pool, table).repeat_interleave(
        h // hkv, dim=2).transpose(1, 2).contiguous() for pool in (pool_k, pool_v)))
        for q, table in sets[:2]]
    lib_fns = [lambda s=s: F.scaled_dot_product_attention(*s, attn_mask=mask) for s in lib_sets]
    lib, lib_eager = cuda_ms(lib_fns, graph=True), cuda_ms(lib_fns)
    del lib_sets, sets
    b_ms, b_by = bound(nbytes, 4.0 * h * d * visible, BF16_FLOPS)
    return dict(shape=f"q({K},1,{h},{d}) pool({hkv},{n_pages + 1},{page},{d}) table({K},{maxp}) "
                      f"lengths={list(lengths)}", max_abs_err=err, ok=over <= 0 and same,
                same_bits_twice=same, ms=ms, eager_ms=eager, plain_ms=plain, library_ms=lib,
                library_eager_ms=lib_eager, bound_ms=b_ms, bound_by=b_by, ms_over_bound=ms / b_ms)


# one short row, one full 8192-token row, one past its table at a page
# boundary (a finished row of the lockstep loop), then ragged rows
PAGED_LENGTHS = [8192, 37, 128 * 64 + 1, 3000, 64, 65, 5000, 129]
# the write folded into the attention: each row's count before its token, so
# the attention covers the lengths above: the serving turn's K = 3 step, then
# K 1 and K 8 (whose third row, at its table's edge, writes the sink page)
PAGED_WRITE_LENGTHS = ([36, 36, 36], [n - 1 for n in PAGED_LENGTHS[:1]],
                       [n - 1 for n in PAGED_LENGTHS])


def paged_write_case(dev, randn, pool_k, pool_v, lengths):
    """paged_decode_attention with the step's new K and V tokens (written in
    the same launch) at one list of row lengths over 128-page tables: pools
    and output bitwise what write_tokens_ref then the write-free kernel at
    length + 1 give, the same bits on a second call.  The fused launch is
    timed by graph replay and eagerly, beside the write-free launch on the
    same inputs (graph replay; the difference is the write phase's time);
    its bound counts the write's bytes and the attention's.  Plain: the
    slots, the write and the attention in PyTorch.  No one PyTorch call
    writes and attends; the write's own yardstick, its two index_put_ calls
    at slots given, is timed beside (``write_library_ms``)."""
    from streammind_torch.ops import paged_attention as PA

    hkv, h, d, page, maxp, n_pages = (PAGED_SHAPE[k] for k in ("hkv", "h", "d", "page", "maxp",
                                                               "n_pages"))
    K = len(lengths)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    lens1 = lens + 1  # the write-free call's lengths, made once: no op of its own in the timing
    visible = sum(min(n + 1, maxp * page) for n in lengths)
    write_bytes = 2 * (2 * 2 * K * hkv * d) + 8 * K
    attn_bytes = 2 * (2 * visible * hkv * d + 2 * K * h * d) + 4 * (K + -(-visible // page))
    sets = []
    for _ in range(n_sets(attn_bytes)):
        perm = torch.randperm(n_pages, device=dev)[: K * maxp] + 1
        sets.append((randn(K, 1, h, d), perm.reshape(K, maxp).to(torch.int32),
                     randn(K, hkv, d), randn(K, hkv, d)))
    q, table, kn, vn = sets[0]
    ref_k, ref_v = pool_k.clone(), pool_v.clone()
    PA.write_tokens_ref(ref_k, ref_v, kn, vn, *PA.token_slots(table, lens, page))
    ref = PA.paged_decode_attention(q, ref_k, ref_v, table, lens1)
    same, err = True, 0.0
    for _ in range(2):
        pk, pv = pool_k.clone(), pool_v.clone()
        out = PA.paged_decode_attention(q, pk, pv, table, lens, k_new=kn, v_new=vn)
        same = same and torch.equal(out, ref) and torch.equal(pk, ref_k) and torch.equal(pv, ref_v)
        err = max(err, *(float((a.float() - b.float()).abs().max())
                         for a, b in ((out, ref), (pk, ref_k), (pv, ref_v))))
        del pk, pv
    del ref_k, ref_v
    fused = [lambda s=s: PA.paged_decode_attention(s[0], pool_k, pool_v, s[1], lens, k_new=s[2],
                                                   v_new=s[3]) for s in sets]
    ms, eager = cuda_ms(fused, graph=True), cuda_ms(fused)
    free = cuda_ms([lambda s=s: PA.paged_decode_attention(s[0], pool_k, pool_v, s[1], lens1)
                    for s in sets], graph=True)
    plain = cuda_ms([lambda s=s: PA.paged_decode_attention_ref(s[0], pool_k, pool_v, s[1], lens,
                                                               s[2], s[3]) for s in sets[:2]],
                    iters=5)
    offs = (lens % page).long()

    def index_put(pages, kn, vn):  # the write's two index_put_ calls, slots given
        pool_k[:, pages, offs] = kn.transpose(0, 1)
        pool_v[:, pages, offs] = vn.transpose(0, 1)

    lib_fns = [lambda s=s, p=s[1][:, 0].long(): index_put(p, s[2], s[3]) for s in sets]
    lib, lib_eager = cuda_ms(lib_fns, graph=True), cuda_ms(lib_fns)
    del sets
    b_ms, b_by = bound(write_bytes + attn_bytes, 4.0 * h * d * visible, BF16_FLOPS)
    write_bound, _ = bound(write_bytes, 0.0, BF16_FLOPS)
    return dict(shape=f"tokens({K},{hkv},{d}) written at lengths={list(lengths)}, attention "
                      f"over q({K},1,{h},{d}) pool({hkv},{n_pages + 1},{page},{d}) "
                      f"table({K},{maxp})", max_abs_err=err, ok=same, same_bits_twice=same,
                ms=ms, eager_ms=eager, write_free_ms=free, write_phase_ms=ms - free,
                plain_ms=plain, library_ms=None, write_library_ms=lib,
                write_library_eager_ms=lib_eager, bound_ms=b_ms, bound_by=b_by,
                write_bound_ms=write_bound, ms_over_bound=ms / b_ms)


def check_paged_kernels(dev, randn):
    """The paged pool's kernel at the serving path's shapes (``PAGED_SHAPE``):
    attention at K 1, 4 and 8 over ``PAGED_LENGTHS``; with the token write
    folded in, at ``PAGED_WRITE_LENGTHS``."""
    pool_k, pool_v = paged_pool(randn)
    results = {"paged_attention": ([paged_attention_case(dev, randn, pool_k, pool_v,
                                                         PAGED_LENGTHS[:K]) for K in (1, 4, 8)],
                                   BF16_TOL_TEXT + "; the same bits on a second call")}
    cases = [paged_write_case(dev, randn, pool_k, pool_v, n) for n in PAGED_WRITE_LENGTHS]
    for c in cases:
        log("kernel", f"paged_write {c['shape']}: one launch (write + attention) "
                      f"{c['ms']:.4f} ms, the write-free attention {c['write_free_ms']:.4f} "
                      f"ms (graph replay; the write phase {c['write_phase_ms']:.4f} ms, its bound "
                      f"{c['write_bound_ms']:.7f} ms, the two index_put_ calls "
                      f"{c['write_library_ms']:.4f} ms)")
    results["paged_write"] = (cases, "pools and output bitwise equal to write_tokens_ref then "
                                     "the write-free kernel; the same bits on a second call")
    return results


def check_paged_serving_case(dev, lengths):
    """paged_decode_attention at the lengths the serving phase's K = 3 turn
    gave its first lockstep step, over the same pool and tables as
    ``check_paged_kernels``; raises if it disagrees with its plain version."""
    g = torch.Generator(device=dev).manual_seed(4321)

    def randn(*shape):
        return torch.empty(shape, device=dev, dtype=torch.bfloat16).normal_(generator=g)

    pool_k, pool_v = paged_pool(randn)
    c = paged_attention_case(dev, randn, pool_k, pool_v, lengths)
    c["shape"] += " (the serving phase's K = 3 turn)"
    log("kernel", f"paged_attention {c['shape']}: max_abs_err={c['max_abs_err']:.3e} within "
                  f"[{BF16_TOL_TEXT}; the same bits on a second call]={c['ok']} kernel="
                  f"{c['ms']:.4f} ms (eager {c['eager_ms']:.4f} ms) plain={c['plain_ms']:.4f} ms "
                  f"library={c['library_ms']:.4f} ms (eager {c['library_eager_ms']:.4f} ms) "
                  f"bound={c['bound_ms']:.4f} ms kernel/bound={c['ms_over_bound']:.2f}")
    del pool_k, pool_v
    torch.cuda.empty_cache()
    if not c["ok"]:
        raise RuntimeError(f"paged_attention disagrees with its plain version: {c['shape']}")
    return c


# the fp32 lse of the training forward against its plain version: about
# twice the largest error measured on an H100 with the CUDA-core kernel
# (9.5e-7 at |lse| ~ 8), as the bf16 limits above were set.  The bf16
# tensor-core forward scales the fp32 q.k after the product where the plain
# version scales q first, and exponentiates with ex2: it measured 1.9e-6 on
# an H100, still inside the limit, which stays.
LSE_TOL = (2e-6, 1e-7)
LSE_TOL_TEXT = "|err| <= 2e-6 + 1e-7*|ref| (fp32 lse)"
# the bf16 dQ, dK and dV (fed either lse) against their plain versions.  The
# tensor-core kernels round each dS and P term to bf16 before its product
# (the plain versions keep them fp32), so an output moves by about 2**-9 of
# the root-mean-square of its terms, whatever its own size.  Their CPU
# emulation (tests/test_torch_attention_tc.py, run as a script) needs, beside
# rtol 1e-2, an atol of up to 1.54e-2 at the shapes timed below (dV at the
# group-7 shape; 1.01e-2 at the 32/8 one); the limit is twice that
# (BF16_TOL's 4e-3 holds the emulation nowhere at these shapes).
BWD_TOL = (3e-2, 1e-2)
BWD_TOL_TEXT = "|err| <= 3e-2 + 1e-2*|ref| (bf16 output; bf16 dS and P terms)"


def check_train_kernels(dev, randn):
    """The training kernels at the adapter stage's shape: Mistral-7B
    attention (32 q / 8 kv heads, D 128) over the 2048 bucket, causal;
    a ragged batch (B 2, kv_len 2048 and 1531), one D 64 case and a GQA
    group of 7 (28 / 4 heads).  The lse forward, dQ and dK/dV each against
    its plain version on the same inputs; SDPA (causal, enable_gqa) is the
    yardstick: its forward, and its forward+backward less the forward (which
    computes dQ, dK and dV at once).  Kernels and yardsticks are timed by
    graph replay, the kernels eagerly too."""
    from streammind_torch.ops import attention as A

    rows = {n: [] for n in TRAIN_KERNELS}
    for b, s, h, hkv, d, kv_len in ((1, 2048, 32, 8, 128, [2048]),
                                    (2, 2048, 32, 8, 128, [2048, 1531]),
                                    (1, 2048, 32, 8, 64, [2048]),
                                    (1, 2048, 28, 4, 128, [2048])):
        shape = f"q({b},{s},{h},{d}) kv({b},{s},{hkv},{d}) causal kv_len={kv_len}"
        lens = torch.tensor(kv_len, dtype=torch.int32, device=dev)
        pairs = h * sum(sum(min(i + 1, n) for i in range(s)) for n in kv_len)
        qb, kvb, rowb = 2 * b * s * h * d, 2 * b * s * hkv * d, 4 * b * s * h
        sets = []
        for _ in range(n_sets(2 * qb + 2 * kvb + 2 * rowb)):
            q, do, k, v = randn(b, s, h, d), randn(b, s, h, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
            out, lse = A.flash_attention_lse(q, k, v, True, lens)
            sets.append((q, k, v, do, lse, (do.float() * out.float()).sum(-1)))
        q, k, v, do, _, _ = sets[0]
        out, lse = A.flash_attention_lse(q, k, v, True, lens)
        ref_out, ref_lse = A.flash_attention_ref(q, k, v, True, lens, return_lse=True)
        delta = (do.float() * ref_out.float()).sum(-1)
        dq = A.flash_bwd_dq(q, k, v, do, ref_lse, delta, True, lens)
        dk, dv = A.flash_bwd_dkv(q, k, v, do, ref_lse, delta, True, lens)
        ref_dq = A.flash_bwd_dq_ref(q, k, v, do, ref_lse, delta, True, lens)
        ref_dk, ref_dv = A.flash_bwd_dkv_ref(q, k, v, do, ref_lse, delta, True, lens)
        # the backward kernels fed the tensor-core forward's lse, as training feeds them
        dq_fwd = A.flash_bwd_dq(q, k, v, do, lse, delta, True, lens)
        dk_fwd, dv_fwd = A.flash_bwd_dkv(q, k, v, do, lse, delta, True, lens)
        checks = {
            "flash_attention_lse": [excess(out, ref_out, *BF16_TOL), excess(lse, ref_lse, *LSE_TOL)],
            "flash_bwd_dq": [excess(dq, ref_dq, *BWD_TOL), excess(dq_fwd, ref_dq, *BWD_TOL)],
            "flash_bwd_dkv": [excess(dk, ref_dk, *BWD_TOL), excess(dv, ref_dv, *BWD_TOL),
                              excess(dk_fwd, ref_dk, *BWD_TOL), excess(dv_fwd, ref_dv, *BWD_TOL)],
        }
        del out, lse, dq, dk, dv, ref_out, ref_dq, ref_dk, ref_dv, dq_fwd, dk_fwd, dv_fwd
        fns = {
            "flash_attention_lse": (lambda z: A.flash_attention_lse(z[0], z[1], z[2], True, lens),
                                    lambda z: A.flash_attention_ref(z[0], z[1], z[2], True, lens,
                                                                    return_lse=True)),
            "flash_bwd_dq": (lambda z: A.flash_bwd_dq(*z, True, lens),
                             lambda z: A.flash_bwd_dq_ref(*z, True, lens)),
            "flash_bwd_dkv": (lambda z: A.flash_bwd_dkv(*z, True, lens),
                              lambda z: A.flash_bwd_dkv_ref(*z, True, lens)),
        }
        # yardstick: SDPA on (B, H, S, D), kv heads grouped by enable_gqa
        mask = None
        if min(kv_len) < s:
            mask = ((torch.arange(s, device=dev)[None, :] <= torch.arange(s, device=dev)[:, None])
                    & (torch.arange(s, device=dev)[None, :] < lens[:, None, None]))[:, None]
        lib_sets = [tuple(t.transpose(1, 2).detach().requires_grad_() for t in z[:3])
                    + (z[3].transpose(1, 2),) for z in sets]

        def sdpa(z):
            return F.scaled_dot_product_attention(z[0], z[1], z[2], attn_mask=mask,
                                                  is_causal=mask is None, enable_gqa=True)

        with torch.no_grad():
            lib_fwd = cuda_ms([lambda z=z: sdpa(z) for z in lib_sets])
            lib_fwd_graph = cuda_ms([lambda z=z: sdpa(z) for z in lib_sets], graph=True)
        both = [lambda z=z: torch.autograd.grad(sdpa(z), z[:3], z[3]) for z in lib_sets]
        lib_bwd_eager = cuda_ms(both) - lib_fwd
        lib_bwd = cuda_ms(both, graph=True) - lib_fwd_graph
        # bytes: each input read once, each output written once
        work = {"flash_attention_lse": (2 * qb + 2 * kvb + rowb, 4.0 * d * pairs),
                "flash_bwd_dq": (qb * 3 + kvb * 2 + 2 * rowb, 6.0 * d * pairs),
                "flash_bwd_dkv": (qb * 2 + kvb * 4 + 2 * rowb, 8.0 * d * pairs)}
        for name in TRAIN_KERNELS:
            kern, plain = fns[name]
            # tensor-core kernels and their yardsticks by graph replay (see check_kernels)
            ms = cuda_ms([lambda z=z: kern(z) for z in sets], graph=True)
            plain_ms = cuda_ms([lambda z=z: plain(z) for z in sets], iters=3, warmup=1)
            b_ms, b_by = bound(*work[name], BF16_FLOPS)
            errs = checks[name]
            fwd = name == "flash_attention_lse"
            rows[name].append(dict(
                shape=shape, max_abs_err=max(e for e, _ in errs), ok=all(o <= 0 for _, o in errs),
                errs=[e for e, _ in errs], ms=ms, plain_ms=plain_ms,
                eager_ms=cuda_ms([lambda z=z: kern(z) for z in sets]),
                library_ms=lib_fwd_graph if fwd else lib_bwd, bound_ms=b_ms, bound_by=b_by))
        dq_row, dkv_row = rows["flash_bwd_dq"][-1], rows["flash_bwd_dkv"][-1]
        log("kernel", f"backward {shape}: dQ + dK/dV = {dq_row['ms'] + dkv_row['ms']:.4f} ms "
                      f"(graph replay; eager {dq_row['eager_ms'] + dkv_row['eager_ms']:.4f} ms) "
                      f"beside SDPA's backward {lib_bwd:.4f} ms (graph replay; eager "
                      f"{lib_bwd_eager:.4f} ms); bound {dq_row['bound_ms'] + dkv_row['bound_ms']:.4f} ms")
        del sets, lib_sets
        torch.cuda.empty_cache()
    return {"flash_attention_lse": (rows["flash_attention_lse"],
                                    f"out {BF16_TOL_TEXT}; lse {LSE_TOL_TEXT}"),
            "flash_bwd_dq": (rows["flash_bwd_dq"], f"{BWD_TOL_TEXT}, fed the plain lse and "
                                                   f"the kernel's"),
            "flash_bwd_dkv": (rows["flash_bwd_dkv"], f"dK and dV {BWD_TOL_TEXT}, fed the plain "
                                                     f"lse and the kernel's")}


# int8 against its plain version: fp32 sums in another order, then one
# rounding to the output dtype; |err| <= atol + rtol*|ref| with one bf16 step
# (2**-8 relative) for bf16 outputs, fp32 sums over up to 14336 terms for fp32
INT8_TOL = {torch.bfloat16: (1e-3, 1e-2), torch.float32: (1e-4, 1e-5)}
# the scan: the same step-by-step fp32 arithmetic but for the order of the sum
# over the 16 states and the exp/log1p of the device; bf16 y rounds once
SCAN_TOL = {torch.bfloat16: (4e-3, 1e-2), torch.float32: (1e-5, 1e-5)}
SCAN_STATE_TOL = (1e-5, 1e-5)


def tol_text(tol, what):
    return f"|err| <= {tol[0]:g} + {tol[1]:g}*|ref| ({what})"


# the int8 gate's four linears (one token a frame) and the int8 decoder's
# three fused ones
INT8_SHAPES = (("v", 1024, 4096), ("o", 4096, 4096), ("gate/up", 14336, 4096),
               ("down", 4096, 14336), ("qkv (fused)", 6144, 4096),
               ("gateup (fused)", 28672, 4096))


def int8_cases(dev, g, shapes=INT8_SHAPES, dtypes=(torch.bfloat16, torch.float32),
               batches=(1, 4, 8)):
    """int8_matvec against its plain version at each (name, out, in) shape,
    x dtype and token count; the yardstick is F.linear on the weight
    dequantized beforehand into x's dtype."""
    from streammind_torch.ops.int8_matvec import int8_matvec, int8_matvec_ref
    from streammind_torch.utils.quantize import dequantize_linear_weight, quantize_linear_weight

    rows = []
    for name, dout, din in shapes:
        n_copy = n_sets(dout * din)
        qs = [quantize_linear_weight(torch.empty((dout, din), device=dev).normal_(
            0.0, 0.02, generator=g)) for _ in range(n_copy)]
        for dtype in dtypes:
            libs = [dequantize_linear_weight(q, dtype) for q in qs]
            esize = torch.finfo(dtype).bits // 8
            for b in batches:
                x = torch.empty((b, din), device=dev, dtype=dtype).normal_(generator=g)
                q0 = qs[0]
                out = int8_matvec(x, q0["w_int8"], q0["scale"])
                ref = int8_matvec_ref(x, q0["w_int8"], q0["scale"])
                err, over = excess(out, ref, *INT8_TOL[dtype])
                # kernel and yardstick by graph replay (the kernel runs in
                # less time than its wrapper's host work) and eagerly
                fns = [lambda q=q: int8_matvec(x, q["w_int8"], q["scale"]) for q in qs]
                ms, eager = cuda_ms(fns, graph=True), cuda_ms(fns)
                plain = cuda_ms([lambda q=q: int8_matvec_ref(x, q["w_int8"], q["scale"])
                                 for q in qs], iters=5)
                lib_fns = [lambda w=w: F.linear(x, w) for w in libs]
                lib, lib_eager = cuda_ms(lib_fns, graph=True), cuda_ms(lib_fns)
                b_ms, b_by = bound(dout * din + 4 * dout + esize * b * (din + dout),
                                   2.0 * b * dout * din,
                                   BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS)
                rows.append(dict(shape=f"{name}: x({b},{din}) {str(dtype)[6:]} W({dout},{din}) "
                                       f"int8", max_abs_err=err, ok=over <= 0, ms=ms,
                                 eager_ms=eager, plain_ms=plain, library_ms=lib,
                                 library_eager_ms=lib_eager, bound_ms=b_ms, bound_by=b_by,
                                 ms_over_bound=ms / b_ms))
            del libs
        del qs
        torch.cuda.empty_cache()
    return rows


# int4 against its plain version, either dtype of x: the fp32 sums in another
# order, then one rounding to the output dtype (the limit of PR 1, which the
# acceptance of the tensor-core redesign keeps)
INT4_TOL = (1e-2, 1e-2)
INT4_TOL_TEXT = "|err| <= 1e-2 + 1e-2*|ref| (bf16 and fp32 output)"
# the int4 gate's four linears (one token a frame a stream)
INT4_SHAPES = INT8_SHAPES[:4]
# the load_4bit="pc" decoder's two fused linears, one token (greedy) or one
# a beam; its o and down have the gate's shapes, held here at one row a beam
# (the gate's cases run them at B 1, 4 and 8)
INT4_DECODER_SHAPES = INT8_SHAPES[4:]
INT4_DECODER_UNFUSED = (INT8_SHAPES[1], INT8_SHAPES[3])


def int4_cases(dev, g, shapes=INT4_SHAPES, dtypes=(torch.bfloat16, torch.float32),
               batches=(1, 4, 8)):
    """int4_matvec against its plain version at each (name, out, in) shape,
    x dtype and token count (B 4: the serving tick's four streams); kernel
    and yardstick (F.linear on the weight dequantized beforehand into x's
    dtype) by graph replay and eagerly."""
    from streammind_torch.ops.int4_matvec import int4_matvec, int4_matvec_ref
    from streammind_torch.utils.quantize import (dequantize_linear_weight_int4_pc,
                                                 quantize_linear_weight_int4_pc)

    rows = []
    for name, dout, din in shapes:
        # enough weight copies to exceed the 50 MB L2: each frame reads them cold
        packs = [quantize_linear_weight_int4_pc(torch.empty((dout, din), device=dev).normal_(
            0.0, 0.02, generator=g)) for _ in range(n_sets(dout * din / 2))]
        for dtype in dtypes:
            libs = [dequantize_linear_weight_int4_pc(p, dtype) for p in packs]
            esize = torch.finfo(dtype).bits // 8
            for b in batches:
                x = torch.empty((b, din), device=dev, dtype=dtype).normal_(generator=g)
                p0 = packs[0]
                out = int4_matvec(x, p0["w_int4pc"], p0["scale"])
                ref = int4_matvec_ref(x, p0["w_int4pc"], p0["scale"])
                err, over = excess(out, ref, *INT4_TOL)
                fns = [lambda p=p: int4_matvec(x, p["w_int4pc"], p["scale"]) for p in packs]
                ms, eager = cuda_ms(fns, graph=True), cuda_ms(fns)
                plain = cuda_ms([lambda p=p: int4_matvec_ref(x, p["w_int4pc"], p["scale"])
                                 for p in packs], iters=5)
                lib_fns = [lambda w=w: F.linear(x, w) for w in libs]
                lib, lib_eager = cuda_ms(lib_fns, graph=True), cuda_ms(lib_fns)
                b_ms, b_by = bound(dout * din / 2 + 4 * dout + esize * b * (din + dout),
                                   2.0 * b * dout * din,
                                   BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS)
                rows.append(dict(shape=f"{name}: x({b},{din}) {str(dtype)[6:]} W({dout},{din}/2) "
                                       f"int4", max_abs_err=err, ok=over <= 0, ms=ms,
                                 eager_ms=eager, plain_ms=plain, library_ms=lib,
                                 library_eager_ms=lib_eager, bound_ms=b_ms, bound_by=b_by,
                                 ms_over_bound=ms / b_ms))
            del libs
        del packs
        torch.cuda.empty_cache()
    return rows


# the scan cases (dtype, batch, steps, carried state, u's layout).  u lies as
# the burst hands it over, the conv output past its 3-step window,
# contiguous in time ("time"), or as the mixer's (B, L, D) product seen as
# (B, D, L) ("channels").  First the burst's own: bf16, L 32, a carried
# state, u by time (its time is the kernels line's ms); then bf16 and fp32
# at L 32, 1, 8 and 64 with and without the state, u by channels; then, in
# bf16 only, L 256 and B 4
SCAN_CASES = ((torch.bfloat16, 1, 32, True, "time"),) + tuple(
    (dt, b, length, h0, "channels") for dt in (torch.bfloat16, torch.float32)
    for b, length in ((1, 32), (1, 1), (1, 8), (1, 64)) for h0 in (True, False)) + (
    (torch.bfloat16, 1, 256, True, "channels"), (torch.bfloat16, 4, 32, True, "channels"),
    (torch.bfloat16, 1, 16, False, "time"))  # the api's clip projection: L = 16 frames, fresh


def scan_cases(dev, g, cases=SCAN_CASES, d=8192, n=16):
    """selective_scan against its plain version at the burst's Mamba shape
    (d_inner 8192, d_state 16), its inputs laid out as the mixer hands them
    over; kernel by graph replay (it runs in less time than its wrapper's
    host work) and eagerly, beside its bound.  No single PyTorch call
    computes it."""
    from streammind_torch.ops import scan as S

    rows = []
    for dtype, b, length, with_h0, u_layout in cases:
        esize = torch.finfo(dtype).bits // 8

        def case():
            def r(*shape, std=1.0, dt=dtype):
                return torch.empty(shape, device=dev, dtype=dt).normal_(0.0, std, generator=g)

            xz, dtp, x_dbl = r(b, length, 2 * d), r(b, length, d, std=0.5), r(b, length,
                                                                             256 + 2 * n)
            u = xz[..., :d].transpose(1, 2) if u_layout == "channels" else r(b, d, length + 3)[
                ..., 3:]
            args = (u, dtp.transpose(1, 2), -torch.exp(r(d, n, std=0.5, dt=torch.float32)),
                    x_dbl[..., 256:256 + n].transpose(1, 2), x_dbl[..., 256 + n:].transpose(1, 2))
            return args, dict(D=r(d, dt=torch.float32), z=xz[..., d:].transpose(1, 2),
                              delta_bias=r(d, dt=torch.float32), delta_softplus=True,
                              return_last_state=True,
                              h0=r(b, d, n, dt=torch.float32) if with_h0 else None)

        nbytes = (esize * (4 * b * d * length + 2 * b * n * length) + 4 * (d * n + 2 * d)
                  + 4 * b * d * n * (2 if with_h0 else 1))
        sets = [case() for _ in range(n_sets(nbytes))]
        args, kw = sets[0]
        y, h = S.selective_scan(*args, **kw, impl="pallas")
        ref_y, ref_h = S.selective_scan_ref(*args, **kw)
        errs = [excess(y, ref_y, *SCAN_TOL[dtype]), excess(h, ref_h, *SCAN_STATE_TOL)]
        fns = [lambda s=s: S.selective_scan(*s[0], **s[1], impl="pallas") for s in sets]
        ms, eager = cuda_ms(fns, graph=True), cuda_ms(fns)
        plain = cuda_ms([lambda s=s: S.selective_scan_ref(*s[0], **s[1]) for s in sets],
                        iters=3, warmup=1)
        b_ms, b_by = bound(nbytes, (7.0 * n + 12.0) * b * d * length, FP32_FLOPS)
        rows.append(dict(shape=f"u/dt/z ({b},{d},{length}) {str(dtype)[6:]} A({d},{n}) "
                               f"B/C ({b},{n},{length}) h0={'yes' if with_h0 else 'no'} "
                               f"u={u_layout}",
                         max_abs_err=max(e for e, _ in errs), errs=[e for e, _ in errs],
                         ok=all(o <= 0 for _, o in errs), ms=ms, eager_ms=eager, plain_ms=plain,
                         library_ms=None, bound_ms=b_ms, bound_by=b_by, ms_over_bound=ms / b_ms))
        del sets
    return rows


def check_fast_kernels(dev, g):
    """The fast tier's two kernels.  int8_matvec at the int8 gate's four
    shapes (one token a frame) and the int8 decoder's three fused ones, B 1, 4
    and 8, bf16 and fp32 x; the yardstick is F.linear on the weight
    dequantized beforehand into x's dtype.  selective_scan at
    ``SCAN_CASES``."""
    results = {"int8_matvec": (int8_cases(dev, g), "; ".join(
        tol_text(INT8_TOL[d], str(d)[6:] + " output") for d in INT8_TOL))}
    results["selective_scan"] = (scan_cases(dev, g), "y " + "; ".join(
        tol_text(SCAN_TOL[dt], str(dt)[6:]) for dt in SCAN_TOL) + "; last state "
        + tol_text(SCAN_STATE_TOL, "fp32"))
    return results


# ---------------------------------------------------------------------------
# phases 4-6: the session, multi-stream serving, parity
# ---------------------------------------------------------------------------
class StandInTokenizer:
    """Character-level stand-in (the repo ships no tokenizer files): ids
    3..202, BOS 1, EOS 2, at most 24 ids per call."""

    bos_token_id = 1
    eos_token_id = 2
    eos_token = "</s>"

    class _Out:
        def __init__(self, ids):
            self.input_ids = ids

    def __call__(self, text):
        return self._Out([self.bos_token_id] + [3 + (ord(c) % 200) for c in text][:24])

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


def make_engine_class():
    from streammind_torch.streaming import StreamMindEngine

    class RecordingEngine(StreamMindEngine):
        """Records gate probs, prefill logits and synchronized host times."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.probs, self.prefill_logits, self.decoded = [], [], []
            self.prefill_end = None
            self.decode_ms = []

        def _sync(self):
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            return time.perf_counter()

        def perceive_step(self, pixels, state):
            probs, state = super().perceive_step(pixels, state)
            self.probs.append(probs.float().cpu())
            return probs, state

        def perceive_step_batch(self, pixels, state, feed_mask=None):
            probs, state = super().perceive_step_batch(pixels, state, feed_mask)
            self.probs.append(probs.float().cpu())
            return probs, state

        def prefill(self, plan, memory, cache):
            last, cache = super().prefill(plan, memory, cache)
            int(torch.argmax(last[0]))  # the greedy first token is known here
            self.prefill_end = self._sync()
            self.prefill_logits.append(last.float().cpu())
            return last, cache

        def generate_from_prefill(self, *a, **kw):
            t0 = self._sync()
            tokens, cache = super().generate_from_prefill(*a, **kw)
            self.decode_ms.append((self._sync() - t0) * 1e3)
            self.decoded.append(list(tokens))
            return tokens, cache

    return RecordingEngine


def recording_serving_classes():
    """Subclasses that the serving phase swaps in for the broker's server and
    page pool: synchronized tick times, the time each batched turn's first
    tokens are known, and the lockstep decode steps and their time."""
    from streammind_torch.streaming.multistream import MultiStreamServer
    from streammind_torch.streaming.paged import PagedDialogues

    class RecordingPaged(PagedDialogues):
        def _decode_step(self, table, length, toks):
            self.steps += 1
            return super()._decode_step(table, length, toks)

        def _decode(self, table, length, first, *a, **kw):
            t0 = sync()  # the first tokens are on the host here
            self.first_token_at.append(t0)
            steps0 = self.steps
            # the lengths the first step's paged attention is given (each
            # row's length before the step, plus the token it appends)
            attn_lengths = [int(n) + 1 for n in length]
            out = super()._decode(table, length, first, *a, **kw)
            self.decodes.append(dict(k=len(first), steps=self.steps - steps0,
                                     ms=(sync() - t0) * 1e3, attn_lengths=attn_lengths))
            return out

    class RecordingServer(MultiStreamServer):
        def step(self, frames):
            n0 = len(self.paged.first_token_at)
            t0 = sync()
            out = super().step(frames)
            t1 = sync()
            self.tick_log.append(dict(
                ms=(t1 - t0) * 1e3, fired=sorted(k for k, v in out.items() if v is not None),
                first_token_ms=[(t - t0) * 1e3 for t in self.paged.first_token_at[n0:]]))
            return out

    return RecordingServer, RecordingPaged


def stand_in_prompt(tok):
    from streammind_torch.constants import VIDEO_TOKEN_INDEX
    from streammind_torch.mm_utils import tokenizer_multimodal_token

    return tokenizer_multimodal_token("[INST] <video>\nWhat is happening? [/INST]", tok,
                                      VIDEO_TOKEN_INDEX)


def run_session(engine, frames, fire, max_new):
    from streammind_torch.streaming import StreamSession

    tok = StandInTokenizer()
    session = StreamSession(engine, tok, prompt_ids=stand_in_prompt(tok), max_new_tokens=max_new,
                            gate_threshold=2.0)  # fires only where forced
    ticks, e2ft = [], []
    for i, f in enumerate(frames):
        t0 = engine._sync()
        session.process_frame(f, force_fire=i in fire)
        t1 = engine._sync()
        if i in fire:
            e2ft.append((engine.prefill_end - t0) * 1e3)
        else:
            ticks.append((t1 - t0) * 1e3)
    return session, ticks, e2ft


def build_engine(dev):
    from streammind_torch.config import StreamMindConfig
    from streammind_torch.models.meta import init_streammind_params
    from streammind_torch.utils.params import param_bytes

    cfg = StreamMindConfig()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    params = init_streammind_params(g, cfg, device=dev, dtype=torch.bfloat16)
    log("session", f"StreamMind-7B bf16 tree: {param_bytes(params) / 1e9:.2f} GB built in "
                   f"{time.perf_counter() - t0:.1f} s")
    engine = make_engine_class()(params, cfg, attn_impl="exact", quantize_gate="int4",
                                      device=dev)
    return engine, g


def full_width_session(engine, g, dev):
    cfg = engine.cfg
    n_frames, fire = 10, (3, 7)
    frames = [torch.empty((1, 3, 336, 336), device=dev, dtype=torch.bfloat16).normal_(
        generator=g) for _ in range(n_frames)]
    torch.cuda.synchronize()
    reset_launches()
    session, ticks, e2ft = run_session(engine, frames, fire, max_new=16)
    counts = read_launches()
    turns = len(session.turns)
    n_vit = cfg.vision.num_layers + cfg.vision.select_layer + 1
    expect = {"exact_attention": n_vit * n_frames, "int4_matvec": 5 * cfg.gate.num_layers * n_frames,
              "flash_attention": cfg.text.num_layers * turns, "paged_write": 0,
              "paged_attention": 0, **{n: 0 for n in TRAIN_KERNELS + FAST_KERNELS}}
    expect.update({f"{n}_tc": expect[n] for n in TC_KERNELS})  # bf16: every launch
    probs = torch.stack(engine.probs)
    n_tok = sum(len(t) for t in engine.decoded)
    decode_ms_tok = sum(engine.decode_ms) / max(n_tok, 1)
    log("session", f"frames={n_frames} turns={turns} tokens={[len(t) for t in engine.decoded]} "
                   f"launches={counts} expected={expect}")
    log("session", f"tensor-core launches: exact {counts['exact_attention_tc'] / n_frames:g} a "
                   f"frame, flash {counts['flash_attention_tc'] / max(turns, 1):g} a turn")
    log("session", f"median tick (silent frames after the first) = "
                   f"{statistics.median(ticks[1:]):.3f} ms; ticks ms = "
                   f"{[round(t, 3) for t in ticks]}")
    log("session", f"event-to-first-token ms = {[round(t, 3) for t in e2ft]}; "
                   f"decode ms/token = {decode_ms_tok:.3f}")
    log("session", f"peak device memory = {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if not (torch.isfinite(probs).all() and (probs.sum(-1) - 1).abs().max() < 1e-5):
        raise RuntimeError(f"gate probs not finite or not summing to 1: {probs}")
    if not torch.isfinite(session.state.memory).all():
        raise RuntimeError("memory ring holds non-finite values")
    if turns != 2 or any(not 0 <= t < cfg.text.vocab_size for ts in engine.decoded for t in ts):
        raise RuntimeError(f"expected two turns of valid token ids: {engine.decoded}")
    if counts != expect:
        raise RuntimeError(f"launch counts {counts} differ from the path's {expect}")
    del session, frames
    torch.cuda.empty_cache()
    return dict(tick_ms_median=statistics.median(ticks[1:]), event_to_first_token_ms=e2ft,
                decode_ms_per_token=decode_ms_tok, launches=counts)


SERVE_TICKS = 8
SERVE_FIRES = {3: ("s0", "s1", "s2"), 6: ("s3",)}  # tick -> streams whose gates fire


def serving_phase(engine, g, dev):
    """Four client threads submit a frame a tick to one BatchedSessionBroker
    (paged KV, page 64) for SERVE_TICKS ticks.  The per-stream gate
    threshold, a request knob, is set before each tick: -1 opens a gate, 2
    keeps it shut, so three streams fire together on one tick and one alone
    on a later one."""
    import threading

    from streammind_torch.serve import BatchedSessionBroker

    cfg = engine.cfg
    sids = [f"s{i}" for i in range(4)]
    torch.cuda.reset_peak_memory_stats()
    # a long batching window: each tick waits for all four frames
    broker = BatchedSessionBroker(engine, capacity=4, kv_mode="paged", page_size=64,
                                  max_wait_ms=2000.0)
    RecordingServer, RecordingPaged = recording_serving_classes()
    srv = broker.server
    srv.__class__, srv.paged.__class__ = RecordingServer, RecordingPaged
    srv.tick_log, srv.paged.steps, srv.paged.first_token_at, srv.paged.decodes = [], 0, [], []
    pd = srv.paged
    pool_gb = sum(t.numel() * t.element_size() for t in pd.pool.k + pd.pool.v) / 1e9
    log("serve", f"page pool: {pd.pool.num_pages - 1} pages + sink of {pd.page_size} tokens, "
                 f"{pool_gb:.2f} GB ({cfg.text.num_kv_heads} kv heads x {cfg.text.head_dim} x "
                 f"{cfg.text.num_layers} layers x k,v, {pd.pool.k[0].dtype}); "
                 f"{pd.max_pages} pages a dialogue")
    tok = StandInTokenizer()
    for sid in sids:
        broker.add(sid, tok, prompt_ids=stand_in_prompt(tok), max_new_tokens=16,
                   gate_threshold=2.0)
    size = cfg.vision.image_size
    frames = {sid: [torch.empty((1, 3, size, size), device=dev, dtype=torch.bfloat16).normal_(
        generator=g) for _ in range(SERVE_TICKS)] for sid in sids}
    results = {sid: [] for sid in sids}
    start, done = threading.Barrier(len(sids) + 1), threading.Barrier(len(sids) + 1)

    def client(sid):
        for t in range(SERVE_TICKS):
            start.wait()
            results[sid].append(broker.submit(sid, frames[sid][t], timeout=600))
            done.wait()

    threads = [threading.Thread(target=client, args=(sid,), daemon=True) for sid in sids]
    torch.cuda.synchronize()
    reset_launches()
    try:
        for th in threads:
            th.start()
        for t in range(SERVE_TICKS):
            for slot in srv.slots:
                slot.gate_threshold = -1.0 if slot.stream_id in SERVE_FIRES.get(t, ()) else 2.0
            start.wait(timeout=600)
            done.wait(timeout=600)
        for th in threads:
            th.join(timeout=60)
        counts = read_launches()
    finally:
        start.abort()
        done.abort()
        broker.shutdown()
    n_vit = cfg.vision.num_layers + cfg.vision.select_layer + 1
    L = cfg.text.num_layers
    steps = pd.steps
    expect = {"exact_attention": n_vit * SERVE_TICKS,
              "int4_matvec": 5 * cfg.gate.num_layers * SERVE_TICKS,
              "flash_attention": L * len(pd.decodes), "paged_write": L * steps,
              "paged_attention": L * steps, **{n: 0 for n in TRAIN_KERNELS + FAST_KERNELS}}
    expect.update({f"{n}_tc": expect[n] for n in TC_KERNELS})
    ticks = srv.tick_log
    log("serve", f"ticks={broker.ticks} frames={broker.frames_seen} fired per tick="
                 f"{[t['fired'] for t in ticks]}")
    log("serve", f"lockstep turns (K, steps, ms, first step's attention lengths) = "
                 f"{[(d['k'], d['steps'], round(d['ms'], 3), d['attn_lengths']) for d in pd.decodes]}; "
                 f"launches={counts} expected={expect}")
    log("serve", f"tensor-core launches: exact {counts['exact_attention_tc'] / SERVE_TICKS:g} a "
                 f"tick, flash {counts['flash_attention_tc'] / len(pd.decodes):g} a batched prefill")
    silent = [t["ms"] for t in ticks[1:] if not t["fired"]]
    fire_ticks = [t for t in ticks if t["fired"]]
    per_step = {d["k"]: d["ms"] / max(d["steps"], 1) for d in pd.decodes}
    log("serve", f"median silent tick at S=4 (after the first) = "
                 f"{statistics.median(silent):.3f} ms; ticks ms = "
                 f"{[round(t['ms'], 3) for t in ticks]}")
    log("serve", f"event-to-first-token ms = "
                 f"{[(t['fired'], [round(x, 3) for x in t['first_token_ms']]) for t in fire_ticks]}"
                 f"; decode ms per lockstep step = "
                 f"{ {k: round(v, 3) for k, v in per_step.items()} }")
    log("serve", f"peak device memory = {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    errors = [r for rs in results.values() for r in rs if "error" in r]
    if errors:
        raise RuntimeError(f"ticks failed inside the broker: {errors}")
    for sid, rs in results.items():
        want = [sid in SERVE_FIRES.get(t, ()) for t in range(SERVE_TICKS)]
        if len(rs) != SERVE_TICKS or [r["fire"] for r in rs] != want:
            raise RuntimeError(f"{sid}: fires {[r['fire'] for r in rs]}, expected {want}")
        if any(r["fire"] != isinstance(r["text"], str) for r in rs):
            raise RuntimeError(f"{sid}: an utterance is missing or a silence spoke: {rs}")
        if [r["frame_idx"] for r in rs] != list(range(1, SERVE_TICKS + 1)):
            raise RuntimeError(f"{sid}: frame indices {[r['frame_idx'] for r in rs]}")
    if broker.ticks != SERVE_TICKS or [d["k"] for d in pd.decodes] != [3, 1]:
        raise RuntimeError(f"expected {SERVE_TICKS} ticks with one K=3 and one K=1 turn, got "
                           f"{broker.ticks} ticks and turns {pd.decodes}")
    if counts != expect or not all(counts[n] for n in counts
                                   if kernel_of(n) not in TRAIN_KERNELS + FAST_KERNELS):
        raise RuntimeError(f"launch counts {counts} differ from the path's {expect}")
    # the token write has no launch of its own: every paged attention launch
    # wrote its step's token, one a layer a step
    log("serve", f"paged decode: {counts['paged_attention']} launches in {steps} lockstep steps "
                 f"({counts['paged_attention'] / max(steps, 1):g} a step), "
                 f"{counts['paged_write']} of them writing the step's token; no separate write "
                 f"kernel")
    probs = torch.cat(engine.probs[-SERVE_TICKS:])
    if not (torch.isfinite(probs).all() and (probs.sum(-1) - 1).abs().max() < 1e-5):
        raise RuntimeError(f"gate probs not finite or not summing to 1: {probs}")
    attn_lengths = {d["k"]: d["attn_lengths"] for d in pd.decodes}
    del frames, broker, srv, pd
    torch.cuda.empty_cache()
    return dict(silent_tick_ms_median=statistics.median(silent),
                event_to_first_token_ms={len(t["fired"]): t["first_token_ms"][0]
                                         for t in fire_ticks},
                decode_ms_per_step=per_step, launches=counts, steps=steps,
                attn_lengths=attn_lengths)


def parity_config():
    from streammind_torch.config import StreamMindConfig, gate_lm_config

    base = StreamMindConfig()
    return base.replace(
        vision=dataclasses.replace(base.vision, num_layers=3),
        text=dataclasses.replace(base.text, num_layers=2),
        gate=dataclasses.replace(gate_lm_config(), num_layers=2),
    )


def parity(dev):
    from streammind_torch.models.meta import init_streammind_params

    cfg = parity_config()
    params = init_streammind_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    rng = torch.Generator().manual_seed(2)
    frames = [torch.randn((1, 3, 336, 336), generator=rng) for _ in range(4)]
    fire = (1, 3)
    Engine = make_engine_class()
    out = {}
    # the card once with TF32 off (the parity run) and once with it on (the
    # control: the limits must catch matmuls that lose fp32 precision)
    for run, where, tf32 in (("cpu", "cpu", False), ("card", dev, False),
                             ("card_tf32", dev, True)):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        t0 = time.perf_counter()
        eng = Engine(params, cfg, attn_impl="exact", quantize_gate="int4", kv_capacity=1024,
                     device=where)
        reset_launches()
        session, _, _ = run_session(eng, [f.to(where) for f in frames], fire, max_new=8)
        counts = read_launches()
        out[run] = dict(probs=torch.stack(eng.probs), memory=session.state.memory[0, :4].cpu(),
                        logits=torch.cat(eng.prefill_logits), tokens=eng.decoded)
        log("parity", f"{run}: {time.perf_counter() - t0:.1f} s, tokens {eng.decoded}")
        if where != "cpu":
            fp32_only(counts, "parity")
            if not (counts["exact_attention"] and counts["flash_attention"]):
                raise RuntimeError(f"the card's session missed the exact or flash kernel: {counts}")
        del eng, session
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # about ten times the errors measured on an H100 with TF32 off
    # (probs 1.94e-6, memory 1.46e-6, logits 1.69e-5)
    tol = {"probs": 2e-5, "memory": 2e-5, "logits": 2e-4}
    c = out["cpu"]
    errs, control = ({k: float((c[k] - out[run][k]).abs().max()) for k in tol}
                     for run in ("card", "card_tf32"))
    log("parity", f"depth vit3/gate2/text2 at published widths, fp32, TF32 off: max |cpu - "
                  f"card| = {errs}, tolerance {tol}; greedy tokens equal: "
                  f"{c['tokens'] == out['card']['tokens']}")
    log("parity", f"control, TF32 on: max |cpu - card| = {control}; over the tolerance: "
                  f"{[k for k in tol if control[k] > tol[k]]}")
    if any(errs[k] > tol[k] for k in tol) or c["tokens"] != out["card"]["tokens"]:
        raise RuntimeError("CPU (plain versions) and card (kernels) disagree")
    if not any(control[k] > tol[k] for k in tol):
        raise RuntimeError("the parity limits do not see TF32 matmuls on the card")
    multistream_parity(cfg, params, dev, tol["probs"])
    return errs


# ticks of the multi-stream parity run: streams whose gates are forced open
PARITY_FIRES = ({"a", "b"}, set(), {"b"}, {"a", "b"})


def multistream_parity(cfg, params, dev, probs_tol):
    """The same frames through MultiStreamServer: paged on the CPU (plain
    versions), paged on the card (kernels) and dense on the card, fp32 with
    TF32 off.  Utterances and turns must be identical across the three; gate
    probs within the session's limit.  page_size 16 puts page boundaries
    inside the decode loop."""
    from streammind_torch.streaming.multistream import MultiStreamServer

    Engine = make_engine_class()
    tok = StandInTokenizer()
    rng = torch.Generator().manual_seed(3)
    size = cfg.vision.image_size
    frames = [{sid: torch.randn((1, 3, size, size), generator=rng) for sid in "ab"}
              for _ in PARITY_FIRES]
    out = {}
    for run, where, kv_mode in (("paged_cpu", "cpu", "paged"), ("paged_card", dev, "paged"),
                                ("dense_card", dev, "dense")):
        t0 = time.perf_counter()
        eng = Engine(params, cfg, attn_impl="exact", quantize_gate="int4", kv_capacity=1024,
                     device=where)
        srv = MultiStreamServer(eng, capacity=2, kv_mode=kv_mode, page_size=16)
        for sid, limit in (("a", 8), ("b", 5)):
            srv.add_stream(sid, tok, prompt_ids=stand_in_prompt(tok), max_new_tokens=limit)
        reset_launches()
        log_ = []
        for f, fires in zip(frames, PARITY_FIRES):
            for slot in srv.slots:
                if slot is not None:
                    slot.gate_threshold = -1.0 if slot.stream_id in fires else 2.0
            log_.append(srv.step({k: v.to(where) for k, v in f.items()}))
        counts = read_launches()
        out[run] = dict(log=log_, turns=[list(s.turns) for s in srv.slots if s is not None],
                        probs=torch.cat(eng.probs))
        log("parity", f"multistream {run}: {time.perf_counter() - t0:.1f} s, utterances "
                      f"{log_}, launches {counts}")
        if where != "cpu" and kv_mode == "paged" and not (
                counts["paged_attention"] and counts["paged_write"]):
            raise RuntimeError(f"the paged run on the card missed the paged kernels: {counts}")
        if where != "cpu":
            fp32_only(counts, "parity")
        del eng, srv
    ref = out["paged_cpu"]
    errs = {run: float((ref["probs"] - out[run]["probs"]).abs().max())
            for run in ("paged_card", "dense_card")}
    same = {run: (out[run]["log"], out[run]["turns"]) == (ref["log"], ref["turns"])
            for run in errs}
    log("parity", f"multistream: max |probs - cpu| = {errs} (limit {probs_tol}); utterances and "
                  f"turns identical to the CPU's: {same}")
    if not all(same.values()) or any(e > probs_tol for e in errs.values()):
        raise RuntimeError("multi-stream serving differs between the CPU and the card")
    if any(o is None for o in ref["log"][0].values()):
        raise RuntimeError(f"the batched tick did not speak: {ref['log'][0]}")


# ---------------------------------------------------------------------------
# phases 9-10: the fast serving tier and the burst catch-up
# ---------------------------------------------------------------------------
BURST = 32          # frames of one burst: about one second of a 30 fps stream
PARITY_BURST = 16


class DecodeCounter:
    """Counts the decoder's one-token forwards (``text_forward`` called with
    input ids, as only the decode loops call it) while it is installed."""

    def __init__(self):
        from streammind_torch.models import mistral

        self.mod, self.orig, self.n = mistral, mistral.text_forward, 0

    def __enter__(self):
        def counted(*a, **kw):
            if kw.get("input_ids") is not None:
                self.n += 1
            return self.orig(*a, **kw)

        self.mod.text_forward = counted
        return self

    def __exit__(self, *exc):
        self.mod.text_forward = self.orig


def clone_state(state):
    from streammind_torch.models.mamba import MambaState

    return state._replace(memory=state.memory.clone(),
                          mamba=MambaState(conv=state.mamba.conv.clone(),
                                           ssm=state.mamba.ssm.clone()))


def burst_and_steps(engine, state, frames):
    """The same frames through one perceive_burst and through single
    perceive_steps, each from its own copy of ``state``.  Returns the two
    (probs, state) pairs and the burst's synchronized ms."""
    a = clone_state(state)
    t0 = sync()
    probs_b, a = engine.perceive_burst(torch.cat(frames), a)
    burst_ms = (sync() - t0) * 1e3
    b = clone_state(state)
    for f in frames:
        probs_s, b = engine.perceive_step(f, b)
    return (probs_b.float().cpu(), a), (probs_s.float().cpu(), b), burst_ms


def burst_errors(burst, steps, first_slot):
    (pb, a), (ps, b) = burst, steps
    rows = slice(first_slot, first_slot + BURST)
    return {"probs": float((pb - ps).abs().max()),
            "memory": float((a.memory[:, rows] - b.memory[:, rows]).abs().max()),
            "ssm": float((a.mamba.ssm - b.mamba.ssm).abs().max()),
            "ssm_max": float(b.mamba.ssm.abs().max())}


def fast_phase(dev):
    """StreamMind-7B on the fast serving tier, built as the JAX package's
    bench builds it: a bf16 tree from seed 0, the decoder through the
    load_8bit transform, then StreamMindEngine(quantize_gate="int8",
    fast_vision="int8").  The session of phase 4 (10 frames, two forced
    fires, 16 new tokens a turn), then a burst of BURST frames on the same
    engine and stream, and the same frames as single steps."""
    from streammind_torch.config import StreamMindConfig
    from streammind_torch.models.meta import init_streammind_params
    from streammind_torch.utils.params import param_bytes
    from streammind_torch.utils.quantize import quantize_text_params

    cfg = StreamMindConfig()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    params = init_streammind_params(g, cfg, device=dev, dtype=torch.bfloat16)
    params["text"] = quantize_text_params(params["text"], bits=8, free_source=True)
    engine = make_engine_class()(params, cfg, quantize_gate="int8", fast_vision="int8",
                                 device=dev)
    del params
    torch.cuda.synchronize()
    log("fast", f"StreamMind-7B, int8 decoder (load_8bit), int8 gate and ViT: "
                f"{param_bytes(engine.params) / 1e9:.2f} GB ({param_bytes(engine.params['text']) / 1e9:.2f} "
                f"GB decoder) built in {time.perf_counter() - t0:.1f} s; ViT attention "
                f"{engine.attn_impl!r}")
    n_frames, fire, size = 10, (3, 7), cfg.vision.image_size
    frames = [torch.empty((1, 3, size, size), device=dev, dtype=torch.bfloat16).normal_(
        generator=g) for _ in range(n_frames)]
    torch.cuda.synchronize()
    reset_launches()
    with DecodeCounter() as dc:
        session, ticks, e2ft = run_session(engine, frames, fire, max_new=16)
    counts = read_launches()
    turns = len(session.turns)
    gate_per_tick = 5 * cfg.gate.num_layers
    per_decode = 4 * cfg.text.num_layers
    expect = {n: 0 for n in counts}
    expect.update(flash_attention=cfg.text.num_layers * turns,
                  flash_attention_tc=cfg.text.num_layers * turns,
                  int8_matvec=gate_per_tick * n_frames + per_decode * dc.n)
    n_tok = sum(len(t) for t in engine.decoded)
    decode_ms_tok = sum(engine.decode_ms) / max(n_tok, 1)
    log("fast", f"session: frames={n_frames} turns={turns} tokens="
                f"{[len(t) for t in engine.decoded]} decode forwards={dc.n} launches={counts} "
                f"expected={expect} ({gate_per_tick} int8 a tick, {per_decode} a decode forward)")
    log("fast", f"median tick (silent frames after the first) = "
                f"{statistics.median(ticks[1:]):.3f} ms; ticks ms = {[round(t, 3) for t in ticks]}")
    log("fast", f"event-to-first-token ms = {[round(t, 3) for t in e2ft]}; decode ms/token = "
                f"{decode_ms_tok:.3f}")
    probs = torch.stack(engine.probs)
    if not (torch.isfinite(probs).all() and torch.isfinite(session.state.memory).all()):
        raise RuntimeError("the fast tier's gate probs or ring hold non-finite values")
    if turns != 2 or any(not 0 <= t < cfg.text.vocab_size for ts in engine.decoded for t in ts):
        raise RuntimeError(f"expected two turns of valid token ids: {engine.decoded}")
    if counts != expect or not dc.n:
        raise RuntimeError(f"launch counts {counts} differ from the path's {expect}")

    # the burst: a warm-up burst (its launches counted), then the timed one
    # and the same frames as single steps, each from a copy of the stream's state
    bframes = [torch.empty((1, 3, size, size), device=dev, dtype=torch.bfloat16).normal_(
        generator=g) for _ in range(BURST)]
    state = session.state
    torch.cuda.synchronize()
    reset_launches()
    t0 = sync()
    engine.perceive_burst(torch.cat(bframes), clone_state(state))
    first_ms = (sync() - t0) * 1e3
    burst_counts = read_launches()
    burst_expect = {n: 0 for n in counts}
    burst_expect.update(selective_scan=cfg.mamba.n_layers, int8_matvec=gate_per_tick)
    burst, steps, burst_ms = burst_and_steps(engine, state, bframes)
    errs = burst_errors(burst, steps, state.frame_idx)
    log("fast", f"perceive_burst of {BURST} frames: {burst_ms:.3f} ms ({BURST / burst_ms * 1e3:.1f} "
                f"frames/s; first call {first_ms:.3f} ms); launches {burst_counts}, expected "
                f"{burst_expect}")
    log("fast", f"burst vs {BURST} single steps, bf16 (a GEMM against GEMVs rounds otherwise): "
                f"max |diff| = {errs}")
    log("fast", f"peak device memory = {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if burst_counts != burst_expect:
        raise RuntimeError(f"burst launch counts {burst_counts} differ from {burst_expect}")
    if not all(math.isfinite(v) for v in errs.values()) or burst[1].frame_idx != state.frame_idx + BURST:
        raise RuntimeError("the burst gave non-finite values or a wrong frame count")
    del engine, session, frames, bframes, state, burst, steps
    torch.cuda.empty_cache()
    launches = dict(counts)
    launches["selective_scan"] = burst_counts["selective_scan"]
    return dict(tick_ms_median=statistics.median(ticks[1:]), event_to_first_token_ms=e2ft,
                decode_ms_per_token=decode_ms_tok, burst_ms=burst_ms, launches=launches,
                burst_launches=burst_counts)


def fast_parity(dev):
    """The fast tier at reduced depth in fp32 (TF32 off): the same seeded
    tree (decoder through the int8 transform) and frames through the plain
    versions on the CPU and the kernels on the card — a 4-frame session with
    two forced fires, then a burst of PARITY_BURST frames; on the card also
    the burst against single steps; then the card with TF32 on as the
    control.  The int8 gate and decoder run as on the path; the ViT keeps
    fp32 linears (fast_vision=True): the int8 ViT rounds its activations to
    int8, and where the CPU's and the card's fp32 sums differ in the last
    bit an activation lands one int8 step away, which moves the memory
    tokens by ~1e-3, as much as TF32 does (measured on an H100).  The int8
    ViT is held on its own (``int8_vit_parity``)."""
    from streammind_torch.models.meta import init_streammind_params
    from streammind_torch.utils.quantize import quantize_text_params

    cfg = parity_config()
    params = init_streammind_params(torch.Generator().manual_seed(7), cfg, device="cpu")
    int8_vit_parity(cfg, params["vision"], dev)
    params["text"] = quantize_text_params(params["text"], bits=8)
    rng = torch.Generator().manual_seed(8)
    size = cfg.vision.image_size
    frames = [torch.randn((1, 3, size, size), generator=rng) for _ in range(4 + PARITY_BURST)]
    Engine = make_engine_class()
    out = {}
    for run, where, tf32 in (("cpu", "cpu", False), ("card", dev, False),
                             ("card_tf32", dev, True)):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        t0 = time.perf_counter()
        eng = Engine(params, cfg, quantize_gate="int8", fast_vision=True, kv_capacity=1024,
                     device=where)
        fs = [f.to(where) for f in frames]
        reset_launches()
        session, _, _ = run_session(eng, fs[:4], (1, 3), max_new=8)
        n_probs = len(eng.probs)
        state = session.state
        burst_probs, bs = eng.perceive_burst(torch.cat(fs[4:]), clone_state(state))
        counts = read_launches()
        out[run] = dict(probs=torch.stack(eng.probs[:n_probs]),
                        memory=session.state.memory[0, :4].cpu(),
                        logits=torch.cat(eng.prefill_logits), tokens=eng.decoded,
                        burst_probs=burst_probs.float().cpu(),
                        burst_memory=bs.memory[0, 4:4 + PARITY_BURST].cpu(),
                        burst_ssm=bs.mamba.ssm.cpu())
        if where != "cpu":
            steps = clone_state(state)
            for f in fs[4:]:
                step_probs, steps = eng.perceive_step(f, steps)
            out[run]["vs_steps"] = {
                "burst_probs": float((step_probs.float().cpu() - out[run]["burst_probs"])
                                     .abs().max()),
                "burst_memory": float((steps.memory[0, 4:4 + PARITY_BURST].cpu()
                                       - out[run]["burst_memory"]).abs().max()),
                "burst_ssm": float((steps.mamba.ssm.cpu() - out[run]["burst_ssm"]).abs().max())}
            if not (counts["int8_matvec"] and counts["selective_scan"] == cfg.mamba.n_layers):
                raise RuntimeError(f"the card's run missed the fast tier's kernels: {counts}")
            fp32_only(counts, "fast-parity")
        log("fast-parity", f"{run}: {time.perf_counter() - t0:.1f} s, tokens {eng.decoded}, "
                           f"launches {counts}")
        del eng, session, state, bs, fs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tol = FAST_PARITY_TOL
    c = out["cpu"]
    errs, control = ({k: float((c[k] - out[run][k]).abs().max()) for k in tol}
                     for run in ("card", "card_tf32"))
    vs_steps = out["card"]["vs_steps"]
    log("fast-parity", f"depth vit3/gate2/text2 at published widths, fp32, TF32 off, int8 gate "
                       f"and decoder: max |cpu - card| = {errs}, limits {tol}; greedy tokens "
                       f"equal: {c['tokens'] == out['card']['tokens']}")
    log("fast-parity", f"card, burst of {PARITY_BURST} vs single steps: max |diff| = {vs_steps}, "
                       f"limits {tol}")
    log("fast-parity", f"control, TF32 on: max |cpu - card| = {control}; over the limits: "
                       f"{[k for k in tol if control[k] > tol[k]]}")
    if (any(errs[k] > tol[k] for k in tol) or c["tokens"] != out["card"]["tokens"]
            or any(vs_steps[k] > tol[k] for k in vs_steps)):
        raise RuntimeError("the fast tier on the CPU (plain versions) and the card disagree")
    if not any(control[k] > tol[k] for k in tol):
        raise RuntimeError("the fast-tier parity limits do not see TF32 matmuls on the card")
    return errs


# about ten times the errors measured on an H100 with TF32 off (probs 2.0e-6,
# memory 1.6e-6, logits 2.1e-5; burst probs 3.0e-7, burst memory 3.2e-6,
# burst state 1.1e-6; the card's burst against its single steps 1.2e-7,
# 3.0e-6 and 9.5e-7); the TF32-on control crossed all six
FAST_PARITY_TOL = {"probs": 2e-5, "memory": 2e-5, "logits": 2e-4, "burst_probs": 3e-6,
                   "burst_memory": 3e-5, "burst_ssm": 1e-5}
# the int8 linear on identical inputs: measured bitwise equal (an exact int8
# product and the same fp32 rescale); the tower's features: the activations'
# int8 rounding flips where the devices' fp32 sums differ, 2.2e-3 relative rms
# measured, limit about ten times that
INT8_VIT_TOL = {"linear_q": 1e-6, "features_rel_rms": 2e-2}


def int8_vit_parity(cfg, vision, dev):
    """The int8 ViT (fp32 tree, depth cut) on the CPU and the card, TF32
    off.  One int8 linear on identical inputs: the int8 product is exact on
    both, so the outputs agree to the fp32 rescale (limit relative to the
    largest output).  The tower on the same two frames: the activations'
    int8 rounding flips where the two devices' fp32 sums differ in the last
    bit, so the features are held by their relative rms difference."""
    from streammind_torch.models import vit
    from streammind_torch.utils.params import tree_map
    from streammind_torch.utils.quantize import quantize_vit_params

    qv = vit.fuse_vit_qkv(quantize_vit_params(vision))
    rng = torch.Generator().manual_seed(9)
    x = torch.randn((2, 577, cfg.vision.hidden_size), generator=rng)
    leaf = {k: t[0] for k, t in qv["layers"]["qkv"].items()}
    ref = vit._linear_q(x, leaf)
    got = vit._linear_q(x.to(dev), {k: t.to(dev) for k, t in leaf.items()}).cpu()
    lin_err = float((got - ref).abs().max() / ref.abs().max())
    size = cfg.vision.image_size
    px = torch.randn((2, 3, size, size), generator=rng)
    f_cpu = vit.vit_forward(qv, cfg.vision, px, attn_impl="bf16")
    f_card = vit.vit_forward(tree_map(lambda t: t.to(dev), qv), cfg.vision, px.to(dev), attn_impl="bf16").cpu()
    rel = float((f_card - f_cpu).norm() / f_cpu.norm())
    err = {"linear_q": lin_err, "features_rel_rms": rel,
           "features_max_abs": float((f_card - f_cpu).abs().max())}
    log("fast-parity", f"int8 ViT (3 layers, fp32, TF32 off), card vs cpu: {err}, limits "
                       f"{INT8_VIT_TOL}")
    if any(err[k] > INT8_VIT_TOL[k] for k in INT8_VIT_TOL):
        raise RuntimeError("the int8 ViT differs between the CPU and the card")


# ---------------------------------------------------------------------------
# phases 7-8: training
# ---------------------------------------------------------------------------
TRAIN_STEPS = 6
TRAIN_ANSWER = 128   # answer tokens a sample; with its EOS 129 supervised labels
TRAIN_LR = 5e-2      # large enough that 6 steps move every bf16 trainable leaf
SMOKE_DIR = Path(__file__).resolve().parent / "_smoke_train"


class MatchTimeShaped:
    """Synthetic MatchTime-shaped samples: pre-extracted (frames, 577, 1024)
    fp32 feature "videos" and prompts of ``lengths`` token ids — BOS, random
    ids with one <video> slot, then a TRAIN_ANSWER-token answer and EOS, the
    supervised span — captioned alternately with speech and silence."""

    def __init__(self, lengths, frames: int, seed: int, vocab: int = 32000, width: int = 1024):
        from streammind_torch.constants import IGNORE_INDEX, VIDEO_TOKEN_INDEX

        rng = np.random.default_rng(seed)
        self.samples = []
        for i, n_ids in enumerate(lengths):
            prompt = [1] + rng.integers(3, vocab, n_ids - TRAIN_ANSWER - 3).tolist()
            prompt.insert(32 + i, VIDEO_TOKEN_INDEX)
            answer = rng.integers(3, vocab, TRAIN_ANSWER).tolist() + [2]
            self.samples.append({
                "input_ids": np.asarray([prompt + answer], np.int64),
                "labels": np.asarray([[IGNORE_INDEX] * len(prompt) + answer], np.int64),
                "video": rng.standard_normal((frames, 577, width), dtype=np.float32),
                "caption_info": "</s>" if i % 2 else "a goal is scored",
            })

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i % len(self.samples)]


def train_args(stage: str, dev, max_steps: int, resume: bool):
    from streammind_torch.train.args import DataArguments, ModelArguments, TrainingArguments

    return (ModelArguments(tune_mm_mlp_adapter=stage == "adapter"),
            DataArguments(score_dataset_train_cls=stage == "cls", num_workers=2),
            TrainingArguments(output_dir=str(SMOKE_DIR), learning_rate=TRAIN_LR, bf16=True,
                              max_steps=max_steps, save_steps=max_steps, logging_steps=1,
                              per_device_train_batch_size=1, gradient_accumulation_steps=2,
                              gradient_checkpointing=True, seed=0, resume=resume, device=dev))


def metric_lines():
    with open(SMOKE_DIR / "logs" / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def training_phase(dev):
    """train() at StreamMind-7B's published widths: the adapter stage for
    TRAIN_STEPS steps, then 2 steps of the cls stage resumed from its
    adapter-only checkpoint."""
    from streammind_torch.config import StreamMindConfig
    from streammind_torch.models.meta import init_streammind_params
    from streammind_torch.train.run import train
    from streammind_torch.train.trainer import named_leaves, trainable_mask
    from streammind_torch.utils.checkpoint import latest_checkpoint, load_checkpoint

    cfg = StreamMindConfig()
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    ds = MatchTimeShaped([1900, 1920, 1940, 1980], frames=64, seed=0)
    log("train", f"data: {len(ds)} samples, features {ds.samples[0]['video'].shape}, prompts "
                 f"{[s['input_ids'].shape[1] for s in ds.samples]} ids, made in "
                 f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state = train(*train_args("adapter", dev, TRAIN_STEPS, resume=False), dataset=ds, cfg=cfg)
    torch.cuda.synchronize()
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated()
    recs = metric_lines()
    losses = [r["train/loss"] for r in recs]
    step_ms = [(b["ts"] - a["ts"]) * 1e3 for a, b in zip(recs, recs[1:])]
    micro = 2 * TRAIN_STEPS
    per_micro = {n: c / micro for n, c in counts.items()}
    expect = {n: 0 for n in counts}
    expect.update(flash_attention_lse=2 * cfg.text.num_layers, flash_bwd_dq=cfg.text.num_layers,
                  flash_bwd_dkv=cfg.text.num_layers)
    expect.update({f"{n}_tc": expect[n] for n in TRAIN_KERNELS})  # bf16: every launch
    tokens = 2 * (TRAIN_ANSWER + 1)
    log("train", f"adapter stage, 2048 bucket, remat, B 1 x accumulation 2: losses {losses}; "
                 f"grad norms {[r['train/grad_norm'] for r in recs]}")
    log("train", f"step ms (synchronized, after the first) = {[round(t, 3) for t in step_ms]}, "
                 f"median {statistics.median(step_ms):.3f}; supervised tokens/s = "
                 f"{tokens / statistics.median(step_ms) * 1e3:.3f} ({tokens} a step)")
    log("train", f"peak device memory = {peak / 1e9:.2f} GB; launches per microbatch = "
                 f"{per_micro}; expected {expect}")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"training losses not finite: {losses}")
    if per_micro != expect:
        raise RuntimeError(f"launch counts {counts} over {micro} microbatches differ from the "
                           f"path's {expect} each")

    # frozen leaves bitwise unchanged, every trainable leaf moved: against the
    # same seeded tree built afresh
    init = init_streammind_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev,
                                  dtype=torch.bfloat16)
    trainable = set(named_leaves(init, trainable_mask(init, "adapter")))
    after, before = named_leaves(state.params), named_leaves(init)
    frozen_same = [p for p in before if p not in trainable and torch.equal(after[p], before[p])]
    moved = [p for p in trainable if not torch.equal(after[p], before[p])]
    log("train", f"{len(frozen_same)} of {len(before) - len(trainable)} frozen leaves bitwise "
                 f"unchanged; {len(moved)} of {len(trainable)} trainable leaves moved")
    if len(frozen_same) != len(before) - len(trainable) or len(moved) != len(trainable):
        raise RuntimeError("a frozen leaf changed or a trainable leaf did not move: "
                           f"{sorted(set(before) - trainable - set(frozen_same))} "
                           f"{sorted(trainable - set(moved))}")
    del init, before
    ckpt = latest_checkpoint(str(SMOKE_DIR))
    loaded, _, meta = load_checkpoint(ckpt, dev)
    saved = named_leaves(loaded)
    same = all(torch.equal(t, after[p]) for p, t in saved.items())
    log("train", f"{Path(ckpt).name}: meta {meta}, {len(saved)} projector leaves read back "
                 f"bitwise: {same}")
    if not (meta["adapter_only"] and meta["step"] == TRAIN_STEPS and same
            and set(saved) == {p for p in after if p.startswith("projector.")}):
        raise RuntimeError("the adapter-only checkpoint does not read back")
    del state, after
    torch.cuda.empty_cache()

    # the gate stage on the same tree: resumed from the adapter checkpoint
    reset_launches()
    state = train(*train_args("cls", dev, TRAIN_STEPS + 2, resume=True), dataset=ds, cfg=cfg)
    torch.cuda.synchronize()
    cls_losses = [r["train/loss"] for r in metric_lines()[TRAIN_STEPS:]]
    after = named_leaves(state.params["projector"], prefix="projector.")
    gate = "projector.cls_net."
    unmoved = sorted(p[len(gate):] for p, t in saved.items()
                     if p.startswith(gate) and torch.equal(after[p], t))
    rest_same = all(torch.equal(after[p], t) for p, t in saved.items() if not p.startswith(gate))
    log("train", f"cls stage, 2 steps resumed at step {TRAIN_STEPS}: losses {cls_losses}; gate "
                 f"leaves unchanged: {unmoved}; the rest of the projector unchanged: "
                 f"{rest_same}; launches {read_launches()}")
    # the gate's loss sits on each pair's first position, which attends to
    # itself alone: its q and k projections and the label embeddings (second
    # position) get no gradient, and so no update
    if (len(cls_losses) != 2 or not all(math.isfinite(x) for x in cls_losses) or not rest_same
            or unmoved != ["embed_tokens", "layers.k.weight", "layers.q.weight"]
            or any(read_launches().values())):
        raise RuntimeError("the cls stage did not train the gate alone")
    del state, loaded, saved, after
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(step_ms_median=statistics.median(step_ms), losses=losses, peak_gb=peak / 1e9,
                launches=counts, launches_per_microbatch=per_micro)


def training_parity(dev):
    """The adapter stage's loss, gradients and two optimizer steps in fp32
    through the plain versions on the CPU and the kernels on the card (TF32
    off), then on the card with TF32 on as the control."""
    from streammind_torch.models.meta import init_streammind_params
    from streammind_torch.train.objectives import stage1_llm_loss
    from streammind_torch.train.run import make_microbatch
    from streammind_torch.train.trainer import (
        cosine_schedule, global_norm, init_train_state, make_grad_step, make_optimizer,
        make_train_step, named_leaves, trainable_mask)
    from streammind_torch.utils.params import tree_map

    cfg = parity_config()
    params = init_streammind_params(torch.Generator().manual_seed(5), cfg, device="cpu")
    sample = MatchTimeShaped([440], frames=16, seed=6).samples[0]   # splices into 512

    def loss_fn(p, b):
        return stage1_llm_loss(p, cfg, b["frames"], b["token_ids"], b["mem_index"], b["use_mem"],
                               b["attn_mask"], b["labels"], remat=True, attn_impl="flash!")

    out = {}
    for run, where, tf32 in (("cpu", "cpu", False), ("card", dev, False),
                             ("card_tf32", dev, True)):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        t0 = time.perf_counter()
        p = tree_map(lambda t: t.to(where, copy=True), params)
        mask = trainable_mask(p, "adapter")
        opt = make_optimizer(cosine_schedule(1e-4, 2))
        state = init_train_state(p, opt, mask)
        _, batch = make_microbatch([sample], cfg, p["vision"], "adapter", pad_to=1)
        reset_launches()
        loss, grads = make_grad_step(loss_fn, mask)(p, batch)
        step = make_train_step(loss_fn, opt, mask)
        for _ in range(2):
            state, _ = step(state, batch)
        counts = read_launches()
        out[run] = dict(loss=float(loss), gnorm=float(global_norm(grads.values())),
                        grads={k: g.cpu() for k, g in grads.items()},
                        params={k: t.detach().cpu() for k, t in named_leaves(p, mask).items()})
        log("train-parity", f"{run}: loss {out[run]['loss']:.7f}, grad norm "
                            f"{out[run]['gnorm']:.7f}, {time.perf_counter() - t0:.1f} s, "
                            f"launches {counts}")
        if where != "cpu" and not all(counts[n] == 3 * 2 * cfg.text.num_layers
                                      if n == "flash_attention_lse" else
                                      counts[n] == 3 * cfg.text.num_layers
                                      for n in TRAIN_KERNELS):
            raise RuntimeError(f"the card's run missed the training kernels: {counts}")
        if where != "cpu":
            fp32_only(counts, "train-parity")
        del p, state, grads, batch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def errs(o):
        # params: Adam steps each element by about lr * sign(grad) whatever
        # its size, so an element whose gradient is at the level of the fp32
        # noise may step either way; the limit holds the elements whose
        # gradient is at least 1e-3 of its leaf's largest, and the max over
        # all elements is printed beside it
        c = out["cpu"]
        firm = {k: g.abs() >= 1e-3 * g.abs().max() for k, g in c["grads"].items()}
        return {"loss": abs(o["loss"] - c["loss"]),
                "grad_norm": abs(o["gnorm"] - c["gnorm"]) / c["gnorm"],
                "grads": max(float((o["grads"][k] - g).abs().max() / g.abs().max().clamp(min=1e-30))
                             for k, g in c["grads"].items()),
                "params": max(float((o["params"][k] - t)[firm[k]].abs().max())
                              for k, t in c["params"].items()),
                "params_all": max(float((o["params"][k] - t).abs().max())
                                  for k, t in c["params"].items())}

    # about ten times the errors measured on an H100 with TF32 off (loss
    # 1.9e-6, grad norm 1.08e-7, grads 8.05e-6, params 2.38e-7)
    tol = {"loss": 2e-5, "grad_norm": 1e-6, "grads": 8e-5, "params": 2.4e-6}
    got, control = errs(out["card"]), errs(out["card_tf32"])
    log("train-parity", f"text 2 / gate 2 layers at published widths, fp32, TF32 off: "
                        f"|cpu - card| = {got} (loss abs, grad norm rel, worst leaf's grad max "
                        f"err / its max |grad|, params after 2 steps (lr 1e-4) abs where "
                        f"|grad| >= 1e-3 of the leaf's max, and over all), limits {tol}")
    log("train-parity", f"control, TF32 on: {control}; over the limits: "
                        f"{[k for k in tol if control[k] > tol[k]]}")
    if any(got[k] > tol[k] for k in tol):
        raise RuntimeError("training on the CPU (plain versions) and the card (kernels) disagree")
    if not any(control[k] > tol[k] for k in tol):
        raise RuntimeError("the training parity limits do not see TF32 matmuls on the card")
    return got


# ---------------------------------------------------------------------------
# phases 11-13: the public API, the released checkpoint layout, the HTTP worker
# ---------------------------------------------------------------------------
API_FRAMES = 16       # frames of the clip api.infer and the worker answer about
API_NEW = 32          # new tokens of a greedy answer
API_BEAMS = 5         # beams (the Ego4D-LTA eval's num_beams)
API_BEAM_NEW = 16     # new tokens of a beam
CKPT_TEXT_LAYERS = 2  # the checkpoint case's one cut: the decoder's depth
CKPT_BEAM_NEW = 8
CKPT_DIR = Path(__file__).resolve().parent / "_smoke_ckpt"
MANIFEST = (Path(__file__).resolve().parent / "tests" / "data"
            / "checkpoint_manifest_full_sft_7b.json")
QUESTION = "What is happening?"
CARD = "no card"  # nvidia-smi's "name, power limit", set by main()


def bitwise_differences(got, want) -> list:
    """Paths whose leaves differ in dtype, shape or any bit, or are missing."""
    from streammind_torch.utils.params import flatten_with_paths

    got, want = dict(flatten_with_paths(got)), dict(flatten_with_paths(want))
    bad = sorted(set(got) ^ set(want))
    for k in sorted(set(got) & set(want)):
        a, b = got[k], want[k]
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b.to(a.device)):
            bad.append(k)
    return bad


def full_sft_state_dict(tree, cfg) -> dict:
    """A StreamMind param tree under the released full-SFT key names (HF
    Mistral, the mm_projector, HF CLIP under the vision tower), as CPU
    copies; CLIP's post_layernorm, which the model does not read, as
    ones and zeros."""
    from streammind_torch.utils.checkpoint import export_projector_torch_sd

    sd = {}
    t = tree["text"]
    sd["model.embed_tokens.weight"] = t["embed_tokens"]
    sd["model.norm.weight"] = t["final_norm"]["weight"]
    sd["lm_head.weight"] = t["lm_head"]["weight"]
    names = {"input_norm": "input_layernorm", "post_norm": "post_attention_layernorm",
             "q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
             "o": "self_attn.o_proj"}
    for i in range(cfg.text.num_layers):
        for ours, theirs in names.items():
            sd[f"model.layers.{i}.{theirs}.weight"] = t["layers"][ours]["weight"][i]
        for p in ("gate", "up", "down"):
            sd[f"model.layers.{i}.mlp.{p}_proj.weight"] = t["layers"]["mlp"][p]["weight"][i]
    for k, x in export_projector_torch_sd(tree["projector"]).items():
        sd["model.mm_projector." + k] = x
    v, c = tree["vision"], cfg.vision
    pre = "model.vision_tower.vision_tower.vision_model."
    sd[pre + "embeddings.class_embedding"] = v["class_embedding"]
    sd[pre + "embeddings.patch_embedding.weight"] = v["patch_embedding"].reshape(
        c.hidden_size, 3, c.patch_size, c.patch_size)
    sd[pre + "embeddings.position_embedding.weight"] = v["position_embedding"]
    for p in ("weight", "bias"):
        sd[pre + f"pre_layrnorm.{p}"] = v["pre_layernorm"][p]
        sd[pre + f"post_layernorm.{p}"] = (torch.ones_like if p == "weight" else
                                           torch.zeros_like)(v["pre_layernorm"][p])
    clip = {"ln1": "layer_norm1", "q": "self_attn.q_proj", "k": "self_attn.k_proj",
            "v": "self_attn.v_proj", "o": "self_attn.out_proj", "ln2": "layer_norm2",
            "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    for i in range(c.num_layers):
        for ours, theirs in clip.items():
            for p in ("weight", "bias"):
                sd[pre + f"encoder.layers.{i}.{theirs}.{p}"] = v["layers"][ours][p][i]
    return {k: x.detach().to("cpu", copy=True).contiguous() for k, x in sd.items()}


def check_against_manifest(sd: dict, text_layers: int):
    """The key names and shapes of ``sd`` must be the released full-SFT
    manifest's, the decoder's layers cut to ``text_layers``."""
    import re

    with open(MANIFEST) as f:
        manifest = json.load(f)
    want = {k: s for k, s in manifest.items()
            if not (m := re.match(r"model\.layers\.(\d+)\.", k)) or int(m.group(1)) < text_layers}
    got = {k: list(x.shape) for k, x in sd.items()}
    if got != want:
        diff = sorted(set(got) ^ set(want)) or [k for k in want if got[k] != want[k]]
        raise RuntimeError(f"the written checkpoint differs from the released manifest: "
                           f"{diff[:8]}")
    return len(want), len(manifest)


def check_counts(what: str, counts: dict, expect: dict) -> None:
    if counts != expect:
        raise RuntimeError(f"{what}: launch counts {counts} differ from the path's {expect}")


def timed(fn):
    """(fn(), synchronized ms, the decoder's one-token forwards it ran)."""
    with DecodeCounter() as dc:
        t0 = sync()
        out = fn()
        ms = (sync() - t0) * 1e3
    return out, ms, dc.n


def copy_cache(cache):
    from streammind_torch.models.mistral import KVCache

    return KVCache(k=cache.k.clone(), v=cache.v.clone(), length=cache.length.clone())


def answer_checks(api, model, tok, video, max_new: int, n_beams: int, beam_new: int):
    """One model through the API: greedy ``infer``; the same plan prefilled
    once and decoded by ``generate_from_prefill`` with the template's stop
    ids (must give infer's text), without them (timed) and by
    ``decode_stream`` (must give the same tokens); ``beam_generate`` with
    n_beams beams (timed) and with one (must be greedy); ``infer_beams``
    (must give the beams' texts).  Returns its numbers."""
    from streammind_torch.mm_utils import trim_at_stop_strings
    from streammind_torch.streaming.engine import decode_tokens_to_text, stop_id_matrix

    eng, version = model.engine, "llama_2"
    stops = api._stop_strings(version)
    text, infer_ms, _ = timed(lambda: api.infer(model, video, QUESTION, tok,
                                                max_new_tokens=max_new))
    plan, mem_buf = api._prepare_cognition_inputs(model, video, QUESTION, tok, version)
    cap = eng.cache_capacity_for(len(plan.token_ids), max_new)
    (last, cache), prefill_ms, _ = timed(lambda: eng.prefill(plan, mem_buf,
                                                             eng.new_kv_cache(capacity=cap)))
    stopped, _ = eng.generate_from_prefill(last, copy_cache(cache), max_new,
                                           stop_ids=stop_id_matrix(tok, stops))
    (greedy, _), decode_ms, decode_fw = timed(lambda: eng.generate_from_prefill(
        last, copy_cache(cache), max_new))
    streamed = list(eng.decode_stream(last, cache, max_new))
    beams, beam_ms, beam_steps = timed(lambda: eng.beam_generate(
        plan, mem_buf, num_beams=n_beams, max_new_tokens=beam_new))
    one = eng.beam_generate(plan, mem_buf, num_beams=1, max_new_tokens=beam_new)
    texts = api.infer_beams(model, video, QUESTION, tok, num_beams=n_beams,
                            num_return_sequences=n_beams, max_new_tokens=beam_new)
    want_text = trim_at_stop_strings(decode_tokens_to_text(tok, stopped).strip(), stops)
    scores = [s for _, s in beams]
    beam_texts = [trim_at_stop_strings(decode_tokens_to_text(tok, b).strip(), stops)
                  for b, _ in beams]
    problems = []
    if text != want_text:
        problems.append(f"infer gave {text!r}, its plan's greedy decode {want_text!r}")
    if streamed != greedy or not greedy:
        problems.append(f"decode_stream {streamed} differs from generate_from_prefill {greedy}")
    if len(beams) != n_beams or scores != sorted(scores, reverse=True) or not all(
            math.isfinite(s) for s in scores):
        problems.append(f"expected {n_beams} beams, best first, finite scores: {scores}")
    # one beam is greedy; where greedy ends early at EOS, beam search keeps
    # a longer hypothesis beside it, which starts with greedy's tokens
    head = greedy[:beam_new]
    if len(one) != 1 or one[0][0][:len(head)] != head or (
            len(head) == beam_new and one[0][0] != head):
        problems.append(f"one beam {one} is not greedy {head}")
    if texts != beam_texts:
        problems.append(f"infer_beams {texts} differs from the beams' texts {beam_texts}")
    if any(not 0 <= t < model.cfg.text.vocab_size for t in greedy):
        problems.append(f"token ids out of the vocabulary: {greedy}")
    if problems:
        raise RuntimeError("; ".join(problems))
    return dict(infer_ms=infer_ms, prefill_ms=prefill_ms, decode_ms_per_token=decode_ms / max(
        decode_fw, 1), decode_forwards=decode_fw, tokens=len(greedy), beam_ms=beam_ms,
        beam_steps=beam_steps, beam_ms_per_step=(beam_ms - prefill_ms) / max(beam_steps, 1),
        scores=scores)


def write_checkpoint(tree, cfg, path: Path) -> float:
    """The tree as a released full-SFT checkpoint directory: one
    pytorch_model.bin and the streammind_config.json.  Returns GB written."""
    sd = full_sft_state_dict(tree, cfg)
    n_keys, n_released = check_against_manifest(sd, cfg.text.num_layers)
    path.mkdir(parents=True, exist_ok=True)
    torch.save(sd, path / "pytorch_model.bin")
    (path / "streammind_config.json").write_text(cfg.to_json())
    gb = sum(x.numel() * x.element_size() for x in sd.values()) / 1e9
    log("api", f"checkpoint: {n_keys} keys ({n_released} in the released manifest, the "
               f"decoder cut to {cfg.text.num_layers} of its layers), names and shapes as the "
               f"manifest's, {gb:.2f} GB bf16 written to {path.name}/pytorch_model.bin")
    return gb


def api_phase(engine, g, dev):
    """The public API at StreamMind-7B's widths on the session's tree (bf16,
    the int4 gate; the engine's ViT attention "exact" for the worker): the
    answer checks on API_FRAMES frames (greedy, API_NEW tokens; API_BEAMS
    beams of API_BEAM_NEW tokens); then the released checkpoint layout: a
    synthetic full-SFT .bin at full widths with the decoder cut to
    CKPT_TEXT_LAYERS layers, loaded by ``model_init(path,
    load_4bit="pc")`` (every leaf bitwise the written bf16 through the
    load's transforms), and the answer checks on it, whose decode and beams
    run through the int4 kernel.  Returns (the model, the tokenizer, the
    numbers)."""
    from streammind_torch import api
    from streammind_torch.config import StreamMindConfig
    from streammind_torch.models.meta import init_streammind_params
    from streammind_torch.models.mistral import fuse_text_linears
    from streammind_torch.models.vit import fuse_vit_qkv
    from streammind_torch.utils.params import flatten_with_paths, param_count
    from streammind_torch.utils.quantize import quantize_text_params

    base = StreamMindConfig()
    tok = StandInTokenizer()
    model, _, _, version = api.model_init(params=engine.params, cfg=base, tokenizer=tok,
                                          vit_attn="exact", device=dev)
    size = base.vision.image_size
    video = torch.empty((API_FRAMES, 3, size, size), device=dev, dtype=torch.bfloat16).normal_(
        generator=g)
    cfg2 = base.replace(text=dataclasses.replace(base.text, num_layers=CKPT_TEXT_LAYERS))
    tree = init_streammind_params(torch.Generator(device=dev).manual_seed(21), cfg2, device=dev,
                                  dtype=torch.bfloat16)
    path = CKPT_DIR / "StreamMind-7B-text2"
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    torch.cuda.synchronize()
    reset_launches()
    try:
        full = answer_checks(api, model, tok, video, API_NEW, API_BEAMS, API_BEAM_NEW)
        _, write_ms, _ = timed(lambda: write_checkpoint(tree, cfg2, path))
        (m2, _, _, v2), load_ms, _ = timed(lambda: api.model_init(
            str(path), tokenizer=tok, load_4bit="pc", device=dev))
        want = {"vision": fuse_vit_qkv(tree["vision"]), "projector": tree["projector"],
                "text": fuse_text_linears(quantize_text_params(tree["text"], bits=4,
                                                               scheme="pc"))}
        bad = bitwise_differences(m2.params, want)
        n_leaves, n_params = len(list(flatten_with_paths(want))), param_count(tree)
        del want, tree
        if bad or v2 != version or m2.cfg != cfg2:
            raise RuntimeError(f"the loaded checkpoint differs from the written one: {bad[:8]}, "
                               f"version {v2}, config equal {m2.cfg == cfg2}")
        log("api", f"checkpoint loaded by model_init(path, load_4bit='pc') in {load_ms:.1f} ms "
                   f"(written in {write_ms:.1f} ms, {n_params} parameters): {n_leaves} leaves "
                   f"bitwise the written bf16 (the ViT's q/k/v fused, the decoder's linears "
                   f"per-channel int4 and fused)")
        with DecodeCounter() as dc:
            ckpt = answer_checks(api, m2, tok, video, API_NEW, API_BEAMS, CKPT_BEAM_NEW)
        ckpt_forwards = dc.n
        counts = read_launches()
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    del m2
    torch.cuda.empty_cache()
    # prefills: infer, the timed plan, the beams, one beam, infer_beams (5 a
    # model); clip projections (one scan launch a Mamba layer): infer, the
    # plan, infer_beams (3 a model); int4: the fused qkv, o, gateup and down
    # of every one-token forward of the int4 decoder (beam steps included)
    L, L2, n_mamba = base.text.num_layers, CKPT_TEXT_LAYERS, base.mamba.n_layers
    expect = {n: 0 for n in counts}
    expect.update(flash_attention=5 * (L + L2), flash_attention_tc=5 * (L + L2),
                  selective_scan=6 * n_mamba, int4_matvec=4 * L2 * ckpt_forwards)
    log("api", f"launches={counts} expected={expect} ({ckpt_forwards} one-token forwards of "
               f"the int4 decoder)")
    check_counts("api", counts, expect)
    for name, r in (("bf16", full), ("load_4bit='pc', text 2 layers", ckpt)):
        log("api", f"[{CARD}] {name}: infer wall ({API_FRAMES} frames, prefill, {API_NEW} tokens) = "
                   f"{r['infer_ms']:.3f} ms; prefill = {r['prefill_ms']:.3f} ms; decode = "
                   f"{r['decode_ms_per_token']:.3f} ms/token over {r['decode_forwards']} "
                   f"forwards ({r['tokens']} tokens); beams: {API_BEAMS} x "
                   f"{API_BEAM_NEW if r is full else CKPT_BEAM_NEW} tokens in "
                   f"{r['beam_ms']:.3f} ms, {r['beam_ms_per_step']:.3f} ms a step over "
                   f"{r['beam_steps']} steps; scores {[round(s, 4) for s in r['scores']]}")
    return model, tok, dict(full=full, ckpt=ckpt, launches=counts)


def worker_phase(model, tok, g, dev):
    """The HTTP serving plane on the card: an in-process Controller and a
    ModelWorker(multistream_capacity=4) over the api phase's model (exact
    ViT attention, the int4 gate), both on 127.0.0.1.  One
    /worker_generate_stream through the controller with a video_b64 npz of
    API_FRAMES frames, whose streamed text must equal decode_stream's
    in-process; then two HTTP stream sessions of 6 frames each through the
    broker (paged KV), one forced fire."""
    import base64
    import io
    import socket
    import threading
    import urllib.request

    from streammind_torch import api
    from streammind_torch.constants import VIDEO_TOKEN_INDEX
    from streammind_torch.mm_utils import tokenizer_multimodal_token
    from streammind_torch.serve import controller as ctl
    from streammind_torch.serve.model_worker import ModelWorker, serve_worker

    def free_port():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    def npz_b64(arr):
        buf = io.BytesIO()
        np.savez(buf, pixels=arr)
        return base64.b64encode(buf.getvalue()).decode()

    def post(url, payload, stream=False):
        """POST a dict, or a body already encoded (so a timed request does
        not count the client's encoding)."""
        data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
        req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            if not stream:
                return json.loads(resp.read())
            chunks, buf, arrivals = [], b"", []
            while True:
                b = resp.read1(65536)
                if not b:
                    return chunks, arrivals
                buf += b
                while b"\0" in buf:
                    part, buf = buf.split(b"\0", 1)
                    chunks.append(json.loads(part.decode()))
                    arrivals.append(time.perf_counter())

    cfg = model.cfg
    size = cfg.vision.image_size
    prompt = "[INST] <video>\nWhat is happening? [/INST]"
    video = torch.empty((API_FRAMES, 3, size, size), device=dev).normal_(generator=g).cpu().numpy()
    # the reference: the same prompt and frames through decode_stream in-process
    pixels = api._pixels(model, video)
    ids = tokenizer_multimodal_token(prompt, tok, VIDEO_TOKEN_INDEX)
    eng = model.engine
    with torch.no_grad():
        plan, mem_buf = api.splice_inputs(model, ids, api.encode_memory(model, pixels))
        last, cache = eng.prefill(plan, mem_buf, eng.new_kv_cache(
            capacity=eng.cache_capacity_for(len(plan.token_ids), API_NEW)))
    ref_tokens = list(eng.decode_stream(last, cache, API_NEW))
    ref_text = tok.decode(ref_tokens)
    del last, cache, mem_buf, pixels
    frames = [torch.empty((1, 3, size, size), device=dev).normal_(generator=g).cpu().numpy()
              for _ in range(12)]

    cport, wport = free_port(), free_port()
    ctrl = ctl.serve("127.0.0.1", cport)
    threading.Thread(target=ctrl.serve_forever, daemon=True).start()
    worker = wserver = None
    torch.cuda.synchronize()
    reset_launches()
    try:
        worker = ModelWorker(f"http://127.0.0.1:{cport}", f"http://127.0.0.1:{wport}",
                             model_path="", model_name="StreamMind-7B", model=model,
                             tokenizer=tok, no_register=False, multistream_capacity=4,
                             vit_attn="exact", device=dev)
        wserver = serve_worker(worker, "127.0.0.1", wport)
        threading.Thread(target=wserver.serve_forever, daemon=True).start()
        listed = post(f"http://127.0.0.1:{cport}/list_models", {})["models"]
        body = json.dumps({"model": "StreamMind-7B", "prompt": prompt,
                           "video_b64": npz_b64(video), "max_new_tokens": API_NEW,
                           "temperature": 0.0}).encode()
        t0 = time.perf_counter()
        chunks, arrivals = post(f"http://127.0.0.1:{cport}/worker_generate_stream", body,
                                stream=True)
        first_chunk_ms = (arrivals[0] - t0) * 1e3 if arrivals else float("nan")
        chunk_ms = ((arrivals[-1] - arrivals[0]) * 1e3 / (len(arrivals) - 1)
                    if len(arrivals) > 1 else float("nan"))
        url = f"http://127.0.0.1:{wport}"
        sids = [post(url + "/stream_session/start", {
            "prompt": prompt, "gate_threshold": 2.0, "max_new_tokens": 16,
            "session_id": f"live{i}"})["session_id"] for i in range(2)]
        outs = {sid: [] for sid in sids}
        session_ms = []
        for t in range(6):
            for j, sid in enumerate(sids):
                fire = sid == sids[0] and t == 3
                for slot in worker.broker.server.slots:
                    if slot is not None and slot.stream_id == sid:
                        slot.gate_threshold = -1.0 if fire else 2.0
                payload = json.dumps({"session_id": sid,
                                      "pixels_b64": npz_b64(frames[2 * t + j])}).encode()
                out, ms, _ = timed(lambda: post(url + "/stream_session/frame", payload))
                outs[sid].append(out)
                session_ms.append(ms)
        stopped = [post(url + "/stream_session/stop", {"session_id": sid}) for sid in sids]
        counts = read_launches()
        broker_ticks = worker.broker.ticks
    finally:
        ctrl.shutdown()
        ctrl.server_close()
        if wserver is not None:
            wserver.shutdown()
            wserver.server_close()
        if worker is not None:
            worker.shutdown()
    text = chunks[-1]["text"] if chunks else None
    fires = {sid: [o.get("fire") for o in outs[sid]] for sid in sids}
    log("worker", f"controller lists {listed}; /worker_generate_stream through the controller: "
                  f"{len(chunks)} chunks, frames {chunks[-1].get('frames') if chunks else None}, "
                  f"text equal to decode_stream in-process: {text == ref_text}")
    log("worker", f"[{CARD}] time to first streamed chunk = {first_chunk_ms:.3f} ms (from the "
                  f"request, its body encoded beforehand: {API_FRAMES} frames as a base64 npz "
                  f"sent and decoded, the ViT, the projector, the prefill); then "
                  f"{chunk_ms:.3f} ms a token (chunk arrivals at the client)")
    log("worker", f"sessions (broker, paged, capacity 4): fires {fires}; {broker_ticks} ticks; "
                  f"frame round trip median {statistics.median(session_ms):.3f} ms; "
                  f"stopped {[s['error_code'] for s in stopped]}")
    problems = []
    if listed != ["StreamMind-7B"]:
        problems.append(f"the controller lists {listed}")
    if text != ref_text or any(c.get("error_code") != 0 for c in chunks):
        problems.append(f"streamed {text!r} (error codes {[c.get('error_code') for c in chunks]})"
                        f", in-process {ref_text!r}")
    want_fires = {sids[0]: [t == 3 for t in range(6)], sids[1]: [False] * 6}
    if fires != want_fires or any(o.get("error_code") != 0 for os_ in outs.values() for o in os_):
        problems.append(f"session fires {fires}, expected {want_fires}: {outs}")
    if not isinstance(outs[sids[0]][3].get("text"), str):
        problems.append(f"the forced fire spoke no text: {outs[sids[0]][3]}")
    for name in ("flash_attention", "selective_scan", "exact_attention", "int4_matvec",
                 "paged_attention", "paged_write"):
        if not counts[name]:
            problems.append(f"the worker path launched no {name}")
    if any(counts[n] for n in TRAIN_KERNELS + ("int8_matvec",)):
        problems.append(f"the worker path launched a training or int8 kernel: {counts}")
    log("worker", f"launches={counts}")
    if problems:
        raise RuntimeError("worker: " + "; ".join(problems))
    return dict(first_chunk_ms=first_chunk_ms, ms_per_token=chunk_ms, launches=counts,
                session_ms_median=statistics.median(session_ms))


# about ten times the errors measured on an H100 80GB HBM3 at 700 W with TF32
# off (memory 1.43e-6, first-token logits 2.07e-5, beam scores 6.4e-7); the
# TF32-on control crossed all three (1.3e-3, 8.0e-3, 8.9e-4)
API_PARITY_TOL = {"memory": 2e-5, "logits": 2e-4, "beam_scores": 6e-6}


def api_parity(dev):
    """infer and beam_generate in fp32 at the parity config (depth cut only,
    TF32 off): the same seeded tree and frames through model_init on the CPU
    (plain versions) and the card (kernels): the clip's memory tokens, the
    first token's logits, the greedy tokens and text, the beam lists and
    scores; then the card with TF32 on, which must break a limit."""
    from streammind_torch import api

    cfg = parity_config()
    from streammind_torch.models.meta import init_streammind_params

    params = init_streammind_params(torch.Generator().manual_seed(11), cfg, device="cpu")
    video = torch.randn((4, 3, cfg.vision.image_size, cfg.vision.image_size),
                        generator=torch.Generator().manual_seed(12))
    tok = StandInTokenizer()
    out = {}
    for run, where, tf32 in (("cpu", "cpu", False), ("card", dev, False),
                             ("card_tf32", dev, True)):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        t0 = time.perf_counter()
        model, _, _, _ = api.model_init(params=params, cfg=cfg, tokenizer=tok,
                                        dtype=torch.float32, device=where)
        eng = model.engine
        reset_launches()
        text = api.infer(model, video, QUESTION, tok, max_new_tokens=8)
        plan, mem_buf = api._prepare_cognition_inputs(model, video, QUESTION, tok, "llama_2")
        last, cache = eng.prefill(plan, mem_buf, eng.new_kv_cache(capacity=256))
        tokens, _ = eng.generate_from_prefill(last, cache, 8)
        beams = eng.beam_generate(plan, mem_buf, num_beams=3, max_new_tokens=6)
        counts = read_launches()
        out[run] = dict(memory=mem_buf[0, :video.shape[0]].cpu(), logits=last.cpu(),
                        beam_scores=torch.tensor([s for _, s in beams], dtype=torch.float64),
                        tokens=tokens, text=text, beams=[b for b, _ in beams])
        log("api-parity", f"{run}: {time.perf_counter() - t0:.1f} s, tokens {tokens}, beams "
                          f"{out[run]['beams']}, launches {counts}")
        if where != "cpu":
            fp32_only(counts, "api-parity")
            if not (counts["flash_attention"] and counts["selective_scan"]):
                raise RuntimeError(f"the card's run missed the flash or scan kernel: {counts}")
        del model, eng, cache
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tol = API_PARITY_TOL
    c = out["cpu"]
    errs, control = ({k: float((c[k] - out[run][k]).abs().max()) for k in tol}
                     for run in ("card", "card_tf32"))
    same = {k: c[k] == out["card"][k] for k in ("tokens", "text", "beams")}
    log("api-parity", f"depth vit3/gate2/text2 at published widths, fp32, TF32 off: max |cpu - "
                      f"card| = {errs}, limits {tol}; identical: {same}")
    log("api-parity", f"control, TF32 on: max |cpu - card| = {control}; over the limits: "
                      f"{[k for k in tol if control[k] > tol[k]]}")
    if any(errs[k] > tol[k] for k in tol) or not all(same.values()):
        raise RuntimeError("infer / beam_generate on the CPU and the card disagree")
    if not any(control[k] > tol[k] for k in tol):
        raise RuntimeError("the api parity limits do not see TF32 matmuls on the card")
    return errs


def main() -> int:
    here = Path(__file__).resolve().parent
    if not (here / "streammind_torch" / "__init__.py").exists():
        print("chip_smoke: streammind_torch/ not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(here))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card only", file=sys.stderr)
        return 2
    dev = "cuda"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    print(CARD, flush=True)
    log("env", f"python {sys.version.split()[0]} torch {torch.__version__} "
               f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    from streammind_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    log("build", f"{sorted(logs)} built in {time.perf_counter() - t0:.1f} s (nvcc, one process "
                 f"each, in parallel); already built: {sorted(set(_build.KERNELS) - set(logs))}")
    for name, info in logs.items():
        ptx = [l.strip() for l in info["log"].splitlines() if "Used" in l or "spill" in l]
        log("build", f"{name}: {info['seconds']:.1f} s; " + " | ".join(ptx))
    hgmma = {name: hgmma_count(name) for name in TC_LIBRARIES}
    for name, n in hgmma.items():
        log("build", f"{name}: {n} HGMMA instructions in its SASS (cuobjdump --dump-sass)")
    if not all(hgmma.values()):
        raise RuntimeError(f"a tensor-core kernel holds no HGMMA instruction: {hgmma}")

    kernels = check_kernels(dev)
    engine, g = build_engine(dev)
    session = full_width_session(engine, g, dev)
    serving = serving_phase(engine, g, dev)
    model, tok, api_run = api_phase(engine, g, dev)
    worker = worker_phase(model, tok, g, dev)
    del engine, model
    torch.cuda.empty_cache()
    kernels["paged_attention"][0].append(check_paged_serving_case(dev, serving["attn_lengths"][3]))
    fast = fast_phase(dev)
    fast_parity(dev)
    parity(dev)
    api_parity(dev)
    training = training_phase(dev)
    training_parity(dev)

    entries = []
    for name, (cases, tol) in kernels.items():
        src, replaces = KERNEL_META[name]
        head = cases[0]
        main_path = (training if name in TRAIN_KERNELS else fast if name in FAST_KERNELS
                     else serving)
        entries.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=main_path["launches"][name],
            launches_by_path={"session": session["launches"][name],
                              "serving": serving["launches"][name],
                              "fast": fast["launches"][name],
                              "train": training["launches"][name],
                              "api": api_run["launches"][name],
                              "worker": worker["launches"][name]},
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=head["ms"], kernel_ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"], tolerance=tol,
            cases=cases))
        if name in GRAPH_TIMED:
            entries[-1].update(ms_over_bound=head["ms_over_bound"],
                               timing="CUDA graph replay (device time); eager_ms in cases")
        if name in TC_KERNELS:
            entries[-1].update(
                tc_launches=main_path["launches"][f"{name}_tc"],
                tc_launches_by_path={p: r["launches"][f"{name}_tc"] for p, r in (
                    ("session", session), ("serving", serving), ("fast", fast),
                    ("train", training), ("api", api_run), ("worker", worker))},
                hgmma=hgmma[src.split("/")[-1][:-3]], ms_over_bound=head["ms_over_bound"],
                timing="CUDA graph replay (device time); eager_ms in cases")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
