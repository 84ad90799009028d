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
     writes the sink page; the grouped int4 GEMM pair of a MoE prefill
     (gate + up, then down) at Mixtral's and Jamba's expert widths over R =
     2 T routed rows, two calls bitwise equal, beside its bound, its plain
     version and the dense dispatch it replaces;
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
 11b. (after phase 11, on its checkpoint directory) the released-checkpoint
     smoke tool: the checkpoint loaded in fp32 on the card by the tool's
     loader; with TF32 off, config 1 (one frame's ViT features, a caption of
     32 tokens) and config 2 (prefill logits of 16 ids, an 8-frame
     open-ended QA) through the tool's port-side functions; features and
     logits held against the same functions on the CPU within the tool's
     2e-4 relative rms; exact launch counts (one fp32 flash a decoder layer
     a prefill, one scan a Mamba layer a clip); flash at each prefill's
     fp32 bucket and the scan at the 1- and 8-frame clips against their
     plain versions; the tool's CLI, which must exit non-zero naming
     ``transformers`` where it is not installed and print OK where it is;
 12. the HTTP plane: a Controller and a ModelWorker (multistream_capacity
     4) on 127.0.0.1, one streamed generation through the controller equal
     to decode_stream in-process, two HTTP sessions of 6 frames through
     the paged broker with one forced fire;
 13. ``infer`` and ``beam_generate`` in fp32 at reduced depth on the CPU and
     the card, TF32 off (identical tokens, text and beams; memory, logits
     and beam scores within limits), and a TF32-on control;
 14. (after phase 12, on the api phase's model) the offline data and eval
     path: the native ingest built from native/ingest.cpp (or
     ``ingest: unavailable (...)`` where libav is missing, and seeded frames
     in its place), a test clip read at 336 (frames/s);
     ``extract_video_features`` through run_extract's encode function (ViT
     bf16, batches of 64) over a 72-frame half-video, read back into
     ``MatchTimeDataset`` byte for byte; ``evaluate_gate_stream`` over two
     half-videos with a threshold that lets the gate fire on its 4 likeliest
     frames (fire times as a first pass of perception predicts them); the
     Ego4D ``llm`` (bucket 512) and ``cls`` evaluations; LTA beams (K 5, 32
     frames) and ``score_lta``; MCQA through ``run_mcqa.run_inference`` and
     ``score_answers``, each question's greedy decode ended at its 32nd
     token through the stand-in tokenizer's stop string; OQA through
     ``x_infer``, ended the same way, and ``judge_predictions`` with a stub
     judge; exact launch counts (23 exact and 20 int4 a gate-stream frame,
     32 flash a prefill, one scan a clip);
 15. the gate stream and the Ego4D llm evaluation in fp32 at reduced depth on
     the CPU and the card (identical fires and summary, lm_ppl within a
     limit) and a TF32-on control;
 16. (after phase 8, on phase 7's samples) QLoRA at full width: ``train()``
     on the ``llm`` stage with ``bits=4`` (int4, groups of 64) and LoRA
     (r 128, alpha 256) on the decoder's q, k, v, o, gate, up and down, bf16,
     remat, two 2048-bucket microbatches a step, 4 steps: step time, tokens/s,
     peak memory, the trainable count, the base's bytes; launches 64 lse
     forwards, 32 dQ, 32 dK/dV a microbatch (tensor-core), no matvec; the
     int4 base, the vision tower and the gate bitwise as quantized from the
     same seeded tree, every LoRA B off zero in every layer; the lora_only
     checkpoint read back bitwise, and 2 more steps resumed from it (with
     its optimizer state); then 2 steps over an int8 base; then 2
     adapter-stage steps over an int8 base from ``--model-path`` (a
     full-SFT .bin, the decoder cut to 2 layers) and
     ``--pretrain-mm-mlp-adapter``, whose starting tree must be bitwise the
     converters' and the quantizer's;
 17. QLoRA in fp32 at reduced depth (text 2, gate 2 layers, LoRA B off zero)
     on the CPU and the card: loss, every LoRA and projector gradient, the
     params after two optimizer steps, and a TF32-on control;
 18. (after phase 14, the 7B model freed) StreamMind over Qwen2-7B at full
     width, bf16, random weights from a seed: the decoder from the
     published config.json (28 layers, 28 / 4 heads, q/k/v biases, vocab
     152,064), the gate LM at hidden 3584 (head_dim 112) under
     quantize_gate="int4", the Mamba at d_model 3584: the session of phase
     4, the paged broker's K = 3 turn (group 7 in the paged kernel),
     ``api.model_init`` by a Qwen2 model name (the "qwen" template) and
     ``infer`` on 16 frames with 32 tokens, then one turn of the decoder
     through ``load_8bit`` (fused qkv with its bias); exact launch counts
     and the peak memory of each;
 19. StreamMind over Mixtral-8x7B at full width, made by
     ``api.model_init(load_4bit="pc")`` (int4 per channel), which draws the
     decoder one layer's bf16 banks at a time and quantizes each before the
     next: the session and the K = 3 paged turn through the int4 kernel on
     every decode step (fused qkv, o, each token's two experts' gate, up and
     down slices of the (E, F, D/2) banks); a per-layer tally of the experts
     chosen, every expert chosen somewhere; on one decode step's input the
     gathered dispatch against the dense one (bf16, the summation order)
     and against the grouped one over the dequantized banks (fp32, another
     route); the build's peak memory;
 20. both decoders in fp32 at depth 2 (Mixtral with its 8 experts) on the
     CPU and the card, TF32 off: fires and greedy tokens identical, probs,
     memory and prefill logits within limits; the three MoE dispatches
     against each other; a TF32-on control;
 21. (after phase 14, while phase 4's StreamMind-7B tree is resident) the
     VideoLLaMA2 projectors at full width over its vision tower and decoder
     (bf16): for stc_connector, stp_connector, stc_connector_v35,
     spatial_conv, spatial_pool, linear and mlp2x_gelu, the projector drawn
     from a seed, ``project_memory`` on 8 frames (the median of 5
     synchronized runs, beside its bound), the memory-token count against
     VideoLLaMA2's (845, 576, 576, 1690, 1152, 576, 576), ``api.infer`` with
     32 greedy tokens (32 flash launches, at bucket 1024 or 2048); then a
     released STC checkpoint (mm_projector.bin in timm naming with its
     gate, beside a full-SFT .bin whose decoder is cut to 2 layers) loaded
     by ``model_init(path, load_4bit="pc")``, every leaf bitwise, and
     answered through the int4 kernel; then ``train()`` on the adapter
     stage over the STC connector, 3 steps of one 8-frame SFT clip
     (``VideoLLaVASFTDataset``): step ms, tokens/s, peak memory, 64 lse
     forwards, 32 dQ and 32 dK/dV a step;
 22. every projector type's ``simple_project`` at full width on 2 frames,
     and one Mamba-2 block at mamba2-2.7b's widths (a forward over 512
     tokens, then 4 steps), in fp32 on the CPU and the card (TF32 off for
     matmuls and cuDNN), within limits, and a TF32-on control;
 23. (last, every model freed) parallelism at world size 1: an NCCL process
     group through ``utils/dist.init_process_group`` (a file:// rendezvous
     under ``_smoke_parallel/``, no port), ``barrier``,
     ``allgather_object``, ``allreduce_mean`` and a bf16 all_reduce,
     all_gather_into_tensor and reduce_scatter_tensor; on its (1,1,1)
     ``DeviceMesh``: every kernel of the sharded paths at the shapes one
     rank of tp 2, 4 and 8 holds (flash forward and the training kernels at
     (16, 4), (8, 2), (4, 1) heads, exact at 8, 4, 2 heads, the int8 and
     int4 matvecs at the column and row shards of q, o, gate/up and down —
     the int4 row shards repacked as placed, their ranks' fp32 products
     summed against the whole — the scan at 4096, 2048, 1024 channels),
     appended to the kernels line's cases; the phase 4 session through
     ``StreamMindEngine(mesh=...)`` and the meshless engine on the same
     frames, in turns (memory and logits within BF16_TOL, equal launches,
     the greedy tokens that agree, ticks and decode ms/token); that session
     in fp32 at the parity depths on the CPU and the card (tokens equal,
     ``parity``'s limits, a TF32-on control); one Mixtral-8x7B MoE layer
     (bf16, 64 tokens): the expert-parallel dispatch bitwise the grouped
     one, and the rank bodies of tp 2 and 4 summed within BF16_TOL; 2
     adapter steps of ``train()`` on the mesh (launches through
     ``flash_mha_sharded``, peak memory), then the group destroyed and the
     same 2 steps with no process group: losses within 1e-3;
then the ``kernels`` JSON line (``launches`` from the serving phase for the
inference kernels, from the training phase for the training kernels and from
the fast phase for int8_matvec and selective_scan; ``tc_launches``, ``hgmma``
and ``ms_over_bound`` for the five tensor-core kernels, ``ms_over_bound`` for
paged attention, the int8 and int4 matvecs, the scan and the paged write,
whose launches are the paged attention's launches that wrote a token;
``launches_by_path`` of every kernel: session, serving, fast, train, api,
real_weights, worker, eval, qlora, qwen2, mixtral, projectors, parallel)
and, last,
the ``ok`` JSON line.  The fp32 parity phases must launch no tensor-core kernel.  It
uses nothing of JAX; without a CUDA card it exits with an error before any
result.
"""
from __future__ import annotations

import dataclasses
import gc
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

from streammind_torch.tools.real_weights_smoke import tf32_matmuls

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
    # replaces no TPU kernel: the JAX package keeps int4 expert banks dense
    # (models/mistral.py:204-217) and leaves the product to XLA
    "int4_grouped_gemm": ("streammind_torch/csrc/int4_grouped_gemm.cu", "none"),
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
    "int4_grouped_gemm": ("streammind_torch.ops.int4_grouped_gemm", "int4_grouped_gemm"),
}
TRAIN_KERNELS = ("flash_attention_lse", "flash_bwd_dq", "flash_bwd_dkv")
COUNTERS = {"paged_write": "write_launches"}
# CUDA-core kernels that are timed by graph replay too, their kernel / bound
# in the kernels line
GRAPH_TIMED = ("paged_attention", "int8_matvec", "int4_matvec", "paged_write", "selective_scan",
               "int4_grouped_gemm")
FAST_KERNELS = ("int8_matvec", "selective_scan")
# launched only by a MoE decoder's prefill (per-channel int4 banks in bf16)
MOE_KERNELS = ("int4_grouped_gemm",)
# the kernels with a bf16 tensor-core (wgmma) instantiation beside the fp32
# CUDA-core one; each wrapper counts its bf16 launches again in .tc_launches,
# read here as "<name>_tc"
TC_KERNELS = ("flash_attention", "exact_attention", "flash_attention_lse", "flash_bwd_dq",
              "flash_bwd_dkv")
# the libraries that hold them, each of which must hold HGMMA instructions
TC_LIBRARIES = ("flash_attention", "exact_attention", "flash_bwd_dq", "flash_bwd_dkv",
                "int4_grouped_gemm")


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


# flash: Mistral-7B prefill over a capacity-8192 cache (H 32/8, D 128) at
# the buckets 64 and 2048 (B 1), and 32 and 512 with B 2 and a ragged,
# nonzero q_offset (the second row's bucket padded by a few tokens); then
# bucket 64 with a GQA group of 7 (Qwen2-7B's 28 / 4 heads); then the
# api's one-shot prefill, bucket 128 from an empty cache; then the eval's
# one-shot prefills over their whole bucket from an empty cache: LTA's
# beams (32 frames, bucket 128), MCQA's and OQA's (8 frames, bucket 64);
# then Qwen2-7B's (28 / 4 heads) session turns (bucket 64 from an empty
# cache, bucket 32 at offset 52), its paged K = 3 prefill and its infer
# (bucket 128; Mixtral-8x7B has Mistral-7B's heads); then the clip
# projectors' one-shot infer prefill at bucket 1024 (STC's 845 memory
# tokens, the 576 of STP, v35, linear and MLP; spatial_conv and
# spatial_pool fill bucket 2048, the second case's shape)
FLASH_SHAPES = ((64, [100], [150], 32, 8), (2048, [0], [2048], 32, 8),
                (32, [100, 1517], [132, 1544], 32, 8),
                (512, [388, 2000], [900, 2505], 32, 8),
                (64, [100], [150], 28, 4),
                (128, [0], [65], 32, 8), (128, [0], [128], 32, 8),
                (64, [0], [64], 32, 8),
                # Qwen2-7B at its group of 7: the session's two turns, the
                # K = 3 batched prefill, infer's prefill
                (64, [0], [64], 28, 4), (32, [52], [84], 28, 4),
                (64, [0] * 3, [64] * 3, 28, 4),
                (128, [0], [128], 28, 4),
                (1024, [0], [1024], 32, 8))


def flash_cases(dev, randn, shapes, tag="", cap=8192, tol=BF16_TOL):
    """flash_attention against its plain version at each (bucket, q
    offsets, kv lengths, heads, kv heads) over caches of ``cap`` rows, in
    the dtype ``randn`` draws (bf16: the tensor-core instantiation; fp32:
    the CUDA-core one).  Sets of inputs: the caches are
    overlapping views of one buffer, each starting past the rows the
    previous one reads, so nothing is read warm.  Kernel and library are
    timed by graph replay (the bf16 kernel runs in less time than its
    wrapper's host work), the kernel eagerly as well."""
    from streammind_torch.ops import attention as A

    cases = []
    esize = randn(1).element_size()
    peak = BF16_FLOPS if esize == 2 else FP32_FLOPS
    for sq, q_offs, kv_lens, h, hkv in shapes:
        b = len(q_offs)
        visible = sum(min(n, off + i + 1) for off, n in zip(q_offs, kv_lens) for i in range(sq))
        rows = [min(n, off + sq) for off, n in zip(q_offs, kv_lens)]
        nbytes = esize * (2 * b * sq * h * 128 + 2 * sum(rows) * hkv * 128)
        n, step = n_sets(nbytes), 64 * math.ceil(max(rows) / 64)
        kbuf, vbuf = (randn(b, (n - 1) * step + cap, hkv, 128) for _ in range(2))
        sets = [(randn(b, sq, h, 128), kbuf[:, i * step:i * step + cap],
                 vbuf[:, i * step:i * step + cap]) for i in range(n)]
        lens = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
        offs = torch.tensor(q_offs, dtype=torch.int32, device=dev)
        q, kc, vc = sets[0]
        out = A.flash_attention(q, kc, vc, causal=True, kv_len=lens, q_offset=offs)
        ref = A.flash_attention_ref(q, kc, vc, causal=True, kv_len=lens, q_offset=offs)
        err, over = excess(out, ref, *tol)
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
        b_ms, b_by = bound(nbytes, 4.0 * 128 * h * visible, peak)
        cases.append(dict(shape=f"q({b},{sq},{h},128) cache({b},{cap},{hkv},128) q_offset={q_offs} "
                                f"kv_len={kv_lens}{tag}", max_abs_err=err, ok=over <= 0, ms=ms,
                          eager_ms=eager, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                          bound_by=b_by))
    return cases


def exact_cases(dev, randn, batches, h=16, tag=""):
    """exact_attention at the ViT-L/14-336's shape (577 tokens, D 64) with
    ``h`` heads, q/k/v strided views of the fused qkv, at each batch."""
    from streammind_torch.ops import attention as A

    cases = []
    for b in batches:
        nbytes = 4 * 2 * b * 577 * h * 64
        qkvs = [randn(b, 577, 3, h, 64) for _ in range(n_sets(nbytes))]
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
        b_ms, b_by = bound(nbytes, 4.0 * b * h * 577 * 577 * 64, BF16_FLOPS)
        cases.append(dict(shape=f"({b},577,{h},64){tag}", max_abs_err=err, ok=over <= 0, ms=ms,
                          eager_ms=eager, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                          bound_by=b_by, one_pass_flash_ms=one_pass))
    return cases


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------
def check_kernels(dev):
    g = torch.Generator(device=dev).manual_seed(1234)
    bf16 = torch.bfloat16
    results = {}

    def randn(*shape, std=1.0):
        return torch.empty(shape, device=dev, dtype=bf16).normal_(0.0, std, generator=g)

    results["flash_attention"] = (flash_cases(dev, randn, FLASH_SHAPES), BF16_TOL_TEXT)
    # exact at B 1 (a session's frame), 4 (the serving tick) and 8
    results["exact_attention"] = (exact_cases(dev, randn, (1, 4, 8)), BF16_TOL_TEXT)

    results["int4_matvec"] = (int4_cases(dev, g) + int4_cases(
        dev, g, shapes=INT4_DECODER_SHAPES, dtypes=(bf16,), batches=(1, API_BEAMS)) + int4_cases(
        dev, g, shapes=INT4_DECODER_UNFUSED, dtypes=(bf16,), batches=(API_BEAMS,)) + int4_cases(
        dev, g, shapes=INT4_QWEN2_GATE, dtypes=(bf16,), batches=(1, 4)) + int4_expert_cases(
        dev, g), INT4_TOL_TEXT)
    results["int4_grouped_gemm"] = (int4_grouped_cases(dev, g), BF16_TOL_TEXT)
    results.update(check_paged_kernels(dev, randn))
    results.update(check_train_kernels(dev, randn))
    results.update(check_fast_kernels(dev, g))

    return report_cases(results)


def report_cases(results: dict) -> dict:
    """Log every case ({kernel: (cases, tolerance text)}), add kernel / bound
    to the tensor-core kernels' cases, and raise if any case disagrees."""
    for name, (cases, tol) in results.items():
        for c in cases:
            if name in TC_KERNELS:
                c["ms_over_bound"] = c["ms"] / c["bound_ms"]
            lib = "none" if c["library_ms"] is None else f"{c['library_ms']:.4f} ms"
            eager = f" (eager {c['eager_ms']:.4f} ms)" if "eager_ms" in c else ""
            if "library_eager_ms" in c:
                lib += f" (eager {c['library_eager_ms']:.4f} ms)"
            one_pass = (f"; the one-pass flash forward on the same inputs: "
                        f"{c['one_pass_flash_ms']:.4f} ms" if "one_pass_flash_ms" in c else "")
            log("kernel", f"[{CARD}] {name} {c['shape']}: max_abs_err={c['max_abs_err']:.3e} "
                          f"{'(each output: ' + str(c['errs']) + ') ' if 'errs' in c else ''}"
                          f"within [{tol}]={c['ok']} kernel={c['ms']:.4f} ms{eager} "
                          f"plain={c['plain_ms']:.4f} ms library={lib} "
                          f"bound={c['bound_ms']:.4f} ms ({c['bound_by']})"
                          + (f" kernel/bound={c['ms_over_bound']:.2f}"
                             if "ms_over_bound" in c else "") + one_pass)
    bad = [(n, c["shape"]) for n, (cs, _) in results.items() for c in cs if not c["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: {bad}")
    return results


PAGED_SHAPE = dict(hkv=8, h=32, d=128, page=64, maxp=128, n_pages=1024)


# Qwen2-7B's pool: 28 q / 4 kv heads, a GQA group of 7
PAGED_SHAPE_G7 = dict(PAGED_SHAPE, hkv=4, h=28)


def paged_pool(randn, sh=PAGED_SHAPE):
    """A pool of 1024 pages (268 MB of K and V, five times the L2, at 8 kv
    heads) at the serving path's shapes: Mistral-7B (32 q / 8 kv heads, D
    128), page 64; or Qwen2-7B's (``PAGED_SHAPE_G7``)."""
    return tuple(randn(sh["hkv"], sh["n_pages"] + 1, sh["page"], sh["d"]) for _ in range(2))


def paged_attention_case(dev, randn, pool_k, pool_v, lengths, sh=PAGED_SHAPE):
    """paged_decode_attention at one list of row lengths over 128-page tables,
    against its plain version; kernel and yardstick timed by graph replay
    (the kernel runs in less time than its wrapper's host work) and
    eagerly."""
    from streammind_torch.ops import paged_attention as PA

    hkv, h, d, page, maxp, n_pages = (sh[k] for k in ("hkv", "h", "d", "page", "maxp",
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


def paged_write_case(dev, randn, pool_k, pool_v, lengths, sh=PAGED_SHAPE):
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

    hkv, h, d, page, maxp, n_pages = (sh[k] for k in ("hkv", "h", "d", "page", "maxp",
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
    folded in, at ``PAGED_WRITE_LENGTHS``.  Then Qwen2-7B's group of 7
    (``PAGED_SHAPE_G7``): attention at K 3 over ragged lengths, and the
    write folded in at the serving turn's K 3."""
    pool_k, pool_v = paged_pool(randn)
    attn = [paged_attention_case(dev, randn, pool_k, pool_v, PAGED_LENGTHS[:K])
            for K in (1, 4, 8)]
    cases = [paged_write_case(dev, randn, pool_k, pool_v, n) for n in PAGED_WRITE_LENGTHS]
    del pool_k, pool_v
    pool_k, pool_v = paged_pool(randn, PAGED_SHAPE_G7)
    attn.append(paged_attention_case(dev, randn, pool_k, pool_v, PAGED_LENGTHS[1:4],
                                     PAGED_SHAPE_G7))
    cases.append(paged_write_case(dev, randn, pool_k, pool_v, PAGED_WRITE_LENGTHS[0],
                                  PAGED_SHAPE_G7))
    del pool_k, pool_v
    results = {"paged_attention": (attn, BF16_TOL_TEXT + "; the same bits on a second call")}
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
    group of 7 (28 / 4 heads); then the adapter step over the STC
    connector: the 1024 bucket, its spliced length valid.  The lse forward, dQ and dK/dV each against
    its plain version on the same inputs; SDPA (causal, enable_gqa) is the
    yardstick: its forward, and its forward+backward less the forward (which
    computes dQ, dK and dV at once).  Kernels and yardsticks are timed by
    graph replay, the kernels eagerly too."""
    rows = train_kernel_cases(dev, randn, (
        (1, 2048, 32, 8, 128, [2048]), (2, 2048, 32, 8, 128, [2048, 1531]),
        (1, 2048, 32, 8, 64, [2048]), (1, 2048, 28, 4, 128, [2048]),
        (1, 1024, 32, 8, 128, [connector_step_len()])))
    return {"flash_attention_lse": (rows["flash_attention_lse"],
                                    f"out {BF16_TOL_TEXT}; lse {LSE_TOL_TEXT}"),
            "flash_bwd_dq": (rows["flash_bwd_dq"], f"{BWD_TOL_TEXT}, fed the plain lse and "
                                                   f"the kernel's"),
            "flash_bwd_dkv": (rows["flash_bwd_dkv"], f"dK and dV {BWD_TOL_TEXT}, fed the plain "
                                                     f"lse and the kernel's")}


def train_kernel_cases(dev, randn, shapes, tag=""):
    """The lse forward, dQ and dK/dV at each (B, S, H, Hkv, D, kv_len),
    causal, each against its plain version, beside SDPA; {kernel: cases}."""
    from streammind_torch.ops import attention as A

    rows = {n: [] for n in TRAIN_KERNELS}
    for b, s, h, hkv, d, kv_len in shapes:
        shape = f"q({b},{s},{h},{d}) kv({b},{s},{hkv},{d}) causal kv_len={kv_len}{tag}"
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
    return rows


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
# the int4 gate at Qwen2-7B's width (hidden 3584, head_dim 112), one token a
# frame and one a stream of the serving tick
INT4_QWEN2_GATE = (("qwen2 gate v", 896, 3584), ("qwen2 gate o", 3584, 3584),
                   ("qwen2 gate gate/up", 14336, 3584), ("qwen2 gate down", 3584, 14336))
# Mixtral-8x7B's load_4bit="pc" experts, one token's slice of an (E, F, D/2) bank
INT4_EXPERT_SHAPES = (("mixtral expert gate/up", 14336, 4096),
                      ("mixtral expert down", 4096, 14336))
# Qwen2-7B's int8 decoder (load_8bit), fused as the engine serves it; the
# q/k/v bias is added after the kernel
INT8_QWEN2_SHAPES = (("qwen2 qkv (fused)", 4608, 3584), ("qwen2 o", 3584, 3584),
                     ("qwen2 gateup (fused)", 37888, 3584), ("qwen2 down", 3584, 18944))


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


def int4_expert_cases(dev, g, n_experts=8):
    """int4_matvec on one token against one expert's slice of a Mixtral
    (E, F, D/2) int4 bank, as the gathered MoE dispatch hands it over: the
    view ``bank[e]`` itself, no copy.  Each launch takes the next expert's
    slice (a bank is 235 MB, more than four times the L2, so each reads
    cold); the yardstick is F.linear on the slice dequantized beforehand."""
    from streammind_torch.ops.int4_matvec import int4_matvec, int4_matvec_ref
    from streammind_torch.utils.quantize import (dequantize_linear_weight_int4_pc,
                                                 quantize_linear_weight_int4_pc)

    rows = []
    for name, dout, din in INT4_EXPERT_SHAPES:
        bank = quantize_linear_weight_int4_pc(torch.empty(
            (n_experts, dout, din), device=dev, dtype=torch.bfloat16).normal_(
            0.0, 0.02, generator=g))
        slices = [{k: v[e] for k, v in bank.items()} for e in range(n_experts)]
        if any(p["w_int4pc"].data_ptr() % 16 or not p["w_int4pc"].is_contiguous()
               for p in slices):
            raise RuntimeError(f"{name}: an expert slice is not a contiguous aligned view")
        libs = [dequantize_linear_weight_int4_pc(p, torch.bfloat16) for p in slices]
        x = torch.empty((1, din), device=dev, dtype=torch.bfloat16).normal_(generator=g)
        p0 = slices[1]
        out = int4_matvec(x, p0["w_int4pc"], p0["scale"])
        ref = int4_matvec_ref(x, p0["w_int4pc"], p0["scale"])
        err, over = excess(out, ref, *INT4_TOL)
        fns = [lambda p=p: int4_matvec(x, p["w_int4pc"], p["scale"]) for p in slices]
        ms, eager = cuda_ms(fns, graph=True), cuda_ms(fns)
        plain = cuda_ms([lambda p=p: int4_matvec_ref(x, p["w_int4pc"], p["scale"])
                         for p in slices], iters=5)
        lib_fns = [lambda w=w: F.linear(x, w) for w in libs]
        lib, lib_eager = cuda_ms(lib_fns, graph=True), cuda_ms(lib_fns)
        b_ms, b_by = bound(dout * din / 2 + 4 * dout + 2 * (din + dout), 2.0 * dout * din,
                           BF16_FLOPS)
        rows.append(dict(shape=f"{name}: x(1,{din}) bfloat16 W({dout},{din}/2) int4, bank "
                               f"({n_experts},{dout},{din}/2)[e]", max_abs_err=err,
                         ok=over <= 0, ms=ms, eager_ms=eager, plain_ms=plain, library_ms=lib,
                         library_eager_ms=lib_eager, bound_ms=b_ms, bound_by=b_by,
                         ms_over_bound=ms / b_ms))
        del bank, slices, libs
        torch.cuda.empty_cache()
    return rows


# the grouped int4 GEMM pair of a MoE prefill: (model, experts, tokens T,
# route), R = 2 T routed rows (top 2), at the expert widths D 4096, F 14336
# that Mixtral-8x7B and Jamba2-Mini share.  T = K x bucket of the prefills a
# traced run of each MoE cell recorded (mixtral.match4: K 1-4 over buckets
# 128-512, T 128-2048; jamba.ask4: buckets 64-256, T 128-1024); and a
# skewed route ("half": every row to the first E / 2 experts, the others
# empty)
GROUPED_SHAPES = (("mixtral", 8, 128, "uniform"), ("mixtral", 8, 512, "uniform"),
                  ("mixtral", 8, 1024, "uniform"), ("mixtral", 8, 2048, "uniform"),
                  ("mixtral", 8, 1024, "half"), ("jamba", 16, 128, "uniform"),
                  ("jamba", 16, 768, "uniform"), ("jamba", 16, 1024, "uniform"))
GROUPED_D, GROUPED_F = 4096, 14336


def grouped_routes(T: int, E: int, how: str, g, dev):
    """(topi, topw) of T tokens, top 2 of E: two distinct experts a token
    drawn uniformly (``how`` "half": among the first E / 2), weights drawn
    and renormalised, fp32."""
    pool = E if how == "uniform" else E // 2
    topi = torch.rand((T, pool), device=dev, generator=g).argsort(dim=-1)[:, :2]
    topw = torch.rand((T, 2), device=dev, generator=g) + 0.1
    return topi, topw / topw.sum(dim=-1, keepdim=True)


def int4_grouped_cases(dev, g, shapes=GROUPED_SHAPES):
    """The grouped int4 GEMM pair (``_moe_apply_grouped_int4``'s two
    launches) against its plain version: h of the gate + up launch against
    the plain gate + up on the same rows, y of the down launch against the
    plain down on the kernel's h; a second call bitwise the first.  Timed by
    CUDA graph replay (each launch reads 235-940 MB of banks, cold), beside
    the bound (each touched expert's packed bytes and scales read once, the
    rows read and written once, 2 operations a multiply-add), the plain
    version, the whole dispatch (sort, gather, the pair, the slot sum) and
    the parent's dense dispatch (every bank dequantized, then ``F.linear``)."""
    from types import SimpleNamespace

    from streammind_torch.models import mistral as lm
    from streammind_torch.ops.int4_grouped_gemm import int4_grouped_gemm, int4_grouped_gemm_ref

    rows, D, F = [], GROUPED_D, GROUPED_F
    for model, E, T, how in shapes:
        def bank(n_out, n_in):
            return {"w_int4pc": torch.randint(-128, 128, (E, n_out, n_in // 2), device=dev,
                                              dtype=torch.int8, generator=g),
                    "scale": torch.rand((E, n_out), device=dev, generator=g) * 0.02}
        banks = (bank(F, D), bank(F, D), bank(D, F))
        cfg = SimpleNamespace(num_experts=E)
        xt = torch.empty((T, D), device=dev, dtype=torch.bfloat16).normal_(generator=g)
        topi, topw = grouped_routes(T, E, how, g, dev)
        flat = topi.reshape(-1)
        order = torch.argsort(flat, stable=True)
        offsets = torch.searchsorted(flat[order], torch.arange(E + 1, device=dev),
                                     out_int32=True)
        xs = xt.index_select(0, order // 2)
        rw = topw.reshape(-1)[order]
        (gw, gs), (uw, us), (dw, ds) = ((b["w_int4pc"], b["scale"]) for b in banks)

        def pair():
            h = int4_grouped_gemm(xs, offsets, gw, gs, up=(uw, us))
            return h, int4_grouped_gemm(h, offsets, dw, ds, dst=order, row_weight=rw)

        n0 = int4_grouped_gemm.launches
        h, y = pair()
        h2, y2 = pair()
        launches = int4_grouped_gemm.launches - n0
        bitwise = torch.equal(h, h2) and torch.equal(y, y2)
        ref_h = int4_grouped_gemm_ref(xs, offsets, gw, gs, up=(uw, us))
        ref_y = int4_grouped_gemm_ref(h, offsets, dw, ds, dst=order, row_weight=rw)
        err_h, over_h = excess(h, ref_h, *BF16_TOL)
        err_y, over_y = excess(y, ref_y, *BF16_TOL)
        ms = cuda_ms([pair], iters=10, warmup=2, graph=True)
        eager = cuda_ms([pair], iters=10, warmup=1)
        whole = cuda_ms([lambda: lm._moe_apply_grouped_int4(xt, banks, cfg, topi, topw)],
                        iters=10, warmup=1)
        plain = cuda_ms([lambda: int4_grouped_gemm_ref(xs, offsets, gw, gs, up=(uw, us))],
                        iters=2, warmup=1)
        plain += cuda_ms([lambda: int4_grouped_gemm_ref(h, offsets, dw, ds, dst=order,
                                                        row_weight=rw)], iters=2, warmup=1)
        dense = cuda_ms([lambda: lm._moe_apply_dense(xt, banks, cfg, topi, topw)], iters=2,
                        warmup=1)
        touched = int((offsets[1:] > offsets[:-1]).sum())
        R = 2 * T
        nbytes = (touched * (3 * F * D // 2 + 4 * (2 * F + D))   # banks and scales
                  + 2 * R * (D + F) * 2 + 4 * R + 8 * R)          # rows in and out, weights, dst
        b_ms, b_by = bound(nbytes, 2.0 * R * 3 * F * D, BF16_FLOPS)
        rows.append(dict(shape=f"{model}: E {E}, T {T} ({how}), R {R}, D {D}, F {F}, "
                               f"{touched} experts touched", max_abs_err=max(err_h, err_y),
                         errs=dict(h=err_h, y=err_y), ok=over_h <= 0 and over_y <= 0 and bitwise,
                         bitwise=bitwise, launches=launches, ms=ms, eager_ms=eager,
                         dispatch_ms=whole, plain_ms=plain, library_ms=dense, bound_ms=b_ms,
                         bound_by=b_by, ms_over_bound=ms / b_ms))
        del banks, xt, xs, h, y, h2, y2, ref_h, ref_y
        torch.cuda.empty_cache()
    return rows


def grouped_main() -> int:
    """The grouped int4 GEMM alone: its build (ptxas registers and spills,
    HGMMA count) and ``int4_grouped_cases``, one JSON line a case.

        python3 -c "import sys, chip_smoke as c; sys.exit(c.grouped_main())"
    """
    from streammind_torch.ops import _build

    global CARD
    CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    log("env", f"{CARD}; torch {torch.__version__} cuda {torch.version.cuda}")
    logs = _build.build_all(["int4_grouped_gemm", "int4_matvec"])
    for name, info in logs.items():
        ptx = [l.strip() for l in info["log"].splitlines() if l.strip()]
        log("build", f"{name}: {info['seconds']:.1f} s; " + " | ".join(ptx))
    log("build", f"int4_grouped_gemm: {hgmma_count('int4_grouped_gemm')} HGMMA instructions")
    cases = report_cases({"int4_grouped_gemm": (int4_grouped_cases(
        "cuda", torch.Generator(device="cuda").manual_seed(4321)), BF16_TOL_TEXT)})
    for c in cases["int4_grouped_gemm"][0]:
        print(json.dumps(c), flush=True)
    return 0


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
    (torch.bfloat16, 1, 16, False, "time"),  # the api's clip projection: L = 16 frames, fresh
    # the eval's clip projections, fresh: the Ego4D llm and cls clip (L 60:
    # two 32-step chunks, the second partial), LTA's (L 32), MCQA's and OQA's (L 8)
    (torch.bfloat16, 1, 60, False, "time"), (torch.bfloat16, 1, 32, False, "time"),
    (torch.bfloat16, 1, 8, False, "time"))


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
    results = {"int8_matvec": (int8_cases(dev, g) + int8_cases(
        dev, g, shapes=INT8_QWEN2_SHAPES, dtypes=(torch.bfloat16,), batches=(1,)), "; ".join(
        tol_text(INT8_TOL[d], str(d)[6:] + " output") for d in INT8_TOL))}
    # the last case: Qwen2-7B's api clip, the Mamba at d_inner 7168
    results["selective_scan"] = (scan_cases(dev, g) + scan_cases(
        dev, g, cases=((torch.bfloat16, 1, 16, False, "time"),), d=7168), "y " + "; ".join(
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


class StopAtId(StandInTokenizer):
    """The stand-in whose template separator ("</s>", the llama_2 reply's
    stop string) is the one id ``stop``: a decode ends where it first emits
    that id.  Every other text encodes as the stand-in's."""

    def __init__(self, stop: int):
        self.stop = stop

    def __call__(self, text):
        if text.strip() == self.eos_token:
            return self._Out([self.bos_token_id, self.stop])
        return super().__call__(text)


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


def as_recording(engine):
    """An engine that ``api.model_init`` made, turned in place into the
    class ``make_engine_class`` returns (its records empty)."""
    engine.__class__ = make_engine_class()
    engine.probs, engine.prefill_logits, engine.decoded = [], [], []
    engine.prefill_end, engine.decode_ms = None, []
    return engine


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


def grouped_per_prefill(engine) -> int:
    """int4_grouped_gemm launches a prefill: two a MoE layer where the
    decoder's experts take the grouped int4 kernels (per-channel int4
    banks, bf16 activations on the card), else none."""
    from streammind_torch.models import mistral as lm

    cfg = engine.cfg.text
    if cfg.num_experts <= 1 or not lm.moe_ids_on_device(engine.params["text"], cfg, "cuda"):
        return 0
    return 2 * sum(cfg.is_moe(i) for i in range(cfg.num_layers))


def full_width_session(engine, g, dev, tag="session", matvec=None):
    """10 frames with forced fires on frames 3 and 7, 16 new tokens a turn.
    ``matvec``: (kernel name, launches a layer of a one-token decode
    forward) of a quantized decoder (its prefill takes the plain product)."""
    cfg = engine.cfg
    n_frames, fire, size = 10, (3, 7), cfg.vision.image_size
    frames = [torch.empty((1, 3, size, size), device=dev, dtype=torch.bfloat16).normal_(
        generator=g) for _ in range(n_frames)]
    torch.cuda.synchronize()
    reset_launches()
    with DecodeCounter() as dc:
        session, ticks, e2ft = run_session(engine, frames, fire, max_new=16)
    counts = read_launches()
    turns = len(session.turns)
    n_vit = cfg.vision.num_layers + cfg.vision.select_layer + 1
    expect = {"exact_attention": n_vit * n_frames, "int4_matvec": 5 * cfg.gate.num_layers * n_frames,
              "flash_attention": cfg.text.num_layers * turns, "paged_write": 0,
              "paged_attention": 0, **{n: 0 for n in TRAIN_KERNELS + FAST_KERNELS},
              "int4_grouped_gemm": grouped_per_prefill(engine) * turns}
    if matvec is not None:
        expect[matvec[0]] += cfg.text.num_layers * matvec[1] * dc.n
    expect.update({f"{n}_tc": expect[n] for n in TC_KERNELS})  # bf16: every launch
    probs = torch.stack(engine.probs)
    n_tok = sum(len(t) for t in engine.decoded)
    decode_ms_tok = sum(engine.decode_ms) / max(n_tok, 1)
    log(tag, f"frames={n_frames} turns={turns} tokens={[len(t) for t in engine.decoded]} "
             f"decode forwards={dc.n} launches={counts} expected={expect}")
    log(tag, f"tensor-core launches: exact {counts['exact_attention_tc'] / n_frames:g} a "
             f"frame, flash {counts['flash_attention_tc'] / max(turns, 1):g} a turn")
    log(tag, f"[{CARD}] median tick (silent frames after the first) = "
             f"{statistics.median(ticks[1:]):.3f} ms; ticks ms = "
             f"{[round(t, 3) for t in ticks]}")
    log(tag, f"[{CARD}] event-to-first-token ms = {[round(t, 3) for t in e2ft]}; "
             f"decode ms/token = {decode_ms_tok:.3f}")
    log(tag, f"peak device memory = {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
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


def serving_phase(engine, g, dev, ticks=SERVE_TICKS, fires=SERVE_FIRES, tag="serve",
                  matvec=None):
    """Four client threads submit a frame a tick to one BatchedSessionBroker
    (paged KV, page 64) for ``ticks`` ticks.  The per-stream gate
    threshold, a request knob, is set before each tick: -1 opens a gate, 2
    keeps it shut, so the streams of ``fires[t]`` fire together on tick t
    (by default three on one tick and one alone on a later one).
    ``matvec``: (kernel name, launches a layer of a lockstep step of K rows
    as a function of K) of a quantized decoder; the decoder's prefill runs
    more than 8 tokens, which take the plain product."""
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
        generator=g) for _ in range(ticks)] for sid in sids}
    results = {sid: [] for sid in sids}
    start, done = threading.Barrier(len(sids) + 1), threading.Barrier(len(sids) + 1)

    def client(sid):
        for t in range(ticks):
            start.wait()
            results[sid].append(broker.submit(sid, frames[sid][t], timeout=600))
            done.wait()

    threads = [threading.Thread(target=client, args=(sid,), daemon=True) for sid in sids]
    torch.cuda.synchronize()
    reset_launches()
    try:
        for th in threads:
            th.start()
        for t in range(ticks):
            for slot in srv.slots:
                slot.gate_threshold = -1.0 if slot.stream_id in fires.get(t, ()) else 2.0
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
    expect = {"exact_attention": n_vit * ticks,
              "int4_matvec": 5 * cfg.gate.num_layers * ticks,
              "flash_attention": L * len(pd.decodes), "paged_write": L * steps,
              "paged_attention": L * steps, **{n: 0 for n in TRAIN_KERNELS + FAST_KERNELS},
              "int4_grouped_gemm": grouped_per_prefill(engine) * len(pd.decodes)}
    if matvec is not None:
        expect[matvec[0]] += sum(L * matvec[1](d["k"]) * d["steps"] for d in pd.decodes)
    expect.update({f"{n}_tc": expect[n] for n in TC_KERNELS})
    tick_log = srv.tick_log
    log(tag, f"ticks={broker.ticks} frames={broker.frames_seen} fired per tick="
             f"{[t['fired'] for t in tick_log]}")
    log(tag, f"lockstep turns (K, steps, ms, first step's attention lengths) = "
             f"{[(d['k'], d['steps'], round(d['ms'], 3), d['attn_lengths']) for d in pd.decodes]}; "
             f"launches={counts} expected={expect}")
    log(tag, f"tensor-core launches: exact {counts['exact_attention_tc'] / ticks:g} a "
             f"tick, flash {counts['flash_attention_tc'] / len(pd.decodes):g} a batched prefill")
    silent = [t["ms"] for t in tick_log[1:] if not t["fired"]]
    fire_ticks = [t for t in tick_log if t["fired"]]
    per_step = {d["k"]: d["ms"] / max(d["steps"], 1) for d in pd.decodes}
    log(tag, f"[{CARD}] median silent tick at S=4 (after the first) = "
             f"{statistics.median(silent):.3f} ms; ticks ms = "
             f"{[round(t['ms'], 3) for t in tick_log]}")
    log(tag, f"[{CARD}] event-to-first-token ms = "
             f"{[(t['fired'], [round(x, 3) for x in t['first_token_ms']]) for t in fire_ticks]}"
             f"; decode ms per lockstep step = "
             f"{ {k: round(v, 3) for k, v in per_step.items()} }")
    log(tag, f"peak device memory = {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    errors = [r for rs in results.values() for r in rs if "error" in r]
    if errors:
        raise RuntimeError(f"ticks failed inside the broker: {errors}")
    for sid, rs in results.items():
        want = [sid in fires.get(t, ()) for t in range(ticks)]
        if len(rs) != ticks or [r["fire"] for r in rs] != want:
            raise RuntimeError(f"{sid}: fires {[r['fire'] for r in rs]}, expected {want}")
        if any(r["fire"] != isinstance(r["text"], str) for r in rs):
            raise RuntimeError(f"{sid}: an utterance is missing or a silence spoke: {rs}")
        if [r["frame_idx"] for r in rs] != list(range(1, ticks + 1)):
            raise RuntimeError(f"{sid}: frame indices {[r['frame_idx'] for r in rs]}")
    want_k = [len(fires[t]) for t in sorted(fires)]
    if broker.ticks != ticks or [d["k"] for d in pd.decodes] != want_k:
        raise RuntimeError(f"expected {ticks} ticks with turns of K {want_k}, got "
                           f"{broker.ticks} ticks and turns {pd.decodes}")
    if counts != expect or not all(counts[n] for n in counts
                                   if kernel_of(n) not in TRAIN_KERNELS + FAST_KERNELS + MOE_KERNELS):
        raise RuntimeError(f"launch counts {counts} differ from the path's {expect}")
    # the token write has no launch of its own: every paged attention launch
    # wrote its step's token, one a layer a step
    log(tag, f"paged decode: {counts['paged_attention']} launches in {steps} lockstep steps "
             f"({counts['paged_attention'] / max(steps, 1):g} a step), "
             f"{counts['paged_write']} of them writing the step's token; no separate write "
             f"kernel")
    probs = torch.cat(engine.probs[-ticks:])
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
        with tf32_matmuls(tf32):
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
                    raise RuntimeError(f"the card's session missed the exact or flash kernel: "
                                       f"{counts}")
            del eng, session
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
    input ids, as only the decode loops call it) while it is installed.
    With ``limit``, it also keeps the ids a single-row decode feeds (the
    tokens it emitted) and ends the call by raising ``Enough`` when
    ``limit`` of them are known."""

    class Enough(Exception):
        pass

    def __init__(self, limit=None):
        from streammind_torch.models import mistral

        self.mod, self.orig, self.n = mistral, mistral.text_forward, 0
        self.limit, self.ids = limit, []

    def __enter__(self):
        def counted(*a, **kw):
            if kw.get("input_ids") is not None:
                self.n += 1
                if self.limit is not None:
                    self.ids.append(int(kw["input_ids"].reshape(-1)[0]))
                    if len(self.ids) == self.limit:
                        raise DecodeCounter.Enough
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
        with tf32_matmuls(tf32):
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


def train_data() -> MatchTimeShaped:
    """The training and QLoRA phases' samples: each splices into the 2048 bucket."""
    t0 = time.perf_counter()
    ds = MatchTimeShaped([1900, 1920, 1940, 1980], frames=64, seed=0)
    log("train", f"data: {len(ds)} samples, features {ds.samples[0]['video'].shape}, prompts "
                 f"{[s['input_ids'].shape[1] for s in ds.samples]} ids, made in "
                 f"{time.perf_counter() - t0:.1f} s")
    return ds


def training_phase(dev, ds):
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


def parity_tree():
    """The fp32 tree of the training and QLoRA parity phases, on the CPU."""
    from streammind_torch.models.meta import init_streammind_params

    return init_streammind_params(torch.Generator().manual_seed(5), parity_config(),
                                  device="cpu")


def training_parity(dev, params):
    """The adapter stage's loss, gradients and two optimizer steps in fp32
    through the plain versions on the CPU and the kernels on the card (TF32
    off), then on the card with TF32 on as the control; ``params`` is
    ``parity_tree()``, left as it is."""
    from streammind_torch.train.objectives import stage1_llm_loss
    from streammind_torch.train.run import make_microbatch
    from streammind_torch.train.trainer import (
        cosine_schedule, global_norm, init_train_state, make_grad_step, make_optimizer,
        make_train_step, named_leaves, trainable_mask)
    from streammind_torch.utils.params import tree_map

    cfg = parity_config()
    sample = MatchTimeShaped([440], frames=16, seed=6).samples[0]   # splices into 512

    def loss_fn(p, b):
        return stage1_llm_loss(p, cfg, b["frames"], b["token_ids"], b["mem_index"], b["use_mem"],
                               b["attn_mask"], b["labels"], remat=True, attn_impl="flash!")

    out = {}
    for run, where, tf32 in (("cpu", "cpu", False), ("card", dev, False),
                             ("card_tf32", dev, True)):
        with tf32_matmuls(tf32):
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
# phases 16-17: QLoRA (LoRA over an int4 or int8 frozen decoder) and a
# released checkpoint as the starting point of train()
# ---------------------------------------------------------------------------
QLORA_STEPS = 4
QLORA_LR = 1e-3   # LoRA B starts at zero: any step moves it; the base never moves
QLORA_DIR = Path(__file__).resolve().parent / "_smoke_qlora"


def qlora_args(dev, max_steps: int, resume: bool, bits: int = 4, stage: str = "llm",
               **model):
    from streammind_torch.train.args import DataArguments, ModelArguments, TrainingArguments

    return (ModelArguments(bits=bits, tune_mm_mlp_adapter=stage == "adapter", **model),
            DataArguments(score_dataset_train_llm=stage == "llm", num_workers=2),
            TrainingArguments(output_dir=str(QLORA_DIR), learning_rate=QLORA_LR, bf16=True,
                              max_steps=max_steps, save_steps=max_steps, logging_steps=1,
                              per_device_train_batch_size=1, gradient_accumulation_steps=2,
                              gradient_checkpointing=True, seed=0, resume=resume, device=dev,
                              lora_enable=stage == "llm"))


def qlora_metrics():
    with open(QLORA_DIR / "logs" / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def train_launch_expect(counts: dict, layers: int) -> dict:
    """A microbatch's launches: 2 lse forwards (the forward and its remat)
    and one dQ and one dK/dV a layer, every one tensor-core; nothing else."""
    expect = {n: 0 for n in counts}
    expect.update(flash_attention_lse=2 * layers, flash_bwd_dq=layers, flash_bwd_dkv=layers)
    expect.update({f"{n}_tc": expect[n] for n in TRAIN_KERNELS})
    return expect


def qlora_phase(dev, ds):
    """train() on the llm stage at StreamMind-7B's widths over an int4 base
    (groups of 64) with LoRA r 128, alpha 256 on q, k, v, o, gate, up and
    down: QLORA_STEPS steps of two 2048-bucket microbatches, then 2 more
    resumed from its lora_only checkpoint; 2 steps over an int8 base; then
    2 adapter-stage steps over an int8 base from a released-layout
    checkpoint (decoder cut to CKPT_TEXT_LAYERS) and an mm_projector.bin."""
    import streammind_torch.train.run as run
    from streammind_torch.config import StreamMindConfig
    from streammind_torch.models.meta import init_streammind_params
    from streammind_torch.train.trainer import named_leaves, trainable_mask
    from streammind_torch.utils.checkpoint import (
        latest_checkpoint, load_checkpoint, save_mm_projector_bin)
    from streammind_torch.utils.convert import (
        convert_projector, convert_streammind_checkpoint, load_state_dict)
    from streammind_torch.utils.params import param_bytes, tree_map
    from streammind_torch.utils.quantize import quantize_text_params

    cfg = StreamMindConfig()
    L = cfg.text.num_layers
    shutil.rmtree(QLORA_DIR, ignore_errors=True)
    frozen = {}
    real_init = run.init_train_state

    def snapshot(params, *a):  # host copies of the frozen leaves train() starts from
        for name, tree in (("text.", params["text"]), ("vision.", params["vision"]),
                           ("projector.cls_net.", params["projector"]["cls_net"])):
            frozen.update({p: t.to("cpu", copy=True)
                           for p, t in named_leaves(tree, prefix=name).items()})
        return real_init(params, *a)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    run.init_train_state = snapshot
    try:
        state = run.train(*qlora_args(dev, QLORA_STEPS, resume=False), dataset=ds, cfg=cfg)
    finally:
        run.init_train_state = real_init
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated()
    recs = qlora_metrics()
    losses = [r["train/loss"] for r in recs]
    step_ms = [(b["ts"] - a["ts"]) * 1e3 for a, b in zip(recs, recs[1:])]
    micro = 2 * QLORA_STEPS
    per_micro = {n: c / micro for n, c in counts.items()}
    expect = train_launch_expect(counts, L)
    lora = named_leaves(state.params["lora"], prefix="lora.")
    proj_mask = trainable_mask({"projector": state.params["projector"]}, "adapter")
    n_trainable = sum(t.numel() for t in lora.values()) + sum(
        t.numel() for t in named_leaves(state.params["projector"], proj_mask["projector"]).values())
    base_gb = param_bytes([t for p, t in named_leaves(state.params["text"]["layers"]).items()
                           if p.split(".")[-1] in ("w_int4", "scale4")]) / 1e9
    tokens = 2 * (TRAIN_ANSWER + 1)
    log("qlora", f"llm stage over an int4 (groups of 64) base, LoRA r 128 alpha 256, bf16, "
                 f"2048 bucket, remat, B 1 x accumulation 2, {QLORA_STEPS} steps in {wall:.1f} s "
                 f"(with the init): losses {losses}; grad norms "
                 f"{[r['train/grad_norm'] for r in recs]}")
    log("qlora", f"[{CARD}] step ms (synchronized, after the first) = "
                 f"{[round(t, 3) for t in step_ms]}, median {statistics.median(step_ms):.3f}; "
                 f"supervised tokens/s = {tokens / statistics.median(step_ms) * 1e3:.3f}; peak "
                 f"device memory = {peak / 1e9:.2f} GB; trainable = {n_trainable} "
                 f"({sum(t.numel() for t in lora.values())} LoRA); the int4 base "
                 f"(nibbles and group scales) = {base_gb:.3f} GB")
    log("qlora", f"launches per microbatch = {per_micro}; expected {expect}")
    if len(losses) != QLORA_STEPS or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"QLoRA losses not finite: {losses}")
    if per_micro != expect:
        raise RuntimeError(f"QLoRA launch counts {counts} over {micro} microbatches differ from "
                           f"the path's {expect} each")

    # the decoder (its int4 base too), the vision tower and the gate bitwise
    # as train() started; every LoRA B off zero in every layer
    after = named_leaves(state.params)
    changed = [p for p, t in frozen.items() if not torch.equal(after[p].cpu(), t)]
    unmoved = [p for p, t in lora.items() if p.endswith(".B")
               and not bool((t.flatten(1).abs().amax(1) > 0).all())]
    n_b = sum(p.endswith(".B") for p in lora)
    n_int4 = sum(p.endswith(".w_int4") for p in frozen)
    log("qlora", f"{len(frozen) - len(changed)} of {len(frozen)} frozen leaves (the decoder with "
                 f"its {n_int4} int4 leaves, the vision tower, the gate) bitwise as train() "
                 f"started; {n_b - len(unmoved)} of {n_b} LoRA B leaves off zero in every layer")
    del frozen
    if changed or unmoved or n_b != 7 or n_int4 != 7:
        raise RuntimeError(f"a frozen leaf changed or a LoRA B stayed zero: {changed[:8]} "
                           f"{unmoved}")
    ckpt = latest_checkpoint(str(QLORA_DIR))
    loaded, opt, meta = load_checkpoint(ckpt, dev)
    saved = named_leaves(loaded)
    same = all(torch.equal(t, after[p]) for p, t in saved.items())
    log("qlora", f"{Path(ckpt).name}: meta {meta}, {len(saved)} lora and projector leaves read "
                 f"back bitwise: {same}; optimizer state saved: {opt is not None}")
    if not (meta["lora_only"] and meta["step"] == QLORA_STEPS and same and opt is not None
            and set(saved) == {p for p in after if p.startswith(("lora.", "projector."))}):
        raise RuntimeError("the lora_only checkpoint does not read back")
    del state, after, loaded, saved, opt
    torch.cuda.empty_cache()

    resumed = []
    real_resume = run._resume

    def recording_resume(*a):
        resumed.append(real_resume(*a))
        return resumed[-1]

    run._resume = recording_resume
    t0 = time.perf_counter()
    try:
        state = run.train(*qlora_args(dev, QLORA_STEPS + 2, resume=True), dataset=ds, cfg=cfg)
    finally:
        run._resume = real_resume
    steps = [r["step"] for r in qlora_metrics()]
    log("qlora", f"resumed ({time.perf_counter() - t0:.1f} s with the init): at step "
                 f"{resumed[0].step if resumed else None} with the saved "
                 f"optimizer state (counts {resumed[0].opt_state['count'] if resumed else None}); "
                 f"logged steps {steps}")
    if (not resumed or resumed[0].step != QLORA_STEPS or state.step != QLORA_STEPS + 2
            or resumed[0].opt_state["count"] != {"base": QLORA_STEPS}
            or steps != list(range(1, QLORA_STEPS + 3))):
        raise RuntimeError("the QLoRA run did not resume from its lora_only checkpoint")
    del state, resumed
    shutil.rmtree(QLORA_DIR, ignore_errors=True)
    torch.cuda.empty_cache()

    # an int8 base
    reset_launches()
    t0 = time.perf_counter()
    state = run.train(*qlora_args(dev, 2, resume=False, bits=8), dataset=ds, cfg=cfg)
    torch.cuda.synchronize()
    int8_s = time.perf_counter() - t0
    counts8 = read_launches()
    recs8 = qlora_metrics()
    b_off = all(bool(t.any()) for p, t in named_leaves(state.params["lora"]).items()
                if p.endswith("B"))
    int8_gb = param_bytes([t for p, t in named_leaves(state.params["text"]["layers"]).items()
                           if p.split(".")[-1] in ("w_int8", "scale")]) / 1e9
    log("qlora", f"int8 base ({int8_gb:.3f} GB with its scales; {int8_s:.1f} s with the init): losses "
                 f"{[r['train/loss'] for r in recs8]}, step ms "
                 f"{(recs8[1]['ts'] - recs8[0]['ts']) * 1e3:.3f}; every LoRA B off zero: {b_off}; "
                 f"launches {counts8}")
    if (counts8 != {n: c * 2 * 2 for n, c in train_launch_expect(counts8, L).items()}
            or not b_off or not all(math.isfinite(r["train/loss"]) for r in recs8)):
        raise RuntimeError("QLoRA over the int8 base did not train through the kernels")
    del state
    shutil.rmtree(QLORA_DIR, ignore_errors=True)
    torch.cuda.empty_cache()

    # --model-path (a released full-SFT directory) + --pretrain-mm-mlp-adapter
    cfg2 = cfg.replace(text=dataclasses.replace(cfg.text, num_layers=CKPT_TEXT_LAYERS))
    path = CKPT_DIR / "StreamMind-7B-text2"
    adapter = CKPT_DIR / "mm_projector.bin"
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        tree = init_streammind_params(torch.Generator(device=dev).manual_seed(31), cfg2,
                                      device=dev, dtype=torch.bfloat16)
        write_checkpoint(tree, cfg2, path)
        # the adapter file's projector differs from the directory's, so the
        # start shows which one train() kept
        save_mm_projector_bin(tree_map(lambda t: t * 0.5, tree["projector"]), str(adapter))
        del tree
        want = convert_streammind_checkpoint(str(path), cfg2, torch.bfloat16)
        want["projector"].update(convert_projector(load_state_dict(str(adapter)), cfg2,
                                                   torch.bfloat16))
        want = tree_map(lambda t: t.to(dev), want)
        want["text"] = quantize_text_params(want["text"], bits=8, free_source=True)
        starts = []

        def recording(params, *a):
            starts.append(bitwise_differences(params, want))
            return real_init(params, *a)

        run.init_train_state = recording
        reset_launches()
        try:
            state = run.train(*qlora_args(dev, 2, resume=False, bits=8, stage="adapter",
                                          model_path=str(path),
                                          pretrain_mm_mlp_adapter=str(adapter)), dataset=ds)
        finally:
            run.init_train_state = real_init
        torch.cuda.synchronize()
        counts_mp = read_launches()
        recs_mp = qlora_metrics()
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        shutil.rmtree(QLORA_DIR, ignore_errors=True)
    n_leaves = len(named_leaves(want))
    del want, state
    torch.cuda.empty_cache()
    log("qlora", f"--model-path ({CKPT_TEXT_LAYERS}-layer full-SFT .bin, "
                 f"{time.perf_counter() - t0:.1f} s with writing it) + "
                 f"--pretrain-mm-mlp-adapter, int8 base, adapter stage: the starting tree's "
                 f"leaves that differ from convert_streammind_checkpoint + convert_projector + "
                 f"quantize_text_params(bits=8): {starts[0] if starts else None} of {n_leaves}; "
                 f"losses {[r['train/loss'] for r in recs_mp]}; launches {counts_mp}")
    if (starts != [[]] or not all(math.isfinite(r["train/loss"]) for r in recs_mp)
            or counts_mp != {n: c * 2 * 2 for n, c in
                             train_launch_expect(counts_mp, CKPT_TEXT_LAYERS).items()}):
        raise RuntimeError("train() from --model-path did not start from the checkpoint's tree "
                           "or did not train through the kernels")
    return dict(step_ms_median=statistics.median(step_ms), losses=losses, peak_gb=peak / 1e9,
                launches=counts, launches_per_microbatch=per_micro, trainable=n_trainable,
                base_gb=base_gb, int8_base_gb=int8_gb)


QLORA_PARITY_R = 128


def qlora_parity(dev, base):
    """The QLoRA loss, every LoRA and projector gradient and two optimizer
    steps in fp32 over an int4 base (parity depths, features in) through the
    plain versions on the CPU and the kernels on the card (TF32 off), then
    on the card with TF32 on as the control.  ``base`` is ``parity_tree()``,
    whose decoder is quantized here into a new tree.  LoRA B starts off zero
    here, so that A has a gradient too."""
    from streammind_torch.train.lora import attach_lora, init_lora_params
    from streammind_torch.train.objectives import stage1_llm_loss
    from streammind_torch.train.run import make_microbatch
    from streammind_torch.train.trainer import (
        cosine_schedule, global_norm, init_train_state, make_grad_step, make_optimizer,
        make_train_step, named_leaves, trainable_mask)
    from streammind_torch.utils.params import tree_map
    from streammind_torch.utils.quantize import quantize_text_params

    cfg = parity_config()
    params = {**base, "text": quantize_text_params(base["text"], bits=4)}
    g = torch.Generator().manual_seed(8)
    params["lora"] = init_lora_params(g, params["text"], r=QLORA_PARITY_R)
    for p, t in named_leaves(params["lora"]).items():
        if p.endswith("B"):
            t.normal_(0.0, 0.02, generator=g)
    scale = 256 / QLORA_PARITY_R
    sample = MatchTimeShaped([200], frames=16, seed=9).samples[0]   # splices into 256

    def loss_fn(p, b):
        eff = {**p, "text": attach_lora(p["text"], p["lora"], scale)}
        return stage1_llm_loss(eff, cfg, b["frames"], b["token_ids"], b["mem_index"],
                               b["use_mem"], b["attn_mask"], b["labels"], remat=True,
                               attn_impl="flash!")

    out = {}
    for name, where, tf32 in (("cpu", "cpu", False), ("card", dev, False),
                              ("card_tf32", dev, True)):
        with tf32_matmuls(tf32):
            t0 = time.perf_counter()
            p = tree_map(lambda t: t.to(where, copy=True), params)
            mask = trainable_mask({k: v for k, v in p.items() if k != "lora"}, "adapter")
            mask["lora"] = tree_map(lambda _: True, p["lora"])
            opt = make_optimizer(cosine_schedule(1e-4, 2))
            state = init_train_state(p, opt, mask)
            _, batch = make_microbatch([sample], cfg, p["vision"], "llm", pad_to=1)
            reset_launches()
            loss, grads = make_grad_step(loss_fn, mask)(p, batch)
            step = make_train_step(loss_fn, opt, mask)
            for _ in range(2):
                state, _ = step(state, batch)
            counts = read_launches()
            out[name] = dict(loss=float(loss), gnorm=float(global_norm(grads.values())),
                             grads={k: v.cpu() for k, v in grads.items()},
                             params={k: t.detach().cpu() for k, t in named_leaves(p, mask).items()})
            log("qlora-parity", f"{name}: loss {out[name]['loss']:.7f}, grad norm "
                                f"{out[name]['gnorm']:.7f}, {time.perf_counter() - t0:.1f} s, "
                                f"launches {counts}")
            if where != "cpu":
                if counts != {n: 3 * c for n, c in
                              train_launch_expect(counts, cfg.text.num_layers).items()
                              } | {f"{n}_tc": 0 for n in TRAIN_KERNELS}:
                    raise RuntimeError(f"the card's run did not take the training kernels alone: "
                                       f"{counts}")
                fp32_only(counts, "qlora-parity")
            del p, state, grads, batch

    def errs(o):
        # as training_parity's: params compared where |grad| >= 1e-3 of the
        # leaf's largest (Adam steps an element by ~lr whatever its size)
        c = out["cpu"]
        firm = {k: v.abs() >= 1e-3 * v.abs().max() for k, v in c["grads"].items()}
        return {"loss": abs(o["loss"] - c["loss"]),
                "grad_norm": abs(o["gnorm"] - c["gnorm"]) / c["gnorm"],
                "grads": max(float((o["grads"][k] - v).abs().max() / v.abs().max().clamp(min=1e-30))
                             for k, v in c["grads"].items()),
                "params": max(float((o["params"][k] - t)[firm[k]].abs().max())
                              for k, t in c["params"].items()),
                "params_all": max(float((o["params"][k] - t).abs().max())
                                  for k, t in c["params"].items())}

    tol = QLORA_PARITY_TOL
    got, control = errs(out["card"]), errs(out["card_tf32"])
    log("qlora-parity", f"int4 base, LoRA r {QLORA_PARITY_R}, text 2 / gate 2 layers at "
                        f"published widths, fp32, TF32 off: |cpu - card| = {got} (loss abs, grad "
                        f"norm rel, worst leaf's grad max err / its max |grad|, params after 2 "
                        f"steps (lr 1e-4) abs where |grad| >= 1e-3 of the leaf's max, and over "
                        f"all), limits {tol}")
    log("qlora-parity", f"control, TF32 on: {control}; over the limits: "
                        f"{[k for k in tol if control[k] > tol[k]]}")
    if any(got[k] > tol[k] for k in tol):
        raise RuntimeError("QLoRA on the CPU (plain versions) and the card (kernels) disagree")
    if not any(control[k] > tol[k] for k in tol):
        raise RuntimeError("the QLoRA parity limits do not see TF32 matmuls on the card")
    return got


# training_parity's limits: 4-7 times the errors measured here on an H100 with
# TF32 off (loss 0, grad norm 2.3e-7, grads 1.17e-5, params 4.8e-7)
QLORA_PARITY_TOL = {"loss": 2e-5, "grad_norm": 1e-6, "grads": 8e-5, "params": 2.4e-6}


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


def hf_text_state_dict(t, prefix: str = "model.") -> dict:
    """A decoder tree (unfused, unquantized) under HF Mistral's names."""
    sd = {prefix + "embed_tokens.weight": t["embed_tokens"],
          prefix + "norm.weight": t["final_norm"]["weight"]}
    if "lm_head" in t:
        sd["lm_head.weight"] = t["lm_head"]["weight"]
    names = {"input_norm": "input_layernorm", "post_norm": "post_attention_layernorm",
             "q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
             "o": "self_attn.o_proj"}
    for i in range(t["layers"]["q"]["weight"].shape[0]):
        for ours, theirs in names.items():
            sd[f"{prefix}layers.{i}.{theirs}.weight"] = t["layers"][ours]["weight"][i]
        for p in ("gate", "up", "down"):
            sd[f"{prefix}layers.{i}.mlp.{p}_proj.weight"] = t["layers"]["mlp"][p]["weight"][i]
    return sd


def full_sft_state_dict(tree, cfg) -> dict:
    """A StreamMind param tree under the released full-SFT key names (HF
    Mistral, the mm_projector where the tree has the mamba projector, HF
    CLIP under the vision tower), as CPU copies; CLIP's post_layernorm,
    which the model does not read, as ones and zeros."""
    from streammind_torch.utils.checkpoint import export_projector_torch_sd

    sd = hf_text_state_dict(tree["text"])
    if "projector" in tree:
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


def check_against_manifest(sd: dict, text_layers: int, projector: bool = True):
    """The key names and shapes of ``sd`` must be the released full-SFT
    manifest's, the decoder's layers cut to ``text_layers`` (and without
    the mamba projector's keys where ``projector`` is False)."""
    import re

    with open(MANIFEST) as f:
        manifest = json.load(f)
    want = {k: s for k, s in manifest.items()
            if (not (m := re.match(r"model\.layers\.(\d+)\.", k)) or int(m.group(1)) < text_layers)
            and (projector or not k.startswith("model.mm_projector."))}
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
    run through the int4 kernel.  The checkpoint directory stays for the
    real_weights phase, which removes it (it is removed here where this
    phase fails).  Returns (the model, the tokenizer, its video processor,
    the numbers)."""
    from streammind_torch import api
    from streammind_torch.config import StreamMindConfig
    from streammind_torch.models.meta import init_streammind_params
    from streammind_torch.models.mistral import fuse_text_linears
    from streammind_torch.models.vit import fuse_vit_qkv
    from streammind_torch.utils.params import flatten_with_paths, param_count
    from streammind_torch.utils.quantize import quantize_text_params

    base = StreamMindConfig()
    tok = StandInTokenizer()
    model, processor, _, version = api.model_init(params=engine.params, cfg=base, tokenizer=tok,
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
    except BaseException:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        raise
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
    return model, tok, processor, dict(full=full, ckpt=ckpt, launches=counts)


RW_TOL = 2e-4          # the tool's --tol: relative rms of the fp32 features and logits
RW_CAPTION_NEW = 32    # the tool's --max-new-tokens default
# fp32 flash (the CUDA-core instantiation) against its plain version, the
# fp32 limit of tests/test_torch_kernels_gpu.py
FLASH_FP32_TOL = (1e-4, 1e-4)
FLASH_FP32_TOL_TEXT = "|err| <= 1e-4 + 1e-4*|ref| (fp32 output)"


def real_weights_phase(dev, g):
    """The released-checkpoint smoke tool (``streammind_torch/tools/
    real_weights_smoke.py``) on the api phase's checkpoint directory
    (StreamMind-7B's widths, ViT-L/14-336 whole, the decoder cut to
    CKPT_TEXT_LAYERS): loaded in fp32 on the card by the tool's loader, its
    port-side functions run on the card with TF32 off and the stand-in
    tokenizer — config 1's features and caption, config 2's logits and
    8-frame open-ended QA (flash at each prefill's fp32 bucket, one scan a
    Mamba layer a clip); the features and logits held against the same
    functions on this machine's CPU within the tool's RW_TOL (a check that
    needs no ``transformers``); flash and the scan held against their
    plain versions at the phase's own shapes; then the tool's CLI as a
    subprocess, which must exit non-zero naming ``transformers`` where that
    is missing and print OK (the card against the mirrors on the CPU) where
    it is installed.  Removes the checkpoint directory."""
    import importlib.metadata
    import importlib.util

    from streammind_torch.api import StreamMindModel
    from streammind_torch.tools import real_weights_smoke as rws
    from streammind_torch.utils.params import tree_map

    path = CKPT_DIR / "StreamMind-7B-text2"
    tok = StandInTokenizer()
    try:
        with rws.fp32_matmuls():
            torch.cuda.synchronize()
            (model, _, _, version), load_ms, _ = timed(lambda: rws.load_model(
                str(path), device=dev, tokenizer=tok))
            cfg = model.cfg
            size, L2, n_mamba = cfg.vision.image_size, cfg.text.num_layers, cfg.mamba.n_layers
            rng = np.random.default_rng(0)  # the tool's inputs, drawn in its order
            pixels = rng.standard_normal((1, 3, size, size)).astype(np.float32)
            video = rng.standard_normal((8, 3, size, size)).astype(np.float32)
            ids = list(range(1, 17))
            prefills = []  # (bucket, cache rows) of each prefill, for the kernel cases
            real_prefill = model.engine.prefill

            def recording(plan, memory, cache):
                prefills.append((len(plan.token_ids), cache.k.shape[2]))
                return real_prefill(plan, memory, cache)

            model.engine.prefill = recording
            reset_launches()
            feats, feat_ms, _ = timed(lambda: rws.vision_features(model, pixels))
            text, caption_ms, caption_fw = timed(lambda: rws.caption(
                model, pixels, tok, version, RW_CAPTION_NEW))
            logits, logits_ms, _ = timed(lambda: rws.decoder_logits(model, ids))
            answer, qa_ms, qa_fw = timed(lambda: rws.video_qa(model, video, tok, version))
            counts = read_launches()
            model.engine.prefill = real_prefill
            cpu = StreamMindModel(params={k: tree_map(lambda t: t.cpu(), model.params[k])
                                          for k in ("vision", "text")}, cfg=cfg, engine=None)
            t0 = time.perf_counter()
            cpu_feats = rws.vision_features(cpu, pixels)
            cpu_logits = rws.decoder_logits(cpu, ids)
            cpu_ms = (time.perf_counter() - t0) * 1e3
        del cpu
        deltas = {"vit_feature_rms": rws._rms(feats, cpu_feats),
                  "decoder_logits_rms": rws._rms(logits, cpu_logits)}
        n_patches = (size // cfg.vision.patch_size) ** 2
        problems = []
        if feats.shape != (1, n_patches, cfg.vision.hidden_size) or not np.isfinite(feats).all():
            problems.append(f"features {feats.shape}, finite {np.isfinite(feats).all()}")
        if logits.shape != (len(ids), cfg.text.vocab_size) or not np.isfinite(logits).all():
            problems.append(f"logits {logits.shape}, finite {np.isfinite(logits).all()}")
        if not all(isinstance(t, str) for t in (text, answer)):
            problems.append(f"caption {text!r} / answer {answer!r} are not strings")
        if caption_fw > RW_CAPTION_NEW or len(prefills) != 2:
            problems.append(f"{caption_fw} caption forwards, {len(prefills)} prefills")
        over = {k: v for k, v in deltas.items() if not v <= RW_TOL}
        if over:
            problems.append(f"card vs CPU deltas over {RW_TOL}: {over}")
        log("real_weights", f"[{CARD}] checkpoint {path.name} loaded in fp32 by the tool's "
                            f"loader in {load_ms:.1f} ms (version {version}); ViT features "
                            f"{feat_ms:.3f} ms, prefill logits of {len(ids)} ids "
                            f"{logits_ms:.3f} ms on the card, both {cpu_ms:.1f} ms on the CPU")
        log("real_weights", f"card vs this machine's CPU, the same functions (the CLI below "
                            f"holds the card against the transformers mirrors where they "
                            f"are installed), TF32 off: vit_feature_rms "
                            f"{deltas['vit_feature_rms']:.3e}, decoder_logits_rms "
                            f"{deltas['decoder_logits_rms']:.3e} (tol {RW_TOL})")
        log("real_weights", f"[{CARD}] config 1 caption: {caption_ms:.3f} ms wall, "
                            f"{caption_fw} decode forwards: {text[:80]!r}")
        log("real_weights", f"[{CARD}] config 2 8-frame QA: {qa_ms:.3f} ms wall, {qa_fw} decode "
                            f"forwards ({qa_ms / max(qa_fw, 1):.3f} ms a forward, prefill "
                            f"included): {answer[:80]!r}")
        expect = {n: 0 for n in counts}
        expect.update(flash_attention=2 * L2, selective_scan=2 * n_mamba)
        log("real_weights", f"launches={counts} expected={expect} (prefills at (bucket, cache "
                            f"rows) {prefills})")
        fp32_only(counts, "real_weights")
        check_counts("real_weights", counts, expect)
        if problems:
            raise RuntimeError("real_weights: " + "; ".join(problems))

        # the kernels at the phase's own shapes: flash at each prefill's fp32
        # bucket over its cache, the scan at the 1- and 8-frame clips
        def randn(*shape, std=1.0):
            return torch.empty(shape, device=dev, dtype=torch.float32).normal_(
                0.0, std, generator=g)

        h, hkv = cfg.text.num_heads, cfg.text.num_kv_heads
        flash = []
        for bucket, rows in prefills:
            flash += flash_cases(dev, randn, ((bucket, [0], [bucket], h, hkv),),
                                 tag=" fp32 (real_weights)", cap=rows, tol=FLASH_FP32_TOL)
        scan = scan_cases(dev, g, cases=((torch.float32, 1, 1, False, "time"),
                                         (torch.float32, 1, 8, False, "time")),
                          d=cfg.mamba.d_inner)
        for c in flash:
            c["tolerance"] = FLASH_FP32_TOL_TEXT
        for c in scan:
            c["tolerance"] = "y " + tol_text(SCAN_TOL[torch.float32], "fp32")
        cases = report_cases({"flash_attention": (flash, FLASH_FP32_TOL_TEXT),
                              "selective_scan": (scan, scan[0]["tolerance"])})
        del model
        gc.collect()
        torch.cuda.empty_cache()

        # the CLI, as a user runs it
        has_tf = importlib.util.find_spec("transformers") is not None
        tf_version = importlib.metadata.version("transformers") if has_tf else "missing"
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "streammind_torch.tools.real_weights_smoke",
                            "--model-path", str(path)], capture_output=True, text=True,
                           cwd=str(Path(__file__).resolve().parent), timeout=600)
        cli_s = time.perf_counter() - t0
        tail = (r.stdout + r.stderr).strip().splitlines()[-3:]
        if has_tf and (r.returncode != 0 or "OK: all deltas within tol" not in r.stdout):
            raise RuntimeError(f"real_weights CLI failed with transformers installed: {tail}")
        if not has_tf and (r.returncode == 0 or "transformers" not in r.stderr
                           or "OK" in r.stdout):
            raise RuntimeError(f"real_weights CLI without transformers: exit {r.returncode}, "
                               f"{tail}")
        cli_deltas = next((json.loads(line)["deltas"] for line in r.stdout.splitlines()
                           if line.startswith('{"deltas"')), None)
        log("real_weights", f"[{CARD}] CLI (transformers {tf_version}): exit {r.returncode} in "
                            f"{cli_s:.1f} s; against the mirrors: {cli_deltas}; {tail}")
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return dict(launches=counts, deltas=deltas, load_ms=load_ms, caption_ms=caption_ms,
                qa_ms=qa_ms, qa_forwards=qa_fw, cli_exit=r.returncode, cli_deltas=cli_deltas,
                kernels={n: cs for n, (cs, _) in cases.items()})


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
    pixels = api.engine_pixels(model.engine, video)
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
        with tf32_matmuls(tf32):
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


# ---------------------------------------------------------------------------
# phases 14-15: from a video file to a benchmark score (the native ingest,
# the datasets, the eval runners)
# ---------------------------------------------------------------------------
EVAL_DIR = Path(__file__).resolve().parent / "_smoke_eval"
INGEST_FRAMES = 64       # the ingest check: one clip at 224x160, read at 336
EXTRACT_FRAMES = 72      # one synthetic half-video at 2 fps (36 s): two ViT batches
EXTRACT_WINDOW = (41, 61)  # the frames of the MatchTime sample at 30 s (from 20 s)
EXTRACT_BATCH = 64       # run_extract's default batch
GATE_FRAMES = 61         # each of two half-videos at 2 fps; the stream reads 60
GATE_FIRES = 4           # the threshold lets the gate fire on the 4 likeliest frames
GATE_NEW = 16            # new tokens a gate-stream turn
EGO_TURNS = 6            # narrations every 5 s: 60 frames, one <video> slot a turn
LTA_FRAMES, LTA_BEAMS, LTA_NEW = 32, 5, 16
MCQA_FRAMES = 8          # run_mcqa's default frames a question
MCQA_NEW = 32            # tokens an MCQA or OQA question decodes before its stop string
EVAL_PARITY_FRAMES = 8   # frames of each parity half-video
# the fp32 Ego4D llm evaluation, CPU against the card: lm_ppl |cpu - card| /
# cpu and max |logits| difference, about ten times the errors measured on an
# H100 80GB HBM3 at 700 W with TF32 off (3.2e-7, 2.3e-5); the TF32-on control
# crossed both (5.0e-4, 1.2e-2)
EVAL_PARITY_TOL = {"lm_ppl": 3e-6, "logits": 2e-4}


def ingest_libraries_missing() -> list:
    """What the native ingest's build needs and the machine lacks: a C++
    compiler, each of libav's four headers (under the standard include
    paths, or where pkg-config says) and each of its four libraries (where
    the dynamic loader finds them)."""
    import ctypes.util
    import os

    missing = [] if shutil.which(os.environ.get("CXX") or "g++") else ["g++"]
    includes = ["/usr/include", "/usr/local/include", "/usr/include/x86_64-linux-gnu"]
    if shutil.which("pkg-config"):
        flags = subprocess.run(["pkg-config", "--cflags-only-I", "libavformat"],
                               capture_output=True, text=True, timeout=60).stdout
        includes += [f[2:] for f in flags.split()]
    for lib in ("libavformat", "libavcodec", "libavutil", "libswscale"):
        header = f"{lib}/{lib[3:]}.h"
        if not any(Path(d, header).exists() for d in includes):
            missing.append(header)
        if ctypes.util.find_library(lib[3:]) is None:
            missing.append(f"{lib}.so")
    return missing


def seeded_pixels(n: int, seed: int, dev) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.empty((n, 3, 336, 336), device=dev, dtype=torch.bfloat16).normal_(generator=g)


def write_matchtime_tree(root: Path, match: str, halves: dict, captions: list) -> list:
    """features_video/smoke/<match>/{half}_224p.mkv (2 fps clips of the frame
    counts ``halves`` gives, written by the native ingest where its library
    is built, else empty files for a seeded frame loader) and
    the Labels-caption.json the MatchTime paths map them to.  Returns the
    half-video paths."""
    from streammind_torch import native

    feat = root / "features_video" / "smoke" / match
    lab = root / "dataset" / "MatchTime" / "train" / "smoke" / match
    feat.mkdir(parents=True, exist_ok=True)
    lab.mkdir(parents=True, exist_ok=True)
    (lab / "Labels-caption.json").write_text(json.dumps({"annotations": [
        {"gameTime": f"{h} - {t // 60:02d}:{t % 60:02d}", "anonymized": c}
        for h, t, c in captions]}))
    paths = []
    for half, frames in halves.items():
        path = feat / f"{half}_224p.mkv"
        if native.available():  # the halves differ in size, so their frames differ
            native.write_test_video(str(path), 256 - 32 * half, 160, frames, 2)
        else:
            path.write_bytes(b"")  # the frames come from a seeded loader
        paths.append(str(path))
    return paths


class TimedModel:
    """``model.new_session`` for ``evaluate_gate_stream``: a StreamSession
    whose ``process_frame`` is timed (synchronized) frame by frame."""

    def __init__(self, model):
        from streammind_torch.streaming.engine import StreamSession

        log_ = self.frames = []

        class Session(StreamSession):
            def process_frame(self, pixels, force_fire=False):
                t0 = sync()
                out = super().process_frame(pixels, force_fire)
                log_.append(((sync() - t0) * 1e3, out is not None))
                return out

        self.new_session = lambda tok, **kw: Session(model.engine, tok, **kw)


def gate_threshold(model, videos, frame_loader, fires: int):
    """A gate threshold between the ``fires``-th and the next likeliest frame
    of ``videos`` (their gate probabilities from a first pass of perception
    alone, frames read as the gate stream reads them), and the fire times
    (seconds) it gives each video."""
    from streammind_torch.eval.run_gate_stream import stream_video_fire_times

    class Probe:  # perception only; answers every frame, so every time is listed
        engine = model.engine

        def __init__(self):
            self.state, self.p = model.engine.new_stream_state(), []

        def process_frame(self, pixels):
            p, self.state = model.engine.perceive_step(pixels, self.state)
            self.p.append(float(p[1]))
            return self.p[-1]

    seen = {}
    for v in videos:
        probe = Probe()
        seen[v] = list(zip(stream_video_fire_times(probe, v, frame_loader=frame_loader), probe.p))
    ranked = sorted((p for tp in seen.values() for _, p in tp), reverse=True)
    threshold = (ranked[fires - 1] + ranked[fires]) / 2
    if not ranked[fires - 1] > threshold:
        raise RuntimeError(f"the gate's probabilities do not vary: {ranked[:fires + 1]}")
    return threshold, {v: [float(t) for t, p in tp if p > threshold] for v, tp in seen.items()}


def eval_phase(model, tok, processor, dev):
    """The offline data and eval path on the api phase's model (StreamMind-7B
    bf16, exact ViT attention, the int4 gate): the native ingest (built from
    native/ingest.cpp, or reported unavailable where libav is missing);
    ``extract_video_features`` through run_extract's encode function over a
    72-frame half-video, read back into ``MatchTimeDataset`` through the
    shard loader; ``evaluate_gate_stream`` over two half-videos; the Ego4D
    ``llm`` and ``cls`` evaluations; LTA beams and ``score_lta``; MCQA
    through ``run_mcqa.run_inference`` and ``score_answers``, each question
    ended after ``MCQA_NEW`` tokens by a stop string of the id a first,
    uncounted pass saw it emit there; OQA through ``x_infer``, ended the
    same way, and ``judge_predictions`` with a stub judge.  Launch counts
    asserted exactly.  Returns the numbers."""
    from streammind_torch import api, native
    from streammind_torch.data import MatchTimeDataset
    from streammind_torch.data.ego4d import Ego4dNarrationDataset
    from streammind_torch.data.extract import (
        extract_video_features, load_feature_window, make_shard_frame_loader, shard_path)
    from streammind_torch.data.run_extract import make_encode_fn
    from streammind_torch.eval import gpt_judge, run_ego4d_lta, run_ego4d_stream, run_mcqa
    from streammind_torch.eval.run_gate_stream import evaluate_gate_stream
    from streammind_torch.models.meta import bucket_length

    cfg = model.cfg
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    EVAL_DIR.mkdir(parents=True)
    out = {}
    try:
        # -- the ingest --------------------------------------------------------
        missing = ingest_libraries_missing()
        if missing:
            print(f"ingest: unavailable ({', '.join(missing)})", flush=True)
        else:
            t0 = time.perf_counter()
            lib = native.build()
            if not native.available():
                raise RuntimeError(f"the ingest library {lib.name} was built but does not load")
            log("eval", f"ingest: {lib.name} built from native/ingest.cpp in "
                        f"{time.perf_counter() - t0:.1f} s ({' '.join(native.CXX_FLAGS)})")
            clip = str(EVAL_DIR / "ingest.mp4")
            native.write_test_video(clip, 224, 160, INGEST_FRAMES, 10)
            with native.NativeVideoReader(clip) as vr:
                t0 = time.perf_counter()
                # the container's frame count may overestimate by one: short tail accepted
                frames = vr.read(list(range(vr.num_frames)), size=336, strict=False)
                read_s = time.perf_counter() - t0
                info = (vr.num_frames, vr.fps, vr.width, vr.height)
            if (frames.shape[1:] != (3, 336, 336) or len(frames) < INGEST_FRAMES - 2
                    or not np.isfinite(frames).all() or info[2:] != (224, 160)):
                raise RuntimeError(f"ingest read {frames.shape} from a {info} clip")
            out["ingest_fps"] = len(frames) / read_s
            log("eval", f"[{CARD}] ingest: {len(frames)} frames of a 224x160 MPEG-4 clip decoded, "
                        f"letterboxed to 336 and normalized in {read_s * 1e3:.3f} ms = "
                        f"{out['ingest_fps']:.1f} frames/s (one host thread)")
        ingest = not missing
        # the gate stream's half-videos and its threshold (a first pass of
        # perception alone, before the counts start)
        videos = write_matchtime_tree(EVAL_DIR, "gate", {1: GATE_FRAMES, 2: GATE_FRAMES}, [
            (1, 10, "a pass"), (1, 20, "a shot"), (2, 5, "a corner"), (2, 25, "a goal")])

        def seeded_stream(path, cur_fps):
            pixels = seeded_pixels(GATE_FRAMES - 1, 40 + int(Path(path).name[0]), dev)
            return [(i / cur_fps, pixels[i:i + 1]) for i in range(len(pixels))]

        loader = None if ingest else seeded_stream
        threshold, want = gate_threshold(model, videos, loader, GATE_FIRES)

        # the clips of LTA, MCQA and OQA, and what each MCQA question and the
        # OQA question emit first: a pass that stops the decode once it has
        # fed MCQA_NEW ids
        clips = EVAL_DIR / "clips"
        clips.mkdir()
        if ingest:
            for name in ("a.mp4", "b.mp4"):
                native.write_test_video(str(clips / name), 224, 160, 64, 10)
            read_clip = processor
        else:
            def read_clip(path, num_frames=8):
                return seeded_pixels(num_frames, 60 + len(Path(path).name), dev)

        records = [
            {"q_uid": "a", "question": "What is shown?",
             "options": ["bars", "noise", "text", "faces", "maps"], "answer": 0},
            {"q_uid": "b", "question": "What happens next?",
             "options": ["a pan", "a cut", "a zoom", "nothing", "a fade"], "answer": 3}]
        first_ids = []
        for rec in records:
            with DecodeCounter(limit=MCQA_NEW) as probe:
                try:
                    list(run_mcqa.run_inference(model, tok, [rec], "egoschema", str(clips),
                                                read_clip, num_frames=MCQA_FRAMES))
                except DecodeCounter.Enough:
                    pass
            if len(probe.ids) != MCQA_NEW:
                raise RuntimeError(f"MCQA {rec['q_uid']}: the decode ended after {probe.ids}")
            first_ids.append(probe.ids)
        oqa_clip = read_clip(str(clips / "b.mp4"), num_frames=MCQA_FRAMES)
        with DecodeCounter(limit=MCQA_NEW) as probe:
            try:
                api.x_infer(oqa_clip, "What is moving?", model, tok, mode="openend")
            except DecodeCounter.Enough:
                pass
        oqa_ids = probe.ids
        if len(oqa_ids) != MCQA_NEW:
            raise RuntimeError(f"OQA: the decode ended after {oqa_ids}")
        torch.cuda.synchronize()
        reset_launches()

        # -- extract: run_extract's encode function, read back into MatchTime ----
        vit_ms = []
        encode = make_encode_fn(model.params["vision"], cfg.vision, batch=EXTRACT_BATCH,
                                device=dev)

        def timed_encode(pixels):
            t0 = sync()
            feats = encode(pixels)
            vit_ms.append((sync() - t0) * 1e3)
            return feats

        (half_video,) = write_matchtime_tree(EVAL_DIR, "extract", {1: EXTRACT_FRAMES}, [
            (1, 10, "a pass"), (1, 20, "a shot"), (1, 30, "a goal")])
        t0 = time.perf_counter()
        if ingest:
            shards = extract_video_features(half_video, timed_encode, half=1)
        else:
            feats = timed_encode(seeded_pixels(EXTRACT_FRAMES, 30, dev).float().cpu().numpy())
            shards = [shard_path(half_video, 1, 0, 500)]
            Path(shards[0]).parent.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(shards[0], features=feats)
            log("eval", "extract: seeded pixels (no ingest) through the same encode function")
        extract_s = time.perf_counter() - t0
        stored = np.load(shards[0])["features"]
        ds = MatchTimeDataset(str(EVAL_DIR / "features_video"), tok,
                              frame_loader=make_shard_frame_loader(video_fps=2.0, cur_fps=2.0))
        sample = ds[len(ds) - 1]  # the caption at 30 s
        lo, hi = EXTRACT_WINDOW
        window = load_feature_window(half_video, 1, lo, hi)
        n_patches = (cfg.vision.image_size // cfg.vision.patch_size) ** 2
        if (stored.shape[1:] != (n_patches, cfg.vision.hidden_size)
                or not hi <= len(stored) <= EXTRACT_FRAMES
                or stored.dtype != np.float16
                or not np.isfinite(stored).all() or sample["timestamp"] != 30
                or not np.array_equal(sample["video"], stored[lo:hi])
                or not np.array_equal(window, stored[lo:hi])):
            raise RuntimeError(f"extract: shard {stored.shape} {stored.dtype}, sample at "
                               f"{sample['timestamp']} s with video {sample['video'].shape}")
        out["extract_fps"] = len(stored) / extract_s
        log("eval", f"[{CARD}] extract: {len(stored)} frames -> {len(shards)} fp16 shard(s) "
                    f"{stored.shape} in {extract_s * 1e3:.1f} ms = {out['extract_fps']:.1f} "
                    f"frames/s (decode, ViT bf16 in batches of {EXTRACT_BATCH} "
                    f"{sum(vit_ms):.1f} ms, npz compression); MatchTimeDataset sample at 30 s "
                    f"holds the shard's frames [{lo}, {hi}) byte for byte")

        # -- the gate stream ---------------------------------------------------
        timed_model = TimedModel(model)
        t0 = sync()
        summary, per_video = evaluate_gate_stream(
            timed_model, tok, videos, frame_loader=loader,
            session_kw=dict(gate_threshold=threshold, max_new_tokens=GATE_NEW))
        gate_s = sync() - t0
        fires = {r["video"]: [float(t) for t in r["fires"]] for r in per_video}
        frames = timed_model.frames
        silent = [ms for ms, fired in frames if not fired]
        turns = [ms for ms, fired in frames if fired]
        n_fires = len(turns)
        out.update(gate_frames=len(frames), gate_fires=n_fires,
                   gate_ms_silent=statistics.median(silent), gate_ms_turn=statistics.median(turns))
        log("eval", f"gate stream: {len(frames)} frames over 2 half-videos ("
                    f"{'native ingest' if ingest else 'seeded frames'}), threshold "
                    f"{threshold:.6f}, fires {fires}; summary {summary}")
        log("eval", f"[{CARD}] gate stream: median {out['gate_ms_silent']:.3f} ms a silent "
                    f"frame (process_frame), {out['gate_ms_turn']:.3f} ms a frame that fires "
                    f"(perception, prefill, {GATE_NEW} tokens); {gate_s * 1e3 / len(frames):.3f} "
                    f"ms a frame in all, reading included")
        if fires != want or set(summary) != {f"{m}@{t}" for m in ("precision", "recall", "f1")
                                             for t in (5, 10, 1)}:
            raise RuntimeError(f"gate stream fired at {fires}, its probabilities say {want}")

        # -- Ego4D: llm and cls ------------------------------------------------
        anno = EVAL_DIR / "ego4d.json"
        anno.write_text(json.dumps({"smoke": [[5.0 * (i + 1), f"You take step {i}."]
                                              for i in range(EGO_TURNS)]}))

        def ego_frames(path, start, end):
            return seeded_pixels(int(round((end - start) * 2)), 50, dev)

        ego = {kind: Ego4dNarrationDataset(str(EVAL_DIR), str(anno), tok, model_type=kind,
                                           frame_loader=ego_frames) for kind in ("llm", "cls")}
        s0 = ego["llm"][0]
        n_tok = s0["input_ids"].shape[1] - len(s0["span_frames"]) + s0["video"].shape[0]
        bucket = bucket_length(n_tok, (256, 512, 1024, 2048, 4096))
        t0 = sync()
        llm = run_ego4d_stream.evaluate_llm(model, tok, ego["llm"], [0],
                                            str(EVAL_DIR / "ego4d.csv"))
        llm_ms = (sync() - t0) * 1e3
        t0 = sync()
        cls = run_ego4d_stream.evaluate_cls(model, ego["cls"], [0])
        cls_ms = (sync() - t0) * 1e3
        out.update(ego_llm=llm, ego_cls=cls, ego_llm_ms=llm_ms, ego_cls_ms=cls_ms)
        log("eval", f"[{CARD}] Ego4D llm: {s0['video'].shape[0]} frames, {EGO_TURNS} turns, "
                    f"{n_tok} tokens in the {bucket} bucket, {llm_ms:.1f} ms: lm_ppl "
                    f"{llm['lm_ppl']:.3f}, lm_correctness {llm['lm_correctness']:.4f}, NLG "
                    f"(fallback scorer) {llm['nlg']}")
        log("eval", f"[{CARD}] Ego4D cls: {cls_ms:.1f} ms: accuracy {cls['accuracy']:.4f}, TPR "
                    f"{cls['tpr']:.4f}, TNR {cls['tnr']:.4f}, time_diff {cls['time_diff']}")
        if bucket < 512 or not (math.isfinite(llm["lm_ppl"]) and llm["lm_ppl"] > 1):
            raise RuntimeError(f"Ego4D llm: bucket {bucket}, {llm}")

        # -- LTA, MCQA, OQA ------------------------------------------------------
        video = read_clip(str(clips / "a.mp4"), num_frames=LTA_FRAMES)
        prompt = "Predict the next 20 future actions as 'verb noun' steps separated by commas."
        with DecodeCounter() as dc:
            t0 = sync()
            beams = api.infer_beams(model, video, prompt, tok, num_beams=LTA_BEAMS,
                                    num_return_sequences=LTA_BEAMS, max_new_tokens=LTA_NEW)
            beam_ms = (sync() - t0) * 1e3
        vocab = {w: i for i, w in enumerate(sorted({w for b in beams for w in b.split()}))}
        lta = run_ego4d_lta.score_lta([beams], [list(range(4))], [list(range(4))], vocab, vocab)
        out.update(lta=lta, lta_ms_per_step=beam_ms / max(dc.n, 1))
        log("eval", f"[{CARD}] LTA: infer_beams K {LTA_BEAMS} on {LTA_FRAMES} frames, "
                    f"{LTA_NEW} tokens: {beam_ms:.1f} ms, {out['lta_ms_per_step']:.3f} ms a beam "
                    f"step over {dc.n} steps (ViT, scan and prefill included); score_lta {lta}")
        if len(beams) != LTA_BEAMS or lta["n_clips"] != 1:
            raise RuntimeError(f"LTA: {beams}, {lta}")

        # each question ends where it first emits the id it fed MCQA_NEW-th
        # in the first pass: its reply is that pass's ids up to there
        rows, mcqa_ms, mcqa_steps = [], [], 0
        for rec, ids in zip(records, first_ids):
            with DecodeCounter() as dc:
                t0 = sync()
                (row,) = run_mcqa.run_inference(model, StopAtId(ids[-1]), [rec], "egoschema",
                                                str(clips), read_clip, num_frames=MCQA_FRAMES)
                mcqa_ms.append((sync() - t0) * 1e3)
            mcqa_steps += dc.n
            rows.append(row)
            if "error" in row or row["response"].split() != [
                    str(i) for i in ids[:ids.index(ids[-1]) + 1]]:
                raise RuntimeError(f"MCQA {rec['q_uid']}: {row}, the first pass fed {ids}")
        answers = EVAL_DIR / "mcqa.jsonl"
        answers.write_text("".join(json.dumps(r) + "\n" for r in rows))
        mcqa = run_mcqa.score_answers(str(answers))
        out.update(mcqa=mcqa, mcqa_ms_per_question=statistics.mean(mcqa_ms),
                   mcqa_tokens=[len(r["response"].split()) for r in rows],
                   mcqa_ms_per_step=sum(mcqa_ms) / max(mcqa_steps, 1))
        log("eval", f"[{CARD}] MCQA (egoschema fields, {MCQA_FRAMES} frames): "
                    f"{out['mcqa_ms_per_question']:.1f} ms a question ({out['mcqa_tokens']} "
                    f"tokens, ended by the stop string), {out['mcqa_ms_per_step']:.3f} ms a "
                    f"decode step over {mcqa_steps} steps (ViT, scan and prefill included); "
                    f"preds {[r['pred'] for r in rows]}; {mcqa}")

        t0 = sync()
        pred = api.x_infer(read_clip(str(clips / "b.mp4"), num_frames=MCQA_FRAMES),
                           "What is moving?", model, StopAtId(oqa_ids[-1]), mode="openend")
        oqa_ms = (sync() - t0) * 1e3
        if pred.split() != [str(i) for i in oqa_ids[:oqa_ids.index(oqa_ids[-1]) + 1]]:
            raise RuntimeError(f"OQA: {pred!r}, the first pass fed {oqa_ids}")
        judged = gpt_judge.judge_predictions(
            [{"id": "b", "question": "What is moving?", "answer": "a pattern", "pred": pred}],
            str(EVAL_DIR / "judge"),
            judge_fn=lambda messages, model=None: "{'pred': 'yes', 'score': 4}")
        out.update(oqa=judged, oqa_ms_per_question=oqa_ms)
        log("eval", f"[{CARD}] OQA: x_infer open-ended {oqa_ms:.1f} ms ({len(pred.split())} "
                    f"words); stub judge {judged}")
        if judged != {"mean_score": 4.0, "accuracy": 1.0, "n": 1}:
            raise RuntimeError(f"OQA judge: {judged}")
        counts = read_launches()
    finally:
        shutil.rmtree(EVAL_DIR, ignore_errors=True)

    # exact and int4: the gate stream's frames (23 ViT layers, 5 gate linears x 4
    # layers); flash: a prefill a fire, the LTA beams, two MCQA questions, one
    # OQA question; scan: a clip each (Ego4D llm and cls, LTA, MCQA x 2, OQA)
    n_vit = cfg.vision.num_layers + cfg.vision.select_layer + 1
    n_frames = out["gate_frames"]
    expect = {n: 0 for n in counts}
    expect.update(exact_attention=n_vit * n_frames, exact_attention_tc=n_vit * n_frames,
                  int4_matvec=5 * cfg.gate.num_layers * n_frames,
                  flash_attention=cfg.text.num_layers * (n_fires + 4),
                  flash_attention_tc=cfg.text.num_layers * (n_fires + 4),
                  selective_scan=cfg.mamba.n_layers * 6)
    log("eval", f"launches={counts} expected={expect} ({n_frames} gate-stream frames, "
                f"{n_fires} fires)")
    check_counts("eval", counts, expect)
    out["launches"] = counts
    return out


def eval_parity(dev):
    """The gate stream and the Ego4D llm evaluation in fp32 at the parity
    config (depth cut only, TF32 off), exact ViT attention and the int4
    gate: the same seeded tree and frames through model_init on the CPU
    (plain versions) and the card (kernels): identical fire times and
    summary, lm_ppl and the logits within EVAL_PARITY_TOL; then the card
    with TF32 on, which must cross a limit.  The gate threshold comes from
    the card's first pass (perception alone), the CPU's being the slow one."""
    from streammind_torch import api
    from streammind_torch.data.ego4d import Ego4dNarrationDataset
    from streammind_torch.eval import run_ego4d_stream
    from streammind_torch.eval.run_gate_stream import evaluate_gate_stream
    from streammind_torch.models.meta import init_streammind_params

    cfg = parity_config()
    params = init_streammind_params(torch.Generator().manual_seed(13), cfg, device="cpu")
    tok = StandInTokenizer()
    root = EVAL_DIR / "parity"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        videos = [str(p) for p in (root / "features_video" / "1_224p.mkv",
                                   root / "features_video" / "2_224p.mkv")]
        lab = root / "dataset" / "MatchTime" / "train"
        lab.mkdir(parents=True)
        (lab / "Labels-caption.json").write_text(json.dumps({"annotations": [
            {"gameTime": "1 - 00:01", "anonymized": "a"},
            {"gameTime": "2 - 00:03", "anonymized": "b"}]}))
        frames = {v: torch.randn((EVAL_PARITY_FRAMES, 3, 336, 336),
                                 generator=torch.Generator().manual_seed(14 + i))
                  for i, v in enumerate(videos)}
        anno = root / "ego4d.json"
        anno.write_text(json.dumps({"p": [[1.0, "You look."], [2.0, "You walk."],
                                          [3.0, "You sit."]]}))
        clip = torch.randn((6, 3, 336, 336), generator=torch.Generator().manual_seed(15))
        out, threshold = {}, None
        for run, where, tf32 in (("card", dev, False), ("cpu", "cpu", False),
                                 ("card_tf32", dev, True)):
            with tf32_matmuls(tf32):
                t0 = time.perf_counter()
                model, _, _, _ = api.model_init(params=params, cfg=cfg, tokenizer=tok,
                                                dtype=torch.float32, vit_attn="exact",
                                                quantize_gate="int4", device=where)

                def loader(path, cur_fps, where=where):
                    return [(i / cur_fps, f[None].to(where)) for i, f in enumerate(frames[path])]

                if threshold is None:
                    threshold, _ = gate_threshold(model, videos, loader, 3)
                reset_launches()
                summary, per_video = evaluate_gate_stream(
                    model, tok, videos, frame_loader=loader,
                    session_kw=dict(gate_threshold=threshold, max_new_tokens=4))
                ds = Ego4dNarrationDataset(str(root), str(anno), tok,
                                           frame_loader=lambda p, s, e, where=where: clip.to(where))
                logits, labels = run_ego4d_stream.llm_sample_logits(model, ds[0])
                llm = run_ego4d_stream.eval_llm_sample(logits, labels, tok)
                counts = read_launches()
                out[run] = dict(summary=summary, fires=[r["fires"] for r in per_video],
                                lm_ppl=llm["lm_ppl"], logits=torch.from_numpy(logits))
                log("eval-parity", f"{run}: {time.perf_counter() - t0:.1f} s, fires "
                                   f"{out[run]['fires']}, lm_ppl {llm['lm_ppl']!r}")
                if where != "cpu":
                    fp32_only(counts, "eval-parity")
                    if not all(counts[n] for n in ("exact_attention", "int4_matvec",
                                                    "flash_attention", "selective_scan")):
                        raise RuntimeError(f"the card's eval run missed a kernel: {counts}")
                del model
    finally:
        shutil.rmtree(root, ignore_errors=True)
    c, tol = out["cpu"], EVAL_PARITY_TOL
    errs, control = ({"lm_ppl": abs(out[r]["lm_ppl"] - c["lm_ppl"]) / c["lm_ppl"],
                      "logits": float((out[r]["logits"] - c["logits"]).abs().max())}
                     for r in ("card", "card_tf32"))
    same = c["fires"] == out["card"]["fires"] and c["summary"] == out["card"]["summary"]
    log("eval-parity", f"depth vit3/gate2/text2 at published widths, fp32, TF32 off: lm_ppl "
                       f"|cpu - card| / cpu and max |logits| difference {errs}, limits {tol}; "
                       f"fires and summary identical: {same}")
    log("eval-parity", f"control, TF32 on: {control}; over the limits: "
                       f"{[k for k in tol if control[k] > tol[k]]}")
    if not same or any(errs[k] > tol[k] for k in tol):
        raise RuntimeError("the eval path on the CPU and the card disagree")
    if not any(control[k] > tol[k] for k in tol):
        raise RuntimeError("the eval parity limits do not see TF32 matmuls on the card")
    return errs


# ---------------------------------------------------------------------------
# phases 18-20: StreamMind over the Qwen2-7B and Mixtral-8x7B decoders
# ---------------------------------------------------------------------------
# the published config.json of Qwen/Qwen2-7B-Instruct ("use_sliding_window"
# is false there: full causal attention, as the port runs)
QWEN2_7B_HF = {"model_type": "qwen2", "hidden_size": 3584, "intermediate_size": 18944,
               "num_hidden_layers": 28, "num_attention_heads": 28, "num_key_value_heads": 4,
               "vocab_size": 152064, "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
               "max_position_embeddings": 32768, "tie_word_embeddings": False}
# the published config.json of mistralai/Mixtral-8x7B-v0.1
MIXTRAL_8X7B_HF = {"model_type": "mixtral", "hidden_size": 4096, "intermediate_size": 14336,
                   "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 8,
                   "vocab_size": 32000, "rope_theta": 1000000.0, "rms_norm_eps": 1e-5,
                   "max_position_embeddings": 32768, "tie_word_embeddings": False,
                   "num_local_experts": 8, "num_experts_per_tok": 2}
# the serving turn of both: three streams of four fire together on tick 1
DECODER_SERVE_TICKS = 3
DECODER_SERVE_FIRES = {1: ("s0", "s1", "s2")}
# the gathered MoE dispatch against the dense one on one decode step's input
# at layer 0 (bf16, int4 slices): the dense form adds the unrouted experts'
# exact zeros, so the two differ by the order of two bf16 additions at most
MOE_DISPATCH_TOL = BF16_TOL
MOE_DISPATCH_TOL_TEXT = BF16_TOL_TEXT
# the gathered dispatch in fp32 (each chosen slice through the int4 kernel's
# fp32 path) against the grouped one over the dequantized banks (fp32
# matmuls): the same products summed in another order, through three
# chained linears of up to 14336 terms; measured 3.7e-6 on an H100 80GB
# HBM3 at 700 W
MOE_ROUTE_TOL = (1e-4, 1e-4)


def decoder_config(hf: dict):
    """StreamMind over the decoder of an HF config.json: the decoder from
    ``text_config_from_hf``, the gate LM and the Mamba projector at its
    width (``api._load_config`` sets the gate's; the Mamba's it leaves at
    4096, which the port refuses for another width)."""
    from streammind_torch.config import StreamMindConfig, text_config_from_hf

    base = StreamMindConfig()
    text = text_config_from_hf(hf)
    return base.replace(
        text=text, mamba=dataclasses.replace(base.mamba, d_model=text.hidden_size),
        gate=dataclasses.replace(base.gate, hidden_size=text.hidden_size,
                                 head_dim=text.hidden_size // base.gate.num_heads))


def require_freed(tag: str, limit_gb: float = 2.0) -> None:
    """The models before this one must be gone from the card: collect the
    reference cycles that hold them (threads, servers, sessions), then
    raise if more than ``limit_gb`` is still allocated, naming the largest
    tensors left and what holds them."""
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    log(tag, f"device memory allocated before the build: {held:.2f} GB")
    if held > limit_gb:
        alive = sorted((o for o in gc.get_objects() if torch.is_tensor(o) and o.is_cuda),
                       key=lambda t: -t.numel() * t.element_size())[:3]
        holders = [[type(r).__name__ + (f"{sorted(r)[:6]}" if isinstance(r, dict) else "")
                    for r in gc.get_referrers(t)][:4] for t in alive]
        raise RuntimeError(f"{tag}: {held:.2f} GB still allocated from earlier phases; the "
                           f"largest tensors {[tuple(t.shape) for t in alive]} held by {holders}")


def add_counts(*runs: dict) -> dict:
    return {n: sum(r[n] for r in runs) for n in runs[0]}


def peak_gb() -> float:
    return torch.cuda.max_memory_allocated() / 1e9


def qwen2_phase(dev):
    """StreamMind over Qwen2-7B at full width (bf16, random weights from a
    seed; ViT-L/14-336 under "exact", the Mamba at d_model 3584, the int4
    gate at hidden 3584 and head_dim 112): the 10-frame session, the paged
    broker's K = 3 turn on the same engine, ``api.model_init`` by a Qwen2
    model name (the "qwen" template) and ``infer`` on API_FRAMES frames
    with API_NEW tokens, then one turn of the decoder through
    ``load_8bit``.  Exact launch counts in each."""
    from streammind_torch import api
    from streammind_torch.models.meta import init_streammind_params
    from streammind_torch.utils.params import param_bytes, param_count

    cfg = decoder_config(QWEN2_7B_HF)
    L, n_vit = cfg.text.num_layers, cfg.vision.num_layers + cfg.vision.select_layer + 1
    require_freed("qwen2")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(13)
    params = init_streammind_params(g, cfg, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log("qwen2", f"StreamMind over Qwen2-7B, bf16: decoder {param_count(params['text'])} "
                 f"parameters ({param_bytes(params['text']) / 1e9:.2f} GB, q/k/v biases), "
                 f"the whole tree {param_bytes(params) / 1e9:.2f} GB, built in "
                 f"{time.perf_counter() - t0:.1f} s; gate hidden {cfg.gate.hidden_size} head_dim "
                 f"{cfg.gate.head_dim}, Mamba d_inner {cfg.mamba.d_inner}; peak {peak_gb():.2f} GB")
    engine = make_engine_class()(params, cfg, attn_impl="exact", quantize_gate="int4",
                                 device=dev)
    del params
    # the gate LM's head_dim 112 has no flash kernel (D 64 or 128): serving
    # reaches the gate only through its single-token shortcut, and a flash
    # call at D 112 on the card raises rather than take the plain version
    from streammind_torch.ops.attention import flash_attention

    q = torch.zeros((1, 2, cfg.gate.num_heads, cfg.gate.head_dim), device=dev,
                    dtype=torch.bfloat16)
    try:
        flash_attention(q, q[:, :, :cfg.gate.num_kv_heads], q[:, :, :cfg.gate.num_kv_heads],
                        causal=True)
    except ValueError as e:
        log("qwen2", f"flash_attention at the gate's head_dim {cfg.gate.head_dim} raises: {e}")
    else:
        raise RuntimeError(f"flash_attention took head_dim {cfg.gate.head_dim}")
    torch.cuda.reset_peak_memory_stats()
    session = full_width_session(engine, g, dev, tag="qwen2")
    serving = serving_phase(engine, g, dev, ticks=DECODER_SERVE_TICKS, fires=DECODER_SERVE_FIRES,
                            tag="qwen2")

    tok = StandInTokenizer()
    model, _, _, version = api.model_init(model_name="StreamMind-Qwen2-7B", params=engine.params,
                                          cfg=cfg, tokenizer=tok, vit_attn="exact", device=dev)
    if version != "qwen":
        raise RuntimeError(f"model_init picked the {version!r} template for a Qwen2 model name")
    size = cfg.vision.image_size
    video = torch.empty((API_FRAMES, 3, size, size), device=dev, dtype=torch.bfloat16).normal_(
        generator=g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    text, infer_ms, forwards = timed(lambda: api.infer(model, video, QUESTION, tok,
                                                       version=version, max_new_tokens=API_NEW))
    api_counts = read_launches()
    expect = {n: 0 for n in api_counts}
    expect.update(flash_attention=L, flash_attention_tc=L, selective_scan=cfg.mamba.n_layers)
    log("qwen2", f"[{CARD}] api.infer ({API_FRAMES} frames, the qwen template, {API_NEW} new "
                 f"tokens at most): {infer_ms:.3f} ms wall, {forwards} one-token forwards, "
                 f"{len(text.split())} ids; launches {api_counts} expected {expect}; peak "
                 f"{peak_gb():.2f} GB")
    check_counts("qwen2 infer", api_counts, expect)
    del model, video

    # the int8 decoder: model_init(load_8bit=True) quantizes the engine's bf16
    # decoder leaf by leaf (free_source), so it is not resident twice
    params = dict(engine.params)
    del engine
    torch.cuda.reset_peak_memory_stats()
    m8, _, _, _ = api.model_init(model_name="StreamMind-Qwen2-7B", params=params, cfg=cfg,
                                 tokenizer=tok, vit_attn="exact", load_8bit=True, device=dev)
    del params
    eng8 = as_recording(m8.engine)
    layers = eng8.params["text"]["layers"]
    if not ("w_int8" in layers["qkv"] and "bias" in layers["qkv"]):
        raise RuntimeError(f"the int8 decoder's fused qkv is {sorted(layers['qkv'])}")
    frames = [torch.empty((1, 3, size, size), device=dev, dtype=torch.bfloat16).normal_(
        generator=g) for _ in range(2)]
    torch.cuda.synchronize()
    reset_launches()
    with DecodeCounter() as dc:
        s8, _, e2ft8 = run_session(eng8, frames, (1,), max_new=16)
    int8_counts = read_launches()
    expect8 = {n: 0 for n in int8_counts}
    expect8.update(exact_attention=n_vit * 2, exact_attention_tc=n_vit * 2,
                   int4_matvec=5 * cfg.gate.num_layers * 2, flash_attention=L,
                   flash_attention_tc=L, int8_matvec=4 * L * dc.n)
    n_tok = sum(len(t) for t in eng8.decoded)
    int8_ms_tok = sum(eng8.decode_ms) / max(n_tok, 1)
    log("qwen2", f"[{CARD}] int8 decoder (load_8bit, {param_bytes(eng8.params['text']) / 1e9:.2f} "
                 f"GB): one turn, event-to-first-token {e2ft8[0]:.3f} ms, {n_tok} tokens, decode "
                 f"{int8_ms_tok:.3f} ms/token; launches {int8_counts} expected {expect8} (4 int8 "
                 f"a layer of a one-token forward: qkv with its bias after, o, gateup, down); "
                 f"peak {peak_gb():.2f} GB")
    check_counts("qwen2 int8", int8_counts, expect8)
    if len(s8.turns) != 1 or not all(0 <= t < cfg.text.vocab_size for t in eng8.decoded[0]):
        raise RuntimeError(f"the int8 turn gave {eng8.decoded}")
    del m8, eng8, s8, layers, frames
    torch.cuda.empty_cache()
    launches = add_counts(session["launches"], serving["launches"], api_counts, int8_counts)
    return dict(session=session, serving=serving, infer_ms=infer_ms,
                int8_decode_ms_per_token=int8_ms_tok, int8_event_to_first_token_ms=e2ft8[0],
                launches=launches)


class ExpertTally:
    """While installed, counts how often each expert is chosen at each layer
    by the gathered MoE dispatch (the decode steps, at most 4 tokens: every
    layer of a forward takes it, so its calls come in layer order), and
    keeps the inputs of its first call at layer 0.  Steps run eagerly: a
    paged decode step being captured into a CUDA graph keeps its ids on the
    card (no copy to the host may run in a capture), and its replays do not
    call the dispatch."""

    def __init__(self, layers: int, experts: int):
        from streammind_torch.models import mistral

        self.mod, self.orig = mistral, mistral._moe_apply_gathered
        self.counts = torch.zeros((layers, experts), dtype=torch.long)
        self.calls, self.sample = 0, None

    def __enter__(self):
        def counted(xt, banks, cfg, topi, topw, **kw):
            if torch.cuda.is_current_stream_capturing():
                return self.orig(xt, banks, cfg, topi, topw, **kw)
            layer = self.calls % self.counts.shape[0]
            self.calls += 1
            self.counts[layer] += torch.bincount(topi.reshape(-1).cpu(),
                                                 minlength=self.counts.shape[1])
            if self.sample is None and layer == 0:
                self.sample = (xt.clone(), banks, topi.clone(), topw.clone())
            return self.orig(xt, banks, cfg, topi, topw, **kw)

        self.mod._moe_apply_gathered = counted
        return self

    def __exit__(self, *exc):
        self.mod._moe_apply_gathered = self.orig


def mixtral_phase(dev):
    """StreamMind over Mixtral-8x7B at full width, made by
    ``api.model_init(load_4bit="pc")`` from a seed (93 GB in bf16 would not
    fit the card; model_init draws the decoder one layer's bf16 banks at a
    time and quantizes each before the next): the 10-frame session and the
    paged broker's K = 3 turn, through the int4 kernel at every one-token or
    lockstep step (the fused qkv, o, and each token's two experts' gate, up
    and down slices); a per-layer tally of the experts chosen over the
    decoded tokens, every expert chosen somewhere; on one decode step's
    input at layer 0, the gathered dispatch against the dense one (bf16)
    and, in fp32, against the grouped one over that layer's dequantized
    banks."""
    from streammind_torch import api
    from streammind_torch.models import mistral as lm
    from streammind_torch.utils.params import param_bytes, param_count
    from streammind_torch.utils.quantize import dequantize_linear_weight_int4_pc

    cfg = decoder_config(MIXTRAL_8X7B_HF)
    L, E, k = cfg.text.num_layers, cfg.text.num_experts, cfg.text.num_experts_per_tok
    require_freed("mixtral")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, _, _, _ = api.model_init(model_name="StreamMind-Mixtral-8x7B", cfg=cfg, seed=17,
                                    load_4bit="pc", quantize_gate="int4", vit_attn="exact",
                                    device=dev)
    torch.cuda.synchronize()
    engine = as_recording(model.engine)
    del model
    text = engine.params["text"]
    experts_gb = param_bytes(text["layers"]["experts"]) / 1e9
    log("mixtral", f"StreamMind over Mixtral-8x7B by api.model_init(load_4bit='pc'), decoder "
                   f"int4 per channel: {param_bytes(text) / 1e9:.2f} GB ({experts_gb:.2f} GB "
                   f"expert banks, {param_count(text)} stored elements), the whole tree "
                   f"{param_bytes(engine.params) / 1e9:.2f} GB, built one layer's bf16 banks at a "
                   f"time in {time.perf_counter() - t0:.1f} s; peak device memory during the "
                   f"build {peak_gb():.2f} GB")
    del text
    g = torch.Generator(device=dev).manual_seed(18)
    torch.cuda.reset_peak_memory_stats()
    per_token = 2 + 3 * k  # a layer: fused qkv, o, and k experts' gate, up, down
    with ExpertTally(L, E) as tally:
        session = full_width_session(engine, g, dev, tag="mixtral",
                                     matvec=("int4_matvec", per_token))
        serving = serving_phase(engine, g, dev, ticks=DECODER_SERVE_TICKS,
                                fires=DECODER_SERVE_FIRES, tag="mixtral",
                                matvec=("int4_matvec", lambda rows: 2 + 3 * k * rows))
    chosen = tally.counts
    log("mixtral", f"experts chosen at each layer over the decoded tokens ({tally.calls} gathered "
                   f"calls, {int(chosen.sum()) // k} token-layers): "
                   f"{[row.tolist() for row in chosen]}")
    log("mixtral", f"experts chosen over all layers: {chosen.sum(0).tolist()}; never chosen at a "
                   f"layer: {int((chosen == 0).sum())} of {L * E}")
    if (chosen.sum(0) == 0).any():
        raise RuntimeError(f"an expert was never chosen: {chosen.sum(0).tolist()}")
    xt, banks, topi, topw = tally.sample
    gathered = lm._moe_apply_gathered(xt, banks, cfg.text, topi, topw)
    dense = lm._moe_apply_dense(xt, banks, cfg.text, topi, topw)
    err, over = excess(gathered, dense, *MOE_DISPATCH_TOL)
    log("mixtral", f"gathered vs dense dispatch on one decode step's input at layer 0 "
                   f"({tuple(xt.shape)}, experts {topi.tolist()}): max |diff| = {err:.3e} within "
                   f"[{MOE_DISPATCH_TOL_TEXT}]={over <= 0} (both send the same bank[e] slices "
                   f"through the int4 kernel: a check of the summation order only)")
    if over > 0 or not torch.isfinite(gathered).all():
        raise RuntimeError("the gathered and dense MoE dispatches disagree")
    # another route: the same input in fp32, the gathered dispatch (the int4
    # kernel's fp32 path on each chosen slice) against the grouped one (one
    # matmul per expert) over layer 0's banks dequantized to fp32
    x32, w32 = xt.float(), topw.float()
    gathered32 = lm._moe_apply_gathered(x32, banks, cfg.text, topi, w32)
    experts = {n: dequantize_linear_weight_int4_pc(b) for n, b in zip(("gate", "up", "down"),
                                                                       banks)}
    grouped32 = lm._moe_apply_grouped(x32, experts, cfg.text, topi, w32)
    err32, over32 = excess(gathered32, grouped32, *MOE_ROUTE_TOL)
    log("mixtral", f"gathered (int4 kernel, fp32 x) vs grouped (fp32 matmuls over the "
                   f"dequantized banks) on the same input: max |diff| = {err32:.3e} within "
                   f"[{tol_text(MOE_ROUTE_TOL, 'fp32')}]={over32 <= 0}")
    if over32 > 0 or not torch.isfinite(gathered32).all():
        raise RuntimeError("the gathered MoE dispatch disagrees with the grouped one over the "
                           "dequantized banks")
    del experts, gathered32, grouped32
    # what a prefill pays for the dense dispatch over int4 banks: all E experts
    # through linear at the session's first bucket, each weight dequantized
    # to bf16 first (more than 8 tokens take no matvec kernel)
    router = engine.params["text"]["layers"]["router"]["weight"][0]
    x64 = torch.empty((64, cfg.text.hidden_size), device=dev, dtype=torch.bfloat16).normal_(
        generator=g)
    w64, i64 = lm.router_top_k(torch.softmax((x64 @ router.T).float(), dim=-1), k)
    w64 = w64 / w64.sum(dim=-1, keepdim=True)
    dense_ms = cuda_ms([lambda: lm._moe_apply_dense(x64, banks, cfg.text, i64, w64)], iters=5,
                       warmup=1)
    grouped_ms = cuda_ms([lambda: lm._moe_apply_grouped_int4(x64, banks, cfg.text, i64, w64)],
                         iters=5, warmup=1)
    log("mixtral", f"[{CARD}] the dense dispatch over the int4 banks at 64 tokens: {dense_ms:.3f} "
                   f"ms a layer ({3 * E} dequantized weights), {dense_ms * L:.1f} ms over "
                   f"{L} layers of a prefill; the grouped int4 dispatch the prefill takes: "
                   f"{grouped_ms:.3f} ms a layer, {grouped_ms * L:.1f} ms over {L} layers")
    del engine, tally, xt, banks, gathered, dense, x64
    torch.cuda.empty_cache()
    return dict(session=session, serving=serving, experts_chosen=chosen.tolist(),
                dispatch_err=err, route_err=err32, dense_dispatch_ms=dense_ms,
                grouped_dispatch_ms=grouped_ms,
                launches=add_counts(session["launches"], serving["launches"]))


# about ten times the largest errors measured on an H100 with TF32 off over
# the two decoders (probs 9.5e-7, memory 1.42e-6, logits 1.84e-5), as the
# other parity phases' limits were set; TF32 on measured 1.6e-4, 5.6e-4
# and 7.7e-3
DECODERS_PARITY_TOL = {"probs": 1e-5, "memory": 1.5e-5, "logits": 2e-4}
# the three MoE dispatches against each other in fp32 on the card: the same
# products, summed in another order
DISPATCH_PARITY_TOL = (1e-5, 1e-5)


def parity_depth(cfg):
    return cfg.replace(vision=dataclasses.replace(cfg.vision, num_layers=3),
                       text=dataclasses.replace(cfg.text, num_layers=2),
                       gate=dataclasses.replace(cfg.gate, num_layers=2))


def moe_dispatch_parity(params, cfg, dev):
    """Mixtral's gathered, dense and grouped dispatches against each other on
    the card in fp32, at layer 0 of the parity tree: 4 rows (all three) and
    12 rows (dense and grouped)."""
    from streammind_torch.models import mistral as lm
    from streammind_torch.utils.params import layer_slice

    lp = layer_slice(params["layers"], 0)
    xt = torch.randn((12, cfg.hidden_size), generator=torch.Generator().manual_seed(7)).to(dev)
    probs = torch.softmax((xt @ lp["router"]["weight"].T).float(), dim=-1)
    topw, topi = lm.router_top_k(probs, cfg.num_experts_per_tok)
    topw = topw / topw.sum(dim=-1, keepdim=True)
    banks = tuple({"weight": lp["experts"][n]} for n in ("gate", "up", "down"))
    dense = lm._moe_apply_dense(xt, banks, cfg, topi, topw)
    grouped = lm._moe_apply_grouped(xt, lp["experts"], cfg, topi, topw)
    gathered = lm._moe_apply_gathered(xt[:4], banks, cfg, topi[:4], topw[:4])
    pairs = {"gathered-dense": (gathered, dense[:4]), "gathered-grouped": (gathered, grouped[:4]),
             "grouped-dense": (grouped, dense)}
    return {name: excess(a, b, *DISPATCH_PARITY_TOL) for name, (a, b) in pairs.items()}


def decoders_parity(dev):
    """Qwen2-7B and Mixtral-8x7B (all 8 experts) in fp32 at their published
    widths, depth cut (vision 3, text 2, gate 2 layers): the same seeded
    tree and frames through the plain versions on the CPU and the kernels
    on the card (TF32 off), then on the card with TF32 on, which must break
    a limit.  Held equal: the forced fires and the greedy tokens; within
    limits: the gate probabilities, the memory ring and the prefill
    logits.  For Mixtral, the three MoE dispatches against each other."""
    from streammind_torch.models.meta import init_streammind_params

    require_freed("parity")
    Engine = make_engine_class()
    errs, controls, dispatch = {}, {}, {}
    for name, hf, seed in (("qwen2", QWEN2_7B_HF, 31), ("mixtral", MIXTRAL_8X7B_HF, 33)):
        cfg = parity_depth(decoder_config(hf))
        t0 = time.perf_counter()
        params = init_streammind_params(torch.Generator().manual_seed(seed), cfg, device="cpu")
        rng = torch.Generator().manual_seed(seed + 1)
        size = cfg.vision.image_size
        frames = [torch.randn((1, 3, size, size), generator=rng) for _ in range(4)]
        fire = (1, 3)
        out = {}
        for run, where, tf32 in (("cpu", "cpu", False), ("card", dev, False),
                                 ("card_tf32", dev, True)):
            with tf32_matmuls(tf32):
                eng = Engine(params, cfg, attn_impl="exact", quantize_gate="int4", kv_capacity=1024,
                             device=where)
                reset_launches()
                session, _, _ = run_session(eng, [f.to(where) for f in frames], fire, max_new=8)
                counts = read_launches()
                out[run] = dict(probs=torch.stack(eng.probs),
                                memory=session.state.memory[0, :4].cpu(),
                                logits=torch.cat(eng.prefill_logits), tokens=eng.decoded,
                                turns=len(session.turns))
                if where != "cpu":
                    fp32_only(counts, f"{name}_parity")
                    if not all(counts[n] for n in ("exact_attention", "flash_attention",
                                                   "int4_matvec")):
                        raise RuntimeError(f"{name}: the card's session missed a kernel: {counts}")
                    if run == "card" and name == "mixtral":
                        dispatch = moe_dispatch_parity(eng.params["text"], cfg.text, where)
                del eng, session
                torch.cuda.empty_cache()
        c = out["cpu"]
        tol = DECODERS_PARITY_TOL
        errs[name], controls[name] = ({k: float((c[k] - out[run][k]).abs().max()) for k in tol}
                                      for run in ("card", "card_tf32"))
        log("parity", f"{name}: depth vit3/gate2/text2 at published widths, fp32 "
                      f"({time.perf_counter() - t0:.1f} s): max |cpu - card| = {errs[name]}, "
                      f"tolerance {tol}; fires {c['turns']}/{out['card']['turns']}, greedy tokens "
                      f"equal: {c['tokens'] == out['card']['tokens']}")
        log("parity", f"{name}: control, TF32 on: max |cpu - card| = {controls[name]}; over the "
                      f"tolerance: {[k for k in tol if controls[name][k] > tol[k]]}")
        if (any(errs[name][k] > tol[k] for k in tol) or c["tokens"] != out["card"]["tokens"]
                or c["turns"] != out["card"]["turns"]):
            raise RuntimeError(f"{name}: CPU (plain versions) and card (kernels) disagree")
        if not any(controls[name][k] > tol[k] for k in tol):
            raise RuntimeError(f"{name}: the parity limits do not see TF32 matmuls on the card")
        del params, out
    log("parity", f"mixtral: MoE dispatches on the card, fp32, layer 0: (max |diff|, excess over "
                  f"[{tol_text(DISPATCH_PARITY_TOL, 'fp32')}]) = {dispatch}")
    if not dispatch or any(over > 0 for _, over in dispatch.values()):
        raise RuntimeError(f"the MoE dispatches disagree: {dispatch}")
    return dict(errs=errs, controls=controls, dispatch=dispatch)


# ---------------------------------------------------------------------------
# phases 21-22: the VideoLLaMA2 projectors and Mamba-2
# ---------------------------------------------------------------------------
# memory tokens of an 8-frame clip of 576 patches a frame, by projector type
PROJ_TOKENS = {"stc_connector": 845, "stp_connector": 576, "stc_connector_v35": 576,
               "spatial_conv": 1690, "spatial_pool": 1152, "linear": 576, "mlp2x_gelu": 576}
PROJ_FRAMES = 8        # VideoLLaMA2's frames a clip (constants.NUM_FRAMES)
PROJ_NEW = 32          # greedy tokens of each infer
PROJ_REPEATS = 5       # timed projections a type (the median is kept)
PROJ_TRAIN_STEPS = 3
PROJ_SAMPLES = 4
PROJ_DIR = Path(__file__).resolve().parent / "_smoke_proj"
# CPU against card in fp32 (TF32 off): the same convolutions, norms and
# products in another order; a TF32 matmul or convolution crosses it
PROJ_PARITY_TOL = (1e-4, 1e-4)
PROJ_PARITY_FRAMES = 2
# state-spaces/mamba2-2.7b's widths
MAMBA2_27B = dict(d_model=2560, d_state=128, headdim=64, ngroups=1, expand=2, chunk_size=256)
MAMBA2_L = 512
MAMBA2_STEPS = 4


def connector_records(n: int = PROJ_SAMPLES) -> list:
    """VideoLLaVA pretrain records: one clip each, a caption longer than the
    stand-in tokenizer's 24 ids, so every sample has the same length."""
    return [{"id": f"v{i}", "video": f"clip{i}.mp4", "conversations": [
        {"from": "human", "value": "<video>\nDescribe the clip."},
        {"from": "gpt", "value": f"clip {i}: a winger crosses from the left and the striker heads"
                                 f" it in"}]} for i in range(n)]


def connector_step_len() -> int:
    """The spliced length of one adapter-stage sample over the STC connector:
    the plain template's ids with the <video> slot replaced by its 845
    memory tokens (the attention's kv_len in the connector training step)."""
    from streammind_torch.data.sft import preprocess_plain

    (n,) = {preprocess_plain(r["conversations"], StandInTokenizer())["input_ids"].shape[1]
            for r in connector_records()}
    return n - 1 + PROJ_TOKENS["stc_connector"]


def connector_dataset(root: Path, size: int):
    """The records through data/sft.py's VideoLLaVASFTDataset (the plain
    style of the adapter stage), PROJ_FRAMES seeded size × size frames a
    clip."""
    from streammind_torch.data.sft import VideoLLaVASFTDataset

    root.mkdir(parents=True, exist_ok=True)
    (root / "sft.json").write_text(json.dumps(connector_records()))

    def frames(path, is_video):
        i = int(Path(path).stem[len("clip"):])
        return np.random.default_rng(100 + i).standard_normal((PROJ_FRAMES, 3, size, size),
                                                              dtype=np.float32)

    return VideoLLaVASFTDataset(str(root / "sft.json"), str(root), StandInTokenizer(),
                                num_frames=PROJ_FRAMES, style="plain", frame_loader=frames)


def projection_bound(cfg, feats_shape):
    """(bound ms, bound_by, flops) of one clip's simple_project: its products
    and convolutions (counted by FlopCounterMode on shape-only tensors) at
    the bf16 peak, against the projector's weights (the gate excluded) and
    the features and tokens read or written once."""
    from torch.utils.flop_counter import FlopCounterMode
    from streammind_torch.models.projector import init_projector_params, simple_project
    from streammind_torch.utils.params import param_bytes

    p = init_projector_params(torch.Generator(), cfg, device="meta", dtype=torch.bfloat16)
    p.pop("cls_net", None)
    with FlopCounterMode(display=False) as fc:
        out = simple_project(p, cfg, torch.empty(feats_shape, device="meta", dtype=torch.bfloat16))
    nbytes = param_bytes(p) + 2 * (math.prod(feats_shape) + out.numel())
    return (*bound(nbytes, fc.get_total_flops(), BF16_FLOPS), fc.get_total_flops())


def connector_state_dict(proj) -> dict:
    """A connector tree under the released mm_projector.bin's names: timm's
    RegStage (s{1,2}.b{n}.conv{1,2,3}.{conv,bn}, .se.fc{1,2}, .downsample),
    sampler.0, readout.{0,2}, and the gate LM in HF Mistral naming under
    cls_net.cls_model; CPU copies."""
    sd = {}
    for stage in ("s1", "s2"):
        for i, blk in enumerate(proj[stage]):
            pre = f"{stage}.b{i + 1}"
            for n in (1, 2, 3):
                sd[f"{pre}.conv{n}.conv.weight"] = blk[f"conv{n}"]
                sd[f"{pre}.conv{n}.bn.weight"] = blk[f"ln{n}"]["weight"]
                sd[f"{pre}.conv{n}.bn.bias"] = blk[f"ln{n}"]["bias"]
            for n in (1, 2):
                sd[f"{pre}.se.fc{n}.weight"] = blk[f"se_fc{n}"]
                sd[f"{pre}.se.fc{n}.bias"] = blk[f"se_fc{n}_bias"]
            if "proj" in blk:
                sd[f"{pre}.downsample.conv.weight"] = blk["proj"]
                sd[f"{pre}.downsample.bn.weight"] = blk["proj_ln"]["weight"]
                sd[f"{pre}.downsample.bn.bias"] = blk["proj_ln"]["bias"]
    if "sampler" in proj:
        sd["sampler.0.weight"] = proj["sampler"]["weight"]
        sd["sampler.0.bias"] = proj["sampler"]["bias"]
    for i, layer in enumerate(proj["readout"]):
        sd[f"readout.{2 * i}.weight"] = layer["weight"]
        sd[f"readout.{2 * i}.bias"] = layer["bias"]
    for k, x in hf_text_state_dict(proj["cls_net"]).items():
        sd["cls_net.cls_model." + k] = x
    return {k: x.detach().to("cpu", copy=True).contiguous() for k, x in sd.items()}


def with_released_extras(proj, g):
    """A drawn connector with the leaves only a released (timm) one has:
    each block's SE biases and the norm of s1's width-changing shortcut."""
    def small(t):
        return torch.empty_like(t).normal_(0.0, 0.05, generator=g)

    for blk in proj["s1"] + proj["s2"]:
        blk["se_fc1_bias"] = small(blk["se_fc1"][:, 0, 0, 0])
        blk["se_fc2_bias"] = small(blk["se_fc2"][:, 0, 0, 0])
        if "proj" in blk:
            blk["proj_ln"] = {"weight": 1.0 + small(blk["ln1"]["weight"]),
                              "bias": small(blk["ln1"]["bias"])}
    return proj


def projector_infer(api, model, tok, video, what: str) -> dict:
    """Greedy ``infer`` (PROJ_NEW tokens) timed, with its launches and the
    bucket of its prefill."""
    reset_launches()
    text, infer_ms, forwards = timed(lambda: api.infer(model, video, QUESTION, tok,
                                                       max_new_tokens=PROJ_NEW))
    counts = read_launches()
    plan, mem = api._prepare_cognition_inputs(model, video, QUESTION, tok, "llama_2")
    ids = [int(t) for t in text.split()]
    if not ids or any(not 0 <= t < model.cfg.text.vocab_size for t in ids):
        raise RuntimeError(f"{what}: infer gave {text!r}")
    return dict(infer_ms=infer_ms, forwards=forwards, launches=counts,
                bucket=len(plan.token_ids), spliced=plan.length, tokens=len(ids))


def projectors_phase(engine, g, dev):
    """The VideoLLaMA2 projectors at full width over the session's
    StreamMind-7B vision tower and decoder (bf16): for each type its
    projector drawn from a seed, ``project_memory`` on PROJ_FRAMES frames
    (timed, the token count against the table), ``api.infer`` with
    PROJ_NEW greedy tokens (one flash prefill a layer); then a released
    STC checkpoint (mm_projector.bin in timm naming with its gate, beside a
    full-SFT .bin whose decoder is cut to CKPT_TEXT_LAYERS layers) loaded
    by ``model_init(path, load_4bit="pc")`` bitwise and answered; then
    ``train()`` on the adapter stage over the STC connector, PROJ_TRAIN_STEPS
    steps of one SFT clip each.  Returns the numbers."""
    from streammind_torch import api
    from streammind_torch.config import StreamMindConfig
    from streammind_torch.models.meta import bucket_length, encode_frames, init_streammind_params
    from streammind_torch.models.mistral import fuse_text_linears
    from streammind_torch.models.projector import (init_projector_params, project_memory,
                                                   projected_token_count)
    from streammind_torch.models.vit import fuse_vit_qkv
    from streammind_torch.train.args import DataArguments, ModelArguments, TrainingArguments
    from streammind_torch.train.run import PLAN_BUCKETS, train
    from streammind_torch.utils.params import flatten_with_paths, param_count
    from streammind_torch.utils.quantize import quantize_text_params

    base, bf16 = engine.cfg, torch.bfloat16
    L, L2 = base.text.num_layers, CKPT_TEXT_LAYERS
    tok = StandInTokenizer()
    size = base.vision.image_size
    video = torch.empty((PROJ_FRAMES, 3, size, size), device=dev, dtype=bf16).normal_(generator=g)
    shared = {"vision": engine.params["vision"], "text": engine.params["text"]}
    with torch.no_grad():
        feats = encode_frames(shared, base, video)
    rows, runs = {}, []
    for i, (ptype, want) in enumerate(PROJ_TOKENS.items()):
        cfg = base.replace(mm_projector_type=ptype)
        proj = init_projector_params(torch.Generator(device=dev).manual_seed(50 + i), cfg,
                                     device=dev, dtype=bf16)
        model, _, _, _ = api.model_init(params={**shared, "projector": proj}, cfg=cfg,
                                        tokenizer=tok, device=dev)
        p = model.params["projector"]
        with torch.no_grad():
            mem = project_memory(p, cfg, feats)
            ms = []
            for _ in range(PROJ_REPEATS):
                t0 = sync()
                project_memory(p, cfg, feats)
                ms.append((sync() - t0) * 1e3)
        n = mem.shape[1]
        if (n != want or n != projected_token_count(cfg, PROJ_FRAMES, feats.shape[2])
                or mem.shape[2] != base.text.hidden_size or not torch.isfinite(mem).all()):
            raise RuntimeError(f"{ptype}: memory {tuple(mem.shape)}, want {want} tokens")
        r = projector_infer(api, model, tok, video, ptype)
        expect = {k: 0 for k in r["launches"]}
        expect.update(flash_attention=L, flash_attention_tc=L)
        check_counts(f"projectors {ptype}", r["launches"], expect)
        b_ms, b_by, flops = projection_bound(cfg, tuple(feats.shape))
        r.update(memory_tokens=n, project_ms=statistics.median(ms), project_ms_all=ms,
                 bound_ms=b_ms, bound_by=b_by, flops=flops,
                 params=param_count({k: v for k, v in proj.items() if k != "cls_net"}))
        rows[ptype] = r
        runs.append(r["launches"])
        log("projectors", f"[{CARD}] {ptype}: {n} memory tokens from {PROJ_FRAMES} frames "
                          f"({r['params']} projector parameters besides the gate); project_memory "
                          f"median {r['project_ms']:.3f} ms of {[round(x, 3) for x in ms]} "
                          f"(bound {b_ms:.4f} ms by {b_by}, {flops / 1e12:.4f} TFLOP); infer wall "
                          f"({PROJ_FRAMES} frames, prefill, {PROJ_NEW} tokens) {r['infer_ms']:.3f} "
                          f"ms, {r['forwards']} decode forwards; prefill of {r['spliced']} tokens "
                          f"in bucket {r['bucket']}: {r['launches']['flash_attention']} flash "
                          f"launches ({r['launches']['flash_attention_tc']} tensor-core)")
        del model, proj, p, mem
        torch.cuda.empty_cache()

    # the released layout: mm_projector.bin (timm names, gate embedded) beside
    # a full-SFT .bin of the decoder (cut to L2 layers) and the vision tower
    cfg2 = base.replace(mm_projector_type="stc_connector",
                        text=dataclasses.replace(base.text, num_layers=L2))
    tree = init_streammind_params(torch.Generator(device=dev).manual_seed(23), cfg2, device=dev,
                                  dtype=bf16)
    with_released_extras(tree["projector"], torch.Generator(device=dev).manual_seed(24))
    path = PROJ_DIR / "VideoLLaMA2-7B-stc-text2"
    shutil.rmtree(PROJ_DIR, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        sd = full_sft_state_dict({k: v for k, v in tree.items() if k != "projector"}, cfg2)
        n_keys, _ = check_against_manifest(sd, L2, projector=False)
        proj_sd = {"model.mm_projector." + k: x
                   for k, x in connector_state_dict(tree["projector"]).items()}
        path.mkdir(parents=True)
        torch.save(sd, path / "pytorch_model.bin")
        torch.save(proj_sd, path / "mm_projector.bin")
        (path / "streammind_config.json").write_text(cfg2.to_json())
        gb = sum(x.numel() * x.element_size() for x in (*sd.values(), *proj_sd.values())) / 1e9
        write_s = time.perf_counter() - t0
        del sd, proj_sd
        (m2, _, _, _), load_ms, _ = timed(lambda: api.model_init(str(path), tokenizer=tok,
                                                                 load_4bit="pc", device=dev))
        want = {"vision": fuse_vit_qkv(tree["vision"]), "projector": tree["projector"],
                "text": fuse_text_linears(quantize_text_params(tree["text"], bits=4,
                                                               scheme="pc"))}
        bad = bitwise_differences(m2.params, want)
        n_proj = len(list(flatten_with_paths(want["projector"])))
        del want, tree
        if bad or m2.cfg != cfg2:
            raise RuntimeError(f"the loaded STC checkpoint differs from the written one: "
                               f"{bad[:8]}, config equal {m2.cfg == cfg2}")
        log("projectors", f"released STC layout: {n_keys} full-SFT keys (the decoder cut to {L2} "
                          f"layers) + mm_projector.bin ({n_proj} projector leaves: timm's "
                          f"RegStage names with the downsample norms and SE biases, the gate "
                          f"under cls_net.cls_model), {gb:.2f} GB bf16 written in {write_s:.1f} s; "
                          f"model_init(path, load_4bit='pc') in {load_ms:.1f} ms: every leaf "
                          f"bitwise the written one (the projector's {n_proj} as they are)")
        ckpt = projector_infer(api, m2, tok, video, "stc checkpoint")
        expect = {k: 0 for k in ckpt["launches"]}
        expect.update(flash_attention=L2, flash_attention_tc=L2,
                      int4_matvec=4 * L2 * ckpt["forwards"])
        check_counts("projectors checkpoint", ckpt["launches"], expect)
        log("projectors", f"[{CARD}] STC checkpoint (int4 'pc' decoder, {L2} layers): infer wall "
                          f"{ckpt['infer_ms']:.3f} ms, {ckpt['forwards']} decode forwards, "
                          f"launches {ckpt['launches']}")
        del m2
        torch.cuda.empty_cache()
        runs.append(ckpt["launches"])

        # train(): the adapter stage over the STC connector at full width
        cfg = base.replace(mm_projector_type="stc_connector")
        ds = connector_dataset(PROJ_DIR / "data", size)
        out = PROJ_DIR / "train"
        args = (ModelArguments(tune_mm_mlp_adapter=True, mm_projector_type="stc_connector"),
                DataArguments(num_workers=2),
                TrainingArguments(output_dir=str(out), learning_rate=TRAIN_LR, bf16=True,
                                  max_steps=PROJ_TRAIN_STEPS, save_steps=PROJ_TRAIN_STEPS,
                                  logging_steps=1, per_device_train_batch_size=1,
                                  gradient_accumulation_steps=1, gradient_checkpointing=True,
                                  seed=0, resume=False, device=dev))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        state = train(*args, dataset=ds, cfg=cfg)
        torch.cuda.synchronize()
        counts = read_launches()
        peak = torch.cuda.max_memory_allocated()
        with open(out / "logs" / "metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        losses = [r["train/loss"] for r in recs]
        step_ms = [(b["ts"] - a["ts"]) * 1e3 for a, b in zip(recs, recs[1:])]
        sample = ds[0]
        supervised = int((sample["labels"][0, 1:] != -100).sum())
        expect = {k: 0 for k in counts}
        expect.update(flash_attention_lse=2 * L * PROJ_TRAIN_STEPS,
                      flash_bwd_dq=L * PROJ_TRAIN_STEPS, flash_bwd_dkv=L * PROJ_TRAIN_STEPS)
        expect.update({f"{n}_tc": expect[n] for n in TRAIN_KERNELS})
        trainable = param_count({k: v for k, v in state.params["projector"].items()
                                 if k != "cls_net"})
        n_step = connector_step_len()
        log("projectors", f"[{CARD}] train(): adapter stage over stc_connector, {PROJ_FRAMES}-frame "
                          f"SFT clips ({n_step} spliced tokens, bucket "
                          f"{bucket_length(n_step, PLAN_BUCKETS)}), remat, "
                          f"B 1: losses {losses}; step ms (synchronized, after the first) "
                          f"{[round(t, 3) for t in step_ms]}, median "
                          f"{statistics.median(step_ms):.3f}; supervised tokens/s "
                          f"{supervised / statistics.median(step_ms) * 1e3:.3f} ({supervised} a "
                          f"step); peak {peak / 1e9:.2f} GB; {trainable} trainable parameters; "
                          f"launches {counts}")
        if len(losses) != PROJ_TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f"connector training losses: {losses}")
        check_counts("projectors train", counts, expect)
        runs.append(counts)
        del state
    finally:
        shutil.rmtree(PROJ_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(rows=rows, ckpt=ckpt, train=dict(losses=losses, step_ms=step_ms,
                                                 peak_gb=peak / 1e9, supervised=supervised),
                launches=add_counts(*runs))


def clip_projector_params(cfg, g, device="cpu"):
    """A clip projector drawn from ``g`` without the gate LM that the
    connectors embed (``simple_project`` does not read it)."""
    from streammind_torch.models import connectors, projector

    t = cfg.mm_projector_type
    if t in projector._SPATIAL:
        return projector._SPATIAL[t][0](g, cfg, device=device)
    if t in projector._CONNECTORS:
        return connectors.init_stc_connector(g, cfg, variant=projector._CONNECTORS[t],
                                             device=device)
    return projector.init_projector_params(g, cfg, device=device)


def projectors_parity(dev):
    """Every projector type's ``simple_project`` at StreamMind-7B's widths on
    PROJ_PARITY_FRAMES frames (338 STC tokens), and one Mamba-2 block at
    mamba2-2.7b's widths (``mamba2_forward`` over MAMBA2_L tokens, then
    MAMBA2_STEPS ``mamba2_step``s), in fp32 on the CPU and on the card with
    TF32 off (matmul and cuDNN), within PROJ_PARITY_TOL; then on the card
    with TF32 on, which must cross it."""
    from streammind_torch.config import StreamMindConfig
    from streammind_torch.models import mamba2 as m2
    from streammind_torch.models.projector import simple_project
    from streammind_torch.utils.params import tree_map

    base = StreamMindConfig()
    rng = torch.Generator().manual_seed(61)
    feats = torch.randn((1, PROJ_PARITY_FRAMES, 576, base.mm_hidden_size), generator=rng)
    m2cfg = m2.Mamba2Config(**MAMBA2_27B)
    u = 0.5 * torch.randn((1, MAMBA2_L, m2cfg.d_model), generator=rng)
    steps = 0.5 * torch.randn((1, MAMBA2_STEPS, m2cfg.d_model), generator=rng)

    def mamba2_run(p, where):
        y, st = m2.mamba2_forward(p, m2cfg, u.to(where), return_state=True)
        ys = []
        for t in range(MAMBA2_STEPS):
            y_t, st = m2.mamba2_step(p, m2cfg, steps[:, t].to(where), st)
            ys.append(y_t)
        return torch.cat([y.flatten(), torch.stack(ys, 1).flatten(), st.ssm.flatten()]).cpu()

    cases = {t: base.replace(mm_projector_type=t) for t in (*PROJ_TOKENS, "identity")}
    cases["mamba2"] = None
    errs, controls = {}, {}
    t0 = time.perf_counter()
    for i, (name, cfg) in enumerate(cases.items()):
        g = torch.Generator().manual_seed(62 + i)
        if cfg is None:
            params = m2.init_mamba2_params(g, m2cfg, device="cpu")
            fn = mamba2_run
        else:
            params = clip_projector_params(cfg, g)
            fn = (lambda c: lambda p, where: simple_project(p, c, feats.to(where)).cpu())(cfg)
        with torch.no_grad():
            ref = fn(params, "cpu")
            card = tree_map(lambda t: t.to(dev), params)
            out = {}
            for run, tf32 in (("card", False), ("card_tf32", True)):
                with tf32_matmuls(tf32):
                    out[run] = fn(card, dev)
        errs[name] = excess(out["card"], ref, *PROJ_PARITY_TOL)
        controls[name] = excess(out["card_tf32"], ref, *PROJ_PARITY_TOL)
        if not torch.isfinite(ref).all() or ref.shape != out["card"].shape:
            raise RuntimeError(f"projectors parity {name}: {tuple(ref.shape)} vs "
                               f"{tuple(out['card'].shape)}")
        del params, card, ref, out
        torch.cuda.empty_cache()
    tol = tol_text(PROJ_PARITY_TOL, "fp32")
    log("parity", f"projectors ({PROJ_PARITY_FRAMES} frames, StreamMind-7B widths) and a Mamba-2 "
                  f"block (mamba2-2.7b widths, L {MAMBA2_L} + {MAMBA2_STEPS} steps), fp32 "
                  f"({time.perf_counter() - t0:.1f} s): (max |cpu - card|, excess over [{tol}]) = "
                  f"{errs}")
    crossed = sorted(n for n, (_, over) in controls.items() if over > 0)
    log("parity", f"projectors: control, TF32 on (matmul and cuDNN): {controls}; over the limit: "
                  f"{crossed}")
    if any(over > 0 for _, over in errs.values()):
        raise RuntimeError(f"projectors: CPU (fp32) and card disagree: {errs}")
    if not crossed:
        raise RuntimeError("projectors: the parity limit does not see TF32 on the card")
    return dict(errs=errs, controls=controls)


# ---------------------------------------------------------------------------
# phase 23: parallelism (dp / fsdp / tp over torch.distributed) at world size 1
# ---------------------------------------------------------------------------
PARALLEL_DIR = Path(__file__).resolve().parent / "_smoke_parallel"
TP_SIZES = (2, 4, 8)
PAR_TRAIN_STEPS = 2
PAR_LOSS_TOL = 1e-3


def rank_matvec_shapes(tp: int):
    """Mistral-7B's decoder linears as one rank of tp holds them: q and
    gate/up column shards (out / tp), o and down row shards (in / tp)."""
    return ((f"tp{tp} rank: q (column)", 4096 // tp, 4096),
            (f"tp{tp} rank: o (row)", 4096, 4096 // tp),
            (f"tp{tp} rank: gate/up (column)", 14336 // tp, 4096),
            (f"tp{tp} rank: down (row)", 4096, 14336 // tp))


def int4_row_shard_cases(dev, g):
    """Per-channel int4 o and down cut by tp on the in dim as the
    partitioning places them (``local_shard``: each rank's columns unpacked
    and repacked column-halved, so its shard reads its own two ranges of
    x): the kernel on every rank's shard against its plain version (bf16
    x), and, with fp32 x (one rounding less a rank), the ranks' kernel
    products summed against the whole matrix's plain product."""
    from streammind_torch.ops.int4_matvec import int4_matvec, int4_matvec_ref
    from streammind_torch.parallel.partitioning import local_shard, spec_for
    from streammind_torch.utils.quantize import (dequantize_linear_weight_int4_pc,
                                                 quantize_linear_weight_int4_pc)

    rows = []
    for name, path, din in (("o", "text.layers.o.w_int4pc", 4096),
                            ("down", "text.layers.mlp.down.w_int4pc", 14336)):
        dout = 4096
        full = quantize_linear_weight_int4_pc(torch.empty((dout, din), device=dev).normal_(
            0.0, 0.02, generator=g))
        x = torch.empty((1, din), device=dev, dtype=torch.bfloat16).normal_(generator=g)
        whole32 = int4_matvec_ref(x.float(), full["w_int4pc"], full["scale"])
        spec = spec_for(path, 3)
        for tp in TP_SIZES:
            shards = [local_shard(full["w_int4pc"][None], spec, {"tp": tp}, {"tp": r}, path)[0]
                      for r in range(tp)]
            xs = [c.contiguous() for c in x.chunk(tp, dim=1)]
            outs = [int4_matvec(xs[r], shards[r], full["scale"]) for r in range(tp)]
            errs = [excess(outs[r], int4_matvec_ref(xs[r], shards[r], full["scale"]), *INT4_TOL)
                    for r in range(tp)]
            x32 = [t.float() for t in xs]
            errs.append(excess(sum(int4_matvec(x32[r], shards[r], full["scale"])
                                   for r in range(tp)), whole32, *INT4_TOL))
            packs = [shards[0]] + [shards[0].clone() for _ in range(n_sets(shards[0].numel()) - 1)]
            fns = [lambda w=w: int4_matvec(xs[0], w, full["scale"]) for w in packs]
            ms, eager = cuda_ms(fns, graph=True), cuda_ms(fns)
            plain = cuda_ms([lambda w=w: int4_matvec_ref(xs[0], w, full["scale"]) for w in packs],
                            iters=5)
            libs = [dequantize_linear_weight_int4_pc({"w_int4pc": w, "scale": full["scale"]},
                                                     torch.bfloat16) for w in packs]
            lib = cuda_ms([lambda w=w: F.linear(xs[0], w) for w in libs], graph=True)
            k = din // tp
            b_ms, b_by = bound(dout * k / 2 + 4 * dout + 2 * (k + dout), 2.0 * dout * k,
                               BF16_FLOPS)
            rows.append(dict(shape=f"tp{tp} rank: {name} (row, repacked): x(1,{k}) bfloat16 "
                                   f"W({dout},{k}/2) int4; the {tp} ranks' fp32 sum vs the "
                                   f"whole",
                             max_abs_err=max(e for e, _ in errs), errs=[e for e, _ in errs],
                             ok=all(o <= 0 for _, o in errs), ms=ms, eager_ms=eager,
                             plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                             ms_over_bound=ms / b_ms))
            del packs, libs
        torch.cuda.empty_cache()
    return rows


def rank_kernel_cases(dev):
    """Every kernel of the sharded paths at the shapes one rank of tp 2, 4
    and 8 holds: the flash forward at (16, 4), (8, 2) and (4, 1) heads (the
    2048 bucket from an empty cache and the session's bucket 64 at offset
    100), the three training kernels at the 2048 bucket, exact attention at
    8, 4 and 2 of the ViT's heads, the int8 and int4 matvecs at the column
    and row shards of q, o, gate/up and down (the int4 row shards repacked
    as placed), the scan at 4096, 2048 and 1024 of the Mamba's channels."""
    g = torch.Generator(device=dev).manual_seed(4321)
    bf16 = torch.bfloat16

    def randn(*shape, std=1.0):
        return torch.empty(shape, device=dev, dtype=bf16).normal_(0.0, std, generator=g)

    out = {n: [] for n in ("flash_attention", "exact_attention", "flash_attention_lse",
                           "flash_bwd_dq", "flash_bwd_dkv", "int8_matvec", "int4_matvec",
                           "selective_scan")}
    for tp in TP_SIZES:
        tag = f" (tp{tp} rank)"
        h, hkv = 32 // tp, 8 // tp
        out["flash_attention"] += flash_cases(
            dev, randn, ((2048, [0], [2048], h, hkv), (64, [100], [150], h, hkv)), tag)
        out["exact_attention"] += exact_cases(dev, randn, (1,), h=16 // tp, tag=tag)
        for name, rows in train_kernel_cases(dev, randn, ((1, 2048, h, hkv, 128, [2048]),),
                                             tag).items():
            out[name] += rows
        out["int8_matvec"] += int8_cases(dev, g, rank_matvec_shapes(tp), (bf16,), (1,))
        out["int4_matvec"] += int4_cases(dev, g, rank_matvec_shapes(tp)[::2], (bf16,), (1,))
        for c in scan_cases(dev, g, ((bf16, 1, 32, True, "time"),), d=8192 // tp):
            c["shape"] += tag
            out["selective_scan"].append(c)
    out["int4_matvec"] += int4_row_shard_cases(dev, g)
    return out


def mesh_sessions(dev, mesh):
    """The 10-frame two-turn session of phase 4 on StreamMind-7B (bf16,
    seed 0) through the meshless engine and through
    ``StreamMindEngine(mesh=(1,1,1))`` on the same frames: both fuse the
    ViT's q/k/v (the decoder, a bf16 7B tree, stays unfused on both), the
    mesh issues no collective, so the memory ring and prefill logits are
    within BF16_TOL of each other (bitwise, where nothing parts them), the
    kernel launches equal, and the greedy tokens that agree are counted.
    Timed in turns."""
    from streammind_torch.config import StreamMindConfig
    from streammind_torch.models.meta import init_streammind_params

    cfg = StreamMindConfig()
    g = torch.Generator(device=dev).manual_seed(0)
    params = init_streammind_params(g, cfg, device=dev, dtype=torch.bfloat16)
    Engine = make_engine_class()
    engines = {"meshless": Engine(params, cfg, attn_impl="exact", quantize_gate="int4",
                                  device=dev),
               "mesh": Engine(params, cfg, attn_impl="exact", quantize_gate="int4", device=dev,
                              mesh=mesh)}
    layouts = {k: ("qkv" in e.params["vision"]["layers"], "qkv" in e.params["text"]["layers"])
               for k, e in engines.items()}
    if layouts != {"meshless": (True, False), "mesh": (True, False)}:
        raise RuntimeError(f"(ViT qkv fused, decoder qkv fused) by engine: {layouts}")
    fg = torch.Generator(device=dev).manual_seed(7)
    size = cfg.vision.image_size
    frames = [torch.empty((1, 3, size, size), device=dev, dtype=torch.bfloat16).normal_(
        generator=fg) for _ in range(10)]
    runs = {}
    # in turns (each engine once forward, once back): host times drift within a call
    for name in (*engines, *reversed(engines)):
        eng = engines[name]
        eng.probs, eng.prefill_logits, eng.decoded, eng.decode_ms = [], [], [], []
        torch.cuda.synchronize()
        reset_launches()
        session, ticks, e2ft = run_session(eng, frames, (3, 7), max_new=16)
        n_tok = sum(len(t) for t in eng.decoded)
        run = dict(memory=session.state.memory.float(), logits=torch.cat(eng.prefill_logits),
                   tokens=eng.decoded, launches=read_launches(),
                   tick_ms=[statistics.median(ticks[1:])], e2ft_ms=e2ft,
                   decode_ms_per_token=[sum(eng.decode_ms) / max(n_tok, 1)])
        if name in runs:  # the second turn: its times beside the first's
            for k in ("tick_ms", "decode_ms_per_token"):
                runs[name][k] += run[k]
        else:
            runs[name] = run
        del session
    a, b = runs["meshless"], runs["mesh"]
    errs = {k: excess(b[k], a[k], *BF16_TOL) for k in ("memory", "logits")}
    agree = sum(x == y for ta, tb in zip(a["tokens"], b["tokens"]) for x, y in zip(ta, tb))
    total = sum(len(t) for t in a["tokens"])
    kern = ("flash_attention", "exact_attention", "int4_matvec", "selective_scan")
    for name, r in runs.items():
        log("parallel", f"[{CARD}] session {name} (two turns): median tick "
                        f"{[round(t, 3) for t in r['tick_ms']]} ms, event-to-first-token "
                        f"{[round(t, 3) for t in r['e2ft_ms']]} ms, decode "
                        f"{[round(t, 3) for t in r['decode_ms_per_token']]} ms/token; launches "
                        f"{ {k: r['launches'][k] for k in kern} }")
    bitwise = torch.equal(a["memory"], b["memory"]) and torch.equal(a["logits"], b["logits"])
    log("parallel", f"(1,1,1) mesh against meshless: memory max|err| {errs['memory'][0]:.3e}, "
                    f"prefill logits max|err| {errs['logits'][0]:.3e} (limit {BF16_TOL_TEXT}; "
                    f"bitwise {bitwise}); greedy tokens agreeing {agree} of {total}")
    if any(over > 0 for _, over in errs.values()):
        raise RuntimeError(f"the (1,1,1)-mesh session parts from the meshless one: {errs}")
    if any(a["launches"][k] != b["launches"][k] for k in kern):
        raise RuntimeError(f"launch counts differ: {a['launches']} vs {b['launches']}")
    del engines, params, frames
    torch.cuda.empty_cache()
    return dict(runs={k: {m: v for m, v in r.items() if m not in ("memory", "logits")}
                      for k, r in runs.items()}, agree=agree, tokens=total, bitwise=bitwise,
                errs={k: e for k, (e, _) in errs.items()})


def mesh_parity(dev, mesh):
    """The (1,1,1)-mesh session of ``parity`` (fp32, parity depths, TF32
    off) on the CPU (a process-local (1,1,1) mesh) and on the card (the
    NCCL mesh): fires and greedy tokens identical, probs, memory and
    prefill logits within ``parity``'s limits; a TF32-on control that must
    cross one of them."""
    from streammind_torch.models.meta import init_streammind_params
    from streammind_torch.parallel.mesh import LocalMesh

    cfg = parity_config()
    params = init_streammind_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    rng = torch.Generator().manual_seed(2)
    frames = [torch.randn((1, 3, 336, 336), generator=rng) for _ in range(4)]
    Engine = make_engine_class()
    out = {}
    for run, where, tf32 in (("cpu", "cpu", False), ("card", dev, False),
                             ("card_tf32", dev, True)):
        with tf32_matmuls(tf32):
            eng = Engine(params, cfg, attn_impl="exact", quantize_gate="int4", kv_capacity=1024,
                         device=where, mesh=LocalMesh("cpu") if where == "cpu" else mesh)
            reset_launches()
            session, _, _ = run_session(eng, [f.to(where) for f in frames], (1, 3), max_new=8)
            counts = read_launches()
            out[run] = dict(probs=torch.stack(eng.probs), memory=session.state.memory[0, :4].cpu(),
                            logits=torch.cat(eng.prefill_logits), tokens=eng.decoded)
            if where != "cpu":
                fp32_only(counts, "parallel parity")
            del eng, session
    tol = {"probs": 2e-5, "memory": 2e-5, "logits": 2e-4}  # parity()'s
    c = out["cpu"]
    errs, control = ({k: float((c[k] - out[run][k]).abs().max()) for k in tol}
                     for run in ("card", "card_tf32"))
    log("parallel", f"(1,1,1)-mesh parity, fp32, TF32 off: max |cpu - card| = {errs}, "
                    f"tolerance {tol}; tokens equal {c['tokens'] == out['card']['tokens']}; "
                    f"TF32-on control {control}")
    if any(errs[k] > tol[k] for k in tol) or c["tokens"] != out["card"]["tokens"]:
        raise RuntimeError("the (1,1,1)-mesh session disagrees between CPU and card")
    if not any(control[k] > tol[k] for k in tol):
        raise RuntimeError("the parity limits do not see TF32 matmuls on the card")
    return errs


def expert_parallel_layer(dev, mesh):
    """One Mixtral-8x7B MoE layer (8 experts, 4096 / 14336, top 2; bf16
    from a seed, 2.8 GB) on 64 tokens: the expert-parallel grouped dispatch
    on the (1,1,1) mesh bitwise the one-device grouped dispatch, and the
    rank-local bodies of tp 2 and 4 summed within BF16_TOL of it."""
    from streammind_torch.config import StreamMindConfig
    from streammind_torch.models import mistral as lm

    cfg = dataclasses.replace(StreamMindConfig().text, num_experts=8, num_experts_per_tok=2)
    g = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape, std=0.02):
        return torch.empty(shape, device=dev, dtype=torch.bfloat16).normal_(0.0, std, generator=g)

    E, F_, D = cfg.num_experts, cfg.intermediate_size, cfg.hidden_size
    ex = {"gate": randn(E, F_, D), "up": randn(E, F_, D), "down": randn(E, D, F_)}
    xt, router = randn(64, D, std=1.0), randn(E, D)
    probs = torch.softmax((xt @ router.T).float(), dim=-1)
    topw, topi = lm.router_top_k(probs, cfg.num_experts_per_tok)
    topw = topw / topw.sum(-1, keepdim=True)
    grouped = lm._moe_apply_grouped(xt, ex, cfg, topi, topw)
    sharded = lm._moe_apply_grouped_sharded(xt, ex, cfg, topi, topw, mesh)
    same = torch.equal(grouped, sharded)
    fns = {"grouped": lambda: lm._moe_apply_grouped(xt, ex, cfg, topi, topw),
           "sharded (1,1,1)": lambda: lm._moe_apply_grouped_sharded(xt, ex, cfg, topi, topw, mesh)}
    ms = {k: [] for k in fns}
    for k in ("grouped", "sharded (1,1,1)", "sharded (1,1,1)", "grouped"):  # in turns
        ms[k].append(cuda_ms([fns[k]], iters=10))
    errs = {}
    for tp in (2, 4):
        parts = [lm._moe_grouped_local(xt, {n: e.chunk(tp)[r] for n, e in ex.items()}, cfg,
                                       topi, topw, r, tp) for r in range(tp)]
        errs[tp] = excess(sum(p.float() for p in parts), grouped.float(), *BF16_TOL)
    log("parallel", f"[{CARD}] expert-parallel MoE layer, 64 tokens: sharded (1,1,1) bitwise the "
                    f"grouped: {same}; ms {ms}; the tp 2 and 4 rank bodies summed, max|err| "
                    f"{ {tp: e for tp, (e, _) in errs.items()} } ({BF16_TOL_TEXT})")
    if not same or any(over > 0 for _, over in errs.values()):
        raise RuntimeError("the expert-parallel dispatch parts from the grouped one")
    del ex, xt
    torch.cuda.empty_cache()
    return dict(bitwise=same, ms=ms, errs={tp: e for tp, (e, _) in errs.items()})


def mesh_train(dev, ds, out_dir: Path):
    """train() on StreamMind-7B (bf16, seed 0), the adapter stage at the
    training phase's shape, PAR_TRAIN_STEPS steps: losses, launches,
    flash_mha_sharded's calls, peak memory."""
    from streammind_torch.config import StreamMindConfig
    from streammind_torch.ops import attention as A
    from streammind_torch.train.run import train

    ma, da, ta = train_args("adapter", dev, PAR_TRAIN_STEPS, resume=False)
    ta = dataclasses.replace(ta, output_dir=str(out_dir))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    A.flash_mha_sharded.calls = 0
    t0 = time.perf_counter()
    state = train(ma, da, ta, dataset=ds, cfg=StreamMindConfig())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    with open(out_dir / "logs" / "metrics.jsonl") as f:
        losses = [json.loads(line)["train/loss"] for line in f]
    run = dict(losses=losses, launches=read_launches(), sharded_calls=A.flash_mha_sharded.calls,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, seconds=seconds)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return run


def parallel_phase(dev):
    """NCCL at world size 1 through ``utils/dist``, then on the (1,1,1) mesh
    the kernels at a rank's shapes, the session, its fp32 parity, the
    expert-parallel layer and 2 adapter steps through train(); then the
    group is destroyed and the same 2 steps run with no process group."""
    import torch.distributed as tdist

    from streammind_torch.parallel.mesh import LocalMesh, make_mesh
    from streammind_torch.utils import dist as D

    require_freed("parallel")
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    PARALLEL_DIR.mkdir()
    t0 = time.perf_counter()
    D.init_process_group(init_method=f"file://{PARALLEL_DIR / 'rendezvous'}", world_size=1,
                         rank=0, device=dev)
    backend = tdist.get_backend()
    D.barrier()
    gathered, mean = D.allgather_object({"rank": D.rank()}), D.allreduce_mean(3.5)
    t = torch.arange(1, 9, device=dev, dtype=torch.bfloat16)
    reduced = t.clone()
    tdist.all_reduce(reduced)
    gathered_t, scattered = torch.empty_like(t), torch.empty_like(t)
    tdist.all_gather_into_tensor(gathered_t, t)
    tdist.reduce_scatter_tensor(scattered, t)
    torch.cuda.synchronize()
    mesh = make_mesh(1, 1, 1)
    log("parallel", f"process group: backend {backend}, world {D.size()}, rank {D.rank()}, "
                    f"{time.perf_counter() - t0:.2f} s; allgather_object {gathered}, "
                    f"allreduce_mean {mean}; bf16 all_reduce / all_gather_into_tensor / "
                    f"reduce_scatter_tensor equal to the input: "
                    f"{[torch.equal(x, t) for x in (reduced, gathered_t, scattered)]}; mesh "
                    f"{type(mesh).__name__} {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    if (backend != "nccl" or gathered != [{"rank": 0}] or mean != 3.5 or isinstance(mesh, LocalMesh)
            or not all(torch.equal(x, t) for x in (reduced, gathered_t, scattered))):
        raise RuntimeError("NCCL at world size 1 did not initialize as expected")

    kernels = report_cases({n: (c, "per-rank shapes") for n, c in
                            rank_kernel_cases(dev).items()})
    sessions = mesh_sessions(dev, mesh)
    parity_errs = mesh_parity(dev, mesh)
    moe = expert_parallel_layer(dev, mesh)
    ds = train_data()
    meshed = mesh_train(dev, ds, PARALLEL_DIR / "train_mesh")
    D.shutdown()
    plain = mesh_train(dev, ds, PARALLEL_DIR / "train_plain")
    del ds
    micro = 2 * PAR_TRAIN_STEPS
    for name, r in (("(1,1,1) NCCL mesh", meshed), ("no process group", plain)):
        log("parallel", f"[{CARD}] train {name}: losses {r['losses']}, "
                        f"{r['seconds']:.1f} s, peak {r['peak_gb']:.2f} GB; launches a "
                        f"microbatch { {n: r['launches'][n] / micro for n in TRAIN_KERNELS} }, "
                        f"through flash_mha_sharded {r['sharded_calls'] / micro:g} a microbatch")
    diff = max(abs(a - b) for a, b in zip(meshed["losses"], plain["losses"]))
    log("parallel", f"losses |mesh - no group| max {diff:.3e} (limit {PAR_LOSS_TOL})")
    layers = 32
    expect = {"flash_attention_lse": 2 * layers, "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
    if (len(meshed["losses"]) != PAR_TRAIN_STEPS or diff > PAR_LOSS_TOL
            or any(meshed["launches"][n] != micro * c for n, c in expect.items())
            or meshed["sharded_calls"] != micro * 2 * layers):
        raise RuntimeError(f"the mesh training run: {meshed}")
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    # the main path's launches: the (1,1,1)-mesh session's and training's
    launches = add_counts(sessions["runs"]["mesh"]["launches"], meshed["launches"])
    return dict(kernels=kernels, sessions=sessions, parity=parity_errs, moe=moe,
                train={"mesh": meshed, "no_group": plain}, launches=launches)


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
    t_start = time.perf_counter()
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

    seconds = {}  # wall seconds of each phase, printed before the kernels line

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    kernels = run("kernels", check_kernels, dev)
    engine, g = run("engine", build_engine, dev)
    session = run("session", full_width_session, engine, g, dev)
    serving = run("serving", serving_phase, engine, g, dev)
    model, tok, processor, api_run = run("api", api_phase, engine, g, dev)
    real_weights = run("real_weights", real_weights_phase, dev, g)
    worker = run("worker", worker_phase, model, tok, g, dev)
    evaluation = run("eval", eval_phase, model, tok, processor, dev)
    projectors = run("projectors", projectors_phase, engine, g, dev)
    del engine, model
    torch.cuda.empty_cache()
    qwen2 = run("qwen2", qwen2_phase, dev)
    mixtral = run("mixtral", mixtral_phase, dev)
    run("decoders_parity", decoders_parity, dev)
    run("projectors_parity", projectors_parity, dev)
    kernels["paged_attention"][0].append(check_paged_serving_case(dev, serving["attn_lengths"][3]))
    fast = run("fast", fast_phase, dev)
    run("fast_parity", fast_parity, dev)
    run("parity", parity, dev)
    run("api_parity", api_parity, dev)
    run("eval_parity", eval_parity, dev)
    ds = train_data()
    training = run("train", training_phase, dev, ds)
    fp32_tree = parity_tree()
    run("train_parity", training_parity, dev, fp32_tree)
    qlora = run("qlora", qlora_phase, dev, ds)
    del ds
    run("qlora_parity", qlora_parity, dev, fp32_tree)
    del fp32_tree
    parallel = run("parallel", parallel_phase, dev)
    for name, (cases, _) in parallel["kernels"].items():
        kernels[name][0].extend(cases)
    for name, cases in real_weights["kernels"].items():
        kernels[name][0].extend(cases)
    log("time", f"phase seconds: {seconds}; total {time.perf_counter() - t_start:.1f} s")

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
                              "real_weights": real_weights["launches"][name],
                              "worker": worker["launches"][name],
                              "eval": evaluation["launches"][name],
                              "qlora": qlora["launches"][name],
                              "qwen2": qwen2["launches"][name],
                              "mixtral": mixtral["launches"][name],
                              "projectors": projectors["launches"][name],
                              "parallel": parallel["launches"][name]},
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
                    ("train", training), ("api", api_run), ("real_weights", real_weights),
                    ("worker", worker),
                    ("eval", evaluation), ("qlora", qlora), ("qwen2", qwen2),
                    ("mixtral", mixtral), ("projectors", projectors), ("parallel", parallel))},
                hgmma=hgmma[src.split("/")[-1][:-3]], ms_over_bound=head["ms_over_bound"],
                timing="CUDA graph replay (device time); eager_ms in cases")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
