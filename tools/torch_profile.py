#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one CUDA card.

    python3 tools/torch_profile.py [--only stc_projection]

Builds StreamMind-7B in bf16 from a seed (as ``chip_smoke.py`` does: exact
ViT attention, int4 gate), warms up one forced turn, then runs five
regions under ``torch.profiler``: six per-frame ticks
(``StreamMindEngine.perceive_step``), one cached prefill of a turn,
sixteen greedy decode steps over the dense cache, then the multi-stream
server's batched turn over the paged KV pool (page 64): one prefill of
K = 3 dialogues and sixteen lockstep decode steps; then the fast serving
tier (int8 decoder through the load_8bit transform, quantize_gate="int8",
fast_vision="int8"): six ticks, sixteen int8 decode steps and one burst
catch-up of 32 frames (``perceive_burst``); last, after a warm-up, one
training microbatch of the adapter stage (``make_grad_step`` of the
stage-1 loss: a 1,980-token prompt with 64 frames of pre-extracted
features, spliced into the 2048 bucket, remat, the flash training
kernels in every layer; forward, recompute and backward, no optimizer
step), and beside it the training projector's plain scan alone
(``selective_scan_ref``, which ``mamba_project`` reaches with
impl="auto"), forward and backward, on the inputs it took in that
microbatch; then the same microbatch on the QLoRA path (the llm stage:
the decoder int4 in groups of 64, LoRA r 128 on its seven projections,
gradients of the LoRA factors and the projector).  For each region it
prints one JSON line:
host wall time (synchronized), the device's busy time (the sum of kernel
and copy times the profiler saw), the idle share, the number of device
operations, and the ten device operations that took the most time.  Last
(or alone, with ``--only stc_projection``), the STC connector of
VideoLLaMA2-7B (``mm_projector_type="stc_connector"`` at StreamMind-7B's
widths, bf16 from a seed) projecting one 8-frame clip: forward, and
forward + backward as the adapter stage runs it.
Imports nothing of JAX; fails without a CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

FRAMES = 6    # ticks profiled
DECODE = 16   # decode steps profiled
PAGED_K = 3   # dialogues in the paged lockstep decode
BURST = 32    # frames of the profiled burst catch-up
SEED = 0


def device_ops(prof):
    """[(name, calls, device µs)] of the device-side events, by total time."""
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, e.count, float(us)))
    return sorted(rows, key=lambda r: -r[2])


def profiled(name, fn, reps=1, units=None):
    """Run ``fn`` ``reps`` times under the profiler and print the region's
    line, its times per unit (``units`` defaults to ``reps``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    units = units or reps
    ops = device_ops(prof)
    busy_ms = sum(r[2] for r in ops) / 1e3
    line = dict(region=name, units=units, wall_ms=wall_ms / units,
                device_busy_ms=busy_ms / units,
                idle_share=(1.0 - busy_ms / wall_ms) if busy_ms else None,
                device_ops=sum(r[1] for r in ops) / units,
                top=[dict(name=n[:90], calls=c / units, ms=us / 1e3 / units)
                     for n, c, us in ops[:10]])
    print(json.dumps(line), flush=True)
    if not ops:
        raise RuntimeError(f"{name}: the profiler saw no device time")
    return out


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=["stc_projection"], default=None,
                    help="profile this region alone")
    only = ap.parse_args().only
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if only == "stc_projection":
        from streammind_torch.config import StreamMindConfig

        stc_projection(StreamMindConfig(), "cuda")
        return 0

    from streammind_torch.config import StreamMindConfig
    from streammind_torch.constants import VIDEO_TOKEN_INDEX
    from streammind_torch.models.meta import init_streammind_params
    from streammind_torch.streaming import StreamMindEngine
    from streammind_torch.streaming.engine import build_turn_plan, turn_suffix_ids
    from streammind_torch.streaming.paged import PagedDialogues

    from chip_smoke import StandInTokenizer

    dev = "cuda"
    cfg = StreamMindConfig()
    g = torch.Generator(device=dev).manual_seed(SEED)
    params = init_streammind_params(g, cfg, device=dev, dtype=torch.bfloat16)
    engine = StreamMindEngine(params, cfg, attn_impl="exact", quantize_gate="int4", device=dev)
    del params
    frames = [torch.empty((1, 3, 336, 336), device=dev, dtype=torch.bfloat16).normal_(generator=g)
              for _ in range(FRAMES + 2)]
    state = engine.new_stream_state()
    cache = engine.new_kv_cache()
    tok = StandInTokenizer()

    def turn(state, cache):
        span = list(range(state.last_fire, state.frame_idx))
        plan = build_turn_plan(engine, tok, span, turn_suffix_ids(tok, [1, 10, VIDEO_TOKEN_INDEX]))
        last, cache = engine.prefill(plan, state.memory, cache)
        return last, cache, plan

    # warm-up: two ticks and one short turn (kernel builds, allocator, cuBLAS)
    for f in frames[:2]:
        _, state = engine.perceive_step(f, state)
    last, cache, _ = turn(state, cache)
    _, cache = engine.generate_from_prefill(last, cache, max_new_tokens=4)
    torch.cuda.synchronize()

    it = iter(frames[2:])

    def tick():
        nonlocal state
        _, state = engine.perceive_step(next(it), state)

    profiled("tick", tick, reps=FRAMES)
    state = state._replace(last_fire=2)
    last, cache, plan = profiled("prefill", lambda: turn(state, cache))
    print(json.dumps(dict(prefill_bucket=len(plan.token_ids), prefill_length=plan.length,
                          cache_capacity=cache.capacity)), flush=True)
    eng_eos = engine.eos_token_id
    engine.eos_token_id = -1  # decode the full budget whatever the random weights say
    # max_new_tokens=N feeds N tokens through the decoder: N steps
    tokens, _ = profiled("decode_step", lambda: engine.generate_from_prefill(
        last, cache, max_new_tokens=DECODE), units=DECODE)
    print(json.dumps(dict(decode_tokens=len(tokens))), flush=True)
    del cache
    torch.cuda.empty_cache()

    # K dialogues on one page pool: a batched prefill, then the lockstep decode
    pd = PagedDialogues(engine, num_pages=256, page_size=64)
    dids = [f"d{i}" for i in range(PAGED_K)]
    span = list(range(state.frame_idx))
    plan = build_turn_plan(engine, tok, span, turn_suffix_ids(tok, [1, 10, VIDEO_TOKEN_INDEX]))
    for d in dids:
        pd.open(d)
        pd.ensure_capacity(d, len(plan.token_ids) + DECODE)
    table = pd._table(dids)
    memory = state.memory.expand(PAGED_K, -1, -1)
    pd._prefill(table, pd._lengths(dids), [plan] * PAGED_K, memory)  # warm-up
    last = profiled(f"paged_prefill_k{PAGED_K}", lambda: pd._prefill(
        table, pd._lengths(dids), [plan] * PAGED_K, memory))
    knobs = ([0.0] * PAGED_K, [0] * PAGED_K, [0.0] * PAGED_K)
    first = torch.argmax(last, dim=-1).tolist()
    lengths = [plan.length] * PAGED_K
    pd._decode(table, lengths, first, [2] * PAGED_K, knobs, None, None)  # warm-up
    buf, _ = profiled(f"paged_decode_step_k{PAGED_K}", lambda: pd._decode(
        table, lengths, first, [DECODE] * PAGED_K, knobs, None, None), units=DECODE)
    engine.eos_token_id = eng_eos
    print(json.dumps(dict(paged_rows=PAGED_K, page_size=pd.page_size, length=plan.length,
                          decode_tokens=int(buf.shape[1]))), flush=True)
    del engine, pd, memory
    torch.cuda.empty_cache()
    fast_tier(cfg, dev)
    torch.cuda.empty_cache()
    train_microbatch(cfg, dev)
    torch.cuda.empty_cache()
    qlora_microbatch(cfg, dev)
    torch.cuda.empty_cache()
    stc_projection(cfg, dev)
    return 0


STC_FRAMES = 8  # VideoLLaMA2's frames a clip


def stc_projection(cfg, dev):
    """The STC connector over one clip of STC_FRAMES frames of 576 patches
    (its gate LM, which the projection does not read, left out): three
    forwards under no_grad, then one forward + backward to the features'
    and the connector's gradients, each after a warm-up."""
    from streammind_torch.models.projector import init_projector_params, project_memory
    from streammind_torch.utils.params import tree_leaves

    cfg = cfg.replace(mm_projector_type="stc_connector")
    g = torch.Generator(device=dev).manual_seed(SEED)
    proj = init_projector_params(g, cfg, device=dev, dtype=torch.bfloat16)
    del proj["cls_net"]
    feats = torch.empty((1, STC_FRAMES, 576, cfg.mm_hidden_size), device=dev,
                        dtype=torch.bfloat16).normal_(generator=g)
    with torch.no_grad():
        project_memory(proj, cfg, feats)  # warm-up
        profiled("stc_projection", lambda: project_memory(proj, cfg, feats), reps=3)
    leaves = [t.requires_grad_() for t in tree_leaves(proj)]

    def fwd_bwd():
        out = project_memory(proj, cfg, feats)
        return torch.autograd.grad(out.float().square().mean(), leaves)

    fwd_bwd()  # warm-up
    profiled("stc_projection_fwd_bwd", fwd_bwd)


def fast_tier(cfg, dev):
    """The fast serving tier on a fresh seeded tree: ticks, int8 decode
    steps and one burst of BURST frames, each after a warm-up."""
    from streammind_torch.constants import VIDEO_TOKEN_INDEX
    from streammind_torch.models.meta import init_streammind_params
    from streammind_torch.streaming import StreamMindEngine
    from streammind_torch.streaming.engine import build_turn_plan, turn_suffix_ids
    from streammind_torch.utils.quantize import quantize_text_params

    from chip_smoke import StandInTokenizer, clone_state

    g = torch.Generator(device=dev).manual_seed(SEED)
    params = init_streammind_params(g, cfg, device=dev, dtype=torch.bfloat16)
    params["text"] = quantize_text_params(params["text"], bits=8, free_source=True)
    engine = StreamMindEngine(params, cfg, quantize_gate="int8", fast_vision="int8", device=dev)
    del params
    size = cfg.vision.image_size
    frames = [torch.empty((1, 3, size, size), device=dev, dtype=torch.bfloat16).normal_(
        generator=g) for _ in range(FRAMES + 2)]
    burst = torch.empty((BURST, 3, size, size), device=dev, dtype=torch.bfloat16).normal_(
        generator=g)
    state = engine.new_stream_state()
    cache = engine.new_kv_cache()
    tok = StandInTokenizer()
    for f in frames[:2]:
        _, state = engine.perceive_step(f, state)
    span = list(range(state.frame_idx))
    plan = build_turn_plan(engine, tok, span, turn_suffix_ids(tok, [1, 10, VIDEO_TOKEN_INDEX]))
    last, cache = engine.prefill(plan, state.memory, cache)
    _, cache = engine.generate_from_prefill(last, cache, max_new_tokens=4)
    engine.perceive_burst(burst, clone_state(state))  # warm-up
    torch.cuda.synchronize()

    it = iter(frames[2:])

    def tick():
        nonlocal state
        _, state = engine.perceive_step(next(it), state)

    profiled("fast_tick", tick, reps=FRAMES)
    eos = engine.eos_token_id
    engine.eos_token_id = -1
    profiled("fast_decode_step", lambda: engine.generate_from_prefill(
        last, cache, max_new_tokens=DECODE), units=DECODE)
    engine.eos_token_id = eos
    profiled(f"fast_burst_{BURST}", lambda: engine.perceive_burst(burst, clone_state(state)))


def train_microbatch(cfg, dev):
    """One adapter-stage microbatch (gradients of the trainable projector
    through the frozen bf16 decoder) on a fresh seeded tree."""
    from streammind_torch.models.meta import init_streammind_params
    from streammind_torch.train.objectives import stage1_llm_loss
    from streammind_torch.train.run import make_microbatch
    from streammind_torch.train.trainer import apply_trainable, make_grad_step, trainable_mask

    from chip_smoke import MatchTimeShaped

    params = init_streammind_params(torch.Generator(device=dev).manual_seed(SEED), cfg,
                                    device=dev, dtype=torch.bfloat16)
    mask = trainable_mask(params, "adapter")
    apply_trainable(params, mask)
    sample = MatchTimeShaped([1980], frames=64, seed=SEED).samples[0]
    _, batch = make_microbatch([sample], cfg, params["vision"], "adapter", pad_to=1)

    def loss_fn(p, b):
        return stage1_llm_loss(p, cfg, b["frames"], b["token_ids"], b["mem_index"], b["use_mem"],
                               b["attn_mask"], b["labels"], remat=True, attn_impl="flash!")

    from streammind_torch.models import mamba as M
    from streammind_torch.ops.scan import selective_scan_ref

    seen, scan = [], M.selective_scan

    def spied(*args, **kw):  # keeps the training projector's scan inputs
        if not seen:
            seen.append((tuple(a.detach().clone() for a in args),
                         {k: v.detach().clone() if torch.is_tensor(v) else v
                          for k, v in kw.items()}))
        return scan(*args, **kw)

    grad_step = make_grad_step(loss_fn, mask)
    M.selective_scan = spied
    try:
        grad_step(params, batch)  # warm-up
    finally:
        M.selective_scan = scan
    profiled("train_microbatch", lambda: grad_step(params, batch))
    args, kw = seen[0]
    if kw.get("impl") != "auto":
        raise RuntimeError(f"the training projector's scan took impl={kw.get('impl')!r}")
    kw = {k: v for k, v in kw.items() if k != "impl"}
    args = tuple(a.requires_grad_(a.is_floating_point()) for a in args)
    kw = {k: v.requires_grad_() if torch.is_tensor(v) and v.is_floating_point() else v
          for k, v in kw.items()}
    inputs = [t for t in (*args, *kw.values()) if torch.is_tensor(t)]
    y, h = selective_scan_ref(*args, **kw)
    grads = (torch.ones_like(y), torch.ones_like(h))

    def scan_fwd_bwd():
        y, h = selective_scan_ref(*args, **kw)
        return torch.autograd.grad((y, h), inputs, grads)

    scan_fwd_bwd()  # warm-up
    print(json.dumps(dict(train_scan_shapes=[list(t.shape) for t in inputs],
                          train_scan_dtype=str(args[0].dtype))), flush=True)
    profiled("train_projector_scan_fwd_bwd", scan_fwd_bwd)
    profiled("train_projector_scan_fwd", lambda: selective_scan_ref(*args, **kw))
    print(json.dumps(dict(train_bucket=int(batch["token_ids"].shape[1]),
                          train_frames=int(batch["frames"].shape[1]),
                          supervised=int((batch["labels"][:, 1:] != -100).sum()))), flush=True)


def qlora_microbatch(cfg, dev):
    """One microbatch of QLoRA (``train()``'s llm stage with ``bits=4`` and
    LoRA at its defaults) on a fresh seeded tree: gradients of the LoRA
    factors and the projector minus the gate, through the int4 decoder."""
    from streammind_torch.models.meta import init_streammind_params
    from streammind_torch.train.lora import attach_lora, init_lora_params
    from streammind_torch.train.objectives import stage1_llm_loss
    from streammind_torch.train.run import make_microbatch
    from streammind_torch.train.trainer import apply_trainable, make_grad_step, trainable_mask
    from streammind_torch.utils.params import tree_map
    from streammind_torch.utils.quantize import quantize_text_params

    from chip_smoke import MatchTimeShaped

    g = torch.Generator(device=dev).manual_seed(SEED)
    params = init_streammind_params(g, cfg, device=dev, dtype=torch.bfloat16)
    params["text"] = quantize_text_params(params["text"], bits=4, free_source=True)
    params["lora"] = init_lora_params(g, params["text"], r=128, dtype=torch.bfloat16)
    mask = trainable_mask({k: v for k, v in params.items() if k != "lora"}, "adapter")
    mask["lora"] = tree_map(lambda _: True, params["lora"])
    apply_trainable(params, mask)
    sample = MatchTimeShaped([1980], frames=64, seed=SEED).samples[0]
    _, batch = make_microbatch([sample], cfg, params["vision"], "llm", pad_to=1)

    def loss_fn(p, b):
        eff = {**p, "text": attach_lora(p["text"], p["lora"], 2.0)}
        return stage1_llm_loss(eff, cfg, b["frames"], b["token_ids"], b["mem_index"],
                               b["use_mem"], b["attn_mask"], b["labels"], remat=True,
                               attn_impl="flash!")

    grad_step = make_grad_step(loss_fn, mask)
    grad_step(params, batch)  # warm-up
    profiled("qlora_microbatch", lambda: grad_step(params, batch))


if __name__ == "__main__":
    sys.exit(main())
