#!/usr/bin/env python3
"""Drive the PyTorch / H100 port (``streammind_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:
  1. the card (nvidia-smi name and power limit) and the torch build;
  2. the kernel build: every ``streammind_torch/csrc/*.cu`` with nvcc for
     sm_90a, one process per source, all at once;
  3. each kernel against its plain PyTorch version on the card at the main
     path's shapes, with its tolerance; times of the kernel, its plain
     version and one PyTorch yardstick call, beside the card's bound;
  4. the full-width StreamMind-7B session (random bf16 weights from a seed):
     ViT-L/14-336 under attn_impl="exact", Mamba d_model 4096, the 4-layer
     gate under quantize_gate="int4", Mistral-7B; 10 frames with two forced
     gate fires and 16 new tokens a turn; the launch counts show the path ran
     through all three kernels;
  5. a reduced-depth parity run at the published widths in fp32 (TF32 off):
     the same seeded weights and frames through the plain versions on the
     CPU and through the kernels on the card; then the card once more with
     TF32 on, which must break at least one limit (the limits see a matmul
     that loses fp32 precision);
then the ``kernels`` JSON line and, last, the ``ok`` JSON line.  It uses
nothing of JAX; without a CUDA card it exits with an error before any result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

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
}


def log(tag: str, msg: str) -> None:
    print(f"[{tag}] {msg}", flush=True)


def cuda_ms(fns, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call over ``iters`` calls cycling through ``fns`` (several
    buffers where one would sit in L2), timed with CUDA events."""
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(warmup, warmup + iters):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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
    from streammind_torch.ops.int4_matvec import int4_matvec, int4_matvec_ref
    from streammind_torch.utils.quantize import quantize_linear_weight_int4_pc

    g = torch.Generator(device=dev).manual_seed(1234)
    bf16 = torch.bfloat16
    results = {}

    def randn(*shape, std=1.0):
        return torch.empty(shape, device=dev, dtype=bf16).normal_(0.0, std, generator=g)

    # flash: Mistral-7B prefill over a capacity-8192 cache (B 1, H 32/8, D 128).
    # Sets of inputs: the caches are overlapping views of one buffer, each
    # starting past the rows the previous one reads, so nothing is read warm.
    cases = []
    for sq, q_off, kv_len in ((64, 100, 150), (2048, 0, 2048)):
        visible = sum(min(kv_len, q_off + i + 1) for i in range(sq))
        rows = min(kv_len, q_off + sq)
        nbytes = 2 * (2 * sq * 32 * 128 + 2 * rows * 8 * 128)
        n, step = n_sets(nbytes), 64 * math.ceil(rows / 64)
        kbuf, vbuf = (randn(1, (n - 1) * step + 8192, 8, 128) for _ in range(2))
        sets = [(randn(1, sq, 32, 128), kbuf[:, i * step:i * step + 8192],
                 vbuf[:, i * step:i * step + 8192]) for i in range(n)]
        lens = torch.tensor([kv_len], dtype=torch.int32, device=dev)
        offs = torch.tensor([q_off], dtype=torch.int32, device=dev)
        q, kc, vc = sets[0]
        out = A.flash_attention(q, kc, vc, causal=True, kv_len=lens, q_offset=offs)
        ref = A.flash_attention_ref(q, kc, vc, causal=True, kv_len=lens, q_offset=offs)
        err, over = excess(out, ref, *BF16_TOL)
        ms = cuda_ms([lambda s=s: A.flash_attention(*s, True, lens, offs) for s in sets])
        plain = cuda_ms([lambda s=s: A.flash_attention_ref(*s, True, lens, offs) for s in sets],
                        iters=5)
        # yardstick: SDPA on the visible keys with the same causal-offset mask
        mask = (torch.arange(kv_len, device=dev)[None, :]
                <= torch.arange(sq, device=dev)[:, None] + q_off)
        lib_sets = [(q.transpose(1, 2),
                     *(c[:, :kv_len].repeat_interleave(4, dim=2).transpose(1, 2).contiguous()
                       for c in (kc, vc))) for q, kc, vc in sets]
        lib = cuda_ms([lambda s=s: F.scaled_dot_product_attention(*s, attn_mask=mask)
                       for s in lib_sets])
        del sets, lib_sets, kbuf, vbuf
        b_ms, b_by = bound(nbytes, 4.0 * 128 * 32 * visible, BF16_FLOPS)
        cases.append(dict(shape=f"q(1,{sq},32,128) cache(1,8192,8,128) q_offset={q_off} "
                                f"kv_len={kv_len}", max_abs_err=err, ok=over <= 0, ms=ms,
                          plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by))
    results["flash_attention"] = (cases, BF16_TOL_TEXT)

    # exact: the ViT-L/14-336 attention, q/k/v strided views of the fused qkv
    cases = []
    for b in (1, 8):
        nbytes = 4 * 2 * b * 577 * 16 * 64
        qkvs = [randn(b, 577, 3, 16, 64) for _ in range(n_sets(nbytes))]
        sets = [(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]) for qkv in qkvs]
        out = A.exact_attention(*sets[0])
        ref = A.exact_attention_ref(*sets[0])
        err, over = excess(out, ref, *BF16_TOL)
        ms = cuda_ms([lambda s=s: A.exact_attention(*s) for s in sets])
        plain = cuda_ms([lambda s=s: A.exact_attention_ref(*s) for s in sets])
        lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in s) for s in sets]
        lib = cuda_ms([lambda s=s: F.scaled_dot_product_attention(*s) for s in lib_sets])
        del qkvs, sets, lib_sets
        b_ms, b_by = bound(nbytes, 4.0 * b * 16 * 577 * 577 * 64, BF16_FLOPS)
        cases.append(dict(shape=f"({b},577,16,64)", max_abs_err=err, ok=over <= 0, ms=ms,
                          plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by))
    results["exact_attention"] = (cases, BF16_TOL_TEXT)

    # int4: the gate LM's five per-layer linears at one token (four shapes)
    cases = []
    for name, dout, din in (("v", 1024, 4096), ("o", 4096, 4096),
                            ("gate/up", 14336, 4096), ("down", 4096, 14336)):
        # enough weight copies to exceed the 50 MB L2: each frame reads them cold
        n_copy = max(1, math.ceil(120e6 / (dout * din / 2)))
        ws = [randn(dout, din, std=0.02) for _ in range(n_copy)]
        packs = [quantize_linear_weight_int4_pc(w) for w in ws]
        x = randn(1, din)
        p0 = packs[0]
        out = int4_matvec(x, p0["w_int4pc"], p0["scale"])
        ref = int4_matvec_ref(x, p0["w_int4pc"], p0["scale"])
        err, over = excess(out, ref, 1e-2, 1e-2)
        ms = cuda_ms([lambda p=p: int4_matvec(x, p["w_int4pc"], p["scale"]) for p in packs])
        plain = cuda_ms([lambda p=p: int4_matvec_ref(x, p["w_int4pc"], p["scale"])
                         for p in packs], iters=5)
        lib = cuda_ms([lambda w=w: F.linear(x, w) for w in ws])
        b_ms, b_by = bound(dout * din / 2 + 4 * dout + 2 * din + 2 * dout,
                           2.0 * dout * din, BF16_FLOPS)
        cases.append(dict(shape=f"{name}: x(1,{din}) W({dout},{din}/2)", max_abs_err=err,
                          ok=over <= 0, ms=ms, plain_ms=plain, library_ms=lib,
                          bound_ms=b_ms, bound_by=b_by))
        del ws, packs
    results["int4_matvec"] = (cases, "|err| <= 1e-2 + 1e-2*|ref| (bf16 output)")

    for name, (cases, tol) in results.items():
        for c in cases:
            log("kernel", f"{name} {c['shape']}: max_abs_err={c['max_abs_err']:.3e} "
                          f"within [{tol}]={c['ok']} kernel={c['ms']:.4f} ms "
                          f"plain={c['plain_ms']:.4f} ms library={c['library_ms']:.4f} ms "
                          f"bound={c['bound_ms']:.4f} ms ({c['bound_by']})")
    bad = [(n, c["shape"]) for n, (cs, _) in results.items() for c in cs if not c["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: {bad}")
    return results


# ---------------------------------------------------------------------------
# phases 4 and 5: sessions
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


def run_session(engine, frames, fire, max_new):
    from streammind_torch.constants import VIDEO_TOKEN_INDEX
    from streammind_torch.mm_utils import tokenizer_multimodal_token
    from streammind_torch.streaming import StreamSession

    tok = StandInTokenizer()
    prompt = tokenizer_multimodal_token("[INST] <video>\nWhat is happening? [/INST]", tok,
                                        VIDEO_TOKEN_INDEX)
    session = StreamSession(engine, tok, prompt_ids=prompt, max_new_tokens=max_new,
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


def full_width_session(dev):
    from streammind_torch.config import StreamMindConfig
    from streammind_torch.models.meta import init_streammind_params
    from streammind_torch.ops.attention import exact_attention, flash_attention
    from streammind_torch.ops.int4_matvec import int4_matvec
    from streammind_torch.utils.params import param_bytes

    cfg = StreamMindConfig()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    params = init_streammind_params(g, cfg, device=dev, dtype=torch.bfloat16)
    log("session", f"StreamMind-7B bf16 tree: {param_bytes(params) / 1e9:.2f} GB built in "
                   f"{time.perf_counter() - t0:.1f} s")
    engine = make_engine_class()(params, cfg, attn_impl="exact", quantize_gate="int4",
                                      device=dev)
    del params
    n_frames, fire = 10, (3, 7)
    frames = [torch.empty((1, 3, 336, 336), device=dev, dtype=torch.bfloat16).normal_(
        generator=g) for _ in range(n_frames)]
    torch.cuda.synchronize()
    for fn in (exact_attention, int4_matvec, flash_attention):
        fn.launches = 0
    session, ticks, e2ft = run_session(engine, frames, fire, max_new=16)
    counts = {"exact_attention": exact_attention.launches, "int4_matvec": int4_matvec.launches,
              "flash_attention": flash_attention.launches}
    turns = len(session.turns)
    n_vit = cfg.vision.num_layers + cfg.vision.select_layer + 1
    expect = {"exact_attention": n_vit * n_frames, "int4_matvec": 5 * cfg.gate.num_layers * n_frames,
              "flash_attention": cfg.text.num_layers * turns}
    probs = torch.stack(engine.probs)
    n_tok = sum(len(t) for t in engine.decoded)
    decode_ms_tok = sum(engine.decode_ms) / max(n_tok, 1)
    log("session", f"frames={n_frames} turns={turns} tokens={[len(t) for t in engine.decoded]} "
                   f"launches={counts} expected={expect}")
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
    summary = dict(tick_ms_median=statistics.median(ticks[1:]), event_to_first_token_ms=e2ft,
                   decode_ms_per_token=decode_ms_tok, launches=counts)
    del engine, session, frames
    torch.cuda.empty_cache()
    return summary


def parity(dev):
    from streammind_torch.config import StreamMindConfig, gate_lm_config
    from streammind_torch.models.meta import init_streammind_params

    base = StreamMindConfig()
    cfg = base.replace(
        vision=dataclasses.replace(base.vision, num_layers=3),
        text=dataclasses.replace(base.text, num_layers=2),
        gate=dataclasses.replace(gate_lm_config(), num_layers=2),
    )
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
        session, _, _ = run_session(eng, [f.to(where) for f in frames], fire, max_new=8)
        out[run] = dict(probs=torch.stack(eng.probs), memory=session.state.memory[0, :4].cpu(),
                        logits=torch.cat(eng.prefill_logits), tokens=eng.decoded)
        log("parity", f"{run}: {time.perf_counter() - t0:.1f} s, tokens {eng.decoded}")
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
    print(smi.stdout.strip().splitlines()[0], flush=True)
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

    kernels = check_kernels(dev)
    summary = full_width_session(dev)
    parity(dev)

    entries = []
    for name, (cases, tol) in kernels.items():
        src, replaces = KERNEL_META[name]
        head = cases[0]
        entries.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=summary["launches"][name],
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=head["ms"], kernel_ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"], tolerance=tol,
            cases=cases))
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
