"""train(): the StreamMind training loop on one CUDA card (or the CPU).

Stage control, as in the JAX package:
  --score-dataset-train-llm  → stage 1 ``llm``: decoder + projector (not the gate)
  --score-dataset-train-cls  → stage 2 ``cls``: the gate only
  --tune-mm-mlp-adapter      → ``adapter``: the projector minus the gate
  --train-skip-cls           → initialize the gate LM from the first
                               gate-depth decoder layers

Each optimizer step takes ``per_device_train_batch_size ×
gradient_accumulation_steps`` samples from the length/modality-grouped
sampler, builds bucketed splice-plan microbatches (the frozen ViT runs
under ``torch.no_grad``, or pre-extracted (T, P, D) features skip it), and
either takes one step or accumulates the microbatches' gradients weighted
by their supervised tokens.  On a CUDA device the decoder's attention is the
flash kernels (lse forward, dQ and dK/dV backward) in every layer, each
layer rematerialized under ``gradient_checkpointing``.

Checkpoints are ``checkpoint-{step}`` directories in the JAX package's
format (``utils/checkpoint.py``), resumed from the latest; the adapter and
cls stages save the projector alone.

Not ported yet (each raises NotImplementedError, ROADMAP Queue 1 item 17):
LoRA, the int8/int4 frozen base (``--bits``), the dp/fsdp/tp mesh,
loading a released checkpoint (``--model-path`` directory,
``--pretrain-mm-mlp-adapter``), and the MatchTime, Ego4D and SFT datasets
(they decode video and need an HF tokenizer): pass ``dataset=``.

    python -m streammind_torch.train.run --config run.json [--flag value ...]
"""
from __future__ import annotations

import functools
import logging
import os
import time
from itertools import islice
from typing import Optional

import numpy as np
import torch

from ..config import StreamMindConfig
from ..constants import IGNORE_INDEX, MMODAL_TOKEN_INDEX, VIDEO_TOKEN_INDEX
from ..models.meta import build_splice_plan, bucket_length, init_streammind_params
from ..models.vit import vit_forward
from ..utils.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint, save_opt_state
from ..utils.logging import MetricLogger
from ..utils.metrics_writer import MetricsWriter
from ..utils.prefetch import prefetch_iter
from .args import DataArguments, ModelArguments, parse_args
from .objectives import stage1_llm_loss, stage2_gate_loss, text_only_llm_loss
from .sampler import LengthGroupedSampler
from .trainer import (
    TrainState,
    cosine_schedule,
    count_trainable,
    init_train_state,
    make_accum_apply,
    make_grad_step,
    make_optimizer,
    make_train_step,
    named_leaves,
    trainable_mask,
    tree_axpy,
    tree_scale,
)

logger = logging.getLogger("streammind_torch.train")

PLAN_BUCKETS = (128, 256, 512, 1024, 2048)
FRAME_BUCKETS = (8, 16, 32, 64, 128, 256, 600)
_TODO = "not ported yet (ROADMAP Queue 1 item 17)"


def copy_decoder_layers_into_gate(params, cfg: StreamMindConfig):
    """train_skip_cls: gate layers i ← decoder layers i, leaf by leaf where
    the shapes line up (the 2-way embed and lm_head stay as initialized)."""
    gate = params["projector"]["cls_net"]["layers"]
    text = params["text"]["layers"]
    n = gate["q"]["weight"].shape[0]

    def take(src, dst):
        if isinstance(dst, dict):
            return {k: (take(src[k], v) if isinstance(src, dict) and k in src else v)
                    for k, v in dst.items()}
        if (not isinstance(src, dict) and src.shape[1:] == dst.shape[1:]
                and src.shape[0] >= n):
            return src[:n].clone().to(dst.dtype)
        return dst

    for name in ("q", "k", "v", "o", "input_norm", "post_norm", "mlp"):
        gate[name] = take(text[name], gate[name])
    logger.info("complete aligning cls_weight (decoder → gate)")
    return params


def _stage_of(model_args: ModelArguments, data_args: DataArguments) -> str:
    if data_args.score_dataset_train_cls:
        return "cls"
    if model_args.tune_mm_mlp_adapter:
        return "adapter"
    return "llm"


def _device_of(tree) -> torch.device:
    while isinstance(tree, (dict, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.device


def _encode_video(video: np.ndarray, t_bucket: int, cfg, vision_params, device):
    """(T,3,H,W) pixels or (T,P,D) features → (1, t_bucket, N, D) features,
    zero-padded to the frame bucket (the projector scan is causal and the
    splice never gathers past the real frames).  Pixels go through the
    frozen ViT under no_grad."""
    t = video.shape[0]
    if t < t_bucket:
        video = np.pad(video, ((0, t_bucket - t),) + ((0, 0),) * (video.ndim - 1))
    x = torch.from_numpy(np.ascontiguousarray(video)).to(device)
    if video.ndim == 3:  # pre-extracted features skip the tower
        return x[None]
    with torch.no_grad():
        return vit_forward(vision_params, cfg.vision, x, attn_impl="auto")[None]


def _plan_geometry(sample, cfg, stage: str, frame_bucket=None):
    """(t, frame_bucket, spans) shared by the batch builders and
    _natural_buckets: frame truncation (the last frames are kept), the frame
    bucket, and the splice span of each <video> slot (one memory token a
    frame); spans is None for cls rows."""
    if cfg.mm_projector_type != "mamba":
        raise NotImplementedError(
            f"projector type {cfg.mm_projector_type!r} is not ported (ROADMAP Queue 1 item 14)")
    video = np.asarray(sample["video"])
    t = min(video.shape[0], FRAME_BUCKETS[-1])
    fb = frame_bucket or bucket_length(t, FRAME_BUCKETS)
    t = min(t, fb)
    if stage == "cls":
        return t, fb, None
    if "span_frames" in sample and "modal" not in sample:
        # multi-turn samples: shrink spans from the front (earliest turns),
        # never below 1 a slot, so the slot count keeps matching the ids
        spans = list(sample["span_frames"])
        drop = sum(spans) - t
        i = 0
        while drop > 0 and i < len(spans):
            take = min(spans[i] - 1, drop)
            spans[i] -= take
            drop -= take
            i += 1
        return t, fb, spans
    return t, fb, [t]


def _truncate_to_cap(ids, labels, spans):
    """Right-truncate a sample whose spliced length exceeds the largest plan
    bucket; truncation never cuts a modal slot."""
    cap = PLAN_BUCKETS[-1]
    n_spliced = len(ids) - len(spans) + sum(spans)
    if n_spliced <= cap:
        return ids, labels
    overflow = n_spliced - cap
    keep = len(ids) - overflow
    last_modal = max((i for i, t in enumerate(ids) if t < 0), default=-1)
    if keep <= last_modal:
        raise ValueError(
            f"sample too long to truncate: spliced length {n_spliced} > {cap} and the "
            f"overflow reaches back into a modal slot")
    logger.warning(f"truncating over-long sample: spliced {n_spliced} > cap {cap} "
                   f"({overflow} trailing tokens dropped)")
    return ids[:keep], labels[:keep]


def _plan_rows(plan, device):
    return {
        "token_ids": torch.from_numpy(plan.token_ids)[None].to(device),
        "mem_index": torch.from_numpy(plan.mem_index)[None].to(device),
        "use_mem": torch.from_numpy(plan.use_mem)[None].to(device),
        "attn_mask": torch.from_numpy(plan.attn_mask)[None].to(device),
        "labels": torch.from_numpy(plan.labels)[None].to(device),
    }


def make_sft_batch(sample, cfg, vision_params, token_bucket=None, frame_bucket=None,
                   device=None):
    """SFT record → batch.  Text-only records give a token-only batch (no
    frames key); media records go through the splice.  token_bucket /
    frame_bucket override the natural buckets so the rows of one microbatch
    stack to one shape."""
    device = device or _device_of(vision_params)
    ids = list(np.asarray(sample["input_ids"])[0])
    labels = list(np.asarray(sample["labels"])[0])
    if sample.get("modal") is None:
        if len(ids) > PLAN_BUCKETS[-1]:
            ids, labels = _truncate_to_cap(ids, labels, [])
        bucket = token_bucket or bucket_length(len(ids), PLAN_BUCKETS)
        pad = bucket - len(ids)
        return {
            "kind": "text",
            "token_ids": torch.tensor([ids + [0] * pad], device=device),
            "attn_mask": torch.tensor([[True] * len(ids) + [False] * pad], device=device),
            "labels": torch.tensor([labels + [IGNORE_INDEX] * pad], device=device),
        }
    video = np.asarray(sample["video"], np.float32)
    t, t_bucket, spans = _plan_geometry(sample, cfg, "llm", frame_bucket)
    video = video[-t:] if video.shape[0] > t else video
    feats = _encode_video(video, t_bucket, cfg, vision_params, device)
    ids, labels = _truncate_to_cap(ids, labels, spans)
    bucket = token_bucket or bucket_length(len(ids) - len(spans) + sum(spans), PLAN_BUCKETS)
    plan = build_splice_plan(ids, spans, MMODAL_TOKEN_INDEX[sample["modal"]], bucket,
                             labels=labels)
    return {"kind": "media", "frames": feats, **_plan_rows(plan, device)}


def make_batch_from_sample(sample, cfg, vision_params, stage: str, token_bucket=None,
                           frame_bucket=None, device=None):
    """Host side: sample dict → device batch with a bucketed splice plan.
    sample["video"] is (T, 3, H, W) pixels or (T, P, D) pre-extracted
    features; multi-turn samples carry "span_frames"."""
    device = device or _device_of(vision_params)
    video = np.asarray(sample["video"], np.float32)
    t, t_bucket, spans = _plan_geometry(sample, cfg, stage, frame_bucket)
    video = video[-t:] if video.shape[0] > t else video
    feats = _encode_video(video, t_bucket, cfg, vision_params, device)

    if stage == "cls":
        gate_labels = np.zeros((1, t_bucket), np.int64)
        gate_labels[0, t - 1] = 0 if sample["caption_info"] == "</s>" else 1
        mask = np.zeros((1, t_bucket), bool)
        mask[0, :t] = True
        return {"frames": feats, "labels": torch.from_numpy(gate_labels).to(device),
                "mask": torch.from_numpy(mask).to(device)}

    ids = list(np.asarray(sample["input_ids"])[0])
    labels = list(np.asarray(sample["labels"])[0])
    ids, labels = _truncate_to_cap(ids, labels, spans)
    bucket = token_bucket or bucket_length(len(ids) - len(spans) + sum(spans), PLAN_BUCKETS)
    plan = build_splice_plan(ids, spans, VIDEO_TOKEN_INDEX, bucket, labels=labels)
    return {"frames": feats, **_plan_rows(plan, device)}


def _natural_buckets(sample, cfg, stage: str):
    """(frame_bucket, token_bucket) this sample needs — host metadata only."""
    cap = PLAN_BUCKETS[-1]
    if "modal" in sample and sample.get("modal") is None:
        ids_len = int(np.asarray(sample["input_ids"]).shape[-1])
        return 0, bucket_length(min(ids_len, cap), PLAN_BUCKETS)
    t, fb, spans = _plan_geometry(sample, cfg, stage)
    if stage == "cls":
        return fb, 0
    ids_len = int(np.asarray(sample["input_ids"]).shape[-1])
    return fb, bucket_length(min(ids_len - len(spans) + sum(spans), cap), PLAN_BUCKETS)


def make_microbatch(samples, cfg, vision_params, stage: str, pad_to: int = 0, device=None):
    """Stack same-kind samples into one (B, ...) batch at shared buckets.
    pad_to > len(samples) appends copies of samples[0] with every label
    masked out (no effect on the token-mean loss).  Returns (kind, batch),
    kind "text" | "media" | "cls"."""
    device = device or _device_of(vision_params)
    n_real = len(samples)
    if pad_to > n_real:
        samples = list(samples) + [samples[0]] * (pad_to - n_real)
    metas = [_natural_buckets(s, cfg, stage) for s in samples]
    fb = max(m[0] for m in metas) or None
    tb = max(m[1] for m in metas) or None
    rows, kind = [], "cls" if stage == "cls" else "media"
    built = {}  # pad rows duplicate samples[0]: build (and encode) it once
    for j, s in enumerate(samples):
        if id(s) in built:
            row = dict(built[id(s)])
        elif "modal" in s:
            row = make_sft_batch(s, cfg, vision_params, tb, fb, device)
            kind = row.pop("kind")
            built[id(s)] = row
        else:
            row = make_batch_from_sample(s, cfg, vision_params, stage, tb, fb, device)
            built[id(s)] = row
        if j >= n_real:  # neutralize pad rows
            row = dict(row)
            if stage == "cls":
                row["mask"] = torch.zeros_like(row["mask"])
            else:
                row["labels"] = torch.full_like(row["labels"], IGNORE_INDEX)
        rows.append(row)
    return kind, {k: torch.cat([r[k] for r in rows], dim=0) for k in rows[0]}


def _check_supported(model_args, data_args, training_args, dataset):
    if training_args.dp * training_args.fsdp * training_args.tp > 1:
        raise NotImplementedError(f"the dp/fsdp/tp mesh is {_TODO}; train on one device")
    if model_args.bits not in (4, 8, 16):
        raise ValueError(f"--bits must be 4, 8 or 16, got {model_args.bits}")
    if model_args.bits != 16:
        raise NotImplementedError(f"the int{model_args.bits} frozen base (--bits) is {_TODO}")
    if training_args.lora_enable:
        raise NotImplementedError(f"LoRA (--lora-enable) is {_TODO}")
    if model_args.model_path and os.path.isdir(model_args.model_path):
        raise NotImplementedError(f"loading a released checkpoint (--model-path) is {_TODO}")
    if model_args.pretrain_mm_mlp_adapter:
        raise NotImplementedError(f"--pretrain-mm-mlp-adapter is {_TODO}")
    if dataset is None:
        raise NotImplementedError(
            f"the {data_args.dataset!r} dataset is {_TODO}; pass dataset= (samples as the "
            f"JAX package's datasets build them)")


def _resume(state: TrainState, path: str, device) -> TrainState:
    """Restore params (or, from an adapter-only checkpoint, the projector),
    the step and, from a full checkpoint of this package, the optimizer
    state; copies into the live leaves in place."""
    loaded, opt_state, meta = load_checkpoint(path, device)
    live = named_leaves(state.params)
    with torch.no_grad():
        for p, t in named_leaves(loaded).items():
            live[p].copy_(t)
    fresh = meta.get("adapter_only") or opt_state is None
    logger.info(f"resumed from {path}" + (" (fresh optimizer state)" if fresh else ""))
    return TrainState(meta["step"], state.params, state.opt_state if fresh else opt_state)


def train(model_args=None, data_args=None, training_args=None, dataset=None,
          cfg: Optional[StreamMindConfig] = None, max_steps_override=None):
    if model_args is None:
        model_args, data_args, training_args = parse_args()
    stage = _stage_of(model_args, data_args)
    logger.info(f"training stage: {stage}")
    _check_supported(model_args, data_args, training_args, dataset)

    # -- model ---------------------------------------------------------------
    if cfg is None:
        cfg = StreamMindConfig(mm_projector_type=model_args.mm_projector_type)
    if stage == "cls" and cfg.mm_projector_type != "mamba":
        raise ValueError("gate (stage-2) training requires mm_projector_type='mamba' — the "
                         f"2-way gate LM lives inside the mamba projector; got "
                         f"{cfg.mm_projector_type!r}")
    device = torch.device(training_args.device)
    dtype = torch.bfloat16 if training_args.bf16 else torch.float32
    params = init_streammind_params(torch.Generator(device=device).manual_seed(training_args.seed),
                                    cfg, device=device, dtype=dtype)
    if model_args.train_skip_cls:
        params = copy_decoder_layers_into_gate(params, cfg)

    # global batch = per-device batch × grad accumulation (one device)
    accum = max(training_args.gradient_accumulation_steps, 1)
    micro_bs = max(training_args.per_device_train_batch_size, 1)
    global_bs = micro_bs * accum
    if training_args.max_steps > 0 or max_steps_override:
        total_steps = max_steps_override or training_args.max_steps
    else:  # optimizer steps for num_train_epochs passes over the data
        total_steps = max(len(dataset) // global_bs, 1) * max(training_args.num_train_epochs, 1)

    # -- optimizer -------------------------------------------------------------
    mask = trainable_mask(params, stage)
    logger.info(f"trainable params: {count_trainable(params, mask) / 1e6:.1f}M")
    optimizer = make_optimizer(
        cosine_schedule(training_args.learning_rate, total_steps, training_args.warmup_ratio),
        projector_lr=training_args.mm_projector_lr, weight_decay=training_args.weight_decay,
        grad_clip=training_args.grad_clip)
    state = init_train_state(params, optimizer, mask)  # frozen leaves: requires_grad False

    if training_args.resume:
        latest = latest_checkpoint(training_args.output_dir)
        if latest:
            state = _resume(state, latest, device)
    start_step = state.step

    # "auto": the flash kernels on a CUDA device, the plain reference on the
    # CPU; "flash" becomes "flash!" (the strict form the JAX package's
    # training uses; one device here, so the same call)
    attn_impl = training_args.attn_impl
    if attn_impl == "auto":
        attn_impl = "flash" if device.type == "cuda" else "auto"
    if attn_impl == "flash":
        attn_impl = "flash!"
    remat = training_args.gradient_checkpointing

    if stage == "cls":
        def loss_fn(p, b, with_tokens=False):
            return stage2_gate_loss(p, cfg, b["frames"], b["labels"], b["mask"],
                                    with_tokens=with_tokens)
    else:
        def loss_fn(p, b, with_tokens=False):
            return stage1_llm_loss(p, cfg, b["frames"], b["token_ids"], b["mem_index"],
                                   b["use_mem"], b["attn_mask"], b["labels"], remat=remat,
                                   attn_impl=attn_impl, with_tokens=with_tokens)

    def text_loss_fn(p, b, with_tokens=False):
        return text_only_llm_loss(p, cfg, b["token_ids"], b["attn_mask"], b["labels"],
                                  remat=remat, attn_impl=attn_impl, with_tokens=with_tokens)

    step_fn = make_train_step(loss_fn, optimizer, mask)
    step_fn_text = make_train_step(text_loss_fn, optimizer, mask)
    # accumulation: each chunk loss is a token mean, so weighting its grads
    # by its supervised-token count gives the token mean of the whole batch
    grad_fn = make_grad_step(functools.partial(loss_fn, with_tokens=True), mask, has_aux=True)
    grad_fn_text = make_grad_step(functools.partial(text_loss_fn, with_tokens=True), mask,
                                  has_aux=True)
    apply_fn = make_accum_apply(optimizer, mask)

    # -- data order: shuffled, length/modality-grouped batches ------------------
    lengths = getattr(dataset, "modality_lengths", None)
    sampler = LengthGroupedSampler(len(dataset), batch_size=micro_bs, world_size=accum,
                                   lengths=lengths, seed=training_args.seed,
                                   group_by_modality=lengths is not None)

    def index_stream():
        epoch = 0
        while True:
            yield from sampler.epoch_indices(epoch)
            epoch += 1

    stream = index_stream()
    for _ in range(start_step * global_bs):  # resume: replay the order
        next(stream)
    sample_stream = prefetch_iter(
        dataset.__getitem__, islice(stream, (total_steps - start_step) * global_bs),
        num_workers=getattr(data_args, "num_workers", 4), depth=max(2 * global_bs, 8))

    vision = state.params["vision"]
    metrics_log = MetricLogger()
    writer = MetricsWriter(os.path.join(training_args.output_dir, "logs"))
    t0 = time.time()
    for step in range(start_step, total_steps):
        batch_samples = [next(sample_stream) for _ in range(global_bs)]
        # modality-pure microbatches (the sampler groups; this guards the seams)
        text_s = [s for s in batch_samples if s.get("modal", "?") is None]
        media_s = [s for s in batch_samples if s.get("modal", "?") is not None]
        chunks = [group[c:c + micro_bs] for group in (media_s, text_s) if group
                  for c in range(0, len(group), micro_bs)]
        if len(chunks) == 1:
            kind, batch = make_microbatch(chunks[0], cfg, vision, stage, pad_to=micro_bs)
            state, metrics = (step_fn_text if kind == "text" else step_fn)(state, batch)
        else:
            grad_sum, loss_sum, w_total = None, None, None
            for chunk in chunks:
                kind, batch = make_microbatch(chunk, cfg, vision, stage, pad_to=micro_bs)
                (loss, w), grads = (grad_fn_text if kind == "text" else grad_fn)(
                    state.params, batch)
                if grad_sum is None:
                    grad_sum, loss_sum, w_total = tree_scale(grads, w), loss * w, w
                else:
                    grad_sum = tree_axpy(grad_sum, grads, w)
                    loss_sum, w_total = loss_sum + loss * w, w_total + w
                del grads, batch
            state, metrics = apply_fn(state, grad_sum, loss_sum, w_total)
            del grad_sum
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        metrics_log.update(loss=loss, grad_norm=gnorm)
        if (step + 1) % training_args.logging_steps == 0:
            logger.info(f"step {step + 1}/{total_steps} {metrics_log} "
                        f"({(time.time() - t0) / (step - start_step + 1):.2f}s/it)")
            writer.write(step + 1, {"train/loss": loss, "train/grad_norm": gnorm})
        if (step + 1) % training_args.save_steps == 0 or step + 1 == total_steps:
            adapter_only = stage in ("cls", "adapter")
            path = save_checkpoint(training_args.output_dir, step + 1, state.params,
                                   adapter_only=adapter_only,
                                   keep=training_args.save_total_limit,
                                   extra={"lora_only": False})
            if not adapter_only:
                save_opt_state(path, state.opt_state)
    return state


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    train()
