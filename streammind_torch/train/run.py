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

A ``--model-path`` directory (any of ``utils/convert.py``'s released
layouts, with ``--vision-tower`` and ``--model-base``) gives the config and
the starting weights; components it lacks are random from the seed.
``--pretrain-mm-mlp-adapter`` loads an ``mm_projector.bin`` over the
projector.  ``--bits 4|8`` stores the frozen decoder int4 (groups of 64) or
int8; ``--lora-enable`` on the llm stage trains LoRA factors over it
(``train/lora.py``, attached inside each loss call) with the projector
minus the gate, and checkpoints only ``{lora, projector}`` (``lora_only``).

Checkpoints are ``checkpoint-{step}`` directories in the JAX package's
format (``utils/checkpoint.py``), resumed from the latest; the adapter and
cls stages save the projector alone.

Without ``dataset=``, ``--dataset`` builds the MatchTime, Ego4D or SFT
dataset from ``--data-path`` / ``--data-folder`` / ``--anno-path``, with
the ``transformers`` tokenizer of ``--model-path``, as the JAX package does.

On a dp × fsdp × tp mesh (``--dp/--fsdp/--tp``, one process a rank;
train() starts the process group from a launcher's WORLD_SIZE, RANK,
MASTER_ADDR and MASTER_PORT unless the caller started it) every rank takes
the same samples, builds the same microbatch of per-device × dp rows and
keeps its dp rows; the params are the rank's shards (fsdp gathered at use,
tp split by the partitioning rules), the token-weighted loss and gradients
are summed over dp, so the logged loss is the global token mean; attention
is the flash kernels per shard (``flash_mha_sharded``).  Checkpoints hold
the whole tree, gathered, written by rank 0; a resume on another mesh
takes its own shards of the params and the optimizer state.

    python -m streammind_torch.train.run --score-dataset-train-llm true \
        --bits 4 --lora-enable true --model-path ckpt/ --dataset matchtime ...

    python -m streammind_torch.train.run --config run.json [--flag value ...]

    torchrun --nproc_per_node 8 -m streammind_torch.train.run --fsdp 8 ...
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
from ..parallel import collectives as C
from ..parallel.mesh import make_mesh, mesh_shape, set_mesh
from ..parallel.partitioning import (gather_leaf, gather_params, local_shard, mesh_coords,
                                     shard_params, spec_for)
from ..utils import dist as dist_utils
from ..utils.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint, save_opt_state
from ..utils.logging import MetricLogger
from ..utils.metrics_writer import MetricsWriter
from ..utils.params import tree_map
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

    for name in ("q", "k", "v", "o", "input_norm", "post_norm"):
        gate[name] = take(text[name], gate[name])
    if "mlp" in text:
        gate["mlp"] = take(text["mlp"], gate["mlp"])
    else:  # a Mixtral decoder has no dense MLP: the gate's keeps its init
        logger.info("skip_cls: MoE decoder has no dense mlp; gate MLP keeps init")
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
    bucket, and the splice span of each <video> slot; spans is None for cls
    rows.  Mamba: one memory token a frame, frames padded to a bucket.  The
    other types: the frame count is the bucket (they are trained at a fixed
    frame count) and the span is ``projected_token_count`` of it."""
    from ..models.projector import projected_token_count

    mamba = cfg.mm_projector_type == "mamba"
    video = np.asarray(sample["video"])
    t = min(video.shape[0], FRAME_BUCKETS[-1])
    fb = frame_bucket or (bucket_length(t, FRAME_BUCKETS) if mamba else t)
    t = min(t, fb)
    if stage == "cls":
        return t, fb, None
    if "span_frames" in sample and "modal" not in sample:
        if not mamba:
            raise ValueError("multi-turn streaming samples need one memory token a frame "
                             f"(mm_projector_type='mamba'); got {cfg.mm_projector_type!r}")
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
    if mamba:
        return t, fb, [t]
    if video.ndim == 3:  # pre-extracted features carry their patch count
        n_patches = video.shape[1]
    else:
        n_patches = (cfg.vision.image_size // cfg.vision.patch_size) ** 2
        if cfg.vision.select_feature == "cls_patch":
            n_patches += 1  # the CLS token is kept
    return t, fb, [projected_token_count(cfg, fb, n_patches)]


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
    if cfg.mm_projector_type != "mamba":
        fbs = {m[0] for m in metas if m[0]}
        if len(fbs) > 1:
            raise ValueError(
                f"mm_projector_type={cfg.mm_projector_type!r} needs one frame count a batch "
                f"(its memory-token count depends on the frame axis it convolves or pools "
                f"over); got {sorted(fbs)}")
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


def _check_supported(model_args, training_args, stage: str):
    """Refuse, before any weight is made, what the JAX package refuses and a
    mesh that is not the process group's world."""
    dp, fsdp, tp = training_args.dp, training_args.fsdp, training_args.tp
    world, need = dist_utils.size(), dp * fsdp * tp
    if need > world:
        raise ValueError(f"mesh {dp}x{fsdp}x{tp} needs {need} devices, have {world}")
    if need < world:
        raise ValueError(f"mesh {dp}x{fsdp}x{tp} covers {need} of the {world} ranks")
    if model_args.bits not in (4, 8, 16):
        raise ValueError(f"--bits must be 4, 8 or 16, got {model_args.bits}")
    if model_args.bits != 16 and stage == "llm" and not training_args.lora_enable:
        raise NotImplementedError(
            "bits<16 freezes the decoder: use the adapter/cls stages, or enable LoRA "
            "(QLoRA: matmul-time adapters over the quantized base)")


def _model_dir(model_args) -> Optional[str]:
    p = model_args.model_path
    return p if p and os.path.isdir(p) else None


def load_start_params(model_args, cfg: StreamMindConfig, seed: int, device, dtype):
    """The starting tree: a ``--model-path`` checkpoint (components it lacks
    random from ``seed``) or random weights, then the
    ``--pretrain-mm-mlp-adapter`` projector over it."""
    path = _model_dir(model_args)
    g = torch.Generator(device=device).manual_seed(seed)
    if path:
        from ..api import _init_component
        from ..utils.convert import convert_streammind_checkpoint

        params = convert_streammind_checkpoint(path, cfg, dtype, vision_path=model_args.vision_tower,
                                               base_path=model_args.model_base)
        params = tree_map(lambda t: t.to(device), params)
        for k in sorted({"vision", "projector", "text"} - set(params)):
            logger.warning(f"checkpoint {path} lacks {k}; it is randomly initialized")
            params[k] = _init_component(k, g, cfg, device, dtype)
    else:
        params = init_streammind_params(g, cfg, device=device, dtype=dtype)
    if model_args.pretrain_mm_mlp_adapter:
        # the released mm_projector.bin exists only for the mamba projector
        if cfg.mm_projector_type != "mamba":
            raise ValueError(
                "--pretrain-mm-mlp-adapter expects mm_projector_type='mamba' "
                f"(got {cfg.mm_projector_type!r}); other projector types load "
                "from framework checkpoints (checkpoint-N dirs) instead")
        from ..utils.convert import convert_projector, load_state_dict

        loaded = convert_projector(load_state_dict(model_args.pretrain_mm_mlp_adapter), cfg, dtype)
        params["projector"].update(tree_map(lambda t: t.to(device), loaded))
        logger.info(f"loaded projector from {model_args.pretrain_mm_mlp_adapter}")
    return params


def build_dataset(model_args, data_args, training_args):
    """The ``--dataset`` named in ``data_args`` (matchtime, ego4d or sft),
    tokenized by the ``transformers`` tokenizer of ``--model-path``."""
    if data_args.dataset not in ("matchtime", "ego4d", "sft"):
        raise ValueError(f"unknown dataset {data_args.dataset}")
    try:
        import transformers

        tokenizer = transformers.AutoTokenizer.from_pretrained(model_args.model_path)
    except Exception as e:  # noqa: BLE001 — any failure to find or read the tokenizer
        raise RuntimeError("need a tokenizer; pass dataset= for tests") from e
    if data_args.dataset == "matchtime":
        from ..data import MatchTimeDataset

        return MatchTimeDataset(data_args.data_path, tokenizer, cur_fps=data_args.cur_fps,
                                seed=training_args.seed)
    if data_args.dataset == "ego4d":
        from ..data.ego4d import Ego4dNarrationDataset

        return Ego4dNarrationDataset(data_args.data_folder or ".", data_args.anno_path,
                                     tokenizer, model_type="llm", data_type="train")
    from ..data.sft import VideoLLaVASFTDataset

    return VideoLLaVASFTDataset(data_args.data_path, data_args.data_folder or ".", tokenizer,
                                num_frames=model_args.num_frames,
                                style="plain" if model_args.tune_mm_mlp_adapter else "llama_2",
                                seed=training_args.seed)


def _resume(state: TrainState, path: str, device, mesh) -> TrainState:
    """Restore params (from an adapter-only checkpoint the projector, from a
    ``lora_only`` one the LoRA factors and the projector), the step and,
    from a checkpoint of this package that holds it, the optimizer state;
    copies into the live leaves in place.  Under a mesh each leaf of the
    (whole) checkpoint is cut to this rank's shard first, so a run resumes
    on another mesh than the one that saved it."""
    loaded, opt_state, meta = load_checkpoint(path, device)
    if meta.get("lora_only"):
        loaded = {k: loaded[k] for k in ("lora", "projector") if k in loaded}
    shape, coords = mesh_shape(mesh), mesh_coords(mesh)

    def mine(p, t):
        return local_shard(t, spec_for(p, t.dim()), shape, coords, p)

    live = named_leaves(state.params)
    with torch.no_grad():
        for p, t in named_leaves(loaded).items():
            live[p].copy_(mine(p, t))
    if opt_state is not None:
        opt_state = {**opt_state, **{m: {p: mine(p, t) for p, t in opt_state[m].items()}
                                     for m in ("mu", "nu")}}
    fresh = meta.get("adapter_only") or opt_state is None
    what = "LoRA adapters" if meta.get("lora_only") else "params"
    logger.info(f"resumed {what} from {path}" + (" (fresh optimizer state)" if fresh else ""))
    return TrainState(meta["step"], state.params, state.opt_state if fresh else opt_state)


def train(model_args=None, data_args=None, training_args=None, dataset=None,
          cfg: Optional[StreamMindConfig] = None, max_steps_override=None):
    if model_args is None:
        model_args, data_args, training_args = parse_args()
    stage = _stage_of(model_args, data_args)
    logger.info(f"training stage: {stage}")
    # a launcher's WORLD_SIZE / RANK / MASTER_ADDR / MASTER_PORT (torchrun);
    # nothing at world size 1 or where the caller started the group
    dist_utils.init_process_group(device=training_args.device)
    _check_supported(model_args, training_args, stage)

    # -- model ---------------------------------------------------------------
    if cfg is None:
        if _model_dir(model_args):
            # the decoder's config from the checkpoint (streammind_config.json
            # or an HF config.json: a mixtral or qwen2 model_type trains as such)
            from ..api import _load_config

            cfg = _load_config(model_args.model_path).replace(
                mm_projector_type=model_args.mm_projector_type)
        else:
            cfg = StreamMindConfig(mm_projector_type=model_args.mm_projector_type)
    if stage == "cls" and cfg.mm_projector_type != "mamba":
        raise ValueError("gate (stage-2) training requires mm_projector_type='mamba' — the "
                         f"2-way gate LM lives inside the mamba projector; got "
                         f"{cfg.mm_projector_type!r}")
    device = torch.device(training_args.device)
    dtype = torch.bfloat16 if training_args.bf16 else torch.float32
    params = load_start_params(model_args, cfg, training_args.seed, device, dtype)
    if model_args.train_skip_cls:
        params = copy_decoder_layers_into_gate(params, cfg)
    if model_args.bits in (4, 8):
        # the frozen decoder rests int8 (per channel) or int4 (groups of 64)
        from ..utils.quantize import quantize_text_params

        params["text"] = quantize_text_params(params["text"], bits=model_args.bits,
                                              free_source=True)
        logger.info(f"frozen decoder quantized to int{model_args.bits}")
    if dataset is None:
        dataset = build_dataset(model_args, data_args, training_args)

    # global batch = dp × per-device batch × grad accumulation
    accum = max(training_args.gradient_accumulation_steps, 1)
    per_device = max(training_args.per_device_train_batch_size, 1)
    dp = max(training_args.dp, 1)
    micro_bs = per_device * dp
    global_bs = micro_bs * accum
    if training_args.max_steps > 0 or max_steps_override:
        total_steps = max_steps_override or training_args.max_steps
    else:  # optimizer steps for num_train_epochs passes over the data
        total_steps = max(len(dataset) // global_bs, 1) * max(training_args.num_train_epochs, 1)

    # -- LoRA: factors over the frozen (maybe quantized) decoder -----------------
    lora_scaling = None
    if training_args.lora_enable and stage == "llm":
        from .lora import init_lora_params

        params["lora"] = init_lora_params(
            torch.Generator(device=device).manual_seed(training_args.seed + 1), params["text"],
            r=training_args.lora_r, dtype=dtype)
        lora_scaling = training_args.lora_alpha / training_args.lora_r
        logger.info(f"LoRA enabled: r={training_args.lora_r} alpha={training_args.lora_alpha}")

    # -- optimizer -------------------------------------------------------------
    if lora_scaling is not None:
        # the decoder frozen; the LoRA factors and the projector minus the gate train
        mask = trainable_mask({k: v for k, v in params.items() if k != "lora"}, "adapter")
        mask["lora"] = tree_map(lambda _: True, params["lora"])
    else:
        mask = trainable_mask(params, stage)
    logger.info(f"trainable params: {count_trainable(params, mask) / 1e6:.1f}M")
    optimizer = make_optimizer(
        cosine_schedule(training_args.learning_rate, total_steps, training_args.warmup_ratio),
        projector_lr=training_args.mm_projector_lr, weight_decay=training_args.weight_decay,
        grad_clip=training_args.grad_clip)
    mesh = make_mesh(training_args.dp, training_args.fsdp, training_args.tp,
                     device_type=device.type)
    params = shard_params(params, mesh)
    optimizer.mesh = mesh
    state = init_train_state(params, optimizer, mask)  # frozen leaves: requires_grad False

    if training_args.resume:
        latest = latest_checkpoint(training_args.output_dir)
        if latest:
            state = _resume(state, latest, device, mesh)
    start_step = state.step
    with set_mesh(mesh):
        return _train_loop(state, mesh, cfg, stage, dataset, model_args, data_args,
                           training_args, optimizer, mask, lora_scaling, device, total_steps,
                           start_step, per_device, micro_bs, global_bs, accum)


def _train_loop(state, mesh, cfg, stage, dataset, model_args, data_args, training_args,
                optimizer, mask, lora_scaling, device, total_steps, start_step, per_device,
                micro_bs, global_bs, accum):

    # "auto": the flash kernels on a CUDA device, the plain reference on the
    # CPU; "flash" becomes "flash!" (the strict form: a mesh that does not
    # divide the batch and heads raises instead of taking the plain path)
    attn_impl = training_args.attn_impl
    if attn_impl == "auto":
        attn_impl = "flash" if device.type == "cuda" else "auto"
    if attn_impl == "flash":
        attn_impl = "flash!"
    remat = training_args.gradient_checkpointing

    def _effective(p):
        if lora_scaling is None:
            return p
        # matmul-time LoRA: no merged weight, the base may rest quantized
        from .lora import attach_lora

        return {**p, "text": attach_lora(p["text"], p["lora"], lora_scaling)}

    if stage == "cls":
        def loss_fn(p, b, with_tokens=False):
            return stage2_gate_loss(p, cfg, b["frames"], b["labels"], b["mask"],
                                    with_tokens=with_tokens)
    else:
        def loss_fn(p, b, with_tokens=False):
            return stage1_llm_loss(_effective(p), cfg, b["frames"], b["token_ids"],
                                   b["mem_index"], b["use_mem"], b["attn_mask"], b["labels"],
                                   remat=remat, attn_impl=attn_impl, with_tokens=with_tokens)

    def text_loss_fn(p, b, with_tokens=False):
        return text_only_llm_loss(_effective(p), cfg, b["token_ids"], b["attn_mask"],
                                  b["labels"], remat=remat, attn_impl=attn_impl,
                                  with_tokens=with_tokens)

    step_fn = make_train_step(loss_fn, optimizer, mask)
    step_fn_text = make_train_step(text_loss_fn, optimizer, mask)
    # accumulation: each chunk loss is a token mean, so weighting its grads
    # by its supervised-token count gives the token mean of the whole batch
    grad_fn = make_grad_step(functools.partial(loss_fn, with_tokens=True), mask, has_aux=True)
    grad_fn_text = make_grad_step(functools.partial(text_loss_fn, with_tokens=True), mask,
                                  has_aux=True)
    apply_fn = make_accum_apply(optimizer, mask)

    # -- data order: shuffled, length/modality-grouped dp × accum batches -------
    lengths = getattr(dataset, "modality_lengths", None)
    sampler = LengthGroupedSampler(len(dataset), batch_size=per_device,
                                   world_size=max(training_args.dp, 1) * accum,
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
    writer = MetricsWriter(os.path.join(training_args.output_dir, "logs")) \
        if dist_utils.is_master() else None
    dp_group = C.axis_group(mesh, "dp")
    rows = C.axis_rows(micro_bs, mesh, "dp")

    def microbatch(chunk):  # the whole microbatch, then this rank's dp rows
        kind, batch = make_microbatch(chunk, cfg, vision, stage, pad_to=micro_bs)
        return kind, {k: v[rows] for k, v in batch.items()}

    t0 = time.time()
    for step in range(start_step, total_steps):
        batch_samples = [next(sample_stream) for _ in range(global_bs)]
        # modality-pure microbatches (the sampler groups; this guards the seams)
        text_s = [s for s in batch_samples if s.get("modal", "?") is None]
        media_s = [s for s in batch_samples if s.get("modal", "?") is not None]
        chunks = [group[c:c + micro_bs] for group in (media_s, text_s) if group
                  for c in range(0, len(group), micro_bs)]
        if len(chunks) == 1 and dp_group is None:
            kind, batch = microbatch(chunks[0])
            state, metrics = (step_fn_text if kind == "text" else step_fn)(state, batch)
        else:
            # token-weighted: each chunk loss is a token mean, so the weighted
            # sum over chunks (and over the dp ranks' rows) is the global mean
            grad_sum, loss_sum, w_total = None, None, None
            for chunk in chunks:
                kind, batch = microbatch(chunk)
                (loss, w), grads = (grad_fn_text if kind == "text" else grad_fn)(
                    state.params, batch)
                if grad_sum is None:
                    grad_sum, loss_sum, w_total = tree_scale(grads, w), loss * w, w
                else:
                    grad_sum = tree_axpy(grad_sum, grads, w)
                    loss_sum, w_total = loss_sum + loss * w, w_total + w
                del grads, batch
            if dp_group is not None:
                for t in (*grad_sum.values(), loss_sum, w_total):
                    torch.distributed.all_reduce(t, group=dp_group)
            state, metrics = apply_fn(state, grad_sum, loss_sum, w_total)
            del grad_sum
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        metrics_log.update(loss=loss, grad_norm=gnorm)
        if (step + 1) % training_args.logging_steps == 0:
            logger.info(f"step {step + 1}/{total_steps} {metrics_log} "
                        f"({(time.time() - t0) / (step - start_step + 1):.2f}s/it)")
            if writer is not None:
                writer.write(step + 1, {"train/loss": loss, "train/grad_norm": gnorm})
        if (step + 1) % training_args.save_steps == 0 or step + 1 == total_steps:
            _save(state, mesh, training_args, step + 1, stage, lora_scaling is not None)
    if writer is not None:
        writer.close()
    return state


def _save(state: TrainState, mesh, training_args, step: int, stage: str, lora: bool):
    """checkpoint-{step}: the whole tree (gathered from the ranks' shards
    under a mesh, written by rank 0); the adapter and cls stages save the
    projector, LoRA runs the trainables (the reference's lora +
    non_lora_trainables split)."""
    adapter_only = stage in ("cls", "adapter")
    saved = state.params
    if lora:
        saved = {"lora": saved["lora"], "projector": saved["projector"]}
    elif adapter_only:
        saved = {"projector": saved["projector"]}
    saved = gather_params(saved, mesh)
    opt_state = None
    if not adapter_only:
        opt_state = {**state.opt_state, **{m: {p: gather_leaf(t, p, t.dim(), mesh)
                                               for p, t in state.opt_state[m].items()}
                                           for m in ("mu", "nu")}}
    if dist_utils.is_master():
        path = save_checkpoint(training_args.output_dir, step, saved, adapter_only=adapter_only,
                               keep=training_args.save_total_limit, extra={"lora_only": lora})
        if opt_state is not None:
            save_opt_state(path, opt_state)
    dist_utils.barrier()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    train()
