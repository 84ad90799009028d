"""Ego4D streaming LLM+gate evaluation CLI (the JAX package's
``eval/run_ego4d_stream.py``).

Reference: eval/inference_video_ego4d_stream_parallel_new.py —
  --eval-type llm : teacher-forced per-turn LM-PPL, LM-correctness, and the
                    pred/target caption CSV fed to the NLG scorer
  --eval-type cls : per-frame gate relaxed accuracy / TPR / TNR / TimeDiff

A clip's memory tokens come from ``api.encode_memory`` (the ViT with the
default attention, then the projector's scan through the scan kernel); the
teacher-forced pass is ``text_forward`` at a bucket of up to 4096 under a
padding mask (the default attention).

  python -m streammind_torch.eval.run_ego4d_stream --model-path ckpt/ \
      --video-root videos/ --anno-path narrations.json [--eval-type cls] [--device cpu]
"""
from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Dict, List

import numpy as np
import torch

from ..constants import IGNORE_INDEX
from .metrics import (
    aggregate,
    gate_frame_metrics,
    gate_timediff,
    split_turns_by_eos,
    turn_ppl_correctness,
)
from .nlg import calculate_metrics


def eval_llm_sample(
    logits: np.ndarray,   # (S, V) full-sequence logits
    labels: np.ndarray,   # (S,)
    tokenizer,
    eos_id: int = 2,
) -> Dict:
    """Per-turn teacher-forced metrics for one video (reference :190-230):
    split on eos labels, shift within each turn, drop IGNORE positions."""
    turns = split_turns_by_eos(labels, eos_id)
    ppls, correctness, token_counts = [], [], []
    rows = []
    for start, end in turns:
        turn_logits = logits[start:end][:-1]
        turn_labels = labels[start:end][1:]
        keep = turn_labels != IGNORE_INDEX
        turn_logits, turn_labels = turn_logits[keep], turn_labels[keep]
        if len(turn_labels) == 0:
            continue
        ppl, corr, n = turn_ppl_correctness(turn_logits, turn_labels)
        ppls.append(ppl)
        correctness.append(corr)
        token_counts.append(n)
        pred_ids = turn_logits.argmax(axis=-1).tolist()
        try:
            pred = tokenizer.decode(pred_ids, skip_special_tokens=True).strip()
            target = tokenizer.decode(turn_labels.tolist(), skip_special_tokens=True).strip()
        except TypeError:
            pred = tokenizer.decode(pred_ids).strip()
            target = tokenizer.decode(turn_labels.tolist()).strip()
        rows.append((pred, target))
    return {
        "lm_ppl": aggregate(ppls),
        "lm_correctness": aggregate(correctness),
        "tokens_per_turn": aggregate([float(t) for t in token_counts]),
        "rows": rows,
    }


def eval_cls_sample(gate_logits: np.ndarray, gate_labels: np.ndarray,
                    tolerance_frames: int = 2) -> Dict:
    """Per-frame gate metrics for one video (reference :300-345)."""
    preds = gate_logits.argmax(axis=-1)
    frame = gate_frame_metrics(gate_labels, preds, tolerance_frames)
    frame["time_diff"] = gate_timediff(gate_labels, preds)
    return frame


def write_caption_csv(path: str, rows: List, header_row=("start csv log!",)):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(header_row)
        for row in rows:
            w.writerow(row)


def score_caption_csv(path: str) -> Dict[str, str]:
    """NLG-score a pred/target CSV (reference score_single.py main)."""
    refs, hyps = {}, {}
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        next(reader, None)
        for i, row in enumerate(reader):
            if len(row) >= 2:
                hyps[i] = [row[0]]
                refs[i] = [row[1]]
    return calculate_metrics(refs, hyps)


@torch.no_grad()
def sample_memory(model, sample) -> torch.Tensor:
    """(1, T, hidden) memory tokens of a sample's frames."""
    from ..api import encode_memory, engine_pixels

    return encode_memory(model, engine_pixels(model.engine, sample["video"]))


@torch.no_grad()
def llm_sample_logits(model, sample):
    """Teacher-forced logits of one video's whole narration dialogue:
    ((length, V) fp32 logits, (length,) labels) over the spliced sequence."""
    from ..models import mistral as lm_mod
    from ..models.meta import build_splice_plan, bucket_length, splice_embeds

    memory = sample_memory(model, sample)
    dev = memory.device
    ids = list(sample["input_ids"][0])
    n = len(ids) - len(sample["span_frames"]) + int(memory.shape[1])
    plan = build_splice_plan(
        ids, sample["span_frames"], -201,
        bucket_length(n, (256, 512, 1024, 2048, 4096)),
        labels=list(sample["labels"][0]),
    )
    embeds = splice_embeds(
        model.params["text"], torch.from_numpy(plan.token_ids)[None].to(dev),
        torch.from_numpy(plan.mem_index)[None].to(dev),
        torch.from_numpy(plan.use_mem)[None].to(dev), memory,
    )
    logits, _ = lm_mod.text_forward(
        model.params["text"], model.cfg.text, inputs_embeds=embeds,
        attn_mask=torch.from_numpy(plan.attn_mask)[None].to(dev),
    )
    return logits[0, : plan.length].float().cpu().numpy(), plan.labels[: plan.length]


@torch.no_grad()
def cls_sample_logits(model, sample) -> np.ndarray:
    """(T, 2) gate logits of a video's memory tokens, each token ALONE (the
    deployed conditioning of gate_decision_step / the training pairs)."""
    from ..models import projector as proj_mod

    memory = sample_memory(model, sample)
    return proj_mod.gate_decision_step(
        model.params["projector"], model.cfg, memory[0]).float().cpu().numpy()


def evaluate_llm(model, tokenizer, ds, idxs, caption_path: str) -> Dict:
    """lm_ppl, lm_correctness (means over videos) and the NLG scores of the
    argmax captions, written to and scored from ``caption_path``."""
    all_rows, ppls, corrs = [], [], []
    for i in idxs:
        logits, labels = llm_sample_logits(model, ds[i])
        out = eval_llm_sample(logits, labels, tokenizer)
        ppls.append(out["lm_ppl"])
        corrs.append(out["lm_correctness"])
        all_rows.extend(out["rows"])
    write_caption_csv(caption_path, all_rows)
    return {
        "lm_ppl": aggregate(ppls),
        "lm_correctness": aggregate(corrs),
        "nlg": score_caption_csv(caption_path),
    }


def evaluate_cls(model, ds, idxs) -> Dict:
    metrics = []
    for i in idxs:
        sample = ds[i]
        glogits = cls_sample_logits(model, sample)
        n = min(glogits.shape[0], sample["gate_labels"].shape[1])
        metrics.append(eval_cls_sample(glogits[:n], sample["gate_labels"][0, :n]))
    return {
        k: aggregate([m[k] for m in metrics])
        for k in ("accuracy", "tpr", "tnr", "time_diff")
    }


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--video-root", required=True)
    parser.add_argument("--anno-path", required=True)
    parser.add_argument("--eval-type", choices=["llm", "cls"], default="llm")
    parser.add_argument("--caption-path", default="inference_result/ego4d.csv")
    parser.add_argument("--max-turns", type=int, default=None)
    parser.add_argument("--num-chunks", type=int, default=1)
    parser.add_argument("--chunk-idx", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from ..api import model_init
    from ..data.ego4d import Ego4dNarrationDataset
    from ..mm_utils import clip_preprocess, frames_to_pil, read_video_frames, video_metadata
    from .mcqa import get_chunk

    model, _, tokenizer, _ = model_init(args.model_path, device=args.device)

    def frame_loader(video_path, start_ts, end_ts, fps=2.0):
        """Sample the exact 1/fps grid (one frame per 0.5 s slot) so the
        frame count equals sum(span_frames) regardless of the container's
        real fps; out-of-range slots clamp to the last frame."""
        duration, vfps = video_metadata(video_path)
        n = max(int(round((end_ts - start_ts) * fps)), 1)
        times = start_ts + (np.arange(n) + 1) / fps
        ids = np.clip(np.round(times * vfps).astype(int), 0, max(duration - 1, 0))
        return clip_preprocess(frames_to_pil(read_video_frames(video_path, ids)))

    ds = Ego4dNarrationDataset(
        args.video_root, args.anno_path, tokenizer,
        model_type=args.eval_type, max_turns=args.max_turns,
        frame_loader=frame_loader,
    )
    idxs = get_chunk(list(range(len(ds))), args.num_chunks, args.chunk_idx)
    if args.eval_type == "llm":
        print(json.dumps(evaluate_llm(model, tokenizer, ds, idxs, args.caption_path), indent=2))
    else:
        print(json.dumps(evaluate_cls(model, ds, idxs), indent=2))


if __name__ == "__main__":
    main()
