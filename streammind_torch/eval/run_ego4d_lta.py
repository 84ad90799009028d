"""Ego4D Long-Term Action Anticipation (LTA) evaluation.

The JAX package's ``eval/run_ego4d_lta.py`` over this package's ``api``, on
``--device`` (default cuda).

Reference: eval/inference_video_ego4d_lta_generate.py — generate K candidate
future-action sequences per clip, map text to verb/noun vocabulary ids, and
score with the official LTA metric: per-clip minimum edit distance over the
K candidates, averaged, for verbs and nouns separately (ED@(Z=20,K=5)).

K candidates come from true beam search (engine.beam_generate, matching the
reference's generate(num_beams=5, num_return_sequences=5)); pass --sampled
to use K sampled decodes instead.
"""
from __future__ import annotations

import argparse
import os
import json
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance over id sequences."""
    m, n = len(a), len(b)
    dp = list(range(n + 1))
    for i in range(1, m + 1):
        prev = dp[0]
        dp[0] = i
        for j in range(1, n + 1):
            cur = dp[j]
            dp[j] = min(
                dp[j] + 1,
                dp[j - 1] + 1,
                prev + (a[i - 1] != b[j - 1]),
            )
            prev = cur
    return dp[n]


def ed_at_k(candidates: List[Sequence], target: Sequence) -> float:
    """min-over-K normalized edit distance (the AntEd metric)."""
    z = max(len(target), 1)
    return min(edit_distance(c[: len(target)], target) for c in candidates) / z


def parse_action_text(
    text: str, verb_vocab: Dict[str, int], noun_vocab: Dict[str, int], z: int = 20
) -> Tuple[List[int], List[int]]:
    """'take spoon, stir pot, ...' → (verb_ids, noun_ids), unknown → -1,
    padded/truncated to z."""
    verbs, nouns = [], []
    for step in re.split(r"[,;.\n]+", text):
        words = step.strip().lower().split()
        if not words:
            continue
        verbs.append(verb_vocab.get(words[0], -1))
        nouns.append(noun_vocab.get(words[-1], -1) if len(words) > 1 else -1)
    verbs = (verbs + [-1] * z)[:z]
    nouns = (nouns + [-1] * z)[:z]
    return verbs, nouns


def score_lta(
    predictions: List[List[str]],       # per clip: K candidate texts
    gt_verbs: List[Sequence[int]],
    gt_nouns: List[Sequence[int]],
    verb_vocab: Dict[str, int],
    noun_vocab: Dict[str, int],
) -> Dict[str, float]:
    verb_eds, noun_eds = [], []
    for cands, gv, gn in zip(predictions, gt_verbs, gt_nouns):
        parsed = [parse_action_text(c, verb_vocab, noun_vocab, len(gv)) for c in cands]
        verb_eds.append(ed_at_k([p[0] for p in parsed], list(gv)))
        noun_eds.append(ed_at_k([p[1] for p in parsed], list(gn)))
    return {
        "verb_ed": float(np.mean(verb_eds)) if verb_eds else 1.0,
        "noun_ed": float(np.mean(noun_eds)) if noun_eds else 1.0,
        "n_clips": len(predictions),
    }


def load_vocab(path: str) -> Dict[str, int]:
    """Vocab file: one token per line, or JSON {token: id} / [tokens]."""
    if path.endswith(".json"):
        with open(path) as f:
            raw = json.load(f)
        if isinstance(raw, dict):
            return {k.lower(): int(v) for k, v in raw.items()}
        return {str(t).lower(): i for i, t in enumerate(raw)}
    with open(path) as f:
        return {line.strip().lower(): i for i, line in enumerate(f) if line.strip()}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--video-root", required=True)
    parser.add_argument("--anno-path", required=True,
                        help="JSON: [{clip: path, gt_verbs: [...], gt_nouns: [...], prompt: str}]")
    parser.add_argument("--verb-vocab", required=True)
    parser.add_argument("--noun-vocab", required=True)
    parser.add_argument("--k", type=int, default=5)
    parser.add_argument("--sampled", action="store_true",
                        help="K sampled decodes instead of beam search")
    parser.add_argument("--num-frames", type=int, default=32)
    parser.add_argument("--num-chunks", type=int, default=1)
    parser.add_argument("--chunk-idx", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from ..api import infer, infer_beams, model_init
    from .mcqa import get_chunk

    model, processor, tokenizer, version = model_init(args.model_path, device=args.device)
    verb_vocab = load_vocab(args.verb_vocab)
    noun_vocab = load_vocab(args.noun_vocab)
    with open(args.anno_path) as f:
        clips = json.load(f)
    clips = get_chunk(clips, args.num_chunks, args.chunk_idx)

    preds, gvs, gns = [], [], []
    for clip in clips:
        # os.path.isabs, not '/'-in-string: a relative subdirectory path
        # like 'scenarios/clip.mp4' must still join --video-root
        path = (clip["clip"] if os.path.isabs(clip["clip"])
                else os.path.join(args.video_root, clip["clip"]))
        try:
            video = processor(path)
        except Exception as e:  # noqa: BLE001 — one bad clip must not
            # abort the whole evaluation (run_mcqa/run_oqa parity)
            print(f"[lta] skipping {clip.get('clip')}: {e}")
            continue
        prompt = clip.get(
            "prompt",
            "Predict the next 20 future actions as 'verb noun' steps separated by commas.",
        )
        if args.sampled:
            cands = [
                infer(model, video, prompt, tokenizer, do_sample=(k > 0),
                      version=version, seed=k)
                for k in range(args.k)
            ]
        else:
            cands = infer_beams(
                model, video, prompt, tokenizer,
                num_beams=args.k, num_return_sequences=args.k, version=version,
            )
        preds.append(cands)
        gvs.append(clip["gt_verbs"])
        gns.append(clip["gt_nouns"])
    print(json.dumps(score_lta(preds, gvs, gns, verb_vocab, noun_vocab), indent=2))


if __name__ == "__main__":
    main()
