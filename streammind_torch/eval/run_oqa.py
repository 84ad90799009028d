"""Open-ended QA + captioning benchmark drivers (GPT-judged).

The JAX package's ``eval/run_oqa.py`` over this package's ``api``, on
``--device`` (default cuda).

Reference: eval/inference_video_oqa_vcgpt*.py (Video-ChatGPT 5-dim,
ActivityNet, MSVD) and inference_video_cap_msvc.py — chunked inference via
x_infer(mode='openend'|'vanilla') → answers JSONL → eval/gpt_judge.py.

  python -m streammind_torch.eval.run_oqa --model-path ckpt \
      --question-file q.json --answer-file out.jsonl --video-root vids/
  python -m streammind_torch.eval.run_oqa --judge-only --answer-file out.jsonl \
      --judge-dim correctness --judge-dir judge_out/
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

from .gpt_judge import judge_predictions
from .mcqa import get_chunk


def load_questions(path: str) -> List[Dict]:
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = data.get("questions") or data.get("annotations") or list(data.values())
    out = []
    for i, rec in enumerate(data):
        row = {
            "id": rec.get("question_id", rec.get("id", i)),
            "video": rec.get("video_name") or rec.get("video") or rec.get("video_id"),
            "question": rec.get("question") or rec.get("Q") or rec.get("question_1")
                        or rec.get("caption_question", ""),
            "answer": rec.get("answer") or rec.get("A") or "",
        }
        # consistency protocol: a PAIRED second question per record
        # (reference inference_video_oqa_vcgpt_consistency.py); carried so
        # the judge can compare pred vs pred2
        q2 = rec.get("question2") or rec.get("Q2") or rec.get("question_2")
        if q2:
            row["question2"] = q2
        out.append(row)
    return out


def run_inference(args):
    from ..api import model_init, x_infer

    model, processor, tokenizer, version = model_init(args.model_path, device=args.device)
    questions = get_chunk(load_questions(args.question_file), args.num_chunks, args.chunk_idx)
    os.makedirs(os.path.dirname(args.answer_file) or ".", exist_ok=True)
    mode = "vanilla" if args.captioning else "openend"
    with open(args.answer_file, "w") as out:
        for q in questions:
            video_path = os.path.join(args.video_root, str(q["video"]))
            if not os.path.splitext(video_path)[1]:
                video_path += ".mp4"
            pred2 = None
            try:
                video = processor(video_path)
                pred = x_infer(video, q["question"], model, tokenizer,
                               mode=mode, version=version)
            except Exception as e:  # noqa: BLE001
                pred = ""
                q["error"] = str(e)
            if pred and q.get("question2"):
                # separate try: a failure on the PAIRED question must not
                # clobber the valid first answer (the row would otherwise
                # score 0 for every dimension, not just consistency)
                try:
                    pred2 = x_infer(video, q["question2"], model, tokenizer,
                                    mode=mode, version=version)
                except Exception as e:  # noqa: BLE001
                    q["error2"] = str(e)
            row = {**q, "pred": pred}
            if pred2 is not None:
                row["pred2"] = pred2
            out.write(json.dumps(row) + "\n")
    print(f"wrote {args.answer_file}")


def run_judge(args):
    preds = [json.loads(line) for line in open(args.answer_file)]
    scored = [p for p in preds if p.get("pred")]
    n_failed = len(preds) - len(scored)
    result = judge_predictions(
        scored, args.judge_dir, dimension=args.judge_dim,
    )
    # inference failures score 0/'no' — dropping them would inflate accuracy
    total = result["n"] + n_failed
    if total:
        result = {
            "mean_score": result["mean_score"] * result["n"] / total,
            "accuracy": result["accuracy"] * result["n"] / total,
            "n": total,
            "n_failed": n_failed,
        }
    print(json.dumps({f"{args.judge_dim}": result}, indent=2))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path")
    parser.add_argument("--question-file")
    parser.add_argument("--video-root", default=".")
    parser.add_argument("--answer-file", required=True)
    parser.add_argument("--captioning", action="store_true",
                        help="MSVC-style captioning (vanilla prompt) instead of QA")
    parser.add_argument("--num-chunks", type=int, default=1)
    parser.add_argument("--chunk-idx", type=int, default=0)
    parser.add_argument("--judge-only", action="store_true")
    parser.add_argument("--judge-dim", default="generic",
                        choices=["generic", "correctness", "detail", "context",
                                 "temporal", "consistency",
                                 "msvc_correctness", "msvc_detailedness"])
    parser.add_argument("--judge-dir", default="judge_out")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.judge_only:
        run_judge(args)
    else:
        run_inference(args)


if __name__ == "__main__":
    main()
