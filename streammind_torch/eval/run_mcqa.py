"""Offline MCQA benchmark CLI (VideoMME / MVBench / EgoSchema /

The JAX package's ``eval/run_mcqa.py`` over this package's ``api``, on
``--device`` (default cuda).
Perception-Test).

Reference: eval/inference_video_mcqa_*.py — chunked inference via
x_infer(mode='mcqa') writing JSONL answers, then rule-based scoring
(eval_video_mcqa_*.py).  One driver handles all four via --benchmark
(dataset JSON schemas differ only in field names).
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Iterator, List

from .mcqa import extract_choice_letter, get_chunk, mcqa_accuracy, mcqa_accuracy_by_task

_FIELDS = {
    # benchmark: (video_key, question_key, options_key, answer_key, task_key)
    "videomme": ("videoID", "question", "options", "answer", "task_type"),
    "mvbench": ("video", "question", "candidates", "answer", "task_type"),
    "egoschema": ("q_uid", "question", "options", "answer", None),
    "perception": ("video_id", "question", "options", "answer_id", "task"),
}

_LETTERS = "ABCDEFGH"


def normalize_gt(benchmark: str, answer, options) -> str:
    """Ground truth → option letter, per benchmark convention:
    videomme stores the letter; mvbench stores the option TEXT; egoschema
    and perception store the option INDEX."""
    if benchmark == "videomme":
        return str(answer).strip()[:1].upper()
    if benchmark == "mvbench":
        text = str(answer).strip()
        for i, opt in enumerate(options or []):
            if str(opt).strip() == text:
                return _LETTERS[i]
        return text[:1].upper()  # letter-style fallback
    # egoschema / perception: integer option index
    try:
        return _LETTERS[int(answer)]
    except (ValueError, TypeError, IndexError):
        return str(answer).strip()[:1].upper()


def format_mcqa_question(question: str, options: List[str]) -> str:
    letters = _LETTERS
    lines = [question]
    for i, opt in enumerate(options):
        prefix = f"{letters[i]}." if not opt.strip().startswith(f"{letters[i]}.") else ""
        lines.append(f"{prefix} {opt.strip()}" if prefix else opt.strip())
    return "\n".join(lines)


def parse_srt(path: str) -> List[tuple]:
    """Minimal .srt parser → [(start_ms, end_ms, text)] (pysubs2 stand-in;
    the reference loads VideoMME subtitles with pysubs2, videomme.py:105)."""
    def to_ms(ts: str) -> int:
        hh, mm, rest = ts.strip().split(":")
        ss, ms = rest.replace(".", ",").split(",")
        return ((int(hh) * 60 + int(mm)) * 60 + int(ss)) * 1000 + int(ms)

    out = []
    with open(path, encoding="utf-8", errors="replace") as f:
        block: List[str] = []
        for line in list(f) + [""]:
            line = line.strip("﻿").rstrip("\n")
            if line.strip():
                block.append(line)
                continue
            if len(block) >= 2 and "-->" in block[1]:
                start, _, end = block[1].partition("-->")
                text = " ".join(block[2:]).strip()
                if text:
                    out.append((to_ms(start), to_ms(end), text))
            block = []
    return out


def subtitles_for_window(subs: List[tuple], duration_ms: int,
                         num_frames: int) -> str:
    """Keep subtitles overlapping the uniformly sampled frame instants
    (reference videomme.py:106-116) and join them with newlines."""
    if not subs or duration_ms <= 0:
        return ""
    instants = [int((i + 0.5) * duration_ms / num_frames) for i in range(num_frames)]
    keep, seen = [], set()
    for start, end, text in subs:
        if any(start <= t <= end for t in instants) and text not in seen:
            keep.append(text)
            seen.add(text)
    return "\n".join(keep)


def run_inference(model, tokenizer, records: List[Dict], benchmark: str,
                  video_root: str, processor, num_frames: int = 8,
                  version: str = "llama_2",
                  subtitle_root: str = None) -> Iterator[Dict]:
    from ..api import x_infer

    vkey, qkey, okey, akey, tkey = _FIELDS[benchmark]
    n_options = 5 if benchmark == "egoschema" else 4
    for rec in records:
        options = rec.get(okey, [])
        gt = normalize_gt(benchmark, rec.get(akey, ""), options)
        video_path = os.path.join(video_root, str(rec[vkey]))
        if not os.path.splitext(video_path)[1]:
            video_path += ".mp4"
        try:
            video = processor(video_path, num_frames=num_frames)
        except Exception as e:  # noqa: BLE001
            # SAME schema as success rows (question_id/task_type), so
            # failures stay visible to the per-task accuracy filter instead
            # of silently vanishing from by_task while counting in overall
            yield {
                "question_id": rec.get("question_id", rec.get(vkey)),
                "task_type": rec.get(tkey) if tkey else None,
                "pred": "",
                "gt": gt,
                "response": "",
                "error": str(e),
            }
            continue
        question = format_mcqa_question(rec[qkey], options)
        if subtitle_root:
            # VideoMME "with subtitles" track (reference videomme.py:88-118)
            srt = os.path.join(subtitle_root, f"{rec[vkey]}.srt")
            subtitle = ""
            if os.path.exists(srt):
                subs = parse_srt(srt)
                dur = rec.get("duration_ms") or (subs[-1][1] if subs else 0)
                subtitle = subtitles_for_window(subs, dur, num_frames)
            if subtitle:
                question = (
                    f"This video's subtitles are listed below:\n{subtitle}\n"
                    + question
                )
        response = x_infer(video, question, model, tokenizer, mode="mcqa",
                           version=version)
        yield {
            "question_id": rec.get("question_id", rec.get(vkey)),
            "task_type": rec.get(tkey) if tkey else None,
            "pred": extract_choice_letter(response, _LETTERS[:n_options]),
            "gt": gt,
            "response": response,
        }


def score_answers(path: str) -> Dict:
    records = [json.loads(line) for line in open(path)]
    # error rows count as wrong (pred "" never equals a letter gt), matching
    # the reference protocol of scoring every question
    records = [r for r in records if r.get("gt") is not None]
    out = {"accuracy": mcqa_accuracy(records)}
    if any(r.get("task_type") for r in records):
        out["by_task"] = mcqa_accuracy_by_task(
            [r for r in records if r.get("task_type")]
        )
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--benchmark", choices=list(_FIELDS), required=True)
    parser.add_argument("--question-file", required=True)
    parser.add_argument("--video-root", required=True)
    parser.add_argument("--answer-file", required=True)
    parser.add_argument("--num-frames", type=int, default=8)
    parser.add_argument("--num-chunks", type=int, default=1)
    parser.add_argument("--chunk-idx", type=int, default=0)
    parser.add_argument("--score-only", action="store_true")
    parser.add_argument("--subtitle-root", default=None,
                        help="VideoMME: dir of {videoID}.srt for the "
                             "with-subtitles track")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    if args.score_only:
        print(json.dumps(score_answers(args.answer_file), indent=2))
        return

    from ..api import model_init

    model, processor, tokenizer, version = model_init(args.model_path, device=args.device)
    with open(args.question_file) as f:
        data = json.load(f)
    records = data if isinstance(data, list) else data.get("questions", data)
    records = get_chunk(records, args.num_chunks, args.chunk_idx)

    os.makedirs(os.path.dirname(args.answer_file) or ".", exist_ok=True)
    with open(args.answer_file, "w") as out:
        for row in run_inference(
            model, tokenizer, records, args.benchmark, args.video_root,
            processor, args.num_frames, version=version,
            subtitle_root=args.subtitle_root,
        ):
            out.write(json.dumps(row) + "\n")
    print(json.dumps(score_answers(args.answer_file), indent=2))


if __name__ == "__main__":
    main()
