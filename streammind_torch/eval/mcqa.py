"""Offline MCQA helpers: rank-chunked work splitting and rule-based answer

A copy of the JAX package's ``eval/mcqa.py`` (it imports no JAX).
extraction (reference eval/inference_video_mcqa_videomme.py:26-34 and
eval_video_mcqa_videomme.py:65-85)."""
from __future__ import annotations

import math
import re
from typing import Dict, List, Sequence


def split_list(lst: Sequence, n: int) -> List[List]:
    """Split into n roughly equal chunks (ceil-sized; last may be short).
    An empty worklist yields no chunks (ceil gives chunk size 0, which
    would make range()'s step zero and raise an opaque ValueError)."""
    if not lst:
        return []
    chunk = math.ceil(len(lst) / n)
    return [list(lst[i : i + chunk]) for i in range(0, len(lst), chunk)]


def get_chunk(lst: Sequence, n: int, k: int) -> List:
    """k-th of n chunks; ranks beyond the ceil-split's chunk count get an
    empty worklist instead of an IndexError (small corpora, many ranks)."""
    chunks = split_list(lst, n)
    return chunks[k] if k < len(chunks) else []


_ANSWER_PREFIXES = [
    "The best answer is",
    "The correct answer is",
    "The answer is",
    "The answer",
    "The best option isThe correct option is",  # reference's missing-comma join
    "Best answer:Best option:",
]


def extract_choice_letter(s: str, choices: str = "ABCD") -> str:
    """First A-D letter after stripping common answer prefixes; '' when the
    response is long free text without any letter."""
    s = s.strip()
    for prefix in _ANSWER_PREFIXES:
        s = s.replace(prefix, "")
    if len(s.split()) > 10 and not re.search(f"[{choices}]", s):
        return ""
    m = re.search(f"[{choices}]", s)
    return m[0] if m else ""


def mcqa_accuracy(records: List[Dict], pred_key: str = "pred", gt_key: str = "gt") -> float:
    if not records:
        return 0.0
    return 100.0 * sum(
        1 for r in records if r.get(pred_key) == r.get(gt_key) and r.get(gt_key)
    ) / len(records)


def mcqa_accuracy_by_task(records: List[Dict], task_key: str = "task_type") -> Dict[str, float]:
    by_task: Dict[str, List[Dict]] = {}
    for r in records:
        by_task.setdefault(r[task_key], []).append(r)
    return {t: mcqa_accuracy(rs) for t, rs in by_task.items()}
