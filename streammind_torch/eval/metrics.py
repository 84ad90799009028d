"""Streaming evaluation metrics — exact reference semantics.

A copy of the JAX package's ``eval/metrics.py`` (it imports no JAX).

  - gate_prf:     precision/recall/F1 @ ±tolerance seconds
                  (reference eval/inference_video_score_stream_ddp.py:242-273:
                  TP counts every prediction inside any target window; FP =
                  predictions minus *unique matched* predictions; FN = targets
                  with no prediction in range)
  - relaxed_correct / gate_timediff_metrics:
                  per-frame accuracy, TPR, TNR with ±N-frame relaxation and
                  the TimeDiff count (eval/inference_video_ego4d_stream_
                  parallel_new.py:127-137, 300-345)
  - turn_ppl_correctness: teacher-forced per-turn LM-PPL and token
                  correctness (:190-230)
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def gate_prf(
    target_times: Sequence[float],
    predicted_times: Sequence[float],
    tolerance: float = 5.0,
) -> Tuple[float, float, float]:
    """Fire-time precision/recall/F1 with a ±tolerance window."""
    target_ranges = [(t - tolerance, t + tolerance) for t in target_times]

    tp = 0
    matched_predicted = set()
    for pred in predicted_times:
        for start, end in target_ranges:
            if start <= pred <= end:
                tp += 1
                matched_predicted.add(pred)
                break
    fp = len(predicted_times) - len(matched_predicted)

    matched_target = set()
    for t in target_times:
        for pred in predicted_times:
            if (t - tolerance) <= pred <= (t + tolerance):
                matched_target.add(t)
                break
    fn = len(target_times) - len(matched_target)

    precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    f1 = (
        2 * precision * recall / (precision + recall)
        if (precision + recall) > 0
        else 0.0
    )
    return precision, recall, f1


def relaxed_correct(labels: np.ndarray, preds: np.ndarray, n: int) -> np.ndarray:
    """matches[i] == True iff labels[i] appears anywhere in preds[i-n:i+n+1]."""
    labels = np.asarray(labels)
    preds = np.asarray(preds)
    out = np.zeros(labels.shape, bool)
    for i in range(len(labels)):
        lo, hi = max(0, i - n), min(len(labels), i + n + 1)
        out[i] = labels[i] in preds[lo:hi]
    return out


def gate_frame_metrics(
    labels: np.ndarray,   # per-frame {0,1}
    preds: np.ndarray,    # per-frame argmax {0,1}
    tolerance_frames: int = 2,
) -> Dict[str, float]:
    """Relaxed accuracy + TPR/TNR as the reference defines them
    (false positives/negatives only count when also outside the relaxed
    window)."""
    labels = np.asarray(labels)
    preds = np.asarray(preds)
    matches = relaxed_correct(labels, preds, tolerance_frames)
    accuracy = matches.sum() / (labels.size + 1e-9)
    fp = np.sum((labels == 0) & (preds == 1) & ~matches)
    tn_total = np.sum(labels == 0)
    tpr = 1 - fp / (tn_total + 1e-9)
    fn = np.sum((labels == 1) & (preds == 0) & ~matches)
    tp_total = np.sum(labels == 1)
    tnr = 1 - fn / (tp_total + 1e-9)
    return {"accuracy": float(accuracy), "tpr": float(tpr), "tnr": float(tnr)}


def gate_timediff(labels: np.ndarray, preds: np.ndarray) -> float:
    """TimeDiff for one turn: wrong-frame count / 2 (frames at 2 fps →
    seconds; reference :330-341)."""
    wrong = np.sum(np.asarray(labels) != np.asarray(preds))
    return float(wrong) / 2.0


def turn_ppl_correctness(
    turn_logits: np.ndarray,  # (T, V) logits for one turn (already shifted)
    turn_labels: np.ndarray,  # (T,) target ids, IGNORE_INDEX-masked upstream
) -> Tuple[float, float, int]:
    """(ppl, correctness, n_tokens) for one teacher-forced turn."""
    logits = np.asarray(turn_logits, np.float64)
    labels = np.asarray(turn_labels)
    logits = logits - logits.max(axis=-1, keepdims=True)
    logp = logits - np.log(np.exp(logits).sum(axis=-1, keepdims=True))
    nll = -logp[np.arange(len(labels)), labels].mean()
    ppl = float(np.exp(nll))
    pred = logits.argmax(axis=-1)
    correctness = float((pred == labels).mean())
    return ppl, correctness, int(len(labels))


def split_turns_by_eos(labels: np.ndarray, eos_id: int = 2) -> List[Tuple[int, int]]:
    """[start, end] index pairs (inclusive of the eos position) per turn —
    the reference splits on labels == 2 (:191-195)."""
    ends = np.nonzero(np.asarray(labels) == eos_id)[0].tolist()
    starts = [-1] + ends[:-1]
    return [(s + 1, e + 1) for s, e in zip(starts, ends)]


def aggregate(values: Sequence[float]) -> float:
    return float(sum(values) / len(values)) if values else 0.0
