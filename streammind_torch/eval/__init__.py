"""Benchmark metrics and runners: own copies of the JAX package's ``eval/``,
the runners over this package's ``api`` on ``cuda`` unless ``--device cpu``."""
from .metrics import (
    aggregate,
    gate_frame_metrics,
    gate_prf,
    gate_timediff,
    relaxed_correct,
    split_turns_by_eos,
    turn_ppl_correctness,
)
from .mcqa import extract_choice_letter, get_chunk, mcqa_accuracy, split_list
from .nlg import bleu, calculate_metrics, cider, meteor_lite, rouge_l
