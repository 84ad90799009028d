"""GPT-judge OQA evaluation (Video-ChatGPT protocol).

A copy of the JAX package's ``eval/gpt_judge.py`` (it imports no JAX).

Reference: eval/eval_video_oqa_vcgpt_{1..5}_*.py + the streammind
activitynet/msvd variants — an Azure/OpenAI chat judge scoring each QA pair,
with per-file caching, a retry loop, and mean-score/accuracy aggregation.

Five dimensions (reference file suffixes): correctness, detailed
orientation ("detail"), context, temporal, consistency — plus the generic
yes/no+score judge used by the ActivityNet/MSVD runs.  The transport is
pluggable (``judge_fn``) so the pipeline tests offline; the default client
reads OPENAI_API_KEY / AZURE_OPENAI_* env vars.
"""
from __future__ import annotations

import ast
import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

_SYSTEM_PROMPTS = {
    "generic": (
        "You are an intelligent chatbot designed for evaluating the correctness "
        "of generative outputs for question-answer pairs. Your task is to compare "
        "the predicted answer with the correct answer and determine if they match "
        "meaningfully."
    ),
    "correctness": (
        "You are an intelligent chatbot designed for evaluating the factual "
        "accuracy of generative outputs for video-based question-answer pairs. "
        "Your task is to compare the predicted answer with the correct answer and "
        "determine if they are factually consistent."
    ),
    "detail": (
        "You are an intelligent chatbot designed for evaluating the detail "
        "orientation of generative outputs for video-based question-answer pairs. "
        "Your task is to compare the predicted answer with the correct answer and "
        "determine its level of detail, considering both completeness and specificity."
    ),
    "context": (
        "You are an intelligent chatbot designed for evaluating the contextual "
        "understanding of generative outputs for video-based question-answer pairs. "
        "Your task is to compare the predicted answer with the correct answer and "
        "determine whether the predicted answer aligns with the overall context of "
        "the video content."
    ),
    "temporal": (
        "You are an intelligent chatbot designed for evaluating the temporal "
        "understanding of generative outputs for video-based question-answer pairs. "
        "Your task is to compare the predicted answer with the correct answer and "
        "determine if they correctly reflect the temporal sequence of events."
    ),
    "consistency": (
        "You are an intelligent chatbot designed for evaluating the consistency of "
        "generative outputs for similar video-based question-answer pairs. Your "
        "task is to compare two predicted answers to similar questions and "
        "determine whether they are consistent with each other and the correct answer."
    ),
    # MSVC multi-reference captioning judges
    # (reference eval_video_cap_msvc_correctness.py:55-75 / _detailedness.py)
    "msvc_correctness": (
        "You are an intelligent chatbot designed for evaluating the factual "
        "accuracy of generative outputs for video-based question-answer pairs. "
        "Your task is to compare the predicted answer with a list of correct "
        "human-annotated answers and determine if they are factually consistent."
    ),
    "msvc_detailedness": (
        "You are an intelligent chatbot designed for evaluating the detailedness "
        "of generative outputs for video captioning. Your task is to compare the "
        "predicted caption with a list of human-annotated captions and determine "
        "its level of detail, considering both completeness and specificity."
    ),
}


# Per-dimension evaluation asks (the Video-ChatGPT 5-dimension protocol;
# the generic variant is the ActivityNet/MSVD yes/no+score judge).
_USER_ASKS = {
    "generic": (
        "Provide your evaluation only as a yes/no and score where the score is an "
        "integer value between 0 and 5, with 5 indicating the highest meaningful match. "
    ),
    "correctness": (
        "Evaluate the factual accuracy of the prediction compared to the answer; "
        "the predicted answer must not contain misinterpretations or misinformation. "
        "Provide a factual-accuracy score between 0 and 5. "
    ),
    "detail": (
        "Evaluate the detail orientation of the prediction: it should cover all "
        "major points of the correct answer and include specific rather than "
        "generic details. Provide a detail-orientation score between 0 and 5. "
    ),
    "context": (
        "Evaluate whether the predicted answer aligns with the overall context of "
        "the video content without deviating from it. Provide a contextual-"
        "understanding score between 0 and 5. "
    ),
    "temporal": (
        "Evaluate whether the predicted answer accurately reflects the temporal "
        "sequence of events in the video. Provide a temporal-accuracy score "
        "between 0 and 5. "
    ),
    "consistency": (
        "Evaluate whether the two predicted answers to the two similar questions "
        "are consistent with each other and with the correct answer. Provide a "
        "consistency score between 0 and 5. "
    ),
    "msvc_correctness": (
        "Evaluate the factual accuracy of the prediction against the reference "
        "answers; synonyms and paraphrases count as valid matches. Provide your "
        "evaluation only as a factual accuracy score between 0 and 5, with 5 "
        "indicating the highest factual consistency. "
    ),
    "msvc_detailedness": (
        "Evaluate how completely and specifically the predicted caption covers "
        "the content of the reference captions. Provide your evaluation only as "
        "a detailedness score between 0 and 5, with 5 indicating the highest "
        "level of detail. "
    ),
}

_FORMAT_ASK = (
    "Please generate the response in the form of a Python dictionary string with "
    "keys 'pred' and 'score', where value of 'pred' is  a string of 'yes' or 'no' "
    "and value of 'score' is in INTEGER, not STRING."
    "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide the Python "
    "dictionary string. "
    "For example, your response should look like this: {'pred': 'yes', 'score': 4.8}."
)

# MSVC judges return a score-only dict (reference msvc_correctness.py:71-75)
_FORMAT_ASK_SCORE_ONLY = (
    "Please generate the response in the form of a Python dictionary string with "
    "keys 'score', where its value is the score in INTEGER, not STRING."
    "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide the Python "
    "dictionary string. For example, your response should look like this: "
    "{'score': 4}."
)


def build_judge_messages(question: str, answer: str, pred: str,
                         dimension: str = "generic",
                         question2: str = None, pred2: str = None) -> List[Dict]:
    if dimension == "consistency":
        if question2 is None or pred2 is None:
            raise ValueError(
                "consistency judging needs the paired question2/pred2 "
                "(the protocol compares two answers to similar questions)"
            )
        body = (
            "Please evaluate the following video-based question-answer pairs:\n\n"
            f"Question 1: {question}\n"
            f"Question 2: {question2}\n"
            f"Correct Answer: {answer}\n"
            f"Predicted Answer to Question 1: {pred}\n"
            f"Predicted Answer to Question 2: {pred2}\n\n"
        )
    elif dimension.startswith("msvc_"):
        # multi-reference captioning: answer is a list of human captions
        refs = answer if isinstance(answer, (list, tuple)) else [answer]
        body = (
            "Please evaluate the following video-based question-answer pair:\n\n"
            f"Question: {question}\n"
            f"Correct Answers: {list(refs)}\n"
            f"Predicted Answer: {pred}\n\n"
        )
    else:
        body = (
            "Please evaluate the following video-based question-answer pair:\n\n"
            f"Question: {question}\n"
            f"Correct Answer: {answer}\n"
            f"Predicted Answer: {pred}\n\n"
        )
    fmt = _FORMAT_ASK_SCORE_ONLY if dimension.startswith("msvc_") else _FORMAT_ASK
    user = body + _USER_ASKS[dimension] + fmt
    return [
        {"role": "system", "content": _SYSTEM_PROMPTS[dimension]},
        {"role": "user", "content": user},
    ]


def default_judge_fn(messages: List[Dict], model: Optional[str] = None) -> str:
    """OpenAI/Azure chat call from env config.  Raises a clear error when no
    credentials/network are available (zero-egress environments)."""
    try:
        import openai  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "openai package not installed; pass judge_fn= for offline judging"
        ) from e
    if os.environ.get("AZURE_OPENAI_ENDPOINT"):
        client = openai.AzureOpenAI(
            azure_endpoint=os.environ["AZURE_OPENAI_ENDPOINT"],
            api_key=os.environ.get("AZURE_OPENAI_KEY", ""),
            api_version=os.environ.get("AZURE_OPENAI_API_VERSION", "2024-02-01"),
        )
        model = model or os.environ.get("AZURE_OPENAI_DEPLOYMENT", "gpt-35-turbo")
    else:
        client = openai.OpenAI()
        model = model or "gpt-3.5-turbo"
    completion = client.chat.completions.create(model=model, messages=messages)
    return completion.choices[0].message.content


def parse_judge_response(text: str) -> Dict:
    """'{'pred': 'yes', 'score': 4}' → dict; tolerant of stray text."""
    text = text.strip()
    try:
        out = ast.literal_eval(text)
    except (ValueError, SyntaxError):
        start, end = text.find("{"), text.rfind("}")
        if start < 0 or end < 0:
            raise ValueError(f"unparseable judge response: {text!r}")
        out = ast.literal_eval(text[start : end + 1])
    return {"pred": str(out.get("pred", "no")).lower(), "score": float(out.get("score", 0))}


def judge_predictions(
    predictions: List[Dict],   # each: {id, question, answer, pred}
    output_dir: str,
    dimension: str = "generic",
    judge_fn: Callable = None,
    max_retries: int = 3,
    retry_sleep: float = 1.0,
) -> Dict:
    """Judge every QA pair with per-file caching (reference annotate loop +
    Pool retry behavior).  Returns {mean_score, accuracy, n}."""
    judge_fn = judge_fn or default_judge_fn
    os.makedirs(output_dir, exist_ok=True)
    results = {}
    for qa in predictions:
        key = str(qa["id"])
        cache = os.path.join(output_dir, f"{key}.json")
        if os.path.exists(cache):
            with open(cache) as f:
                results[key] = json.load(f)[0]
            continue
        msg = build_judge_messages(
            qa["question"], qa["answer"], qa["pred"], dimension,
            question2=qa.get("question2"), pred2=qa.get("pred2"),
        )
        verdict = None
        for attempt in range(max_retries):
            try:
                verdict = parse_judge_response(judge_fn(msg))
                break
            except Exception:  # noqa: BLE001
                if attempt == max_retries - 1:
                    raise
                time.sleep(retry_sleep)
        with open(cache, "w") as f:
            json.dump([verdict, qa], f)
        results[key] = verdict
    scores = [r["score"] for r in results.values()]
    yes = sum(1 for r in results.values() if r["pred"].startswith("y"))
    return {
        "mean_score": sum(scores) / len(scores) if scores else 0.0,
        "accuracy": yes / len(results) if results else 0.0,
        "n": len(results),
    }
