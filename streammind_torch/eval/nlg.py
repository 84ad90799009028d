"""NLG captioning metrics: BLEU-1..4 (SoccerNet 'closest' ref-length option),
ROUGE-L, CIDEr-D, and a METEOR-lite fallback.

A copy of the JAX package's ``eval/nlg.py``.  Pure-Python implementations
of the published algorithm definitions; when pycocoevalcap is installed,
`calculate_metrics` delegates to it so scores are bit-identical with the
reference scorer (the reference's eval/score_single.py).  METEOR proper
needs the Java jar; the fallback is the unigram harmonic-mean variant with
the standard alpha=0.9/beta=3/gamma=0.5 parameters.
"""
from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


# ---------------------------------------------------------------------------
# BLEU (corpus-level, with 'closest' reference length — SoccerNet convention)
# ---------------------------------------------------------------------------
def bleu(
    references: Dict, hypotheses: Dict, max_n: int = 4, option: str = "closest"
) -> List[float]:
    """Corpus BLEU-1..max_n.  references/hypotheses: {id: [str, ...]}/{id: [str]}."""
    assert references.keys() == hypotheses.keys()
    match = [0] * max_n
    total = [0] * max_n
    hyp_len = 0
    ref_len = 0.0
    for key in references:
        hyp = hypotheses[key][0].split()
        refs = [r.split() for r in references[key]]
        hyp_len += len(hyp)
        if option == "closest":
            ref_len += min((abs(len(r) - len(hyp)), len(r)) for r in refs)[1]
        elif option == "shortest":
            ref_len += min(len(r) for r in refs)
        else:  # average
            ref_len += sum(len(r) for r in refs) / len(refs)
        for n in range(1, max_n + 1):
            hyp_ng = _ngrams(hyp, n)
            max_ref = Counter()
            for r in refs:
                for ng, c in _ngrams(r, n).items():
                    max_ref[ng] = max(max_ref[ng], c)
            match[n - 1] += sum(min(c, max_ref[ng]) for ng, c in hyp_ng.items())
            total[n - 1] += max(len(hyp) - n + 1, 0)

    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    scores = []
    tiny, small = 1e-15, 1e-9  # pycocoevalcap smoothing constants
    logp_sum = 0.0
    for n in range(max_n):
        p_n = (match[n] + tiny) / (total[n] + small)
        logp_sum += math.log(p_n)
        scores.append(bp * math.exp(logp_sum / (n + 1)))
    return scores


# ---------------------------------------------------------------------------
# ROUGE-L (sentence level, beta = 1.2, max over refs, mean over corpus)
# ---------------------------------------------------------------------------
def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_l(references: Dict, hypotheses: Dict, beta: float = 1.2) -> Tuple[float, List[float]]:
    scores = []
    for key in references:
        hyp = hypotheses[key][0].split()
        best = 0.0
        for ref in references[key]:
            r = ref.split()
            lcs = _lcs_len(hyp, r)
            if lcs == 0:
                continue
            prec = lcs / len(hyp) if hyp else 0.0
            rec = lcs / len(r) if r else 0.0
            if prec and rec:
                f = ((1 + beta**2) * prec * rec) / (rec + beta**2 * prec)
                best = max(best, f)
        scores.append(best)
    mean = sum(scores) / len(scores) if scores else 0.0
    return mean, scores


# ---------------------------------------------------------------------------
# CIDEr-D (n=1..4, sigma=6, doc frequencies from the reference corpus)
# ---------------------------------------------------------------------------
def cider(references: Dict, hypotheses: Dict, max_n: int = 4, sigma: float = 6.0):
    doc_freq = [defaultdict(int) for _ in range(max_n)]
    for key in references:
        for n in range(max_n):
            seen = set()
            for ref in references[key]:
                seen.update(_ngrams(ref.split(), n + 1).keys())
            for ng in seen:
                doc_freq[n][ng] += 1
    num_docs = max(len(references), 1)
    log_docs = math.log(num_docs)

    def tfidf_vec(tokens, n):
        counts = _ngrams(tokens, n + 1)
        length = sum(counts.values())
        vec = {}
        norm_sq = 0.0
        for ng, c in counts.items():
            df = math.log(max(doc_freq[n][ng], 1.0))
            w = (c / max(length, 1)) * max(log_docs - df, 0.0)
            vec[ng] = w
            norm_sq += w * w
        return vec, math.sqrt(norm_sq), length

    scores = []
    for key in references:
        hyp_tokens = hypotheses[key][0].split()
        # hypothesis tf-idf depends only on (key, n) — hoist it out of the
        # per-reference loop (it was rebuilt nrefs times per n)
        hyp_vecs = [tfidf_vec(hyp_tokens, n) for n in range(max_n)]
        score_n = [0.0] * max_n
        for ref in references[key]:
            ref_tokens = ref.split()
            delta = len(hyp_tokens) - len(ref_tokens)
            gauss = math.exp(-(delta**2) / (2 * sigma**2))
            for n in range(max_n):
                hv, hnorm, _ = hyp_vecs[n]
                rv, rnorm, _ = tfidf_vec(ref_tokens, n)
                dot = sum(min(hv[ng], rv.get(ng, 0.0)) * rv.get(ng, 0.0) for ng in hv)
                if hnorm and rnorm:
                    score_n[n] += gauss * dot / (hnorm * rnorm)
        nrefs = len(references[key])
        scores.append(10.0 * sum(s / nrefs for s in score_n) / max_n)
    mean = sum(scores) / len(scores) if scores else 0.0
    return mean, scores


# ---------------------------------------------------------------------------
# METEOR-lite (exact-match unigram alignment; alpha=0.9, beta=3, gamma=0.5)
# ---------------------------------------------------------------------------
def meteor_lite(references: Dict, hypotheses: Dict) -> Tuple[float, List[float]]:
    alpha, beta, gamma = 0.9, 3.0, 0.5
    scores = []
    for key in references:
        hyp = hypotheses[key][0].split()
        best = 0.0
        for ref in references[key]:
            r = ref.split()
            # greedy left-to-right exact alignment
            used = [False] * len(r)
            pairs = []
            for i, h in enumerate(hyp):
                for j, t in enumerate(r):
                    if not used[j] and h == t:
                        used[j] = True
                        pairs.append((i, j))
                        break
            m = len(pairs)
            if m == 0:
                continue
            prec = m / len(hyp)
            rec = m / len(r)
            fmean = prec * rec / (alpha * prec + (1 - alpha) * rec)
            # chunks: maximal runs of adjacent aligned pairs
            chunks = 1
            for (i0, j0), (i1, j1) in zip(pairs, pairs[1:]):
                if i1 != i0 + 1 or j1 != j0 + 1:
                    chunks += 1
            penalty = gamma * (chunks / m) ** beta
            best = max(best, fmean * (1 - penalty))
        scores.append(best)
    mean = sum(scores) / len(scores) if scores else 0.0
    return mean, scores


def calculate_metrics(references: Dict, hypotheses: Dict) -> Dict[str, str]:
    """Same output format as the reference scorer (score_single.py:96):
    percentages with 3 decimals."""
    try:  # bit-parity path when the reference's scorer stack is installed
        from pycocoevalcap.bleu.bleu_scorer import BleuScorer
        from pycocoevalcap.meteor.meteor import Meteor
        from pycocoevalcap.rouge.rouge import Rouge
        from pycocoevalcap.cider.cider import Cider
        import numpy as np

        scorer = BleuScorer(n=4)
        for key in references:
            scorer += (hypotheses[key][0], references[key])
        bleu_scores, _ = scorer.compute_score(option="closest", verbose=0)
        meteor_score, _ = Meteor().compute_score(references, hypotheses)
        _, rl = Rouge().compute_score(references, hypotheses)
        rouge_score = float(np.mean(rl))
        cider_score, _ = Cider().compute_score(references, hypotheses)
    except ImportError:
        bleu_scores = bleu(references, hypotheses)
        meteor_score, _ = meteor_lite(references, hypotheses)
        rouge_score, _ = rouge_l(references, hypotheses)
        cider_score, _ = cider(references, hypotheses)
    return {
        "BLEU-1": f"{bleu_scores[0]*100:.3f}",
        "BLEU-4": f"{bleu_scores[3]*100:.3f}",
        "METEOR": f"{meteor_score*100:.3f}",
        "ROUGE-L": f"{rouge_score*100:.3f}",
        "CIDER": f"{cider_score*100:.3f}",
    }
