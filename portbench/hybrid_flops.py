"""Model operations of a hybrid (Jamba) decoder's served work, counted from
shapes as ``flops.py`` counts a Mistral's (2 per multiply-add, routed
experts only, padding rows and finished decode rows not counted): the
Mamba mixers' products, conv and scan (its state update and read-out), the
attention layers' products and their keys, the dense and the routed MLPs,
the router, and one lm_head row a served token."""
from __future__ import annotations


def _token_static(t) -> int:
    n = t.counts
    attn = t.d * t.q_dim + 2 * t.d * t.kv_dim + t.q_dim * t.d
    mamba = (t.d * 2 * t.inner + t.inner * (t.dt_rank + 2 * t.n) + t.dt_rank * t.inner
             + t.inner * t.d + t.inner * t.conv + 2 * t.inner * t.n)
    mlp = 3 * t.d * t.ffn
    moe = 3 * t.d * t.ffn * t.top_k + t.d * t.experts
    return 2 * (n["attention"] * attn + n["mamba"] * mamba + n["mlp"] * mlp + n["moe"] * moe)


def tokens(t, offset: int, n: int) -> int:
    """n tokens at positions offset..offset+n-1 (each attention layer's
    query to the keys up to itself) and one lm_head row."""
    keys = n * offset + n * (n + 1) // 2
    return (n * _token_static(t) + 2 * 2 * t.counts["attention"] * t.q_dim * keys
            + 2 * t.d * t.vocab)


def decoded(t, offset: int, n: int) -> int:
    return tokens(t, offset, n) + (n - 1) * 2 * t.d * t.vocab if n else 0


def prefill(t, p: dict) -> int:
    return sum(tokens(t, o, n) for o, n in zip(p["offsets"], p["lengths"]))


def decode(t, dec: dict) -> int:
    return sum(decoded(t, o, n) for o, n in zip(dec["offsets"], dec["fed"]))
