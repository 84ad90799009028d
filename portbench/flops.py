"""Model operations of the served work, counted from shapes (2 per
multiply-add): what the work needs, not what the program happens to run
(padding rows and finished decode rows are not counted)."""
from __future__ import annotations


def vit_frame(v) -> int:
    tok = v.patches + 1
    layer = 2 * tok * (4 * v.d * v.d + 2 * v.d * v.ffn) + 2 * 2 * tok * tok * v.d
    return 2 * v.patches * 3 * v.patch ** 2 * v.d + v.run_layers * layer


def mamba_frame(dm) -> int:
    m, d_in, d = dm.mamba, dm.vision.d, dm.text.d
    block = m.d * 2 * m.inner + m.inner * (m.dt_rank + 2 * m.n) + m.dt_rank * m.inner + m.inner * m.d
    return 2 * (d_in * d + m.blocks * block + d * d)


def gate_token(g) -> int:
    """One memory token alone through the gate: its attention is its own
    value, so only v, o and the MLP multiply."""
    return 2 * g.layers * (g.kv_dim * g.d + g.d * g.q_dim + 3 * g.d * g.ffn) + 2 * g.d * g.vocab


def frame(dm) -> int:
    return vit_frame(dm.vision) + mamba_frame(dm) + gate_token(dm.gate)


def _token_static(t) -> int:
    mlp = 3 * t.d * t.ffn * (t.top_k if t.experts > 1 else 1) + (t.d * t.experts if t.experts > 1
                                                                  else 0)
    return 2 * t.layers * (t.d * t.q_dim + 2 * t.d * t.kv_dim + t.q_dim * t.d + mlp)


def tokens(t, offset: int, n: int) -> int:
    """n tokens at positions offset..offset+n-1, each attending to the keys
    up to itself, and one lm_head row (the last position's logits)."""
    keys = n * offset + n * (n + 1) // 2
    return n * _token_static(t) + 2 * 2 * t.layers * t.q_dim * keys + 2 * t.d * t.vocab


def decoded(t, offset: int, n: int) -> int:
    """n decoded tokens from ``offset``: each needs its lm_head row too."""
    return tokens(t, offset, n) + (n - 1) * 2 * t.d * t.vocab if n else 0


def prefill(t, p: dict) -> int:
    return sum(tokens(t, o, n) for o, n in zip(p["offsets"], p["lengths"]))


def decode(t, dec: dict) -> int:
    return sum(decoded(t, o, n) for o, n in zip(dec["offsets"], dec["fed"]))
