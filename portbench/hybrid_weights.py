"""A hybrid (Jamba) decoder's weights made on the card from the seed, in
the layout the port serves, beside ``weights.py``'s perception tier.

Each kind of layer's leaves are stacked over the layers of that kind (the
plan of ``reference/jamba.py::dims``): every layer's two norms; the
attention layers' q, k, v, o, the dense MLPs and the expert banks as int4
codes and per-channel scales (``decoder_int4_pc``); the Mamba mixers, the
router, the embeddings and lm_head bfloat16.  As in ``weights.py``, every
normal draw comes from one flat buffer filled by one call of a generator
on the device.
"""
from __future__ import annotations

import math

import torch

import weights as W
from modelcfg import dims
from reference import jamba as rj


def jamba_text(dr: W._Draw, t, int4: bool) -> dict:
    n = t.counts
    L, d, E, F, dev, dt = t.layers, t.d, t.experts, t.ffn, dr.device, dr.dtype
    tree = {"layers": {}, "final_norm": {}, "lm_head": {}}
    dr.n(tree, "embed_tokens", (t.vocab, d), 0.02)
    lay = tree["layers"]
    lay["input_norm"] = {"weight": torch.ones((L, d), device=dev, dtype=dt)}
    lay["post_norm"] = {"weight": torch.ones((L, d), device=dev, dtype=dt)}

    def linear(holder, key, lead, out, inp):
        holder[key] = {}
        if int4:
            scale_std = 0.02 / 4.32  # codes uniform over -7..7 (std 4.32): weights ~0.02
            dr.f(holder[key], "w_int4pc",
                 lambda g, s=(*lead, out, inp // 2): W._int4_codes(g, s, dev))
            dr.f(holder[key], "scale", lambda g, s=(*lead, out): torch.empty(
                s, device=dev).uniform_(0.9 * scale_std, 1.1 * scale_std, generator=g))
        else:
            dr.n(holder[key], "weight", (*lead, out, inp), 0.02)

    La, Ld, Le, Lm = n["attention"], n["mlp"], n["moe"], n["mamba"]
    for name, out, inp in (("q", t.q_dim, d), ("k", t.kv_dim, d), ("v", t.kv_dim, d),
                           ("o", d, t.q_dim)):
        linear(lay, name, (La,), out, inp)
    lay["mlp"] = {}
    for name, out, inp in (("gate", F, d), ("up", F, d), ("down", d, F)):
        linear(lay["mlp"], name, (Ld,), out, inp)
    lay["router"] = {}
    dr.n(lay["router"], "weight", (Le, E, d), 0.02)
    lay["experts"] = {}
    for name, out, inp in (("gate", F, d), ("up", F, d), ("down", d, F)):
        linear(lay["experts"], name, (Le, E), out, inp)

    # the mixers as weights.py draws the projector's (mamba_ssm's init)
    mb = {"in_proj": {}, "out_proj": {}, "conv1d": {}, "x_proj": {}, "dt_proj": {},
          "A_log": torch.log(torch.arange(1, t.n + 1, dtype=torch.float32, device=dev)
                             ).expand(Lm, t.inner, t.n).contiguous(),
          "D": torch.ones((Lm, t.inner), device=dev, dtype=torch.float32),
          "dt_norm": {"weight": torch.ones((Lm, t.dt_rank), device=dev, dtype=dt)},
          "b_norm": {"weight": torch.ones((Lm, t.n), device=dev, dtype=dt)},
          "c_norm": {"weight": torch.ones((Lm, t.n), device=dev, dtype=dt)}}
    dr.n(mb["in_proj"], "weight", (Lm, 2 * t.inner, d), 0.02)
    dr.n(mb["out_proj"], "weight", (Lm, d, t.inner), W._lin_std(t.inner))
    conv_std = math.sqrt(1.0 / t.conv) / math.sqrt(3.0)
    dr.n(mb["conv1d"], "weight", (Lm, t.inner, t.conv), conv_std)
    if t.conv_bias:
        dr.n(mb["conv1d"], "bias", (Lm, t.inner), conv_std)
    dr.n(mb["x_proj"], "weight", (Lm, t.dt_rank + 2 * t.n, t.inner), 0.02)
    dr.n(mb["dt_proj"], "weight", (Lm, t.inner, t.dt_rank), t.dt_rank ** -0.5 / math.sqrt(3.0))

    def dt_bias(g):
        # mamba_ssm's dt init: log-uniform in [1e-3, 1e-1], floored, inverse softplus
        u = torch.rand((Lm, t.inner), device=dev, generator=g)
        step = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        step = torch.clamp(step, min=1e-4)
        return (step + torch.log(-torch.expm1(-step))).to(dt)

    dr.f(mb["dt_proj"], "bias", dt_bias)
    lay["mamba"] = mb
    tree["final_norm"]["weight"] = torch.ones((d,), device=dev, dtype=dt)
    dr.n(tree["lm_head"], "weight", (t.vocab, d), 0.02)
    return tree


def build(config: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The whole StreamMind tree {vision, projector (with cls_net), text}
    over a Jamba decoder, drawn on ``device`` from ``seed``."""
    dm = dims(config)
    g = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    dr = W._Draw(torch.device(device), dtype)
    tree = {"vision": W._vision(dr, dm.vision), "projector": W._projector(dr, dm),
            "text": jamba_text(dr, rj.dims(config), dm.int4_decoder)}
    tree["projector"]["cls_net"] = W._text(dr, dm.gate, False)
    dr.fill(g)
    if not dm.int4_decoder:
        ex = tree["text"]["layers"]["experts"]
        for k in ("gate", "up", "down"):
            ex[k] = ex[k]["weight"]
    return tree
