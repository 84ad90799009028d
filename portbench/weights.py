"""Weights made on the card from the seed, in the layout the port serves.

Every leaf a normal draw takes comes from one flat buffer filled by one
call of a generator on the device, then scaled leaf by leaf; int4 codes
are drawn an (out, in/2) matrix at a time.  The benchmark hands this tree
to the port and to the reference alike; neither makes weights of its own.
"""
from __future__ import annotations

import math

import torch

from modelcfg import dims


def _lin_std(fan_in: int) -> float:
    """The spread of torch.nn.Linear's uniform(±1/sqrt(fan_in)) init."""
    return 1.0 / math.sqrt(3.0 * fan_in)


class _Draw:
    """Collects leaves, then fills them in a few large calls."""

    def __init__(self, device, dtype):
        self.device, self.dtype = device, dtype
        self.normal = []   # (holder, key, shape, std)
        self.other = []    # (holder, key, fn)

    def n(self, holder, key, shape, std):
        self.normal.append((holder, key, tuple(shape), std))

    def f(self, holder, key, fn):
        self.other.append((holder, key, fn))

    def fill(self, g: torch.Generator):
        total = sum(math.prod(s) for _, _, s, _ in self.normal)
        flat = torch.empty(total, device=self.device, dtype=self.dtype).normal_(generator=g)
        off = 0
        for holder, key, shape, std in self.normal:
            n = math.prod(shape)
            holder[key] = flat[off:off + n].view(shape).mul_(std)
            off += n
        for holder, key, fn in self.other:
            holder[key] = fn(g)


def _int4_codes(g: torch.Generator, shape, dev) -> torch.Tensor:
    """Packed int4 codes, both nibbles uniform over -7..7 as the quantizer
    makes them (zero mean), drawn an (out, in/2) matrix at a time."""
    out = torch.empty(shape, device=dev, dtype=torch.int8)
    for part in out.view(-1, *shape[-2:]) if len(shape) > 2 else [out]:
        u = torch.randint(0, 225, part.shape, device=dev, dtype=torch.uint8, generator=g)
        lo = (u % 15).to(torch.int8) - 7
        hi = (u // 15).to(torch.int8) - 7
        part.copy_((lo & 0x0F) | (hi << 4))
    return out


def _text(dr: _Draw, t, int4: bool) -> dict:
    L, d, E, F = t.layers, t.d, t.experts, t.ffn
    dev, dt = dr.device, dr.dtype
    tree = {"layers": {}, "final_norm": {}, "lm_head": {}}
    dr.n(tree, "embed_tokens", (t.vocab, d), 0.02)
    lay = tree["layers"]
    lay["input_norm"] = {"weight": torch.ones((L, d), device=dev, dtype=dt)}
    lay["post_norm"] = {"weight": torch.ones((L, d), device=dev, dtype=dt)}

    def linear(holder, key, lead, out, inp):
        holder[key] = {}
        if int4:
            scale_std = 0.02 / 4.32  # codes uniform over -7..7 (std 4.32): weights ~0.02
            dr.f(holder[key], "w_int4pc", lambda g, s=(*lead, out, inp // 2): _int4_codes(g, s, dev))
            dr.f(holder[key], "scale", lambda g, s=(*lead, out): torch.empty(
                s, device=dev).uniform_(0.9 * scale_std, 1.1 * scale_std, generator=g))
        else:
            dr.n(holder[key], "weight", (*lead, out, inp), 0.02)

    for name, out in (("q", t.q_dim), ("k", t.kv_dim), ("v", t.kv_dim)):
        linear(lay, name, (L,), out, d)
    linear(lay, "o", (L,), d, t.q_dim)
    if E > 1:
        lay["router"] = {}
        dr.n(lay["router"], "weight", (L, E, d), 0.02)
        lay["experts"] = {}
        linear(lay["experts"], "gate", (L, E), F, d)
        linear(lay["experts"], "up", (L, E), F, d)
        linear(lay["experts"], "down", (L, E), d, F)
    else:
        lay["mlp"] = {}
        linear(lay["mlp"], "gate", (L,), F, d)
        linear(lay["mlp"], "up", (L,), F, d)
        linear(lay["mlp"], "down", (L,), d, F)
    tree["final_norm"]["weight"] = torch.ones((d,), device=dev, dtype=dt)
    dr.n(tree["lm_head"], "weight", (t.vocab, d), 0.02)
    return tree


def _vision(dr: _Draw, v) -> dict:
    d, L, F, dev, dt = v.d, v.layers, v.ffn, dr.device, dr.dtype
    pd = 3 * v.patch * v.patch
    tree = {"pre_layernorm": {"weight": torch.ones((d,), device=dev, dtype=dt),
                              "bias": torch.zeros((d,), device=dev, dtype=dt)}, "layers": {}}
    dr.n(tree, "class_embedding", (d,), d ** -0.5)
    dr.n(tree, "patch_embedding", (d, pd), 0.02)
    dr.n(tree, "position_embedding", (v.patches + 1, d), 0.02)
    lay = tree["layers"]
    for ln in ("ln1", "ln2"):
        lay[ln] = {"weight": torch.ones((L, d), device=dev, dtype=dt),
                   "bias": torch.zeros((L, d), device=dev, dtype=dt)}
    for name, out, inp in (("q", d, d), ("k", d, d), ("v", d, d), ("o", d, d), ("fc1", F, d),
                           ("fc2", d, F)):
        lay[name] = {}
        dr.n(lay[name], "weight", (L, out, inp), _lin_std(inp))
        dr.n(lay[name], "bias", (L, out), _lin_std(inp))
    return tree


def _projector(dr: _Draw, dm) -> dict:
    m, dev, dt = dm.mamba, dr.device, dr.dtype
    d_out, d_in = dm.text.d, dm.vision.d
    tree = {"pre_net": {}, "post_net": {}}
    for name, inp in (("pre_net", d_in), ("post_net", d_out)):
        dr.n(tree[name], "weight", (d_out, inp), _lin_std(inp))
        dr.n(tree[name], "bias", (d_out,), _lin_std(inp))
    blocks = []
    for _ in range(m.blocks):
        b = {"in_proj": {}, "out_proj": {}, "conv1d": {}, "x_proj": {}, "dt_proj": {},
             "norm": {"weight": torch.ones((m.d,), device=dev, dtype=dt),
                      "bias": torch.zeros((m.d,), device=dev, dtype=dt)},
             "D": torch.ones((m.inner,), device=dev, dtype=torch.float32),
             "A_log": torch.log(torch.arange(1, m.n + 1, dtype=torch.float32, device=dev)
                                ).expand(m.inner, m.n).contiguous()}
        dr.n(b["in_proj"], "weight", (2 * m.inner, m.d), 0.02)
        dr.n(b["out_proj"], "weight", (m.d, m.inner), _lin_std(m.inner))
        dr.n(b["conv1d"], "weight", (m.inner, m.conv), math.sqrt(1.0 / m.conv) / math.sqrt(3.0))
        if m.conv_bias:
            dr.n(b["conv1d"], "bias", (m.inner,), math.sqrt(1.0 / m.conv) / math.sqrt(3.0))
        dr.n(b["x_proj"], "weight", (m.dt_rank + 2 * m.n, m.inner), 0.02)
        dr.n(b["dt_proj"], "weight", (m.inner, m.dt_rank), m.dt_rank ** -0.5 / math.sqrt(3.0))

        def dt_bias(g, inner=m.inner):
            # mamba_ssm's dt init: log-uniform in [1e-3, 1e-1], floored, inverse softplus
            u = torch.rand((inner,), device=dev, generator=g)
            step = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
            step = torch.clamp(step, min=1e-4)
            return (step + torch.log(-torch.expm1(-step))).to(dt)

        dr.f(b["dt_proj"], "bias", dt_bias)
        blocks.append(b)
    tree["mamba"] = {"blocks": blocks,
                     "final_norm": {"weight": torch.ones((m.d,), device=dev, dtype=dt),
                                    "bias": torch.zeros((m.d,), device=dev, dtype=dt)}}
    return tree


def build(config: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The whole StreamMind tree {vision, projector (with cls_net), text},
    drawn on ``device`` from ``seed``."""
    dm = dims(config)
    g = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    dr = _Draw(torch.device(device), dtype)
    tree = {"vision": _vision(dr, dm.vision), "projector": _projector(dr, dm),
            "text": _text(dr, dm.text, dm.int4_decoder)}
    tree["projector"]["cls_net"] = _text(dr, dm.gate, False)
    dr.fill(g)
    if dm.text.experts > 1 and not dm.int4_decoder:
        ex = tree["text"]["layers"]["experts"]
        for k in ("gate", "up", "down"):
            ex[k] = ex[k]["weight"]
    return tree

