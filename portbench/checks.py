"""The comparison that decides ``correct`` for the serving cells.

Run once the window has closed and the program's state is freed.

Perception, on the sampled ticks (the run's first tick, from a fresh
stream state, and ticks of the window drawn from the seed): the reference
takes the tick's pixels and the Mamba state the program carried into it,
and works out the ViT features, the memory token and the gate probs again.
Compared: the relative rms error of the features, of the memory tokens, of
the Mamba state the tick hands on and of the gate probs, over the fed
rows.

Cognition, on dialogues drawn from the seed, the one with the most tokens
served in the window among them: the reference runs once over each
dialogue's whole sequence (every turn's prompt as the paged pool holds it,
the program's memory tokens at the spliced positions, and the tokens it
served) and reads, at each position where a token was served in the
window, how far that token's logit lies below its best.  Compared: the
widest such gap.

The control puts the reference at fp8 in the program's place: its
perception numbers, and the gap of the token its logits put first.
"""
from __future__ import annotations

import numpy as np
import torch

from reference import model as ref

VIT_BLOCK = 8   # frames a reference ViT call takes at once


def relrms(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want).norm() / want.norm().clamp(min=1e-30))


def _perceive(tree, dm, cap, rows, prec):
    feats = torch.cat([ref.vit_features(tree["vision"], dm.vision, cap["pixels"][rows[i:i + VIT_BLOCK]],
                                        prec) for i in range(0, len(rows), VIT_BLOCK)])
    mem, _, ssm = ref.mamba_step(tree["projector"], dm.mamba, feats, cap["conv"][:, rows],
                                 cap["ssm"][:, rows], prec)
    probs = ref.gate_probs(tree["projector"]["cls_net"], dm.gate, mem, prec)
    return feats, mem, probs, ssm


def perception(captures, tree, dm, control: bool = False) -> dict:
    """The four perception numbers, the largest over the sampled ticks;
    with ``control`` the fp8 reference's beside the program's."""
    names = ("features_relerr", "memory_relerr", "state_relerr", "probs_relerr")
    out = {n: 0.0 for n in names}
    ctl = {n: 0.0 for n in names}

    def numbers(feats, mem, ssm, probs, want):
        return (relrms(feats, want[0]), relrms(mem, want[1]), relrms(ssm, want[3]),
                relrms(probs, want[2]))

    for cap in captures:
        rows = torch.nonzero(cap["feed"]).flatten()
        want = _perceive(tree, dm, cap, rows, ref.FP32)
        got = numbers(cap["feats"][rows], cap["memory"][rows], cap["ssm_after"][:, rows],
                      cap["probs"][rows], want)
        for n, v in zip(names, got):
            out[n] = max(out[n], v)
        if control:
            c = _perceive(tree, dm, cap, rows, ref.FP8)
            for n, v in zip(names, numbers(c[0], c[1], c[3], c[2], want)):
                ctl[n] = max(ctl[n], v)
        del want
    return (out, ctl) if control else out


def _window_tokens(segment) -> int:
    return sum(len(it["toks"]) for it in segment if it["kind"] == "gen" and it["judged"])


def sample_dialogues(dialogues: dict, n: int, seed: int) -> list:
    """(sid, segment) pairs with tokens served in the window: the one with
    the most, and n - 1 more drawn from the seed."""
    segs = [(sid, s) for sid, ss in sorted(dialogues.items()) for s in ss if _window_tokens(s)]
    if not segs:
        return []
    longest = max(range(len(segs)), key=lambda i: _window_tokens(segs[i][1]))
    rest = [i for i in range(len(segs)) if i != longest]
    rng = np.random.default_rng(seed + 11)
    pick = [longest] + [rest[i] for i in rng.permutation(len(rest))[:max(n - 1, 0)]]
    return [segs[i] for i in pick]


def _sequence(tree, segment, device):
    """A segment's input embeddings (N, d); for each token served in the
    window, the position whose logits chose it and the token; and the
    experts the program took at every position and layer (None for a dense
    decoder)."""
    emb = tree["text"]["embed_tokens"]
    rows, at, toks, routes, pos = [], [], [], [], 0
    for item in segment:
        if item["kind"] == "prefill":
            x = emb[torch.as_tensor(item["ids"].astype(np.int64), device=device)].float()
            x[torch.as_tensor(item["use"], device=device)] = item["mem"].float()
            rows.append(x)
            n = len(item["ids"])
        else:
            gen, n = item["toks"], len(item["toks"])
            if item["judged"]:
                at += list(range(pos - 1, pos - 1 + n))
                toks += gen
            if not gen:
                continue
            rows.append(emb[torch.as_tensor(gen, device=device)].float())
        routes.append(item["routes"])
        pos += n
    moe = all(r is not None for r in routes)
    return (torch.cat(rows), torch.as_tensor(at, device=device),
            torch.as_tensor(toks, device=device), torch.cat(routes, dim=1) if moe else None)


# a route is judged where the reference's router puts at least this much
# probability between its k-th expert and the next: nearer ties flip on rounding
ROUTE_MARGIN = 0.05


def _route_miss(seen) -> tuple:
    """(routes where the experts taken are not the reference router's own
    top k by more than ROUTE_MARGIN, routes) over every layer and position."""
    miss = total = 0
    for own, margin, taken in seen:
        differ = (own.sort(dim=-1).values != taken.sort(dim=-1).values).any(dim=-1)
        miss += int((differ & (margin > ROUTE_MARGIN)).sum())
        total += own.shape[0]
    return miss, total


def cognition(dialogues: dict, tree, dm, n: int, seed: int, device, control: bool = False):
    """The widest logit gap of a served token and, for a MoE decoder, the
    share of routes that part from the reference router's clear choices;
    with ``control`` the same of the fp8 reference put in the program's
    place.  The reference takes the experts the judged side took (routing
    ties flip on any rounding, and a flipped expert parts a random model's
    later tokens by whole logits), and the route share judges the routing
    itself.  Returns (numbers, control numbers, tokens judged)."""
    prog = {"token_gap": 0.0}
    ctl = {"token_gap": 0.0}
    counts = {"prog": [0, 0], "ctl": [0, 0]}
    judged = 0

    def gap(logits, rows, pick):
        return float((logits.max(dim=-1).values - logits[rows, pick]).max())

    for _sid, seg in sample_dialogues(dialogues, n, seed):
        x, at, toks, routes = _sequence(tree, seg, device)
        moe = routes is not None
        rows = torch.arange(len(toks), device=x.device)
        seen = [] if moe else None
        logits = ref.sequence_logits(tree["text"], dm.text, x, at, ref.FP32, routes=routes,
                                     seen=seen)
        prog["token_gap"] = max(prog["token_gap"], gap(logits, rows, toks))
        judged += len(toks)
        if moe:
            counts["prog"] = [a + b for a, b in zip(counts["prog"], _route_miss(seen))]
        if control:
            seen_c = [] if moe else None
            pick = ref.sequence_logits(tree["text"], dm.text, x, at, ref.FP8,
                                       seen=seen_c).argmax(dim=-1)
            if moe:   # judged as the program is: by the reference taking its experts
                seen_r = []
                logits = ref.sequence_logits(tree["text"], dm.text, x, at, ref.FP32,
                                             routes=torch.stack([s[2] for s in seen_c]),
                                             seen=seen_r)
                counts["ctl"] = [a + b for a, b in zip(counts["ctl"], _route_miss(seen_r))]
            ctl["token_gap"] = max(ctl["token_gap"], gap(logits, rows, pick))
        del logits, x
    if counts["prog"][1]:
        prog["route_miss"] = counts["prog"][0] / counts["prog"][1]
        if control:
            ctl["route_miss"] = counts["ctl"][0] / max(counts["ctl"][1], 1)
    return prog, ctl, judged
