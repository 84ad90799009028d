"""Training runtime: freeze masks, the optimizer, train and accumulation steps.

The JAX package's trainer in PyTorch, same stages:
  - ``llm``     — train the decoder and the projector, not the gate;
  - ``cls``     — train only the gate (the projector's ``cls_net``);
  - ``adapter`` — ``tune_mm_mlp_adapter``: the projector minus the gate.

The JAX package splits the param tree into trainable and frozen subtrees so
that no decoder-sized gradient is ever built.  Here the split is
``requires_grad``: frozen leaves are set to ``requires_grad=False``
(``apply_trainable``) and gradients are taken only with respect to the
trainable leaves, so the same holds — no frozen-sized gradient exists.  One
step function serves both of the JAX package's variants (whole tree or
split).

The optimizer computes what optax's chain of the JAX package computes:
one global-norm clip over the trainable gradients (``g / norm * max_norm``
when norm >= max_norm, optax's form), then AdamW (b1 0.9, b2 0.999, eps
1e-8, decoupled weight decay) with the projector in a group of its own
learning rate, and zero update for frozen leaves.  The learning rate of a
group is evaluated at that group's pre-increment count, so the first update
of a warm-up schedule has lr 0.  Moments are stored in each param's dtype,
as optax stores them; the update arithmetic is fp32.  Params are updated in
place.
"""
from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, NamedTuple

import torch


class TrainState(NamedTuple):
    step: int
    params: Any
    opt_state: Any


# ---------------------------------------------------------------------------
# Freeze masks
# ---------------------------------------------------------------------------
_GATE_PAT = re.compile(r"projector\.cls_net\.")
_PROJECTOR_PAT = re.compile(r"projector\.")
_VISION_PAT = re.compile(r"vision\.")


def trainable_mask(params, stage: str) -> Any:
    """Bool tree: True == trainable.  The vision tower is always frozen."""

    def decide(path: str) -> bool:
        if _VISION_PAT.match(path):
            return False
        is_gate = bool(_GATE_PAT.match(path))
        is_proj = bool(_PROJECTOR_PAT.match(path))
        if stage == "llm":       # stage 1: everything but the gate
            return not is_gate
        if stage == "cls":       # stage 2: only the gate
            return is_gate
        if stage == "adapter":   # mm-adapter pretrain: projector minus gate
            return is_proj and not is_gate
        raise ValueError(f"unknown stage {stage!r}")

    def build(tree, prefix):
        if isinstance(tree, dict):
            return {k: build(v, prefix + k + ".") for k, v in tree.items()}
        if isinstance(tree, list):
            return [build(v, prefix + str(i) + ".") for i, v in enumerate(tree)]
        return decide(prefix.rstrip("."))

    return build(params, "")


def named_leaves(tree, mask=None, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{dotted path: leaf} of a param tree, only the mask=True leaves when a
    mask is given (dotted paths as ``trainable_mask`` matches them)."""
    out: Dict[str, torch.Tensor] = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        if mask is None or mask:
            out[prefix.rstrip(".")] = tree
        return out
    for k, v in items:
        m = None if mask is None else (mask[k] if isinstance(mask, dict) else mask[int(k)])
        out.update(named_leaves(v, m, prefix + k + "."))
    return out


def apply_trainable(params, mask) -> Dict[str, torch.Tensor]:
    """Mark the trainable leaves ``requires_grad=True`` and every other leaf
    ``False`` (the frozen-subtree split); returns the trainable leaves by path."""
    trainable = named_leaves(params, mask)
    for path, t in named_leaves(params).items():
        t.requires_grad_(path in trainable)
    return trainable


def count_trainable(params, mask) -> int:
    return sum(t.numel() for t in named_leaves(params, mask).values())


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------
def cosine_schedule(peak_lr: float, total_steps: int, warmup_ratio: float = 0.03):
    """optax.warmup_cosine_decay_schedule(0 → peak over max(3 % of the steps,
    1), cosine to 0 over the rest) as a function of the update count."""
    warmup = max(int(total_steps * warmup_ratio), 1)
    decay = max(total_steps, warmup + 1) - warmup

    def schedule(count: int) -> float:
        if count < warmup:
            frac = 1.0 - max(count, 0) / warmup
            return (0.0 - peak_lr) * frac + peak_lr
        c = min(count - warmup, decay)
        return peak_lr * (0.5 * (1.0 + math.cos(math.pi * c / decay)))

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros(())
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


class AdamW:
    """clip_by_global_norm → AdamW per group ("proj" for ``projector.*``
    when ``projector_lr`` is given, else one "base" group).  ``learning_rate``
    and ``projector_lr`` are floats or schedules of the group's count."""

    def __init__(self, learning_rate, projector_lr=None, weight_decay: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 grad_clip: float = 1.0):
        self.lrs = {"base": learning_rate}
        if projector_lr is not None:
            self.lrs["proj"] = projector_lr
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.grad_clip = grad_clip

    def group(self, path: str) -> str:
        return "proj" if "proj" in self.lrs and path.startswith("projector.") else "base"

    def init(self, trainable: Dict[str, torch.Tensor]) -> dict:
        return {"count": {g: 0 for g in self.lrs},
                "mu": {p: torch.zeros_like(t) for p, t in trainable.items()},
                "nu": {p: torch.zeros_like(t) for p, t in trainable.items()}}

    def _lr(self, g: str, count: int) -> float:
        lr = self.lrs[g]
        return float(lr(count) if callable(lr) else lr)

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: dict,
               trainable: Dict[str, torch.Tensor]) -> dict:
        """One step: updates ``trainable`` in place from ``grads`` (same
        keys), returns the new state."""
        norm = global_norm(grads.values()).to(next(iter(grads.values())).device)
        clip = bool(norm >= self.grad_clip)
        counts = dict(state["count"])
        lrs = {g: self._lr(g, c) for g, c in counts.items()}
        for g in counts:
            counts[g] += 1
        mu, nu = dict(state["mu"]), dict(state["nu"])
        for path, p in trainable.items():
            grp = self.group(path)
            g = grads[path].float()
            if clip:
                g = (g / norm) * self.grad_clip
            m = (1 - self.b1) * g + self.b1 * mu[path].float()
            v = (1 - self.b2) * g * g + self.b2 * nu[path].float()
            n = counts[grp]
            m_hat = m / (1 - self.b1 ** n)
            v_hat = v / (1 - self.b2 ** n)
            u = m_hat / (torch.sqrt(v_hat) + self.eps)
            u = u + self.weight_decay * p.float()
            p.copy_((p.float() + (-lrs[grp]) * u).to(p.dtype))
            mu[path], nu[path] = m.to(p.dtype), v.to(p.dtype)
        return {"count": counts, "mu": mu, "nu": nu}


def make_optimizer(learning_rate, projector_lr=None, weight_decay: float = 0.0,
                   b1: float = 0.9, b2: float = 0.999, grad_clip: float = 1.0) -> AdamW:
    """AdamW with one global-norm clip over the trainable grads and an
    optional separate projector learning rate."""
    return AdamW(learning_rate, projector_lr, weight_decay, b1, b2, grad_clip=grad_clip)


def init_train_state(params, optimizer: AdamW, mask) -> TrainState:
    return TrainState(step=0, params=params,
                      opt_state=optimizer.init(apply_trainable(params, mask)))


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------
def make_grad_step(loss_fn: Callable, mask, has_aux: bool = False) -> Callable:
    """loss_fn(params, batch) -> loss, or (loss, aux) with has_aux.  Returns
    grad_step(params, batch) -> ((loss[, aux]), {path: grad}) over the
    trainable leaves only (zeros for a trainable leaf the loss does not
    reach, as jax.grad gives)."""

    def grad_step(params, batch):
        trainable = named_leaves(params, mask)
        out = loss_fn(params, batch)
        loss = out[0] if has_aux else out
        gs = torch.autograd.grad(loss, list(trainable.values()), allow_unused=True)
        grads = {p: torch.zeros_like(t) if g is None else g
                 for (p, t), g in zip(trainable.items(), gs)}
        if has_aux:
            return (loss.detach(), out[1].detach()), grads
        return loss.detach(), grads

    return grad_step


def make_train_step(loss_fn: Callable, optimizer: AdamW, mask) -> Callable:
    """step(state, batch) -> (state, {"loss", "grad_norm"}): one gradient and
    one optimizer update (the JAX package's make_train_step and
    make_split_train_step)."""
    grad_step = make_grad_step(loss_fn, mask)

    def step(state: TrainState, batch):
        loss, grads = grad_step(state.params, batch)
        opt_state = optimizer.update(grads, state.opt_state,
                                     named_leaves(state.params, mask))
        return (TrainState(state.step + 1, state.params, opt_state),
                {"loss": loss, "grad_norm": global_norm(grads.values())})

    return step


def tree_axpy(acc: dict, g: dict, w) -> dict:
    """acc + w·g — weighted grad accumulation, in place on acc."""
    for k in acc:
        acc[k].add_(g[k] * w)
    return acc


def tree_scale(g: dict, w) -> dict:
    """w·g — the first weighted chunk of an accumulation."""
    return {k: v * w for k, v in g.items()}


def make_accum_apply(optimizer: AdamW, mask) -> Callable:
    """apply(state, grad_sum, loss_sum, total_weight) -> (state, metrics):
    divides the weighted grad sum by the total weight and takes ONE
    optimizer step, so accumulation over unequal chunks equals the token
    mean of one combined batch."""

    def apply(state: TrainState, grad_sum, loss_sum, total_weight):
        grads = {k: g / total_weight for k, g in grad_sum.items()}
        opt_state = optimizer.update(grads, state.opt_state,
                                     named_leaves(state.params, mask))
        return (TrainState(state.step + 1, state.params, opt_state),
                {"loss": loss_sum / total_weight, "grad_norm": global_norm(grads.values())})

    return apply
