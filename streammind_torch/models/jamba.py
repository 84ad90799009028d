"""Jamba's hybrid decoder (AI21's ``JambaForCausalLM``) over the Mistral
family's pieces: Mamba-1 mixers and GQA attention without positional
encoding, dense SwiGLU MLPs and a sparse MoE, each layer's kinds set by
``HybridTextConfig``'s periods and offsets.

The text tree keeps Mixtral's leaf names, each kind's leaves stacked over
the layers of that kind in layer order, so ``quantize_text_params``,
``fuse_text_linears`` and the MoE dispatch read it as they read Mixtral's:

  input_norm, post_norm   (L, d)         every layer (HF input_layernorm,
                                         pre_ff_layernorm)
  q, k, v, o (qkv fused)  (La, ...)      the attention layers
  mamba                   (Lm, ...)      the Mamba mixers: in_proj, conv1d,
                                         x_proj, dt_proj, A_log, D, out_proj
                                         and the RMSNorms dt_norm, b_norm,
                                         c_norm after x_proj
  mlp (gateup fused)      (Ld, ...)      the dense MLP layers
  router, experts         (Le, ...)      the MoE layers

The serving path is the paged one (``streaming/paged.py``): a dialogue's
attention layers keep their keys and values in the page pool and its Mamba
layers their conv window and SSM state in a slot of the recurrent-state
pool.  ``mamba_mixer`` (a prefill's block) and ``mamba_mixer_step`` (a
decode step's token) are the Mamba layer's calls, looked up on this module
at call time.
"""
from __future__ import annotations

import functools

import torch

from ..config import HybridTextConfig, MambaConfig
from ..utils.params import normal_init, ones, stack_layers, tree_map
from . import mamba as mb


@functools.lru_cache(maxsize=None)
def layer_plan(cfg: HybridTextConfig) -> tuple:
    """Per layer: (its mixer, "attention" or "mamba", and its index among
    the layers of that mixer; its MLP, "moe" or "mlp", and its index among
    those)."""
    seen = {"attention": 0, "mamba": 0, "moe": 0, "mlp": 0}
    plan = []
    for i in range(cfg.num_layers):
        mixer = "attention" if cfg.is_attention(i) else "mamba"
        ffn = "moe" if cfg.is_moe(i) else "mlp"
        plan.append((mixer, seen[mixer], ffn, seen[ffn]))
        seen[mixer] += 1
        seen[ffn] += 1
    return tuple(plan)


def layer_counts(cfg: HybridTextConfig) -> dict:
    """How many layers of each kind: attention, mamba, moe, mlp."""
    plan = layer_plan(cfg)
    return {k: sum(k in (p[0], p[2]) for p in plan) for k in ("attention", "mamba", "moe", "mlp")}


@functools.lru_cache(maxsize=None)
def mamba_sizes(cfg: HybridTextConfig) -> MambaConfig:
    return cfg.mamba_config()


_ATTN = ("q", "k", "v", "qkv", "o")


def layer_view(layers: dict, cfg: HybridTextConfig, i: int) -> dict:
    """Layer i's leaves in the layout one Mistral layer has, with its Mamba
    mixer under "mamba" where it has one."""
    mixer, m, ffn, f = layer_plan(cfg)[i]
    lp = {"input_norm": {"weight": layers["input_norm"]["weight"][i]},
          "post_norm": {"weight": layers["post_norm"]["weight"][i]}}
    if mixer == "attention":
        lp.update({k: tree_map(lambda t: t[m], layers[k]) for k in _ATTN if k in layers})
    else:
        lp["mamba"] = tree_map(lambda t: t[m], layers["mamba"])
    if ffn == "moe":
        lp["router"] = {"weight": layers["router"]["weight"][f]}
        lp["experts"] = tree_map(lambda t: t[f], layers["experts"])
    else:
        lp["mlp"] = tree_map(lambda t: t[f], layers["mlp"])
    return lp


def init_hybrid_layers(g: torch.Generator, cfg: HybridTextConfig, kw: dict) -> dict:
    """Random layer leaves in the layout above: Mistral's inits for the
    attention and MLP leaves, mamba_ssm's for the mixers, ones for the
    norms."""
    n = layer_counts(cfg)
    d, F_, E, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts, cfg.num_layers
    layers = {"input_norm": {"weight": ones((L, d), **kw)},
              "post_norm": {"weight": ones((L, d), **kw)}}
    La, Ld, Le = n["attention"], n["mlp"], n["moe"]
    if La:
        for name, out, inp in (("q", cfg.q_dim, d), ("k", cfg.kv_dim, d), ("v", cfg.kv_dim, d),
                               ("o", d, cfg.q_dim)):
            layers[name] = {"weight": normal_init(g, (La, out, inp), **kw)}
    if n["mamba"]:
        mcfg = mamba_sizes(cfg)
        blocks = []
        for _ in range(n["mamba"]):
            bp = mb.init_mamba_block_params(g, mcfg, **kw)
            del bp["norm"]   # the layer's norm is input_norm; the mixer has its inner three
            for name, width in (("dt_norm", mcfg.dt_rank_), ("b_norm", mcfg.d_state),
                                ("c_norm", mcfg.d_state)):
                bp[name] = {"weight": ones((width,), **kw)}
            blocks.append(bp)
        layers["mamba"] = stack_layers(blocks)
    if Ld:
        layers["mlp"] = {name: {"weight": normal_init(g, (Ld, out, inp), **kw)}
                         for name, out, inp in (("gate", F_, d), ("up", F_, d), ("down", d, F_))}
    if Le:
        layers["router"] = {"weight": normal_init(g, (Le, E, d), **kw)}
        layers["experts"] = {"gate": normal_init(g, (Le, E, F_, d), **kw),
                             "up": normal_init(g, (Le, E, F_, d), **kw),
                             "down": normal_init(g, (Le, E, d, F_), **kw)}
    return layers


def mamba_mixer(bp: dict, cfg: MambaConfig, x: torch.Tensor, conv: torch.Tensor,
                ssm: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """A prefill's Mamba layer: K right-padded rows (K, S, d) continue their
    (K, d_inner, d_conv) conv windows and (K, d_inner, d_state) fp32 SSM
    states, through the scan kernel on the card; each row's state at its
    real length (``lengths``) is written back into ``conv`` and ``ssm``.
    Returns the mixer's (K, S, d) output."""
    out, (c, h) = mb._mixer_forward(bp, cfg, x, impl="pallas", conv_state0=conv,
                                    ssm_state0=ssm, lengths=lengths)
    conv.copy_(c)
    ssm.copy_(h)
    return out


def mamba_mixer_step(bp: dict, cfg: MambaConfig, x: torch.Tensor, conv: torch.Tensor,
                     ssm: torch.Tensor) -> torch.Tensor:
    """A decode step's Mamba layer: one token a row (K, d), the rows'
    states advanced in place; returns (K, d)."""
    out, c, h = mb._mixer_step(bp, cfg, x, conv, ssm)
    conv.copy_(c)
    ssm.copy_(h)
    return out
