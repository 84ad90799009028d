"""Multimodal projectors: Video_Mamba_seq (StreamMind's default), its gate
LM, and the VideoLLaMA2 baselines.

Video_Mamba_seq, per frame: spatial mean-pool 576→1 token, PreNet linear +
leaky-relu, a VideoMamba step with carried state, PostNet leaky-relu +
linear; the gate (ClsNet) is a small Mistral with a 2-token vocabulary, run
on the newest memory token alone; a burst of frames after a stall continues
the carried state in one chunked scan (``mamba_project_chunk``).

The other types project a whole clip (``simple_project``): the STC / STP
connectors and their spatial (depth-0) forms (``models/connectors.py``),
each with an embedded gate LM, and linear / mlpNx_gelu / identity over the
clip's mean over time.  ``project_memory`` dispatches by type;
``projected_token_count`` gives the memory tokens one clip projects to.
Training adds the class-weighted ``gate_loss``.
"""
from __future__ import annotations

import re
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import StreamMindConfig
from ..parallel.partitioning import use_linear
from ..utils.params import linear, torch_linear_init
from . import connectors
from . import mistral as lm
from .mamba import MambaState, init_video_mamba_params, video_mamba_forward, video_mamba_step


def check_mamba_width(cfg: StreamMindConfig) -> None:
    """The Mamba projector runs at the decoder's width (pre_net maps the
    vision features to ``text.hidden_size``, which the Mamba's in_proj
    takes).  Raise ``ValueError`` where ``mamba.d_model`` differs: an
    HF config.json of another width (Qwen2-7B's 3584) gives such a config
    through ``api._load_config``, as in the JAX package, which fails later
    on a shape."""
    if cfg.mm_projector_type == "mamba" and cfg.mamba.d_model != cfg.text.hidden_size:
        raise ValueError(
            f"the Mamba projector's d_model {cfg.mamba.d_model} differs from the decoder's "
            f"hidden_size {cfg.text.hidden_size}; set cfg.mamba.d_model = "
            f"{cfg.text.hidden_size}")


# STC-family type → stc_forward's variant; spatial type → (init, forward)
_CONNECTORS = {
    "stc_connector": "stc", "stp_connector": "stp", "stc_connector_v35": "stc_v35",
}
_SPATIAL = {
    "spatial_conv": (connectors.init_spatial_conv, connectors.spatial_conv_forward),
    "spatial_pool": (connectors.init_spatial_pool, connectors.spatial_pool_forward),
}
_MLP = re.compile(r"^mlp(\d+)x_gelu$")


def init_projector_params(g: torch.Generator, cfg: StreamMindConfig, device="cuda",
                          dtype=torch.float32):
    t = cfg.mm_projector_type
    d_in, d_out = cfg.mm_hidden_size, cfg.text.hidden_size
    kw = dict(device=device, dtype=dtype)
    if t == "mamba":
        check_mamba_width(cfg)
        return {
            "pre_net": torch_linear_init(g, d_out, d_in, **kw),
            "mamba": init_video_mamba_params(g, cfg.mamba, **kw),
            "post_net": torch_linear_init(g, d_out, d_out, **kw),
            "cls_net": lm.init_text_params(g, cfg.gate, **kw),
        }
    if t == "linear":
        return {"proj": torch_linear_init(g, d_out, d_in, **kw)}
    m = _MLP.match(t)
    if m:
        depth = int(m.group(1))
        return {"mlp": [torch_linear_init(g, d_out, d_in if i == 0 else d_out, **kw)
                        for i in range(depth)]}
    if t == "identity":
        return {}
    if t in _CONNECTORS:
        p = connectors.init_stc_connector(g, cfg, variant=_CONNECTORS[t], **kw)
    elif t in _SPATIAL:
        p = _SPATIAL[t][0](g, cfg, **kw)
    else:
        raise ValueError(f"Unknown projector type: {t}")
    # every connector embeds a gate LM, as the reference's do
    p["cls_net"] = lm.init_text_params(g, cfg.gate, **kw)
    return p


def spatial_pool(frames_features: torch.Tensor) -> torch.Tensor:
    """(B, T, N, H) → (B, T, H): each frame's mean over its patch tokens."""
    return frames_features.mean(dim=2)


def mamba_project(params, cfg: StreamMindConfig, frames_features: torch.Tensor,
                  impl: str = "auto") -> Tuple[torch.Tensor, MambaState]:
    """(B, T, N, H) frame features → per-frame memory tokens (B, T, hidden)
    and the final Mamba state.  ``impl`` is the scan's (auto, ref, pallas)."""
    return mamba_project_chunk(params, cfg, frames_features, None, impl)


def mamba_project_chunk(params, cfg: StreamMindConfig, frames_features: torch.Tensor,
                        state: Optional[MambaState],
                        impl: str = "auto") -> Tuple[torch.Tensor, MambaState]:
    """Continue the carried Mamba ``state`` over a burst of T frames (B, T,
    N, H) in one scan: the catch-up path, equal to T single steps (None
    starts a fresh stream).  Returns (B, T, hidden) memory tokens and the
    new state."""
    x = F.leaky_relu(_net(spatial_pool(frames_features), params, "pre_net"),
                     negative_slope=0.01)
    x, state = video_mamba_forward(params["mamba"], cfg.mamba, x, state=state, impl=impl)
    x = _net(F.leaky_relu(x, negative_slope=0.01), params, "post_net")
    return x, state


def _net(x, params, name: str):
    """pre_net / post_net: whole on every rank (fsdp gathered at use)."""
    return linear(x, use_linear(params[name], f"projector.{name}", "full"))


_PROJ_COUNT_MEMO: dict = {}


def projected_token_count(cfg: StreamMindConfig, t: int, n_patches: int) -> int:
    """How many memory tokens one <video> slot of t frames of n_patches
    patches expands to: t for the mamba projector; for the other types the
    token axis of ``simple_project``'s output, found by running it on
    shape-only ("meta") tensors, so the splice plan is sized before any
    device work."""
    ty = cfg.mm_projector_type
    if ty == "mamba":
        return t
    key = (ty, cfg.mm_hidden_size, cfg.text.hidden_size, t, n_patches)
    if key not in _PROJ_COUNT_MEMO:
        params = init_projector_params(torch.Generator(), cfg, device="meta")
        feats = torch.empty((1, t, n_patches, cfg.mm_hidden_size), device="meta")
        _PROJ_COUNT_MEMO[key] = int(simple_project(params, cfg, feats).shape[1])
    return _PROJ_COUNT_MEMO[key]


def project_memory(params, cfg: StreamMindConfig, frames_features: torch.Tensor,
                   impl: str = "auto") -> torch.Tensor:
    """Full-clip projection (B, T, N, H) → (B, M, hidden) memory tokens (M =
    ``projected_token_count``).  For the mamba projector, one token a frame
    and ``impl`` is the scan's: "auto" (differentiable, for training) or
    "pallas" (the scan kernel, for inference); the other types go through
    ``simple_project`` and ignore ``impl``."""
    if cfg.mm_projector_type == "mamba":
        memory, _ = mamba_project(params, cfg, frames_features, impl=impl)
        return memory
    return simple_project(params, cfg, frames_features)


def simple_project(params, cfg: StreamMindConfig, frames_features: torch.Tensor) -> torch.Tensor:
    """Every non-mamba type over (B, T, N, H) frame features: the connectors
    over the whole clip; linear / mlpNx_gelu / identity over its mean over
    time (B, N, H)."""
    t = cfg.mm_projector_type
    if t in _CONNECTORS:
        return connectors.stc_forward(frames_features, params, variant=_CONNECTORS[t])
    if t in _SPATIAL:
        return _SPATIAL[t][1](frames_features, params)
    video_features = frames_features.mean(dim=1)
    if t == "identity":
        return video_features
    if t == "linear":
        return linear(video_features, params["proj"])
    if not _MLP.match(t):
        raise ValueError(f"Unknown projector type: {t}")
    x = linear(video_features, params["mlp"][0])
    for layer in params["mlp"][1:]:
        x = linear(F.gelu(x), layer)
    return x


def mamba_project_step(params, cfg: StreamMindConfig, frame_features: torch.Tensor,
                       state: MambaState) -> Tuple[torch.Tensor, MambaState]:
    """O(1) streaming projection of one frame (B, N, H) → one memory token
    (B, hidden)."""
    x = frame_features.mean(dim=1)
    x = F.leaky_relu(_net(x, params, "pre_net"), negative_slope=0.01)
    x, state = video_mamba_step(params["mamba"], cfg.mamba, x, state)
    x = _net(F.leaky_relu(x, negative_slope=0.01), params, "post_net")
    return x, state


def gate_logits(params, cfg: StreamMindConfig, memory_tokens: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The gate LM over an embedded sequence (B, S, hidden) → (B, S, 2)."""
    logits, _ = lm.text_forward(params["cls_net"], cfg.gate, inputs_embeds=memory_tokens,
                                attn_mask=attn_mask, path="projector.cls_net")
    return logits


def gate_decision_step(params, cfg: StreamMindConfig,
                       memory_token: torch.Tensor) -> torch.Tensor:
    """Streaming gate: the newest memory token (B, hidden) alone through the
    gate LM, logits at the last position → (B, 2)."""
    return gate_logits(params, cfg, memory_token[:, None, :])[:, -1, :]


def gate_loss(logits: torch.Tensor, labels: torch.Tensor,
              class_weights: Tuple[float, float] = (0.15, 0.85)) -> torch.Tensor:
    """Class-weighted causal CE over the 2-way gate vocabulary (B, S, 2):
    shifted by one, IGNORE_INDEX (-100) masked out, normalized by the sum
    of the weights of the counted labels (a weighted mean)."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:].long()
    valid = shift_labels != -100
    safe = torch.where(valid, shift_labels, 0)
    logp = torch.log_softmax(shift_logits, dim=-1)
    picked = logp.gather(-1, safe[..., None])[..., 0]
    w = torch.tensor(class_weights, dtype=torch.float32, device=logits.device)[safe]
    w = torch.where(valid, w, 0.0)
    return -(picked * w).sum() / torch.clamp(w.sum(), min=1e-8)
