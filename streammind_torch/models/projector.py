"""The Video_Mamba_seq projector (StreamMind's default) and its gate LM.

Per frame: spatial mean-pool 576→1 token, PreNet linear + leaky-relu,
a VideoMamba step with carried state, PostNet leaky-relu + linear; the
gate (ClsNet) is a small Mistral with a 2-token vocabulary, run on the
newest memory token alone; a burst of frames after a stall continues the
carried state in one chunked scan (``mamba_project_chunk``).  Only the
``"mamba"`` projector type is ported.
Training adds ``project_memory`` (the whole clip at once) and the
class-weighted ``gate_loss``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import StreamMindConfig
from ..utils.params import linear, torch_linear_init
from . import mistral as lm
from .mamba import MambaState, init_video_mamba_params, video_mamba_forward, video_mamba_step


def init_projector_params(g: torch.Generator, cfg: StreamMindConfig, device="cuda",
                          dtype=torch.float32):
    if cfg.mm_projector_type != "mamba":
        raise NotImplementedError(f"projector type {cfg.mm_projector_type!r} is not ported")
    d_in, d_out = cfg.mm_hidden_size, cfg.text.hidden_size
    kw = dict(device=device, dtype=dtype)
    return {
        "pre_net": torch_linear_init(g, d_out, d_in, **kw),
        "mamba": init_video_mamba_params(g, cfg.mamba, **kw),
        "post_net": torch_linear_init(g, d_out, d_out, **kw),
        "cls_net": lm.init_text_params(g, cfg.gate, **kw),
    }


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
    x = F.leaky_relu(linear(spatial_pool(frames_features), params["pre_net"]),
                     negative_slope=0.01)
    x, state = video_mamba_forward(params["mamba"], cfg.mamba, x, state=state, impl=impl)
    x = linear(F.leaky_relu(x, negative_slope=0.01), params["post_net"])
    return x, state


def project_memory(params, cfg: StreamMindConfig, frames_features: torch.Tensor,
                   impl: str = "auto") -> torch.Tensor:
    """Full-clip projection (B, T, N, H) → (B, T, hidden) memory tokens, one a
    frame.  ``impl`` is the scan's: "auto" (differentiable, for training) or
    "pallas" (the scan kernel, for inference).  Only the mamba projector is
    ported."""
    if cfg.mm_projector_type != "mamba":
        raise NotImplementedError(
            f"projector type {cfg.mm_projector_type!r} is not ported (ROADMAP Queue 1 item 14)")
    memory, _ = mamba_project(params, cfg, frames_features, impl=impl)
    return memory


def mamba_project_step(params, cfg: StreamMindConfig, frame_features: torch.Tensor,
                       state: MambaState) -> Tuple[torch.Tensor, MambaState]:
    """O(1) streaming projection of one frame (B, N, H) → one memory token
    (B, hidden)."""
    x = frame_features.mean(dim=1)
    x = F.leaky_relu(linear(x, params["pre_net"]), negative_slope=0.01)
    x, state = video_mamba_step(params["mamba"], cfg.mamba, x, state)
    x = linear(F.leaky_relu(x, negative_slope=0.01), params["post_net"])
    return x, state


def gate_logits(params, cfg: StreamMindConfig, memory_tokens: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The gate LM over an embedded sequence (B, S, hidden) → (B, S, 2)."""
    logits, _ = lm.text_forward(params["cls_net"], cfg.gate, inputs_embeds=memory_tokens,
                                attn_mask=attn_mask)
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
