"""Per-stream carried state for the perception/cognition split."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import StreamMindConfig
from ..models.mamba import MambaState, init_mamba_state


class StreamState(NamedTuple):
    """Everything a live stream carries between frames.

    mamba:      carried SSM/conv state
    memory:     (1, capacity, hidden) ring of projected memory tokens
                ((S, capacity, hidden) for S batched streams)
    frame_idx:  frames seen (== next write slot while < capacity); an int,
                or (S,) int32 for batched streams
    last_fire:  frame index of the last gate fire (span start); likewise
    """

    mamba: MambaState
    memory: torch.Tensor
    frame_idx: int
    last_fire: int


def init_stream_state(cfg: StreamMindConfig, device="cuda", dtype=torch.float32) -> StreamState:
    return StreamState(
        mamba=init_mamba_state(cfg.mamba, batch=1, device=device),
        memory=torch.zeros((1, cfg.max_stream_frames, cfg.text.hidden_size), dtype=dtype,
                           device=device),
        frame_idx=0,
        last_fire=0,
    )


def init_multistream_state(cfg: StreamMindConfig, n_streams: int, device="cuda",
                           dtype=torch.float32) -> StreamState:
    """Batched state for S concurrent streams (``perceive_step_batch``):
    per-stream memory rings, and frame counters and fire marks as (S,)
    int32 tensors on the device (the ring write reads them there)."""
    return StreamState(
        mamba=init_mamba_state(cfg.mamba, batch=n_streams, device=device),
        memory=torch.zeros((n_streams, cfg.max_stream_frames, cfg.text.hidden_size),
                           dtype=dtype, device=device),
        frame_idx=torch.zeros((n_streams,), dtype=torch.int32, device=device),
        last_fire=torch.zeros((n_streams,), dtype=torch.int32, device=device),
    )
