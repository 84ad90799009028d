"""Event-gated cognition: the per-frame perception step and the turn.

Per frame, ``StreamMindEngine.perceive_step`` runs the ViT, one Mamba
projector step, the gate LM on the new memory token, and a write into the
memory ring.  When the gate fires, ``StreamSession._cognify`` builds a
splice plan, prefills the Mistral decoder from a bucketed suffix into the
persistent KV cache, and decodes greedily (or sampled) until EOS, a stop
sequence or the token budget.  After a stall, ``perceive_burst`` catches a
stream up on T frames at once (one ViT batch, one chunked Mamba scan through
the scan kernel).  The engine serves the JAX package's tiers: an int8 or int4
gate (``quantize_gate``), the bf16-attention or int8 ViT (``fast_vision``)
and a decoder quantized by ``utils.quantize.quantize_text_params``.

Many streams: ``perceive_step_batch`` runs one frame of each of S streams
at once, and ``prefill_batch`` / ``generate_from_prefill_batch`` one turn of
each of K fired streams; ``lockstep_decode`` is the batched decode loop of
both KV modes (dense rings here, the page pool in ``streaming/paged.py``).
One-shot callers (``api``, the HTTP worker) stream a turn's tokens with
``decode_stream`` and run beam search with ``beam_generate``.

This package runs eagerly: the decode loops are Python loops with one host
sync per token (or lockstep step), where the JAX package compiles a
while-loop.  Ring and KV cache writes happen in place.

Tensor-parallel serving (``mesh=``): every rank of the mesh builds the same
engine and calls the same methods with the same inputs.  The params are
the rank's shards (``parallel/partitioning.py``), the caches and stream
states it creates hold the rank's kv heads and Mamba channels
(``parallel/serving.py``), and each method runs under the mesh, whose
collectives the layers issue.  Batched state sharded over dp holds the
rank's rows; their outputs are gathered over dp, so every rank returns the
same probs, logits and tokens (the logits are gathered over tp before any
token is sampled on the host).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..config import StreamMindConfig
from ..constants import VIDEO_TOKEN_INDEX
from ..mm_utils import tokenizer_multimodal_token, trim_at_stop_strings
from ..models import mistral as lm
from ..models import projector as proj
from ..models.mamba import MambaState
from ..models.meta import SplicePlan, bucket_length, build_splice_plan, splice_embeds
from ..models.vit import fuse_vit_qkv, vit_forward
from ..parallel import collectives as C
from ..parallel.mesh import axis_size, is_trivial, set_mesh
from ..utils.from_jax import array_to_tensor
from ..utils.params import param_bytes, tree_leaves, tree_map
from ..utils.profiling import tracer
from .logit_filters import (
    sample_first_token,
    sample_first_token_rows,
    sample_token,
    sample_token_rows,
)
from .memory_subsample import subsample_span
from .state import StreamState, init_multistream_state, init_stream_state

DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)
_EMPTY_STOP_IDS = np.zeros((0, 1), np.int32)


def _float_dtype(tree) -> torch.dtype:
    """Working float dtype of a (possibly quantized) tree: the first sub-fp32
    float leaf if any (a quantized tree carries fp32 scales beside bf16
    embeddings), else the first float leaf, else bf16."""
    first = None
    for leaf in tree_leaves(tree):
        if leaf.is_floating_point():
            if first is None:
                first = leaf.dtype
            if leaf.dtype != torch.float32:
                return leaf.dtype
    return first if first is not None else torch.bfloat16


def require_streaming_projector(cfg: StreamMindConfig, what: str) -> None:
    """Streaming perception needs the mamba projector's per-frame step (its
    pre_net, carried Mamba state and gate); raise ``ValueError`` for any
    other type before a frame is taken.  (The JAX package fails later, with
    a KeyError at the first frame.)"""
    if cfg.mm_projector_type != "mamba":
        raise ValueError(f"{what} streams through the mamba projector's per-frame step; "
                         f"mm_projector_type={cfg.mm_projector_type!r} projects whole clips "
                         "only (use api.infer / x_infer)")


def require_attention_decoder(cfg: StreamMindConfig, what: str) -> None:
    """The dense-ring paths hold a KV ring per stream and nothing else;
    raise ``ValueError`` for a hybrid decoder (Jamba), whose Mamba layers'
    state only the paged pool keeps (``MultiStreamServer(kv_mode="paged")``)."""
    if cfg.text.hybrid:
        raise ValueError(f"{what} keeps a dense KV ring a stream; a hybrid decoder's Mamba "
                         "state lives in the paged pool (MultiStreamServer(kv_mode='paged'))")


def top_stable(values: np.ndarray, n: int) -> np.ndarray:
    """``np.argsort(-values, kind="stable")[:n]`` without sorting every
    value: the n-th largest value bounds the set, and only that set is
    sorted (stably, so ties keep index order).  Arrays holding NaN take the
    full sort, whose order for NaN the partition would not keep."""
    if n < values.size and not np.isnan(values).any():
        thr = np.partition(values, values.size - n)[values.size - n]
        idx = np.flatnonzero(values >= thr)
        return idx[np.argsort(-values[idx], kind="stable")[:n]]
    return np.argsort(-values, kind="stable")[:n]


def _on_mesh(method):
    """Run an engine method under the engine's mesh (none: as it is)."""

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        if self.mesh is None:
            return method(self, *args, **kwargs)
        with set_mesh(self.mesh):
            return method(self, *args, **kwargs)

    return wrapper


class StreamMindEngine:
    """Holds the params; many StreamSessions can share one engine."""

    def __init__(
        self,
        params,
        cfg: StreamMindConfig,
        eos_token_id: int = 2,
        prefill_buckets=DEFAULT_BUCKETS,
        kv_capacity: Optional[int] = None,
        attn_impl: str = "auto",
        quantize_gate=False,
        fast_vision=False,
        split_perceive: bool = False,
        device="cuda",
        mesh=None,
    ):
        """params: the JAX package's tree layout, as tensors (moved to
        ``device`` if they lie elsewhere).  The serving tiers, as the JAX
        package's: quantize_gate False/None, True or "int8" (per-channel
        int8 gate, read by the int8 matvec kernel) or "int4" (per-channel
        int4, the int4 kernel); fast_vision False, True (the ViT's attention
        in bf16 where attn_impl is "auto") or "int8" (that, and the int8
        ViT).  A text tree quantized by ``quantize_text_params`` (the
        ``load_8bit`` / ``load_4bit`` transforms) is served as it is.
        split_perceive is taken for the JAX package's signature: there it
        dispatches the one-frame tick as two compiled programs instead of
        one; run eagerly, the tick is the same sequence of operations either
        way, so it changes nothing here.

        mesh: a (dp, fsdp, tp) mesh (``parallel.make_mesh``) — tensor-parallel
        serving.  tp must divide the kv heads and the Mamba d_inner
        (``mesh_fits_inference``, checked first); the tree stays unfused
        (separate q/k/v and gate/up, as the rules name them) and is sharded
        after the tiers' transforms; Mixtral's experts split over tp.  A
        mesh whose every axis has size 1 fuses as no mesh does: its layers
        are the one-device code."""
        self.mesh = mesh
        if mesh is not None:
            from ..parallel.serving import mesh_fits_inference

            if not mesh_fits_inference(mesh, cfg):
                raise ValueError(
                    f"mesh tp={axis_size(mesh, 'tp')} does not divide "
                    f"num_kv_heads={cfg.text.num_kv_heads} / Mamba "
                    f"d_inner={cfg.mamba.d_model * cfg.mamba.expand}")
        if quantize_gate not in (False, None, True, "int8", "int4"):
            raise ValueError(f"quantize_gate must be True/'int8' or 'int4', got {quantize_gate!r}")
        if fast_vision not in (False, None, True, "int8"):
            raise ValueError(f"fast_vision must be False, True or 'int8', got {fast_vision!r}")
        if fast_vision and attn_impl == "auto":
            attn_impl = "bf16"
        self.device = torch.device(device)
        params = tree_map(lambda t: t.to(self.device), params)
        if fast_vision == "int8" and "vision" in params:
            from ..utils.quantize import quantize_vit_params

            params["vision"] = quantize_vit_params(params["vision"])
        if quantize_gate and "cls_net" in params.get("projector", {}):
            from ..utils.quantize import quantize_gate_params

            params["projector"] = dict(params["projector"])
            params["projector"]["cls_net"] = quantize_gate_params(
                params["projector"]["cls_net"], bits=4 if quantize_gate == "int4" else 8)
        if "vision" in params and is_trivial(mesh):
            params["vision"] = fuse_vit_qkv(params["vision"])
        if "text" in params and is_trivial(mesh):
            # q/k/v → qkv (biases too) and gate/up → gateup (Mixtral's
            # expert banks stay as they are); quantized trees (any scheme)
            # always, plain trees only under 2 GiB (a bf16 Mistral-7B stays
            # unfused).  The gate LM (projector.cls_net) is never fused: its
            # single-token shortcut reads only v.
            q_leaf = params["text"].get("layers", {}).get("q", {})
            quantized = isinstance(q_leaf, dict) and bool(
                {"w_int8", "w_int4", "w_int4pc"} & set(q_leaf))
            if quantized or param_bytes(params["text"]) < 2 << 30:
                params["text"] = lm.fuse_text_linears(params["text"])
        if mesh is not None:
            from ..parallel.partitioning import shard_params

            params = shard_params(params, mesh)
        self.params = params
        self.cfg = cfg
        self.eos_token_id = eos_token_id
        self.buckets = tuple(b for b in prefill_buckets if b <= cfg.text.max_position_embeddings)
        self.kv_capacity = kv_capacity or min(cfg.text.max_position_embeddings, 8192)
        self.attn_impl = attn_impl

    # -- perception -------------------------------------------------------
    @torch.no_grad()
    @_on_mesh
    def perceive_step(self, pixels: torch.Tensor, state: StreamState):
        """pixels (1, 3, H, W) → (gate_probs (2,) fp32, new_state).  The
        memory ring of ``state`` is written in place."""
        p, cfg = self.params, self.cfg
        pixels = pixels.to(self.device)
        feats = vit_forward(p["vision"], cfg.vision, pixels, attn_impl=self.attn_impl)
        mem_tok, mamba_state = proj.mamba_project_step(p["projector"], cfg, feats, state.mamba)
        logits = proj.gate_decision_step(p["projector"], cfg, mem_tok)
        gate_probs = torch.softmax(logits[0].float(), dim=-1)
        slot = min(state.frame_idx, cfg.max_stream_frames - 1)
        state.memory[:, slot] = mem_tok.to(state.memory.dtype)
        new_state = StreamState(mamba=mamba_state, memory=state.memory,
                                frame_idx=state.frame_idx + 1, last_fire=state.last_fire)
        return gate_probs, new_state

    @torch.no_grad()
    @_on_mesh
    def perceive_burst(self, pixels: torch.Tensor, state: StreamState):
        """Catch-up after a stall: a burst of T frames (T, 3, H, W) of one
        stream at once, equal to T perceive_steps — one ViT batch, one
        chunked Mamba scan through the scan kernel (``mamba_project_chunk``,
        impl="pallas"), the gate on the last memory token.  Frame j goes to
        ring slot min(frame_idx + j, M - 1), as the steps would put it (the
        last frame wins the clamped slot); the ring is written in place.
        Returns (the last frame's gate_probs (2,) fp32, new_state)."""
        p, cfg = self.params, self.cfg
        pixels = pixels.to(self.device)
        t = pixels.shape[0]
        feats = vit_forward(p["vision"], cfg.vision, pixels, attn_impl=self.attn_impl)
        mem_toks, mamba_state = proj.mamba_project_chunk(p["projector"], cfg, feats[None],
                                                         state.mamba, impl="pallas")
        logits = proj.gate_decision_step(p["projector"], cfg, mem_toks[:, -1])
        gate_probs = torch.softmax(logits[0].float(), dim=-1)
        last_slot = cfg.max_stream_frames - 1
        n_free = max(0, min(t, last_slot - state.frame_idx))
        mem = mem_toks.to(state.memory.dtype)
        state.memory[:, state.frame_idx:state.frame_idx + n_free] = mem[:, :n_free]
        if n_free < t:
            state.memory[:, last_slot] = mem[:, -1]
        new_state = StreamState(mamba=mamba_state, memory=state.memory,
                                frame_idx=state.frame_idx + t, last_fire=state.last_fire)
        return gate_probs, new_state

    # -- cognition --------------------------------------------------------
    @torch.no_grad()
    @_on_mesh
    def prefill(self, plan: SplicePlan, memory: torch.Tensor, cache: lm.KVCache):
        """Bucketed prefill of one right-padded suffix into ``cache`` (in
        place).  Returns (next-token logits (1, V) fp32, cache advanced by
        the plan's real length)."""
        dev = self.device

        def t(a):
            return torch.as_tensor(a, device=dev)[None]

        embeds = splice_embeds(self.params["text"], t(plan.token_ids), t(plan.mem_index),
                               t(plan.use_mem), memory)
        real_len = torch.full((1,), plan.length, dtype=torch.int32, device=dev)
        logits, cache = lm.text_forward(self.params["text"], self.cfg.text,
                                        inputs_embeds=embeds, cache=cache,
                                        cache_advance=real_len)
        return logits[:, max(plan.length - 1, 0), :], cache

    @torch.no_grad()
    @_on_mesh
    def generate_from_prefill(
        self,
        last_logits: torch.Tensor,
        cache: lm.KVCache,
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 0.0,
        generator: Optional[torch.Generator] = None,
        stop_ids=None,
    ):
        """Decode after a prefill, greedy or sampled.  stop_ids: optional
        (S, L) matrix of stop sequences left-padded with -1 (stop_id_matrix).
        Returns (token_list, cache).  The token buffer, the stop match and
        the returned count follow the JAX package's compiled loop: a
        stop-terminating token is returned, EOS is not, and an EOS first
        token returns []."""
        eos = self.eos_token_id
        first = sample_first_token(generator, last_logits[0], temperature, top_k, top_p)
        if first == eos:
            return [], cache
        stop = np.asarray(_EMPTY_STOP_IDS if stop_ids is None else stop_ids, np.int32)
        width = stop.shape[1]

        def stop_hit(tail):
            return bool(np.any(np.all((stop == np.asarray(tail)[None, :]) | (stop < 0), axis=1)))

        buf = [eos] * max_new_tokens
        buf[0] = first
        tail = [-2] * (width - 1) + [first]
        done = stop_hit(tail)
        i, tok = 0, first
        while i < max_new_tokens and not done:
            nxt, cache = self._decode_step(tok, cache, temperature, top_k, top_p, generator)
            if i + 1 < max_new_tokens:
                buf[i + 1] = nxt
            tail = tail[1:] + [nxt]
            done = nxt == eos or stop_hit(tail)
            i, tok = i + 1, nxt
        # iterations fed = i; a stop hit's final token is buffered but unfed
        n = min(i + int(done and tok != eos), max_new_tokens)
        return buf[:n], cache

    @_on_mesh
    def _decode_step(self, tok: int, cache: lm.KVCache, temperature, top_k, top_p, generator):
        """Feed one token; returns (the next token, the cache advanced by 1)."""
        ids = torch.tensor([[tok]], dtype=torch.long, device=self.device)
        logits, cache = lm.text_forward(self.params["text"], self.cfg.text, input_ids=ids,
                                        cache=cache)
        return sample_token(generator, logits[0, -1], temperature, top_k, top_p), cache

    @torch.no_grad()
    def decode_stream(self, last_logits: torch.Tensor, cache: lm.KVCache,
                      max_new_tokens: int = 256, temperature: float = 0.0, top_k: int = 0,
                      top_p: float = 0.0, generator: Optional[torch.Generator] = None):
        """Generator of token ids, one a decode step, for token-streaming
        callers (the HTTP worker).  Yields the tokens ``generate_from_prefill``
        returns when no stop ids are given: up to EOS (not yielded) or
        max_new_tokens.  The cache is consumed (written in place); callers
        that need it afterwards use generate_from_prefill.  Unlike the JAX
        package's, it runs no decode step past the last token it yields."""
        tok = sample_first_token(generator, last_logits[0], temperature, top_k, top_p)
        for i in range(max_new_tokens):
            if tok == self.eos_token_id:
                return
            yield tok
            if i + 1 < max_new_tokens:
                tok, cache = self._decode_step(tok, cache, temperature, top_k, top_p, generator)

    @torch.no_grad()
    @_on_mesh
    def beam_generate(self, plan: SplicePlan, memory: torch.Tensor, num_beams: int = 5,
                      max_new_tokens: int = 128, num_return_sequences: Optional[int] = None,
                      length_penalty: float = 1.0, kv_dtype: Optional[torch.dtype] = None):
        """Beam search (HF ``generate(num_beams=K)``, the Ego4D-LTA eval's
        decoding).  Prefills once into a right-sized cache, tiles K/V and
        length across the beams, steps all beams as one batch and reorders
        the cache rows with index_select.  The bookkeeping runs on the host
        in numpy, as the JAX package's does, so the beam lists and their
        order are the same: the top 2K of the flattened candidates, a
        finished beam proposing only EOS at its frozen score, and the
        length penalty on finished sequences.  One difference: candidates
        that tie are taken lowest index first (a stable sort), the rule of
        the greedy argmax, so one beam is greedy decoding also where bf16
        logits tie (the JAX package's unstable sort may take either); the
        top 2K come from a partition and a sort of that few
        (``top_stable``), where the JAX package sorts all K x vocab.
        Returns up to num_return_sequences (token_list, score) pairs, best
        first."""
        n_ret = num_return_sequences or num_beams
        if kv_dtype is None:
            kv_dtype = _float_dtype(self.params["text"])
        cap = self.cache_capacity_for(len(plan.token_ids), max_new_tokens)
        last, cache1 = self.prefill(plan, memory, self.new_kv_cache(dtype=kv_dtype, capacity=cap))
        logp0 = torch.log_softmax(last[0].float(), dim=-1).cpu().numpy()

        K = num_beams
        cache = lm.KVCache(k=cache1.k.repeat_interleave(K, dim=1),
                           v=cache1.v.repeat_interleave(K, dim=1),
                           length=cache1.length.repeat_interleave(K))
        del cache1
        top = top_stable(logp0, K)
        scores = logp0[top]
        seqs = [[int(t)] for t in top]
        done = [int(t) == self.eos_token_id for t in top]
        eos = self.eos_token_id
        finished: list = [
            ([t for t in s if t != eos], sc) for s, sc, d in zip(seqs, scores, done) if d
        ]
        toks = [s[-1] for s in seqs]

        for _ in range(max_new_tokens - 1):
            if all(done):
                break
            ids = torch.tensor(toks, dtype=torch.long, device=self.device)[:, None]
            logits, cache = lm.text_forward(self.params["text"], self.cfg.text, input_ids=ids,
                                            cache=cache)
            logp = torch.log_softmax(logits[:, -1].float(), dim=-1).cpu().numpy()
            # finished beams only propose repeating eos at their frozen score
            cand = scores[:, None] + logp
            for i, d in enumerate(done):
                if d:
                    cand[i, :] = -np.inf
                    cand[i, eos] = scores[i]
            flat = top_stable(cand.ravel(), 2 * K)
            new_seqs, new_scores, new_done, reorder = [], [], [], []
            for f in flat:
                if len(new_seqs) == K:
                    break
                b, t = divmod(int(f), cand.shape[1])
                seq = seqs[b] + ([] if done[b] else [t])
                if t == eos and not done[b]:
                    norm = cand[b, t] / (max(len(seq) - 1, 1) ** length_penalty)
                    finished.append(([x for x in seq if x != eos], norm))
                    continue
                new_seqs.append(seq)
                new_scores.append(cand[b, t])
                new_done.append(done[b])
                reorder.append(b)
            if not new_seqs:
                break
            seqs, scores, done = new_seqs, np.asarray(new_scores), new_done
            idx = torch.tensor(reorder, dtype=torch.long, device=self.device)
            cache = lm.KVCache(k=cache.k.index_select(1, idx), v=cache.v.index_select(1, idx),
                               length=cache.length.index_select(0, idx))
            toks = [s[-1] for s in seqs]

        for s, sc, d in zip(seqs, scores, done):
            if d:
                continue  # already in `finished` from its eos step
            finished.append(([x for x in s if x != eos],
                             float(sc) / (max(len(s), 1) ** length_penalty)))
        finished.sort(key=lambda p: -p[1])
        return finished[:n_ret]

    CACHE_CAPACITY_LADDER = (256, 512, 1024, 2048, 4096, 8192)

    def cache_capacity_for(self, n_prompt_padded: int, max_new: int) -> int:
        """Smallest ladder capacity holding a one-shot turn (padded prefill
        bucket + decode budget); decode attention reads the whole ring."""
        need = n_prompt_padded + max_new
        for c in self.CACHE_CAPACITY_LADDER:
            if need <= c <= self.kv_capacity:
                return c
        return self.kv_capacity

    def new_kv_cache(self, dtype=None, capacity: Optional[int] = None) -> lm.KVCache:
        """dtype None → the decoder weights' working dtype.  Under a mesh the
        cache holds this rank's kv heads (``kv_cache_specs``)."""
        if dtype is None:
            dtype = _float_dtype(self.params["text"])
        text = self.cfg.text
        if self.mesh is not None:
            text = dataclasses.replace(
                text, num_kv_heads=text.num_kv_heads // axis_size(self.mesh, "tp"))
        return lm.init_kv_cache(text, batch=1, capacity=capacity or self.kv_capacity,
                                dtype=dtype, device=self.device)

    def new_stream_state(self, n_streams: Optional[int] = None) -> StreamState:
        """Fresh perception state: one stream, or S batched streams.  Under a
        mesh it holds this rank's Mamba channels and, where dp divides S,
        its streams (``stream_state_specs``)."""
        if n_streams is None:
            state = init_stream_state(self.cfg, device=self.device)
        else:
            state = init_multistream_state(self.cfg, n_streams, device=self.device)
        if self.mesh is None:
            return state
        from ..parallel.serving import shard_stream_state

        dp = axis_size(self.mesh, "dp")
        axis = "dp" if (n_streams and dp > 1 and n_streams % dp == 0) else None
        return shard_stream_state(state, self.mesh, stream_axis=axis)

    def _dp_rows(self, n_global: int, n_local: int):
        """The rows of n_global this rank holds where its state holds
        n_local of them (dp-sharded), else None."""
        if self.mesh is None or n_local == n_global:
            return None
        return C.axis_rows(n_global, self.mesh, "dp")

    # -- batched perception and cognition (multi-stream serving) ----------
    @torch.no_grad()
    @_on_mesh
    def perceive_step_batch(self, pixels: torch.Tensor, state: StreamState,
                            feed_mask: Optional[torch.Tensor] = None):
        """One frame for each of S streams (state from new_stream_state(S)).
        feed_mask (S,) bool: unfed rows keep their conv/ssm state, ring and
        frame counter.  Returns (gate_probs (S, 2) fp32, new_state); the
        ring is written in place, one row per fed stream."""
        p, cfg = self.params, self.cfg
        pixels = pixels.to(self.device)
        if feed_mask is None:
            feed_mask = torch.ones((pixels.shape[0],), dtype=torch.bool, device=self.device)
        feed_mask = torch.as_tensor(feed_mask, device=self.device)
        rows = self._dp_rows(pixels.shape[0], state.memory.shape[0])
        if rows is not None:  # this rank's streams; the probs gathered over dp
            probs, state = self.perceive_step_batch(pixels[rows], state, feed_mask[rows])
            return C.all_gather_rows(probs, self.mesh, "dp"), state
        s = pixels.shape[0]
        with tracer.span("engine.perceive", rows=s):
            with tracer.span("engine.vit"):
                feats = vit_forward(p["vision"], cfg.vision, pixels, attn_impl=self.attn_impl)
            with tracer.span("engine.mamba"):
                mem_tok, mamba_state = proj.mamba_project_step(p["projector"], cfg, feats,
                                                               state.mamba)
            with tracer.span("engine.gate"):
                logits = proj.gate_decision_step(p["projector"], cfg, mem_tok)
                gate_probs = torch.softmax(logits.float(), dim=-1)
            rows = torch.arange(s, device=self.device)
            slots = torch.clamp(state.frame_idx.long(), max=cfg.max_stream_frames - 1)
            cur = state.memory[rows, slots]
            state.memory[rows, slots] = torch.where(feed_mask[:, None],
                                                    mem_tok.to(state.memory.dtype), cur)
            fed = feed_mask[None, :, None, None]
            mamba_state = MambaState(conv=torch.where(fed, mamba_state.conv, state.mamba.conv),
                                     ssm=torch.where(fed, mamba_state.ssm, state.mamba.ssm))
        new_state = StreamState(mamba=mamba_state, memory=state.memory,
                                frame_idx=state.frame_idx + feed_mask.to(torch.int32),
                                last_fire=state.last_fire)
        return gate_probs, new_state

    @torch.no_grad()
    @_on_mesh
    def prefill_batch(self, plans, memory: torch.Tensor, cache: lm.KVCache):
        """Batched prefill of K turns padded to one shared bucket into a
        batch-K cache (in place).  memory (K, M, D).  Returns ((K, V)
        last logits, cache with each row advanced by its plan's length)."""
        dev = self.device
        rows = self._dp_rows(len(plans), cache.k.shape[1])
        if rows is not None:  # this rank's turns; the logits gathered over dp
            last, cache = self.prefill_batch(plans[rows], memory[rows], cache)
            return C.all_gather_rows(last, self.mesh, "dp"), cache

        def t(key):
            return torch.as_tensor(np.stack([getattr(pl, key) for pl in plans]), device=dev)

        embeds = splice_embeds(self.params["text"], t("token_ids"), t("mem_index"),
                               t("use_mem"), memory)
        real_len = torch.tensor([pl.length for pl in plans], dtype=torch.int32, device=dev)
        logits, cache = lm.text_forward(self.params["text"], self.cfg.text,
                                        inputs_embeds=embeds, cache=cache,
                                        cache_advance=real_len)
        last = torch.clamp(real_len.long() - 1, min=0)
        return logits[torch.arange(len(plans), device=dev), last], cache

    @torch.no_grad()
    @_on_mesh
    def generate_from_prefill_batch(self, last_logits: torch.Tensor, cache: lm.KVCache,
                                    max_new_tokens, active=None, temperature=0.0, top_k=0,
                                    top_p=0.0, generator: Optional[torch.Generator] = None,
                                    stop_ids=None):
        """Lockstep decode of K rows after prefill_batch: per-row limits
        (an int or K ints), ``active`` (K,) bools (False rows are padding
        and never advance), per-row knobs and stop matrices ((S, L) shared
        or (K, S, L) from stack_stop_ids).  Returns (K token lists,
        lockstep steps run, cache)."""
        K = last_logits.shape[0]
        limits = ([max_new_tokens] * K if isinstance(max_new_tokens, int)
                  else list(max_new_tokens))
        knobs = (_knob_rows(temperature, K), _knob_rows(top_k, K), _knob_rows(top_p, K))
        first = sample_first_token_rows(generator, last_logits, *knobs)
        rows = self._dp_rows(K, cache.k.shape[1]) or slice(0, K)

        def step(toks, advance):
            nonlocal cache
            ids = torch.tensor(toks[rows], dtype=torch.long, device=self.device)[:, None]
            adv = torch.tensor(advance[rows], dtype=torch.int32, device=self.device)
            logits, cache = lm.text_forward(self.params["text"], self.cfg.text, input_ids=ids,
                                            cache=cache, cache_advance=adv)
            return C.all_gather_rows(logits[:, -1], self.mesh, "dp")

        buf, steps = lockstep_decode(step, first, limits, self.eos_token_id, knobs, generator,
                                     stop_ids, active)
        return [tokens_until_eos(r, self.eos_token_id) for r in buf], steps, cache


def _knob_rows(v, K: int) -> list:
    """Scalar-or-list sampling knob → K per-row values (host list)."""
    if isinstance(v, (int, float)):
        return [v] * K
    vals = list(v)
    if len(vals) != K:
        raise ValueError(f"{len(vals)} sampling-knob rows for K={K}")
    return vals


def _stop_hit(per_row: np.ndarray, tail: np.ndarray) -> np.ndarray:
    """per_row (K or 1, S, L) stop matrices, tail (K, L) → (K,) bool.  All-(-1)
    padding rows of a ragged per-row stack never match."""
    concrete = np.any(per_row >= 0, axis=-1)
    hit = np.all((per_row == tail[:, None, :]) | (per_row < 0), axis=-1)
    return np.any(hit & concrete, axis=-1)


def lockstep_decode(step, first: list, limits: list, eos: int, knobs, generator, stop_ids=None,
                    active=None):
    """The batched decode loop of the dense and the paged cognition paths.

    ``step(toks, advance)`` feeds K tokens (host ints), advances row r's
    cache length by advance[r] (0 for finished rows, which keep writing at
    their frozen length) and returns the (K, V) logits.  Per row: a limit
    (rows stop at their own), a done flag (EOS, a stop sequence, the
    limit, or inactive padding), and a buffer that is EOS-filled past the
    generated prefix, with column 0 the first token and sampled tokens
    written as they come, so a stop-terminating token stays visible.
    Returns (buf (K, max_new) int32, lockstep steps run)."""
    K = len(first)
    max_new = max(max(limits), 1)
    stop = np.asarray(_EMPTY_STOP_IDS if stop_ids is None else stop_ids, np.int32)
    per_row = stop if stop.ndim == 3 else stop[None]
    first = np.asarray(first, np.int64)
    lim = np.asarray(limits)
    done = lim <= 0
    if active is not None:
        done |= ~np.asarray(active, bool)
    done |= first == eos
    buf = np.full((K, max_new), eos, np.int32)
    buf[:, 0] = np.where(done, eos, first)
    tail = np.full((K, per_row.shape[-1]), -2, np.int64)
    tail[:, -1] = np.where(done, -2, first)
    done |= _stop_hit(per_row, tail)
    i, toks = 0, first
    while i < max_new and not done.all():
        logits = step(toks.tolist(), np.where(done, 0, 1).tolist())
        with tracer.span("decode.sample"):
            nxt = np.asarray(sample_token_rows(generator, logits, *knobs), np.int64)
        limit_hit = i + 1 >= lim
        nxt = np.where(done | limit_hit, eos, nxt)
        tail = np.concatenate([tail[:, 1:], nxt[:, None]], axis=1)
        if i + 1 < max_new:
            buf[:, i + 1] = nxt
        done = done | (nxt == eos) | _stop_hit(per_row, tail) | limit_hit
        i, toks = i + 1, nxt
    return buf, i


def tokens_until_eos(row, eos_id: int) -> list:
    """Decode-buffer row → the generated tokens (rows are EOS-filled past
    the generated prefix)."""
    toks = []
    for t in row:
        if int(t) == eos_id:
            break
        toks.append(int(t))
    return toks


def stack_kv_caches(caches) -> lm.KVCache:
    """Per-stream batch-1 caches → one batch-K cache (a copy)."""
    return lm.KVCache(k=torch.cat([c.k for c in caches], dim=1),
                      v=torch.cat([c.v for c in caches], dim=1),
                      length=torch.cat([c.length for c in caches]))


def split_kv_cache(cache: lm.KVCache, rows: int) -> list:
    """A batch-K cache → K batch-1 caches (views of its rows)."""
    return [lm.KVCache(k=cache.k[:, i:i + 1], v=cache.v[:, i:i + 1],
                       length=cache.length[i:i + 1]) for i in range(rows)]


def stack_stop_ids(mats):
    """Per-row stop matrices for the batched decode: K Optional (S_i, L_i)
    matrices → (K, S, L), ragged slots padded with all-(-1) rows (which
    never match), so a row halts only on its OWN stop sequences.  None if
    every input is None."""
    if all(m is None for m in mats):
        return None
    S = max(m.shape[0] for m in mats if m is not None) or 1
    L = max(m.shape[1] for m in mats if m is not None) or 1
    out = np.full((len(mats), S, L), -1, np.int32)
    for i, m in enumerate(mats):
        if m is not None:
            out[i, : m.shape[0], L - m.shape[1]:] = m
    return out


def merge_stop_ids(mats):
    """Union of stop matrices (one matcher shared by every row), padded to
    a common width, rows deduplicated.  None if all inputs are."""
    mats = [m for m in mats if m is not None]
    if not mats:
        return None
    width = max(m.shape[1] for m in mats)
    rows = [np.concatenate([np.full((m.shape[0], width - m.shape[1]), -1, np.int32), m], axis=1)
            for m in mats]
    return np.unique(np.concatenate(rows, axis=0), axis=0)


def stop_id_matrix(tokenizer, stop_strings) -> Optional[np.ndarray]:
    """Encode stop strings into the (S, L) left-padded (-1) matrix the decode
    loop matches against; each string bare and with a leading space."""
    seqs: list = []
    for s in stop_strings or []:
        for variant in (s, " " + s):
            ids = _encode_no_bos(tokenizer, variant)
            if ids and ids not in seqs:
                seqs.append(ids)
    if not seqs:
        return None
    width = max(len(x) for x in seqs)
    mat = np.full((len(seqs), width), -1, np.int32)
    for r, x in enumerate(seqs):
        mat[r, width - len(x):] = x
    return mat


def _encode_no_bos(tokenizer, text: str) -> list:
    ids = tokenizer(text).input_ids
    bos = getattr(tokenizer, "bos_token_id", None)
    if bos is not None and ids and ids[0] == bos:
        ids = ids[1:]
    return ids


_TURN_SCAFFOLD = 16  # "[INST] <video>\n [/INST]" worst case


def turn_bucket(engine, n_pending: int, span_len: int, min_bucket: int = 0) -> int:
    """The prefill bucket a turn with this pending/span size will pick."""
    n_spliced = n_pending + _TURN_SCAFFOLD + span_len
    return max(bucket_length(min(n_spliced, engine.buckets[-1]), engine.buckets), min_bucket)


def ensure_turn_capacity(engine: StreamMindEngine, tokenizer, pending_ids: list, turns: list,
                         cache, span_len: int, max_new_tokens: int, min_bucket: int = 0):
    """KV-capacity guard: prefill writes the whole padded bucket, so the
    budget counts that bucket plus the decode tokens.  On overflow: a fresh
    cache, with recent turns re-carried as text (pending is REPLACED)."""
    bucket = turn_bucket(engine, len(pending_ids), span_len, min_bucket)
    if int(cache.length[0]) + bucket + max_new_tokens <= engine.kv_capacity:
        return pending_ids, cache
    new_pending = rebuild_history_pending(engine, tokenizer, turns, pending_ids, span_len,
                                          max_new_tokens, min_bucket=min_bucket)
    return new_pending, engine.new_kv_cache()


def rebuild_history_pending(engine, tokenizer, turns: list, pending_ids: list, span_len: int,
                            max_new_tokens: int, min_bucket: int = 0,
                            capacity: Optional[int] = None) -> list:
    """The pending suffix for a FRESH cache of ``capacity`` tokens: recent
    turns re-carried as text, trimmed until bucket + decode budget fit."""
    if capacity is None:
        capacity = engine.kv_capacity
    keep = min(capacity // 2,
               max(engine.buckets) - span_len - _TURN_SCAFFOLD - max_new_tokens)
    history: list = []
    for turn in turns[::-1]:
        ids = _encode_no_bos(tokenizer, f" {turn} </s>")
        if len(history) + len(ids) > keep:
            break
        history = ids + history

    def fits(hist):
        n = len(hist) + _TURN_SCAFFOLD + span_len
        b = max(bucket_length(min(n, engine.buckets[-1]), engine.buckets), min_bucket)
        return b + max_new_tokens <= capacity and n <= engine.buckets[-1]

    while history and not fits(history):
        history = history[max(len(history) // 4, 1):]
    if not fits(history):
        history = []
    return history if turns else pending_ids


def turn_suffix_ids(tokenizer, pending_ids: list) -> list:
    """Pending dialogue ids plus the "[INST] <video>\\n [/INST]" scaffold if
    no modal slot is pending."""
    if pending_ids and VIDEO_TOKEN_INDEX in pending_ids:
        return pending_ids
    turn_ids = tokenizer_multimodal_token("[INST] <video>\n [/INST]", tokenizer,
                                          VIDEO_TOKEN_INDEX)
    bos = getattr(tokenizer, "bos_token_id", None)
    if bos is not None and turn_ids and turn_ids[0] == bos:
        turn_ids = turn_ids[1:]
    return pending_ids + turn_ids


def build_turn_plan(engine: StreamMindEngine, tokenizer, span: list, pending_ids: list,
                    pad_to: Optional[int] = None) -> SplicePlan:
    """The splice plan of one cognition turn (span = absolute ring slots)."""
    suffix_ids = turn_suffix_ids(tokenizer, pending_ids)
    if pad_to is None:
        pad_to = bucket_length(len(suffix_ids) - 1 + len(span), engine.buckets)
    plan = build_splice_plan(suffix_ids, [len(span)], VIDEO_TOKEN_INDEX, pad_to)
    mem_index = plan.mem_index.copy()
    mem_index[plan.use_mem] = np.asarray(span, np.int32)
    return SplicePlan(token_ids=plan.token_ids, mem_index=mem_index, use_mem=plan.use_mem,
                      attn_mask=plan.attn_mask, labels=plan.labels, length=plan.length)


def post_turn_pending(tokenizer) -> list:
    """Ids carried into the next turn: only the closing </s> — the generated
    tokens were each fed through the decode loop and are in the cache."""
    eos_ids = tokenizer(getattr(tokenizer, "eos_token", "</s>")).input_ids
    bos = getattr(tokenizer, "bos_token_id", None)
    if bos is not None and eos_ids and eos_ids[0] == bos:
        eos_ids = eos_ids[1:]
    return list(eos_ids)


def decode_tokens_to_text(tokenizer, tokens: list) -> str:
    if hasattr(tokenizer, "decode"):
        try:
            return tokenizer.decode(tokens, skip_special_tokens=True)
        except TypeError:
            return tokenizer.decode(tokens)
    return ""


def run_cognition_turn(engine: StreamMindEngine, tokenizer, memory: torch.Tensor, span: list,
                       pending_ids: list, cache, max_new_tokens: int = 128,
                       temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
                       generator: Optional[torch.Generator] = None, stop_ids=None):
    """One turn: splice the span into the pending suffix, prefill, decode.
    Returns (text, tokens, new_pending_ids, cache)."""
    plan = build_turn_plan(engine, tokenizer, span, pending_ids)
    last, cache = engine.prefill(plan, memory, cache)
    tokens, cache = engine.generate_from_prefill(
        last, cache, max_new_tokens, temperature=temperature, top_k=top_k, top_p=top_p,
        generator=generator, stop_ids=stop_ids)
    return decode_tokens_to_text(tokenizer, tokens), tokens, post_turn_pending(tokenizer), cache


class StreamSession:
    """One live stream: per frame → perceive; on a gate fire → splice the
    memory span since the previous fire into the rolling dialogue and decode
    a turn.  The KV cache persists across turns."""

    def __init__(
        self,
        engine: StreamMindEngine,
        tokenizer,
        prompt_ids: Optional[list] = None,
        max_new_tokens: int = 128,
        gate_threshold: Optional[float] = None,
        stop_strings: Optional[list] = None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 0.0,
        seed: int = 0,
        sample_type: str = "all",
        sample_per: float = 0.5,
    ):
        require_streaming_projector(engine.cfg, "StreamSession")
        require_attention_decoder(engine.cfg, "StreamSession")
        self.engine = engine
        self.tokenizer = tokenizer
        self.max_new_tokens = max_new_tokens
        self.gate_threshold = gate_threshold  # None → argmax
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.generator = torch.Generator(device=engine.device).manual_seed(seed)
        self.sample_type = sample_type
        self.sample_per = float(sample_per)
        self.last_span: list = []
        self.stop_strings = list(stop_strings) if stop_strings else []
        self.stop_ids = stop_id_matrix(tokenizer, self.stop_strings)
        self.state = engine.new_stream_state()
        self.cache = engine.new_kv_cache()
        self.turns: list = []
        self.pending_ids: list = list(prompt_ids) if prompt_ids else []
        self.interval_ids: list = []

    def export_state(self) -> dict:
        """Everything the dialogue carries, as host values (bf16 tensors are
        exported as fp32 arrays, which is lossless)."""
        def host(t):
            return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

        return {
            "mamba_conv": host(self.state.mamba.conv),
            "mamba_ssm": host(self.state.mamba.ssm),
            "memory": host(self.state.memory),
            "frame_idx": int(self.state.frame_idx),
            "last_fire": int(self.state.last_fire),
            "kv_k": host(self.cache.k),
            "kv_v": host(self.cache.v),
            "kv_length": host(self.cache.length),
            "pending_ids": list(self.pending_ids),
            "turns": list(self.turns),
            "interval_ids": list(self.interval_ids),
            "max_new_tokens": self.max_new_tokens,
            "gate_threshold": self.gate_threshold,
            "stop_strings": list(self.stop_strings),
            "temperature": self.temperature,
            "top_k": self.top_k,
            "top_p": self.top_p,
            "sample_type": self.sample_type,
            "sample_per": self.sample_per,
        }

    @classmethod
    def resume(cls, engine: StreamMindEngine, tokenizer, blob: dict) -> "StreamSession":
        s = cls(engine, tokenizer,
                max_new_tokens=int(blob["max_new_tokens"]),
                gate_threshold=blob["gate_threshold"],
                stop_strings=blob.get("stop_strings"),
                temperature=float(blob.get("temperature", 0.0)),
                top_k=int(blob.get("top_k", 0)),
                top_p=float(blob.get("top_p", 0.0)),
                sample_type=str(blob.get("sample_type", "all")),
                sample_per=float(blob.get("sample_per", 0.5)))

        def dev(a, like):  # a blob exported by either package: bf16 arrays are ml_dtypes'
            return array_to_tensor(a).to(device=like.device, dtype=like.dtype)

        s.state = StreamState(
            mamba=MambaState(conv=dev(blob["mamba_conv"], s.state.mamba.conv),
                             ssm=dev(blob["mamba_ssm"], s.state.mamba.ssm)),
            memory=dev(blob["memory"], s.state.memory),
            frame_idx=int(blob["frame_idx"]),
            last_fire=int(blob["last_fire"]),
        )
        s.cache = lm.KVCache(k=dev(blob["kv_k"], s.cache.k), v=dev(blob["kv_v"], s.cache.v),
                             length=dev(blob["kv_length"], s.cache.length))
        s.pending_ids = list(blob["pending_ids"])
        s.turns = list(blob["turns"])
        s.interval_ids = list(blob["interval_ids"])
        return s

    def process_frame(self, pixels: torch.Tensor, force_fire: bool = False) -> Optional[str]:
        """One video frame → None (silence) or the generated utterance.
        force_fire overrides the gate for this frame; perception still runs."""
        gate_probs, self.state = self.engine.perceive_step(pixels, self.state)
        if force_fire:
            fire = True
        else:
            p = gate_probs.tolist()
            fire = p[1] > p[0] if self.gate_threshold is None else p[1] > self.gate_threshold
        if not fire:
            return None
        return self._cognify()

    def _cognify(self) -> str:
        eng = self.engine
        cur = self.state.frame_idx
        cur_clamped = min(cur, eng.cfg.max_stream_frames)
        start = min(self.state.last_fire, cur_clamped)
        span = list(range(start, cur_clamped)) or [max(cur_clamped - 1, 0)]
        if self.sample_type not in (None, "all"):
            span = subsample_span(span, self.state.memory, self.sample_type, self.sample_per)
        self.last_span = span
        self.interval_ids.append(cur)
        self.pending_ids, self.cache = ensure_turn_capacity(
            eng, self.tokenizer, self.pending_ids, self.turns, self.cache, len(span),
            self.max_new_tokens)
        text, _, self.pending_ids, self.cache = run_cognition_turn(
            eng, self.tokenizer, self.state.memory, span, self.pending_ids, self.cache,
            self.max_new_tokens, temperature=self.temperature, top_k=self.top_k,
            top_p=self.top_p, generator=self.generator, stop_ids=self.stop_ids)
        if self.stop_strings:
            text = trim_at_stop_strings(text, self.stop_strings)
        self.turns.append(text)
        self.state = self.state._replace(last_fire=min(cur, eng.cfg.max_stream_frames))
        return text
