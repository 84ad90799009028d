"""Length/modality-grouped batch sampler.

A copy of the JAX package's sampler (pure numpy, so the same seed gives the
same indices in both packages), which re-implements the reference's
LengthGroupedSampler (its videollama2_trainer_score.py:215-305, wired with
world_size = world_size * grad_accum_steps):
shuffle, then sort within megabatches so samples of similar length land in
the same global batch (less padding waste), with multimodal and text-only
records kept in separate megabatches so every microbatch is modality-pure.

Deterministic per (seed, epoch) — resume replays the identical order.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def split_to_even_chunks(indices: List[int], lengths: Sequence[int], num_chunks: int):
    """Split indices into num_chunks lists of roughly equal total length
    (reference :210-234) — balances per-device work inside a megabatch."""
    if len(indices) % num_chunks != 0:
        return [indices[i::num_chunks] for i in range(num_chunks)]
    per_chunk = len(indices) // num_chunks
    chunks = [[] for _ in range(num_chunks)]
    totals = [0.0] * num_chunks
    for idx in indices:
        shortest = totals.index(min(totals))
        chunks[shortest].append(idx)
        totals[shortest] += abs(lengths[idx])
        if len(chunks[shortest]) == per_chunk:
            totals[shortest] = float("inf")
    return chunks


def get_length_grouped_indices(
    lengths: Sequence[int],
    batch_size: int,
    world_size: int,
    rng: np.random.Generator,
) -> List[int]:
    """Reference :237-246: random megabatches, sorted by length inside each,
    then length-balanced across the world_size chunks."""
    indices = list(rng.permutation(len(lengths)))
    mega = world_size * batch_size
    megabatches = [indices[i : i + mega] for i in range(0, len(lengths), mega)]
    megabatches = [
        sorted(m, key=lambda i: abs(lengths[i]), reverse=True) for m in megabatches
    ]
    megabatches = [split_to_even_chunks(m, lengths, world_size) for m in megabatches]
    return [int(i) for m in megabatches for chunk in m for i in chunk]


def get_modality_length_grouped_indices(
    lengths: Sequence[int],
    batch_size: int,
    world_size: int,
    rng: np.random.Generator,
) -> List[int]:
    """Reference :236-262: signed lengths (negative == text-only).  Multimodal
    and language megabatches are built separately, interleaved in random
    order, with the two ragged tails merged into one final batch."""
    assert all(l != 0 for l in lengths), "zero-length sample"
    if all(l > 0 for l in lengths) or all(l < 0 for l in lengths):
        return get_length_grouped_indices(lengths, batch_size, world_size, rng)
    mm = [(i, l) for i, l in enumerate(lengths) if l > 0]
    lang = [(i, -l) for i, l in enumerate(lengths) if l < 0]
    mm_idx = [i for i, _ in mm]
    lang_idx = [i for i, _ in lang]
    mm_shuffle = [
        mm_idx[j]
        for j in get_length_grouped_indices([l for _, l in mm], batch_size, world_size, rng)
    ]
    lang_shuffle = [
        lang_idx[j]
        for j in get_length_grouped_indices([l for _, l in lang], batch_size, world_size, rng)
    ]
    mega = world_size * batch_size
    mm_mb = [mm_shuffle[i : i + mega] for i in range(0, len(mm_shuffle), mega)]
    lang_mb = [lang_shuffle[i : i + mega] for i in range(0, len(lang_shuffle), mega)]
    additional = mm_mb[-1] + lang_mb[-1] if (mm_mb or lang_mb) else []
    megabatches = mm_mb[:-1] + lang_mb[:-1]
    order = rng.permutation(len(megabatches))
    megabatches = [megabatches[i] for i in order]
    if additional:
        megabatches.append(sorted(additional))
    return [int(i) for m in megabatches for i in m]


class LengthGroupedSampler:
    """Per-epoch index order. batch_size is the per-device microbatch size;
    world_size should be dp * gradient_accumulation_steps so one megabatch ==
    one optimizer step's global batch (matches the reference's trainer
    wiring, videollama2_trainer_score.py:330-338)."""

    def __init__(
        self,
        n: int,
        batch_size: int = 1,
        world_size: int = 1,
        lengths: Optional[Sequence[int]] = None,
        seed: int = 0,
        group_by_modality: bool = True,
    ):
        if lengths is not None and len(lengths) != n:
            raise ValueError(f"lengths has {len(lengths)} entries for {n} samples")
        self.n = n
        self.batch_size = batch_size
        self.world_size = world_size
        self.lengths = list(lengths) if lengths is not None else None
        self.seed = seed
        self.group_by_modality = group_by_modality

    def epoch_indices(self, epoch: int) -> List[int]:
        rng = np.random.default_rng((self.seed, epoch))
        if self.lengths is None:
            return [int(i) for i in rng.permutation(self.n)]
        if self.group_by_modality:
            return get_modality_length_grouped_indices(
                self.lengths, self.batch_size, self.world_size, rng
            )
        return get_length_grouped_indices(
            self.lengths, self.batch_size, self.world_size, rng
        )
