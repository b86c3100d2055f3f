"""Token data for the trainer (port of ``repro/data/tokens.py``).

A deterministic synthetic corpus (no downloads): each (step, rank) batch
is drawn by numpy from ``SeedSequence([seed, step, rank])``, exactly as
the reference draws it, so the port's tokens, labels and mask equal the
reference's; they are handed over as tensors on the corpus's device. A
restarted job resumes the exact stream from the checkpointed step.
"""

from __future__ import annotations

from typing import Dict, Iterator, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device


class Batch(NamedTuple):
    tokens: torch.Tensor   # (B, S) int32 — input ids
    labels: torch.Tensor   # (B, S) int32 — next-token targets
    mask: torch.Tensor     # (B, S) f32 — loss weights


class SyntheticCorpus:
    """Deterministic infinite token stream with a Zipf-ish unigram shape
    (``u ** 4`` concentrates mass on low ids), on ``device`` (the card
    unless ``device="cpu"``).

    ``sample(step, rank, per_rank_batch)`` is a pure function of its
    arguments: ranks never exchange data.
    """

    def __init__(self, vocab: int, seq_len: int, seed: int = 0, *,
                 device=None):
        self.vocab = vocab
        self.seq_len = seq_len
        self.seed = seed
        self.device = resolve_device(device)

    def sample(self, step: int, rank: int, per_rank_batch: int) -> Batch:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, rank]))
        u = rng.random((per_rank_batch, self.seq_len + 1))
        toks = np.minimum((u ** 4 * self.vocab).astype(np.int32),
                          self.vocab - 1)
        toks = torch.as_tensor(toks, device=self.device)
        return Batch(toks[:, :-1].contiguous(), toks[:, 1:].contiguous(),
                     torch.ones((per_rank_batch, self.seq_len),
                                dtype=torch.float32, device=self.device))

    def batches(self, rank: int, per_rank_batch: int,
                start_step: int = 0) -> Iterator[Batch]:
        step = start_step
        while True:
            yield self.sample(step, rank, per_rank_batch)
            step += 1


def train_batch_specs(global_batch: int, seq_len: int
                      ) -> Dict[str, torch.Tensor]:
    """Stand-ins for a training batch on the ``meta`` device: the
    reference's shapes and dtypes, nothing allocated."""
    shape = (global_batch, seq_len)
    return {"tokens": torch.empty(shape, dtype=torch.int32, device="meta"),
            "labels": torch.empty(shape, dtype=torch.int32, device="meta"),
            "mask": torch.empty(shape, dtype=torch.float32, device="meta")}


def decode_batch_specs(global_batch: int) -> Dict[str, torch.Tensor]:
    """Stand-ins for a decode step's tokens and positions on ``meta``."""
    return {k: torch.empty((global_batch,), dtype=torch.int32, device="meta")
            for k in ("tokens", "positions")}
