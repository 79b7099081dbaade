"""Deterministic synthetic LM data: the port's copy of
:class:`repro.data.synthetic.SyntheticLM`.

A noisy order-1 Markov process over the vocabulary, drawn with numpy
exactly as the reference draws it (same seeds, same streams, same
order), so both packages see the same tokens; the batches come out as
int32 tensors on the requested device.  The transition table is
``vocab²`` float32 on the host, so only small vocabularies are
practical (the reference trains ``--reduced``, vocab 512).
``make_batch_specs`` (dry-run tooling) is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator

import numpy as np
import torch

__all__ = ["SyntheticLM"]


@dataclasses.dataclass
class SyntheticLM:
    """Iterator of ``{"tokens": int32 (batch, seq_len)}`` on ``device``."""

    vocab_size: int
    seq_len: int
    batch: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0
    device: Any = "cpu"

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)   # shared task definition
        v = self.vocab_size
        # order-1 transition logits with strong structure + noise
        self._trans = rng.normal(size=(v, v)).astype(np.float32)
        self._trans += 3.0 * np.eye(v, k=1, dtype=np.float32)[
            np.arange(v)[:, None] % v, np.arange(v)[None, :] % v]
        self._rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.shard]))

    def _sample_seq(self) -> np.ndarray:
        v = self.vocab_size
        seq = np.empty(self.seq_len, dtype=np.int32)
        seq[0] = self._rng.integers(v)
        # Gumbel-max over the transition row
        for i in range(1, self.seq_len):
            logits = self._trans[seq[i - 1]]
            g = self._rng.gumbel(size=v).astype(np.float32)
            seq[i] = int(np.argmax(logits + g))
        return seq

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            toks = np.stack([self._sample_seq() for _ in range(self.batch)])
            yield {"tokens": torch.from_numpy(toks).to(self.device)}
