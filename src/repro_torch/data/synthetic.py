"""Deterministic synthetic LM data: the port's copy of
:class:`repro.data.synthetic.SyntheticLM`.

A noisy order-1 Markov process over the vocabulary, drawn with numpy
exactly as the reference draws it (same seeds, same streams, same
order), so both packages see the same tokens; the batches come out as
int32 tensors on the requested device.  The transition table is
``vocab²`` float32 on the host, so only small vocabularies are
practical (the reference trains ``--reduced``, vocab 512).
:func:`make_batch_specs` gives the dry run's batch as
:class:`~repro_torch.models.params.Abstract` records (no allocation).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.models.params import abstract

__all__ = ["SyntheticLM", "make_batch_specs"]


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


def make_batch_specs(cfg, shape, rules=None,
                     kind: Optional[str] = None) -> Dict:
    """The dry run's batch for (arch cfg, InputShape), as
    :class:`~repro_torch.models.params.Abstract` records with specs
    under ``rules``.

    train/prefill: ``{"tokens": int32 (B, S − F)[, "embeds": bf16 (B, F,
    D)]}``, F the config's frontend rows; decode: ``{"tokens": int32 (B,
    1)}`` (the cache comes from ``models.cache_defs``).
    """
    kind = kind or shape.kind
    B = shape.global_batch
    if kind == "decode":
        return {"tokens": abstract((B, 1), torch.int32, ("batch", None),
                                   rules)}
    F = cfg.frontend_tokens
    batch = {"tokens": abstract((B, shape.seq_len - F), torch.int32,
                                ("batch", None), rules)}
    if F:
        batch["embeds"] = abstract((B, F, cfg.d_model), torch.bfloat16,
                                   ("batch", None, None), rules)
    return batch
