"""Serving engine: request-lifecycle API over continuously batched decode.

The port's counterpart of :mod:`repro.serving.engine`, request for
request and token for token:

* :meth:`ServingEngine.submit` — enqueue a :class:`Request`, get its id;
* :meth:`ServingEngine.step` — one batched decode tick: admit queued
  requests into free slots (batched prefill), sample one token for every
  active slot, retire finished slots (EOS / token budget / cache
  capacity) as :class:`Completion`\\ s, then advance the KV caches one
  decode step;
* :meth:`ServingEngine.drain` — step until queue and slots are empty;
* :meth:`ServingEngine.set_params` — hot-swap the model between decode
  steps.  In-flight groups keep the model (and version) they pinned at
  creation; only newly admitted work sees the new one
  (:meth:`~ServingEngine.request_versions` and
  :meth:`~ServingEngine.live_versions` say which versions are pinned).

Slots live in fixed-width decode groups (``ServeConfig.batch`` slots,
``ServeConfig.max_len`` cache capacity) sharing one cache clock, so
admission into a running group left-pads the new prompt to the group's
current length (pads are attended, positions start at 0).  A model with
``local`` layers keeps a ring of ``sliding_window`` slots per such layer,
so ``max_len`` must be at least the window (the prefill lays its ring
out at that width), as the reference's engine requires.
``generate(prompts, embeds)`` submits batch-sized waves and drains each.

A model with a modality frontend (``cfg.frontend_tokens`` F > 0:
internvl2-2b, musicgen-large) takes each request's own frontend rows
(:attr:`Request.embed`, ``(F, d_model)``; zeros where omitted), which
its prefill puts before the prompt: F counts in every capacity check
and in the group's clock, exactly where the reference counts it, and
a block's rows are rounded to bfloat16 before the prefill whatever the
compute dtype, as the reference's engine rounds them.

Greedy decoding is ``argmax`` with the first index on ties, as
``jnp.argmax``; top-k and temperature draw from a ``torch.Generator`` on
the model's device, seeded from ``ServeConfig.seed`` (not the
reference's bits).  The model runs its kernels under the engine's
``impl`` (``auto|cuda|ref``).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import Model, decode_step, init_cache, prefill

__all__ = ["Completion", "Request", "ServeConfig", "ServingEngine",
           "StepResult", "sample_token"]


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 temperature: float = 1.0,
                 top_k: Optional[int] = None) -> torch.Tensor:
    """logits (B, V) → token ids (B,)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@dataclasses.dataclass
class ServeConfig:
    """Engine knobs.  ``max_len`` is the per-group cache capacity: every
    request must satisfy ``prompt + frontend + max_new_tokens <=
    max_len`` (frontend: the model's ``frontend_tokens``), and a slot
    whose group clock reaches it finishes with reason ``"capacity"``.
    ``max_groups`` bounds concurrently decoding groups (admission
    back-pressure: excess requests wait in the queue)."""

    batch: int = 8
    max_len: int = 512
    max_new_tokens: int = 64
    temperature: float = 0.0
    top_k: Optional[int] = None
    eos_id: Optional[int] = None
    seed: int = 0
    max_groups: int = 4


@dataclasses.dataclass
class Request:
    """One generation request; ``max_new_tokens=None`` takes the engine
    default, and :meth:`ServingEngine.submit` assigns ``req_id``.
    ``embed`` is the request's frontend rows ``(F, d_model)`` for a model
    with ``cfg.frontend_tokens`` F (zeros when omitted).
    ``deadline_s`` is a wall-clock budget from submission that the
    engine ignores: :class:`~repro_torch.serving.server.InferenceServer`
    enforces it."""

    prompt: np.ndarray
    embed: Optional[np.ndarray] = None
    max_new_tokens: Optional[int] = None
    req_id: Optional[int] = None
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class Completion:
    """A finished request: generated ``tokens``, the ``snapshot_version``
    it was served on (pinned at admission), and why it stopped
    (``"eos"`` | ``"length"`` | ``"capacity"``)."""

    req_id: int
    tokens: np.ndarray
    snapshot_version: int
    prompt_len: int
    finish_reason: str


@dataclasses.dataclass
class StepResult:
    """One tick's outcome: finished requests plus every ``(req_id,
    token)`` emitted this tick."""

    completions: List[Completion]
    emitted: List[Tuple[int, int]]


@dataclasses.dataclass
class _Slot:
    req_id: int
    prompt_len: int
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)


class _Group:
    """A fixed-width decode group: ``batch`` slots sharing one cache
    clock and one pinned ``(model, version)`` snapshot."""

    def __init__(self, params: Model, version: int, cache, logits,
                 batch: int):
        self.params = params
        self.version = version
        self.cache = cache
        self.logits = logits                       # (batch, V) f32
        self.slots: List[Optional[_Slot]] = [None] * batch
        self.length: Optional[int] = None          # shared cache clock

    def active(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def free(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]


class ServingEngine:
    """Continuously batched decoder with snapshot hot-swap (one device).

    ``params`` is a :class:`~repro_torch.models.Model`; its device is the
    engine's.  Not thread-safe: one thread drives the lifecycle calls.
    ``prefill_calls`` and ``decode_steps`` count the model calls made.
    """

    def __init__(self, params: Model, cfg, serve_cfg: ServeConfig, *,
                 version: int = 0, impl: str = "auto"):
        if cfg.sliding_window and serve_cfg.max_len < cfg.sliding_window:
            raise ValueError(
                f"max_len {serve_cfg.max_len} < sliding_window "
                f"{cfg.sliding_window}: the prefill ring cache would not "
                "fit the group cache")
        self.params = params
        self.cfg = cfg
        self.scfg = serve_cfg
        self.version = version
        self.impl = impl
        self._F = cfg.frontend_tokens or 0
        self.device = params.embed.device
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(serve_cfg.seed)
        self._queue: Deque[Request] = collections.deque()
        self._groups: List[_Group] = []
        self._next_id = 0
        self.swaps = 0
        self.prefill_calls = 0
        self.decode_steps = 0

    # ------------------------------------------------------------------ #
    # lifecycle API
    # ------------------------------------------------------------------ #
    def set_params(self, params: Model, version: Optional[int] = None) -> int:
        """Swap the serving model between decode steps; running groups
        keep theirs.  Returns the (auto-incremented) new version."""
        self.params = params
        self.version = self.version + 1 if version is None else version
        self.swaps += 1
        return self.version

    def submit(self, req: Request) -> int:
        """Validate and enqueue a request; returns its assigned id."""
        prompt = np.asarray(req.prompt)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(f"prompt must be a non-empty 1-D token array, "
                             f"got shape {prompt.shape}")
        mn = req.max_new_tokens or self.scfg.max_new_tokens
        need = prompt.size + self._F + mn
        if need > self.scfg.max_len:
            raise ValueError(
                f"request needs {need} cache slots (prompt {prompt.size} + "
                f"frontend {self._F} + max_new {mn}) > max_len "
                f"{self.scfg.max_len}")
        if self._F and req.embed is not None:
            shape = np.shape(req.embed)
            if shape != (self._F, self.cfg.d_model):
                raise ValueError(f"embed shape {shape} != "
                                 f"({self._F}, {self.cfg.d_model})")
        req = dataclasses.replace(req, prompt=prompt.astype(np.int32),
                                  max_new_tokens=mn, req_id=self._next_id)
        self._next_id += 1
        self._queue.append(req)
        return req.req_id

    def has_pending(self) -> bool:
        """Queued or in-flight work remains."""
        return bool(self._queue) or any(g.active() for g in self._groups)

    def cancel(self, req_id: int) -> bool:
        """Remove a queued or in-flight request without completing it;
        returns whether it was found.  A cancelled slot frees at once."""
        for i, r in enumerate(self._queue):
            if r.req_id == req_id:
                del self._queue[i]
                return True
        for g in self._groups:
            for i, s in enumerate(g.slots):
                if s is not None and s.req_id == req_id:
                    g.slots[i] = None
                    return True
        return False

    def request_versions(self) -> Dict[int, Optional[int]]:
        """Every live request id → its pinned snapshot version (``None``
        while still queued); the server's worker-death re-admission reads
        it to rebuild version cohorts."""
        out: Dict[int, Optional[int]] = {r.req_id: None for r in self._queue}
        for g in self._groups:
            for s in g.slots:
                if s is not None:
                    out[s.req_id] = g.version
        return out

    def live_versions(self) -> List[int]:
        """Snapshot versions still pinned by some decode group."""
        return sorted({g.version for g in self._groups if g.active()})

    def reset(self) -> List[int]:
        """Drop every queued and in-flight request; returns their ids.
        Request ids are not reused afterwards."""
        ids = [r.req_id for r in self._queue]
        ids += [s.req_id for g in self._groups for s in g.slots
                if s is not None]
        self._queue.clear()
        self._groups = []
        return ids

    def admit_queued(self) -> None:
        """Admit queued requests into decode groups now, without a decode
        step (group formation pins the current model and version)."""
        self._admit()

    def step(self) -> StepResult:
        """One batched decode tick (admit → sample/retire → decode)."""
        self._admit()
        completions: List[Completion] = []
        emitted: List[Tuple[int, int]] = []
        scfg = self.scfg
        for g in self._groups:
            active = g.active()
            if not active:
                continue
            tok = sample_token(g.logits, self._gen, scfg.temperature,
                               scfg.top_k)
            t = tok.cpu().numpy()
            for i in active:
                s = g.slots[i]
                s.out.append(int(t[i]))
                emitted.append((s.req_id, int(t[i])))
                reason = None
                if scfg.eos_id is not None and t[i] == scfg.eos_id:
                    reason = "eos"
                elif len(s.out) >= s.max_new:
                    reason = "length"
                elif g.length >= scfg.max_len:
                    reason = "capacity"   # cache full: no further decode
                if reason is not None:
                    completions.append(Completion(
                        req_id=s.req_id,
                        tokens=np.asarray(s.out, np.int32),
                        snapshot_version=g.version,
                        prompt_len=s.prompt_len,
                        finish_reason=reason))
                    g.slots[i] = None
            if g.active():
                g.logits, g.cache = decode_step(g.params, g.cache,
                                                tok[:, None], impl=self.impl)
                self.decode_steps += 1
                g.length += 1
        self._groups = [g for g in self._groups if g.active()]
        return StepResult(completions, emitted)

    def drain(self) -> List[Completion]:
        """Step until every queued and in-flight request completed."""
        out: List[Completion] = []
        while self.has_pending():
            out.extend(self.step().completions)
        return out

    # ------------------------------------------------------------------ #
    # admission
    # ------------------------------------------------------------------ #
    def _fits_running(self, req: Request, g: _Group) -> bool:
        """Left-pad admission into a running group's shared clock."""
        return (g.version == self.version and g.free()
                and req.prompt.size + self._F <= g.length
                and g.length + req.max_new_tokens <= self.scfg.max_len)

    def _admit(self):
        """FIFO admission: fill running same-version groups first, then
        open fresh groups up to ``max_groups``; head-of-line blocking is
        deliberate (no reordering → deterministic, fair)."""
        while self._queue:
            head = self._queue[0]
            target = next((g for g in self._groups
                           if self._fits_running(head, g)), None)
            if target is not None:
                block = []
                while (self._queue and len(block) < len(target.free())
                       and self._fits_running(self._queue[0], target)):
                    block.append(self._queue.popleft())
                self._admit_block(target, block)
                continue
            if len(self._groups) >= self.scfg.max_groups:
                return
            block, L, mn = [], 0, 0
            while self._queue and len(block) < self.scfg.batch:
                r = self._queue[0]
                L2 = max(L, r.prompt.size)
                mn2 = max(mn, r.max_new_tokens)
                if block and L2 + self._F + mn2 > self.scfg.max_len:
                    break           # would overflow a co-admitted slot
                L, mn = L2, mn2
                block.append(self._queue.popleft())
            self._groups.append(self._new_group())
            self._admit_block(self._groups[-1], block)

    def _new_group(self) -> _Group:
        scfg = self.scfg
        cache = init_cache(self.cfg, scfg.batch, scfg.max_len, self.device)
        logits = torch.zeros(scfg.batch, self.cfg.vocab_size,
                             dtype=torch.float32, device=self.device)
        return _Group(self.params, self.version, cache, logits, scfg.batch)

    def _admit_block(self, g: _Group, reqs: List[Request]):
        """Prefill ``reqs`` together and scatter them into ``g``'s free
        slots.  A fresh group's clock starts at the block's padded
        length and its frontend rows; a running group left-pads every
        prompt to its clock."""
        F = self._F
        if g.length is None:
            L = max(r.prompt.size for r in reqs)
            g.length = L + F
        else:
            L = g.length - F
        toks = np.zeros((len(reqs), L), np.int32)
        for i, r in enumerate(reqs):
            toks[i, L - r.prompt.size:] = r.prompt
        emb = None
        if F:
            rows = np.zeros((len(reqs), F, self.cfg.d_model), np.float32)
            for i, r in enumerate(reqs):
                if r.embed is not None:
                    rows[i] = np.asarray(r.embed, np.float32)
            emb = torch.from_numpy(rows).to(self.device, torch.bfloat16)
        logits, cache = prefill(g.params, torch.from_numpy(toks).to(
            self.device), embeds=emb, max_len=self.scfg.max_len,
            impl=self.impl)
        self.prefill_calls += 1
        if cache["length"] != g.length:
            raise RuntimeError(f"prefill clock {cache['length']} != group "
                               f"clock {g.length}")
        slots = g.free()[:len(reqs)]
        self._scatter(g, cache, logits, slots)
        for slot, r in zip(slots, reqs):
            g.slots[slot] = _Slot(req_id=r.req_id, prompt_len=r.prompt.size,
                                  max_new=r.max_new_tokens)

    def _scatter(self, g: _Group, cache, logits, slots: List[int]):
        """Write a k-row prefill (every cache leaf's rows and the logits
        rows) into the group's slot rows, in the group cache's dtypes;
        the ``length`` clock is shared and equal."""
        idx = torch.tensor(slots, device=self.device)
        for dst, src in zip(g.cache["layers"], cache["layers"]):
            for name, t in dst.items():
                t[idx] = src[name].to(t.dtype)
        g.cache["length"] = cache["length"]
        g.logits[idx] = logits

    # ------------------------------------------------------------------ #
    # blocking API
    # ------------------------------------------------------------------ #
    def generate(self, prompts: List[np.ndarray],
                 embeds: Optional[List[np.ndarray]] = None
                 ) -> List[np.ndarray]:
        """Blocking wave-batch generation: prompts are submitted in
        batch-sized waves and each wave is drained before the next is
        admitted, padded to its own longest prompt; each request carries
        its row of ``embeds`` (one ``(F, d_model)`` array a prompt), so
        that each wave decodes against its own frontend rows."""
        if embeds is not None and len(embeds) != len(prompts):
            raise ValueError(f"{len(prompts)} prompts got {len(embeds)} "
                             "embeddings")
        results: Dict[int, np.ndarray] = {}
        ids: List[int] = []
        for start in range(0, len(prompts), self.scfg.batch):
            for j, p in enumerate(prompts[start:start + self.scfg.batch]):
                emb = None if embeds is None else embeds[start + j]
                ids.append(self.submit(Request(prompt=np.asarray(p),
                                               embed=emb)))
            for c in self.drain():
                results[c.req_id] = c.tokens
        return [results[i] for i in ids]
