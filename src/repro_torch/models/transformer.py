"""The decoder: parameters, caches, prefill, decode.

The port's counterpart of :mod:`repro.models.transformer`, for stacks of
attention blocks, global (``attn``) or sliding-window (``local``) in
any pattern (qwen2-0.5b, qwen1.5-4b, h2o-danube-1.8b, gemma2-27b's
alternating ``("local", "attn")``), of global attention with a
mixture-of-experts FFN (``moe``: qwen3-moe-30b-a3b, dbrx-132b), of
Mamba-2 ``ssd`` blocks (mamba2-780m), or of RG-LRU ``rglru`` blocks
mixed with attention (recurrentgemma-2b's ``("rglru", "rglru",
"local")``, whose 26 layers end in an (R, R) tail).  A model is
``embed → blocks → final norm → unembed`` (tied: the embedding
transposed; untied: ``lm_head``).  The modality models (internvl2-2b's
vision stub, musicgen-large's audio stub) take ``embeds`` ``(B, F,
d)``: precomputed frontend rows, cast to the compute dtype and
prepended to the token embeddings, so that the positions run over F +
T; musicgen-large adds sinusoidal positions to the concatenation
(:func:`~repro_torch.models.layers.sinusoidal_pos`) in place of RoPE,
and its MLP is the plain GELU one.  :class:`Model` holds one block module
per layer (:class:`Block` for ``attn``, ``local`` and ``moe``,
:class:`SSDBlock` for ``ssd``,
:class:`RGLRUBlock` for ``rglru``) and loops over them, tail layers
included (the reference scans a stacked layer axis per pattern
position and runs the tail after it).  An attention block is pre-norm,
with gemma2's post-norms of the attention and MLP outputs where
``cfg.post_norms`` is set, and a ``moe`` block's FFN is
:func:`repro_torch.models.moe.moe_apply` in place of the MLP; an RG-LRU
block is pre-norm with the MLP.
Parameters keep the reference's shapes (``wq`` is ``(d, h, hd)``,
``wqkv`` ``(d, 16, w, hd)``, ``in_proj`` ``(d, 16, width)`` and so on)
and float32, so
:func:`repro_torch.convert.params_from_jax` only has to split the
reference's stacked layer axes.  Matrix weights are cast once to the
compute dtype and kept beside the parameters (``weights``).

Serving entry points, forward only and without autograd:

* :func:`forward` — hidden states for ``mode`` "train" (teacher-forced,
  no cache), "prefill" (returns a cache whose clock is F + T) or
  "decode" (reads the cache; attention layers update theirs in place,
  ``ssd`` and ``rglru`` layers return new states; a decode step takes
  no ``embeds`` and its positions start at the cache's ``length``);
* :func:`prefill` / :func:`decode_step` — last-position logits (f32)
  and the cache, as the serving engine calls them.

Training entry points, functional and differentiable (``attn``,
``moe``, ``ssd`` and ``rglru`` stacks; an ``ssd`` block's scan and an
``rglru`` block's RG-LRU scan run with their backward kernels on the
card):

* :func:`forward_train` — hidden states of a **parameter tree** of
  tensors (:meth:`Model.tree` layout), so that a worker's view goes
  straight in, as in the reference.  Weights are cast to the compute
  dtype on every call, inside the autograd graph: the serving memo
  (``weights``, ``unembed``) holds detached casts, whose gradient would
  silently be zero, and never serves this path.  With ``cfg.remat``
  each block is recomputed in the backward (``torch.utils.checkpoint``,
  the reference's ``jax.checkpoint`` of its layer body);
* :func:`loss_fn` — the causal-LM loss over it (chunked cross-entropy
  against :func:`unembed_matrix`; with ``embeds`` every token is
  predicted from the position before it, the first from the last
  frontend row) plus ``cfg.router_aux_coef`` times the ``moe`` blocks'
  summed load-balance loss.

Every kernel-backed op takes ``impl`` (``auto|cuda|ref``, see
:mod:`repro_torch.kernels.ops`).  Stacks that mix ``ssd`` with other
kinds raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, moe, rglru, ssm
from repro_torch.models.layers import (chunked_cross_entropy, embed_tokens,
                                       mlp_apply, mlp_defs, rmsnorm,
                                       rope_angles, sinusoidal_pos, softcap)
from repro_torch.models.params import ParamDef, init_params, torch_dtype

__all__ = ["Block", "Model", "RGLRUBlock", "SSDBlock", "cache_defs",
           "decode_step", "forward", "forward_train", "init_cache",
           "init_model", "loss_fn", "model_defs", "prefill",
           "unembed_matrix"]

Cache = Dict[str, Any]

#: where the unported stacks are queued
_TODO = "ROADMAP queue 1, item 10 (ssd mixed with other block kinds)"


#: the block kinds with attention (a ``moe`` block's is global)
_ATTN = frozenset({"attn", "local", "moe"})
#: the block kinds a stack may mix: attention and RG-LRU blocks
_MIXED = _ATTN | {"rglru"}


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for what the port does not run."""
    kinds = set(cfg.layer_kinds())
    if not (kinds <= _MIXED or kinds == {"ssd"}):
        raise NotImplementedError(f"block kinds {sorted(kinds)} of "
                                  f"{cfg.name} (the port runs stacks of "
                                  f"attn, local, moe and rglru blocks, or "
                                  f"of ssd blocks): {_TODO}")


def _window(cfg, kind: str) -> Optional[int]:
    """A block's attention window: ``cfg.sliding_window`` for ``local``,
    None (global) otherwise."""
    return cfg.sliding_window if kind == "local" else None


def _norm_def(cfg) -> ParamDef:
    init = "zeros" if cfg.gemma_norm else "ones"   # gemma scales by (1 + w)
    return ParamDef((cfg.d_model,), (None,), init=init)


def block_defs(cfg, kind: str) -> Dict:
    """Parameter definitions of one block of ``kind`` (``attn``,
    ``local``, ``moe``, ``ssd`` or ``rglru``), as the reference's."""
    if kind == "ssd":
        return {"ssd": ssm.ssd_defs(cfg)}
    if kind == "moe":
        return {"ln1": _norm_def(cfg), "attn": attention.attn_defs(cfg),
                "ln2": _norm_def(cfg), "moe": moe.moe_defs(cfg)}
    if kind == "rglru":
        return {"ln1": _norm_def(cfg), "rglru": rglru.rglru_defs(cfg),
                "ln2": _norm_def(cfg), "mlp": mlp_defs(cfg)}
    d = {"ln1": _norm_def(cfg), "attn": attention.attn_defs(cfg),
         "ln2": _norm_def(cfg), "mlp": mlp_defs(cfg)}
    if cfg.post_norms:
        d["ln1_post"] = _norm_def(cfg)
        d["ln2_post"] = _norm_def(cfg)
    return d


def model_defs(cfg) -> Dict:
    """Parameter definitions: ``embed``, ``final_norm``, ``lm_head``
    ``(d, V)`` when the embeddings are untied, and one block tree per
    layer under ``layers`` (the reference stacks them instead)."""
    check_supported(cfg)
    d = {"embed": ParamDef((cfg.vocab_size, cfg.d_model),
                           ("vocab_w", "d_model_w"), scale=0.02),
         "final_norm": _norm_def(cfg),
         "layers": [block_defs(cfg, k) for k in cfg.layer_kinds()]}
    if not cfg.tie_embeddings:
        d["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                ("d_model_w", "vocab_w"), scale=0.02)
    return d


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _cast_key(module: nn.Module, dtype: torch.dtype, recurse: bool):
    """Identity of a module's parameter storage and contents for a cast
    memo: a parameter moved or edited in place changes it."""
    return (dtype,) + tuple((p.data_ptr(), p._version)
                            for p in module.parameters(recurse=recurse))


#: an attention block's norm gains, in :func:`block_defs` order
_NORMS = ("ln1", "ln2", "ln1_post", "ln2_post")


class Block(nn.Module):
    """One pre-norm ``attn``, ``local`` or ``moe`` block: x +
    post1(attn(ln1(x))); x + post2(ffn(ln2(x))), the post-norms where
    ``cfg.post_norms``; the FFN is the MLP, or for ``moe`` the experts
    (:func:`repro_torch.models.moe.moe_apply`)."""

    def __init__(self, cfg, tree: Dict[str, Any], kind: str = "attn"):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        self.norm_names = tuple(k for k in _NORMS if k in tree)
        for k in self.norm_names:
            self.register_parameter(k, _param(tree[k]))
        self.attn = nn.ParameterDict({k: _param(v)
                                      for k, v in tree["attn"].items()})
        #: the FFN's parameters, ``mlp`` or ``moe`` by the block's kind
        self.ffn = "moe" if kind == "moe" else "mlp"
        setattr(self, self.ffn, nn.ParameterDict(
            {k: _param(v) for k, v in tree[self.ffn].items()}))
        self._memo: Tuple[Any, Dict] = (None, {})

    def tree(self) -> Dict[str, Any]:
        """This layer's parameter tensors in :func:`block_defs` layout."""
        return {**{k: v.data for k, v in self.norms().items()},
                **{g: {k: v.data for k, v in getattr(self, g).items()}
                   for g in ("attn", self.ffn)}}

    def norms(self) -> Dict[str, torch.Tensor]:
        """The norm gains by name (``ln1``, ``ln2``, and the post-norms
        where ``cfg.post_norms``)."""
        return {k: getattr(self, k) for k in self.norm_names}

    def weights(self, dtype: torch.dtype) -> Dict[str, Dict]:
        """The attention and FFN weights (the MLP's, or the router's and
        the experts') cast to ``dtype``, made once and kept until a
        parameter moves or changes."""
        key = _cast_key(self, dtype, True)
        if self._memo[0] != key:
            self._memo = (key, {
                g: {k: v.to(dtype) for k, v in getattr(self, g).items()}
                for g in ("attn", self.ffn)})
        return self._memo[1]

    def forward(self, x: torch.Tensor, *,
                rot: Tuple[torch.Tensor, torch.Tensor],
                length: Optional[int], cache: Optional[Dict], mode: str,
                max_len: Optional[int], impl: str
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """Apply the block (``rot``: the RoPE (cos, sin) of x's
        positions, None under sinusoidal positions); returns (x, this
        layer's new cache or None)."""
        return _attn_block(x, self.norms(), self.weights(x.dtype),
                           self.cfg, _window(self.cfg, self.kind), rot=rot,
                           length=length, cache=cache, mode=mode,
                           max_len=max_len, impl=impl)[:2]


def _attn_block(x: torch.Tensor, norms: Dict[str, torch.Tensor],
                w: Dict[str, Dict], cfg, window: Optional[int], *, rot,
                length: Optional[int], cache: Optional[Dict], mode: str,
                max_len: Optional[int], impl: str
                ) -> Tuple[torch.Tensor, Optional[Dict],
                           Optional[torch.Tensor]]:
    """x + post1(attn(ln1(x))); x + post2(ffn(ln2(x))) (the reference's
    ``_apply_block``), with the norm gains ``norms`` (f32; the post-norms
    where ``cfg.post_norms``), the attention and FFN weights ``w`` in x's
    dtype (the MLP's under ``mlp``, or the experts' under ``moe``) and
    the attention ``window``; returns (x, the layer's new cache, the
    experts' load-balance loss or None)."""
    eps, gn = cfg.norm_eps, cfg.gemma_norm
    norm = lambda t, name: rmsnorm(t, norms[name], eps, gn, impl)
    a, c = attention.attn_apply(w["attn"], norm(x, "ln1"), cfg=cfg, rot=rot,
                                window=window, length=length, cache=cache,
                                mode=mode, max_len=max_len, impl=impl)
    if cfg.post_norms:
        a = norm(a, "ln1_post")
    x = x + a
    aux = None
    if "moe" in w:
        m, aux = moe.moe_apply(w["moe"], norm(x, "ln2"), cfg)
    else:
        m = mlp_apply(w["mlp"], norm(x, "ln2"), cfg)
    if cfg.post_norms:
        m = norm(m, "ln2_post")
    return x + m, c, aux


#: the parameters of an ``ssd`` block that stay float32 (the reference
#: reads them in float32: norm gains, A_log, dt_bias)
_SSD_F32 = ("ln", "norm", "A_log", "dt_bias")


class SSDBlock(nn.Module):
    """One Mamba-2 block: x + ssd_apply(x) (its norm is inside)."""

    def __init__(self, cfg, tree: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.ssd = nn.ParameterDict({k: _param(v)
                                     for k, v in tree["ssd"].items()})
        self._memo: Tuple[Any, Dict] = (None, {})

    def tree(self) -> Dict[str, Any]:
        """This layer's parameter tensors in :func:`block_defs` layout."""
        return {"ssd": {k: v.data for k, v in self.ssd.items()}}

    def weights(self, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """The block's parameters with the projections, D and the conv
        weights cast to ``dtype`` (the rest float32), made once and kept
        until a parameter moves or changes."""
        key = _cast_key(self, dtype, True)
        if self._memo[0] != key:
            self._memo = (key, {k: v if k in _SSD_F32 else v.to(dtype)
                                for k, v in self.ssd.items()})
        return self._memo[1]

    def forward(self, x: torch.Tensor, *, rot, length: Optional[int],
                cache: Optional[Dict], mode: str, max_len: Optional[int],
                impl: str) -> Tuple[torch.Tensor, Optional[Dict]]:
        """Apply the block (``rot``, ``length`` and ``max_len`` are unused:
        the state carries the position); returns (x, this layer's new
        cache or None)."""
        o, c = ssm.ssd_apply(self.weights(x.dtype), x, cfg=self.cfg,
                             cache=cache, mode=mode, impl=impl)
        return x + o, c


def _rglru_weights(lp: Dict[str, Any], dtype: torch.dtype) -> Dict:
    """An RG-LRU block's RG-LRU and MLP weights in ``dtype`` (``Lambda``
    stays float32)."""
    return {"rglru": {k: v if k in rglru.F32_PARAMS else v.to(dtype)
                      for k, v in lp["rglru"].items()},
            "mlp": {k: v.to(dtype) for k, v in lp["mlp"].items()}}


def _rglru_block(x: torch.Tensor, norms: Dict[str, torch.Tensor],
                 w: Dict[str, Dict], cfg, *, cache: Optional[Dict],
                 mode: str, impl: str
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x + rglru(ln1(x)); x + mlp(ln2(x)) (the reference's
    ``_apply_block`` for ``rglru``); returns (x, the layer's new cache)."""
    eps, gn = cfg.norm_eps, cfg.gemma_norm
    o, c = rglru.rglru_apply(w["rglru"],
                             rmsnorm(x, norms["ln1"], eps, gn, impl),
                             cfg=cfg, cache=cache, mode=mode, impl=impl)
    x = x + o
    return x + mlp_apply(w["mlp"], rmsnorm(x, norms["ln2"], eps, gn, impl),
                         cfg), c


class RGLRUBlock(nn.Module):
    """One RecurrentGemma recurrent block: x + rglru(ln1(x)); x +
    mlp(ln2(x))."""

    def __init__(self, cfg, tree: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _param(tree["ln1"])
        self.ln2 = _param(tree["ln2"])
        self.rglru = nn.ParameterDict({k: _param(v)
                                       for k, v in tree["rglru"].items()})
        self.mlp = nn.ParameterDict({k: _param(v)
                                     for k, v in tree["mlp"].items()})
        self._memo: Tuple[Any, Dict] = (None, {})

    def tree(self) -> Dict[str, Any]:
        """This layer's parameter tensors in :func:`block_defs` layout."""
        return {"ln1": self.ln1.data, "ln2": self.ln2.data,
                "rglru": {k: v.data for k, v in self.rglru.items()},
                "mlp": {k: v.data for k, v in self.mlp.items()}}

    def weights(self, dtype: torch.dtype) -> Dict[str, Dict]:
        """The RG-LRU and MLP weights cast to ``dtype`` (``Lambda`` stays
        float32), made once and kept until a parameter moves or
        changes."""
        key = _cast_key(self, dtype, True)
        if self._memo[0] != key:
            self._memo = (key, _rglru_weights(
                {"rglru": self.rglru, "mlp": self.mlp}, dtype))
        return self._memo[1]

    def forward(self, x: torch.Tensor, *, rot, length: Optional[int],
                cache: Optional[Dict], mode: str, max_len: Optional[int],
                impl: str) -> Tuple[torch.Tensor, Optional[Dict]]:
        """Apply the block (``rot``, ``length`` and ``max_len`` are unused:
        the state carries the position); returns (x, this layer's new
        cache or None)."""
        return _rglru_block(x, {"ln1": self.ln1, "ln2": self.ln2},
                            self.weights(x.dtype), self.cfg, cache=cache,
                            mode=mode, impl=impl)


def _block(cfg, kind: str, tree: Dict[str, Any]) -> nn.Module:
    """The block module of ``kind`` on its parameter tree."""
    if kind == "ssd":
        return SSDBlock(cfg, tree)
    if kind == "rglru":
        return RGLRUBlock(cfg, tree)
    return Block(cfg, tree, kind)


class Model(nn.Module):
    """The decoder: embedding, one block per layer, final norm.

    ``tree`` holds the parameter tensors in :func:`model_defs` layout
    (from :func:`init_model`, or converted by
    :func:`repro_torch.convert.params_from_jax`).
    """

    def __init__(self, cfg, tree: Dict[str, Any]):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = _param(tree["embed"])
        self.final_norm = _param(tree["final_norm"])
        self.lm_head = (None if cfg.tie_embeddings
                        else _param(tree["lm_head"]))
        self.blocks = nn.ModuleList(
            _block(cfg, kind, t)
            for kind, t in zip(cfg.layer_kinds(), tree["layers"]))
        self._memo: Tuple[Any, Optional[torch.Tensor]] = (None, None)

    def tree(self) -> Dict[str, Any]:
        """The parameter tensors in :func:`model_defs` layout (shared, not
        copied): ``Model(other_cfg, model.tree())`` runs the same weights
        under another configuration, e.g. another compute dtype."""
        t = {"embed": self.embed.data, "final_norm": self.final_norm.data,
             "layers": [b.tree() for b in self.blocks]}
        if self.lm_head is not None:
            t["lm_head"] = self.lm_head.data
        return t

    def unembed(self, dtype: torch.dtype) -> torch.Tensor:
        """The unembedding ``(d, V)`` in ``dtype``, cast once."""
        key = _cast_key(self, dtype, False)
        if self._memo[0] != key:
            self._memo = (key, unembed_matrix(
                {"embed": self.embed, "lm_head": self.lm_head},
                self.cfg).to(dtype))
        return self._memo[1]

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, *,
                embeds: Optional[torch.Tensor] = None,
                cache: Optional[Cache] = None, mode: str = "train",
                max_len: Optional[int] = None, impl: str = "auto"
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """Run the stack on ``tokens`` (B, T), after the frontend rows
        ``embeds`` (B, F, D) where given (train and prefill); returns
        (final hidden states (B, F + T, D), new cache or None)."""
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        if embeds is not None and mode == "decode":
            raise ValueError("a decode step takes no frontend embeddings")
        offset = cache["length"] if mode == "decode" else 0
        x, rot = _embed(self.embed, tokens, embeds, offset, self.cfg)
        S = x.shape[1]
        layers = []
        for i, blk in enumerate(self.blocks):
            x, c = blk(x, rot=rot, length=offset,
                       cache=cache["layers"][i] if mode == "decode" else None,
                       mode=mode, max_len=max_len, impl=impl)
            layers.append(c)
        new_cache = (None if mode == "train"
                     else {"layers": layers, "length": offset + S})
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps,
                    self.cfg.gemma_norm, impl)
        return x, new_cache


def init_model(cfg, *, seed: int = 0, device: Any = "cpu") -> Model:
    """A model with the reference's initialisation law, drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed`` (``meta``:
    shapes only, nothing allocated)."""
    dev = torch.device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    tree = init_params(model_defs(cfg), generator=gen, device=dev,
                       dtype=torch_dtype(cfg.param_dtype))
    return Model(cfg, tree)


def unembed_matrix(params: Dict[str, Any], cfg) -> torch.Tensor:
    """The unembedding ``(d, V)`` of a parameter tree: the embedding
    transposed (tied), or ``lm_head``."""
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def _block_cache_defs(cfg, kind: str, batch: int, max_len: int) -> Dict:
    """One layer's cache: bf16 ``k``/``v`` ``(batch, max_len, KV, hd)``
    for ``attn`` and ``moe``, ``(batch, min(window, max_len), KV, hd)``
    (the ring) for ``local``; for ``ssd`` bf16 conv states ``(batch, K −
    1, ·)`` and the f32 SSM state ``(batch, nh, hd, N)``; for ``rglru``
    the bf16 conv state ``(batch, K − 1, W)`` and the f32 state
    ``(batch, W)``."""
    if kind == "rglru":
        return {"conv": ParamDef((batch, cfg.conv_width - 1, cfg.lru_width),
                                 ("cache_batch", None, "lru_act"),
                                 init="zeros", dtype="bfloat16"),
                "h": ParamDef((batch, cfg.lru_width),
                              ("cache_batch", "lru_act"),
                              init="zeros", dtype="float32")}
    if kind in _ATTN:
        w = _window(cfg, kind)
        kv = ParamDef((batch, max_len if w is None else min(w, max_len),
                       cfg.n_kv_heads, cfg.head_dim),
                      ("cache_batch", "cache_seq", "kv_heads", None),
                      init="zeros", dtype="bfloat16")
        return {"k": kv, "v": kv}
    gs = cfg.ssm_groups * cfg.ssm_state
    conv = lambda width, axis: ParamDef(
        (batch, cfg.ssm_conv - 1, width), ("cache_batch", None, axis),
        init="zeros", dtype="bfloat16")
    return {"conv_x": conv(cfg.d_inner, "d_inner_act"),
            "conv_b": conv(gs, None), "conv_c": conv(gs, None),
            "ssm": ParamDef((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                             cfg.ssm_state),
                            ("cache_batch", "ssm_heads_act", None, None),
                            init="zeros", dtype="float32")}


def cache_defs(cfg, batch: int, max_len: int) -> Dict:
    """Cache definitions: one cache per layer (its block kind's) and the
    shared ``length``."""
    check_supported(cfg)
    return {"layers": [_block_cache_defs(cfg, k, batch, max_len)
                       for k in cfg.layer_kinds()],
            "length": ParamDef((), (), init="zeros", dtype="int32")}


def init_cache(cfg, batch: int, max_len: int, device: Any = "cpu") -> Cache:
    """A zero cache on ``device``; ``length`` is a host int."""
    defs = cache_defs(cfg, batch, max_len)
    return {"layers": init_params(defs["layers"], device=device),
            "length": 0}


def forward(model: Model, tokens: torch.Tensor, *,
            embeds: Optional[torch.Tensor] = None,
            cache: Optional[Cache] = None, mode: str = "train",
            max_len: Optional[int] = None, impl: str = "auto"
            ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Run the decoder stack (see :meth:`Model.forward`)."""
    return model(tokens, embeds=embeds, cache=cache, mode=mode,
                 max_len=max_len, impl=impl)


def _head(h_last: torch.Tensor, model: Model) -> torch.Tensor:
    """Logits (f32) of the last hidden states, soft-capped if configured."""
    logits = h_last @ model.unembed(h_last.dtype)
    return softcap(logits.float(), model.cfg.logit_softcap)


def prefill(model: Model, tokens: torch.Tensor, *,
            embeds: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None, impl: str = "auto"
            ) -> Tuple[torch.Tensor, Cache]:
    """Process a prompt after its frontend rows ``embeds`` (B, F, D)
    where given; returns (last-position logits (B, V), cache), the
    cache's clock at F + T.

    ``max_len`` pre-sizes the caches so decode can append."""
    h, cache = model(tokens, embeds=embeds, mode="prefill", max_len=max_len,
                     impl=impl)
    return _head(h[:, -1], model), cache


def decode_step(model: Model, cache: Cache, tokens: torch.Tensor, *,
                impl: str = "auto") -> Tuple[torch.Tensor, Cache]:
    """One decode step: tokens (B, 1) → (logits (B, V), cache).

    Attention layers update their key and value tensors in place (the
    reference's engine donates them); ``ssd`` and ``rglru`` layers return
    new conv and recurrent states, as the reference's do.  The returned
    cache holds them and the advanced ``length``."""
    h, new_cache = model(tokens, cache=cache, mode="decode", impl=impl)
    return _head(h[:, -1], model), new_cache


def _train_block(lp: Dict[str, Any], x: torch.Tensor, rot, cfg, kind: str,
                 impl: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block of ``kind`` on layer parameters ``lp`` (f32), its weights
    cast to x's dtype here, in the graph, where the reference casts them:
    an attention block's matrices (a ``moe`` block's router and experts
    too); an ``ssd`` block's projections, conv weights and D
    (``_SSD_F32`` stay float32); an ``rglru`` block's all but
    ``Lambda``.  Returns (x, a ``moe`` block's load-balance loss or
    None)."""
    if kind == "rglru":
        return _rglru_block(x, lp, _rglru_weights(lp, x.dtype), cfg,
                            cache=None, mode="train", impl=impl)[0], None
    if kind == "ssd":
        w = {k: v if k in _SSD_F32 else v.to(x.dtype)
             for k, v in lp["ssd"].items()}
        return (x + ssm.ssd_apply(w, x, cfg=cfg, mode="train",
                                  impl=impl)[0], None)
    w = {g: {k: v.to(x.dtype) for k, v in lp[g].items()}
         for g in ("attn", "moe" if kind == "moe" else "mlp")}
    x, _, aux = _attn_block(x, lp, w, cfg, _window(cfg, kind), rot=rot,
                            length=None, cache=None, mode="train",
                            max_len=None, impl=impl)
    return x, aux


def _embed(embed: torch.Tensor, tokens: torch.Tensor,
           embeds: Optional[torch.Tensor], offset: int, cfg
           ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor,
                                                   torch.Tensor]]]:
    """The stack's input and its RoPE angles, as the reference's
    ``forward`` forms them: the token embeddings after the frontend rows
    ``embeds`` (cast to the compute dtype) where given, the positions
    ``offset … offset + F + T − 1``; under sinusoidal positions those
    are added to the input and no angles are made (None, as for a stack
    without attention)."""
    x = embed_tokens(embed, tokens, cfg)
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    positions = torch.arange(offset, offset + x.shape[1], device=x.device)
    if cfg.pos_embed == "sinusoidal":
        return x + sinusoidal_pos(positions, cfg.d_model).to(x.dtype), None
    if not _ATTN & set(cfg.layer_kinds()):
        return x, None
    return x, rope_angles(positions, cfg.head_dim, cfg.rope_theta)


def forward_train(params: Dict[str, Any], tokens: torch.Tensor, cfg, *,
                  embeds: Optional[torch.Tensor] = None,
                  impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Final hidden states (B, F + T, D) of ``tokens`` (B, T) after the
    frontend rows ``embeds`` (B, F, D) where given, under the parameter
    tree ``params``, differentiable (see the module docstring), and the
    ``moe`` blocks' summed load-balance loss (f32; 0 without them)."""
    check_supported(cfg)
    x, rot = _embed(params["embed"], tokens, embeds, 0, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, lp in zip(cfg.layer_kinds(), params["layers"]):
        if cfg.remat:
            x, a = checkpoint(_train_block, lp, x, rot, cfg, kind, impl,
                              use_reentrant=False)
        else:
            x, a = _train_block(lp, x, rot, cfg, kind, impl)
        if a is not None:
            aux = aux + a
    return rmsnorm(x, params["final_norm"], cfg.norm_eps, cfg.gemma_norm,
                   impl), aux


def loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor], cfg, *,
            impl: str = "auto") -> Tuple[torch.Tensor, Dict]:
    """Causal-LM loss of ``batch = {"tokens": (B, S)[, "embeds": (B, F,
    D)]}`` (f32) with the router's load-balance term, and ``{"ce",
    "aux"}``; as ``repro.models.transformer.loss_fn``.  Without
    ``embeds`` position i predicts token i + 1; with them the F frontend
    rows come first, and the hidden states from the last row on, ``h[:,
    F − 1:−1]``, predict every token."""
    tokens, embeds = batch["tokens"], batch.get("embeds")
    h, aux = forward_train(params, tokens, cfg, embeds=embeds, impl=impl)
    if embeds is not None and embeds.shape[1]:
        hp, labels = h[:, embeds.shape[1] - 1:-1], tokens
    else:
        hp, labels = h[:, :-1], tokens[:, 1:]
    ce = chunked_cross_entropy(hp, labels, unembed_matrix(params, cfg), cfg)
    return ce + cfg.router_aux_coef * aux, {"ce": ce, "aux": aux}
