"""The port's sliding-window and local/global decoders' logits and
caches against the reference's, on the same weights: qwen1.5-4b (untied
unembedding, QKV bias, MHA), h2o-danube-1.8b (every layer ``local``) and
gemma2-27b
(alternating ``("local", "attn")``, softcaps, post-norms, the gemma norm,
``embed_scale``, GeGLU).

Each runs at its reduced width in both packages (``reduced``: 2 layers,
d_model 256, window 64, vocab 512; qwen1.5 2 / 2 heads, danube 4 / 1,
gemma2 4 / 2, hd 64), on the reference's ``init_model`` weights with the
biases and norm gains redrawn from numpy so that they matter, carried
across by ``params_from_jax``.  Fused QKV runs on a reduced gemma2 with
16 / 16 heads of 16 (``reduced`` alone gives 4 / 2 heads, which the
reference does not fuse).

Prompts of S 96 tokens (past the window of 64, S % 64 != 0), so that a
``local`` layer's prefill keeps the last 64 keys rolled into its ring
and the decode steps write into a ring that has wrapped.  Tolerances
as ``tests/test_torch_transformer.py`` (max |Δ| / max |logits|):
float32 compute 1e-4 at prefill, 5e-3 in decode (bfloat16 caches in
both packages), the caches within one bf16 ulp; bfloat16 compute 2e-2,
the caches within 2e-2 of their largest entry.  gemma2's logit softcap
(30) bounds every logit by 30, so its max |logits| is at most 30 and the
bound stays relative to it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.models import (decode_step as _jdecode,  # noqa: E402
                          init_model as jinit, prefill as _jprefill)
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import decode_step, forward, prefill  # noqa: E402
from repro_torch.models.attention import fusable_qkv  # noqa: E402
from repro_torch.models.transformer import _head  # noqa: E402

ARCHS = ["qwen1.5-4b", "h2o-danube-1.8b", "gemma2-27b"]
TOL = {"float32": (1e-4, 5e-3), "bfloat16": (2e-2, 2e-2)}
B, S, N = 2, 96, 4
W = 64                                  # the reduced window
#: gemma2 at 16 / 16 heads of 16: the reference fuses its q/k/v
FUSED = dict(n_heads=16, n_kv_heads=16, head_dim=16)
NORMS = ("ln1", "ln2", "ln1_post", "ln2_post")
#: the reference's prefill and decode step, compiled once per config (a
#: decode step run eagerly recompiles its layer scan on every call)
jprefill = jax.jit(_jprefill, static_argnums=2, static_argnames="max_len")
jdecode = jax.jit(_jdecode, static_argnums=3)


def _rel(want, got):
    want = np.asarray(want, np.float32)
    return float(np.abs(want - got.float().numpy()).max()
                 / np.abs(want).max())


def _pair(arch, dtype, seed=0, **changes):
    """(reference cfg, port cfg, reference params (numpy), port model)."""
    jcfg = dataclasses.replace(jreduced(jget(arch)), dtype=dtype, **changes)
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype,
                              **changes)
    tree = jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    # a gemma norm's gain is 1 + w, w initialised to 0
    base = 0.0 if cfg.gemma_norm else 1.0
    draw = lambda a, mean: (mean + 0.1 * rng.normal(size=a.shape)).astype(
        np.float32)
    for g in tree["groups"].values():
        for k in ("bq", "bk", "bv"):
            if k in g["attn"]:
                g["attn"][k] = draw(g["attn"][k], 0.0)
        for k in NORMS:
            if k in g:
                g[k] = draw(g[k], base)
    tree["final_norm"] = draw(tree["final_norm"], base)
    return jcfg, cfg, tree, params_from_jax(tree, cfg)


def _within_one_ulp(got, want):
    """Every entry of the bf16 ``got`` within one bf16 ulp of ``want``
    (f32), the ulp taken at the larger magnitude of the two, plus 1e-6 of
    max(1, max |want|): float32 sums in another order can round a cache
    entry to the neighbouring bf16 value (across a power of two too),
    and near 0 their own rounding error exceeds a bf16 ulp."""
    a, b = want, got.float().numpy()
    top = np.maximum(np.maximum(np.abs(a), np.abs(b)),
                     np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(top)) - 7)
    atol = 1e-6 * max(1.0, float(np.abs(a).max()))
    assert (np.abs(a - b) <= ulp + atol).all(), float(np.abs(a - b).max())


def _ref_cache(jc, cfg, i):
    """Layer i's attention cache in the reference's stacked groups."""
    n = len(cfg.layer_pattern)
    return jc["groups"][str(i % n)]["attn"], i // n


def _check_caches(tc, jc, cfg, dtype, length, decoded=False):
    """Every layer's k and v: a ring of W slots for ``local``, the full
    ``length`` for ``attn``; equal to the reference's (see the module
    docstring for the tolerances; after decode steps, whose inputs carry
    the caches' one-ulp differences, a float32 cache within the decode
    logits' 5e-3 of its largest entry)."""
    for i, (kind, layer) in enumerate(zip(cfg.layer_kinds(), tc["layers"])):
        ref, g = _ref_cache(jc, cfg, i)
        for name in ("k", "v"):
            got = layer[name]
            want = np.asarray(ref[name][g], np.float32)
            assert got.dtype == torch.bfloat16
            assert got.shape == want.shape == (
                B, W if kind == "local" else length, cfg.n_kv_heads,
                cfg.head_dim), (i, name)
            if dtype == "float32" and not decoded:
                _within_one_ulp(got, want)
            else:
                assert _rel(want, got) <= TOL[dtype][1], (i, name)


def _tokens(cfg, seed, n=S + N):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, n)).astype(np.int32)


def _prefill_decode(arch, dtype, **changes):
    jcfg, cfg, tree, model = _pair(arch, dtype, **changes)
    tol_prefill, tol_decode = TOL[dtype]
    toks = _tokens(cfg, 7)
    jp = jax.tree.map(jnp.asarray, tree)
    jl, jc = jprefill(jp, jnp.asarray(toks[:, :S]), jcfg, max_len=S + N)
    tl, tc = prefill(model, torch.from_numpy(toks[:, :S]), max_len=S + N)
    assert tl.dtype == torch.float32 and tl.shape == (B, cfg.vocab_size)
    assert _rel(jl, tl) <= tol_prefill
    assert tc["length"] == int(jc["length"]) == S
    _check_caches(tc, jc, cfg, dtype, S + N)
    for i in range(N):
        step = toks[:, S + i:S + i + 1]
        jl, jc = jdecode(jp, jc, jnp.asarray(step), jcfg)
        tl, tc = decode_step(model, tc, torch.from_numpy(step))
        assert _rel(jl, tl) <= tol_decode, i
    assert tc["length"] == S + N
    _check_caches(tc, jc, cfg, dtype, S + N, decoded=True)
    return cfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    """Prefill logits and caches at S 96 > window 64, then 4 decode steps
    into the wrapped ring, against ``repro.models.prefill`` /
    ``decode_step``."""
    cfg = _prefill_decode(arch, dtype)
    assert not fusable_qkv(cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_qkv_matches_reference(dtype):
    """gemma2 at 16 / 16 heads: one ``wqkv`` (D, 16, 3, hd), split per
    block into q, k, v as the reference splits it."""
    cfg = _prefill_decode("gemma2-27b", dtype, **FUSED)
    assert fusable_qkv(cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_forward_equals_prefill_plus_decode(arch, dtype):
    """The port's own forward over S + N tokens ≡ prefill of S and N
    decode steps through the ring (bound 2e-2, as
    ``tests/test_decode_consistency.py``)."""
    _, cfg, _, model = _pair(arch, dtype, seed=3)
    toks = torch.from_numpy(_tokens(cfg, 9))
    h, cache = forward(model, toks)
    assert cache is None
    want = _head(h[:, -1], model)
    logits, cache = prefill(model, toks[:, :S], max_len=S + N)
    for i in range(N):
        logits, cache = decode_step(model, cache, toks[:, S + i:S + i + 1])
    assert float((logits - want).abs().max() / want.abs().max()) < 2e-2
