"""The sliding-window and local/global decoders' caches, norms, trees and
serving against the reference's: the prefill ring of h2o-danube-1.8b at
S below, at and past its window (and with ``max_len`` under it), decode
wrapping the ring, the gemma norm's gradient, ``params_from_jax`` round
trips of ``lm_head``, ``wqkv``, the post-norms and two-kind groups, the
cache definitions, and the serving engine (greedy tokens against the
reference engine's; ``max_len`` under the window raises).

Models, weights and tolerances as ``tests/test_torch_local_global.py``,
whose helpers this file uses.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.models.layers import rmsnorm as jrmsnorm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import params_to_numpy  # noqa: E402
from repro_torch.models import (decode_step, init_cache,  # noqa: E402
                                init_model, prefill)
from repro_torch.models.layers import rmsnorm  # noqa: E402
from repro_torch.serving import ServeConfig, ServingEngine  # noqa: E402
from test_torch_local_global import (ARCHS, B, FUSED, TOL, W,  # noqa: E402
                                     _check_caches, _pair, _ref_cache,
                                     _rel, _tokens, _within_one_ulp,
                                     jdecode, jprefill)


@pytest.mark.parametrize("s, max_len", [(40, 48), (64, 72), (100, 104),
                                        (130, 136)])
def test_prefill_ring_matches_reference(s, max_len):
    """danube's prefill ring at S < w (zero-padded to w, even where
    ``max_len`` < w, as the reference pads it), S = w, and S > w with
    S % w != 0 (once and twice round): the reference's cache, and slot
    p % w holding position p's key, as a global layer's cache of the same
    prompt holds it at p."""
    jcfg, cfg, tree, model = _pair("h2o-danube-1.8b", "float32", seed=5)
    toks = np.random.default_rng(s).integers(
        0, cfg.vocab_size, size=(B, s)).astype(np.int32)
    _, jc = jprefill(jax.tree.map(jnp.asarray, tree), jnp.asarray(toks),
                     jcfg, max_len=max_len)
    _, tc = prefill(model, torch.from_numpy(toks), max_len=max_len)
    glob = dataclasses.replace(cfg, layer_pattern=("attn",))
    _, full = prefill(type(model)(glob, model.tree()),
                      torch.from_numpy(toks), max_len=max_len)
    for i in range(cfg.n_layers):
        ref, g = _ref_cache(jc, cfg, i)
        for name in ("k", "v"):
            got = tc["layers"][i][name]
            assert got.shape == (B, W, cfg.n_kv_heads, cfg.head_dim)
            _within_one_ulp(got, np.asarray(ref[name][g], np.float32))
    # layer 0's keys and values depend on the prompt alone, so the global
    # layer's cache holds the same ones, in position order
    for name in ("k", "v"):
        ring, lin = tc["layers"][0][name], full["layers"][0][name]
        for p in range(max(0, s - W), s):
            assert torch.equal(ring[:, p % W], lin[:, p]), (name, p)
        if s < W:
            assert not ring[:, s:].any()


def test_decode_ring_wraps_like_reference():
    """danube decoding from a prompt shorter than the window past it: 80
    decode steps from S 20 fill the ring, wrap it and overwrite its
    oldest slots, each step's logits against the reference's."""
    jcfg, cfg, tree, model = _pair("h2o-danube-1.8b", "float32", seed=6)
    toks = _tokens(cfg, 13, n=100)
    jp = jax.tree.map(jnp.asarray, tree)
    jl, jc = jprefill(jp, jnp.asarray(toks[:, :20]), jcfg, max_len=100)
    tl, tc = prefill(model, torch.from_numpy(toks[:, :20]), max_len=100)
    for i in range(20, 99):
        step = toks[:, i:i + 1]
        jl, jc = jdecode(jp, jc, jnp.asarray(step), jcfg)
        tl, tc = decode_step(model, tc, torch.from_numpy(step))
        assert _rel(jl, tl) <= TOL["float32"][1], i
    _check_caches(tc, jc, cfg, "float32", 100, decoded=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma_norm_gradient_matches_reference(dtype):
    """``rmsnorm(gemma=True)`` (gain 1 + w in float32) under autograd:
    the value and the gradients of x and w against ``jax.vjp`` of the
    reference's ``rmsnorm(..., gemma=True)``; float32 rtol 1e-5, atol
    1e-6·max(1, max|·|), bfloat16 within 2e-2 of the largest entry
    (dw is float32 in both: rtol 1e-4)."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(3, 5, 96)).astype(np.float32) * 2
    w = (0.2 * rng.normal(size=96)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    jd = getattr(jnp, dtype)
    y, vjp = jax.vjp(lambda a, b: jrmsnorm(a, b, 1e-6, True),
                     jnp.asarray(x, jd), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g, jd))
    td = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(td).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    ty = rmsnorm(tx, tw, 1e-6, gemma=True)
    dx, dw = torch.autograd.grad(ty, (tx, tw), torch.from_numpy(g).to(td))
    assert dx.dtype == td and dw.dtype == torch.float32
    for got, want in ((ty, y), (dx, jdx)):
        want = np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(
                got.detach().numpy(), want, rtol=1e-5,
                atol=1e-6 * max(1.0, float(np.abs(want).max())))
        else:
            assert _rel(want, got.detach()) <= 2e-2
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-4,
                               atol=1e-5 * float(np.abs(jdw).max()))


@pytest.mark.parametrize("arch, changes", [(a, {}) for a in ARCHS]
                         + [("gemma2-27b", FUSED)])
def test_params_round_trip_exactly(arch, changes):
    """``params_from_jax`` then ``params_to_numpy``: every leaf of the
    reference's tree back bit for bit, ``lm_head`` (untied), ``wqkv``,
    the post-norms and both pattern positions' groups included."""
    _, cfg, tree, model = _pair(arch, "float32", **changes)
    assert ("lm_head" in tree) == (not cfg.tie_embeddings)
    assert set(tree["groups"]) == {str(j) for j in
                                   range(len(cfg.layer_pattern))}
    back = params_to_numpy(model)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(leaves) == len(jax.tree.leaves(back))
    for path, a in leaves:
        b = back
        for p in path:
            b = b[p.key]
        np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_defs_hold_rings_and_full_caches(arch):
    """``init_cache``: a ``local`` layer's ring of min(window, max_len)
    slots, an ``attn`` layer's max_len, side by side in gemma2."""
    cfg = get_config(arch)
    for max_len in (1024, 8192):
        cache = init_cache(cfg, 2, max_len, device="meta")
        for kind, layer in zip(cfg.layer_kinds(), cache["layers"]):
            want = (min(cfg.sliding_window, max_len) if kind == "local"
                    else max_len)
            assert layer["k"].shape == (2, want, cfg.n_kv_heads,
                                        cfg.head_dim)
            assert layer["v"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "gemma2-27b"])
def test_engine_generates_reference_tokens(arch, monkeypatch):
    """The serving engine in float32, greedy, batch 2: prompts of 66–90
    tokens (past the window), left-padded within a wave, 8 new tokens
    each, against the reference engine.  Each request's tokens must be
    equal up to its first step where the reference's top-1 logit leads
    its top-2 by no more than the decode logits tolerance (5e-3 of max
    |logit|): from a near tie on, the two may rightly part.  The reduced
    random models have such ties, so the test also asserts that most
    tokens are compared."""
    jcfg, cfg, tree, model = _pair(arch, "float32", seed=2)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (70, 90, 81, 66)]
    seen = []
    real = jengine.sample_token

    def recording(logits, *a, **kw):
        seen.append(np.asarray(logits, np.float32))
        return real(logits, *a, **kw)

    monkeypatch.setattr(jengine, "sample_token", recording)
    new = 8
    ref = jengine.ServingEngine(tree, jcfg, jengine.ServeConfig(
        batch=2, max_len=100, max_new_tokens=new)).generate(prompts)
    assert len(seen) == 2 * new          # two waves of two
    got = ServingEngine(model, cfg, ServeConfig(
        batch=2, max_len=100, max_new_tokens=new)).generate(prompts)
    compared = 0
    for i, (a, b) in enumerate(zip(ref, got)):
        wave, row = divmod(i, 2)
        steps = np.stack([seen[new * wave + t][row] for t in range(new)])
        top2 = np.sort(steps, axis=-1)[:, -2:]
        tied = top2[:, 1] - top2[:, 0] <= 5e-3 * np.abs(steps).max(-1)
        n = int(np.argmax(tied)) if tied.any() else new
        np.testing.assert_array_equal(np.asarray(a)[:n], b[:n])
        compared += n
    assert compared >= len(prompts) * new // 2, compared


def test_engine_raises_below_the_window():
    """As the reference's engine: ``max_len`` under the sliding window
    raises (the prefill ring is laid out at the window's width)."""
    cfg = reduced(get_config("h2o-danube-1.8b"))
    model = init_model(cfg)
    with pytest.raises(ValueError, match="sliding_window"):
        ServingEngine(model, cfg, ServeConfig(max_len=W - 1))
    ServingEngine(model, cfg, ServeConfig(max_len=W))
    with pytest.raises(ValueError, match="sliding_window"):
        jengine.ServingEngine({}, jreduced(jget("h2o-danube-1.8b")),
                              jengine.ServeConfig(max_len=W - 1))
