"""The port's decoders against the reference's, on the same weights.

The configs and the full-width shapes are checked for every registered
architecture (the sliding-window and local/global decoders' parity is
``tests/test_torch_local_global.py``); the other tests run for these
two at their reduced width in both packages:
``reduced(get_config("qwen2-0.5b"))`` (2 layers, d_model 256, GQA 2:1,
hd 64, vocab 512) and ``reduced(get_config("mamba2-780m"))``
(2 ``ssd`` layers, d_model 256, d_inner 512, 32 SSM heads of 16, state
32, one group, vocab 512).  The reference's ``init_model`` weights, with
biases, decay parameters and norm gains redrawn from numpy so that they
matter, are carried across by ``params_from_jax``.  Prefill logits and
caches, then 4 decode steps, are held against ``repro.models.prefill`` /
``decode_step`` on the same tokens.

Tolerances, as max |Δlogits| / max |logits|:
* float32 compute: 1e-4 at prefill; 5e-3 at decode, because the
  attention caches are bfloat16 in both packages and a key or value that
  differs in its last float32 bit can round to a neighbouring bfloat16.
  Those caches agree within one bf16 ulp (rtol 2⁻⁷); the ``ssd`` caches
  (conv states in the compute dtype, the float32 SSM state) within 1e-4
  of their largest entry.
* bfloat16 compute (the default): 2e-2, the bound of
  ``tests/test_decode_consistency.py``; caches within 2e-2 of their
  largest entry.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
from repro.configs import (LONG_CONTEXT_ARCHS as JLONG,  # noqa: E402
                           get_config as jget, reduced as jreduced)
from repro.models import (decode_step as jdecode,  # noqa: E402
                          init_model as jinit, prefill as jprefill)
from repro.models.layers import rope as jrope  # noqa: E402
from repro.models.transformer import model_defs as jmodel_defs  # noqa: E402
from repro_torch.configs import (ARCHS as REGISTERED,  # noqa: E402
                                 LONG_CONTEXT_ARCHS, get_config, reduced)
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.models import (decode_step, forward, init_model,  # noqa: E402
                                prefill)
from repro_torch.models.layers import rope  # noqa: E402
from repro_torch.models.transformer import _head  # noqa: E402

TOL = {"float32": (1e-4, 5e-3), "bfloat16": (2e-2, 2e-2)}
B, S, N = 2, 40, 4
ARCHS = ["qwen2-0.5b", "mamba2-780m"]
#: each arch's cache subtree in the reference and its leaves
CACHE = {"qwen2-0.5b": ("attn", ("k", "v")),
         "mamba2-780m": ("ssd", ("conv_x", "conv_b", "conv_c", "ssm"))}


def _rel(want, got):
    want = np.asarray(want, np.float32)
    return float(np.abs(want - got.float().numpy()).max()
                 / np.abs(want).max())


def _pair(arch, dtype, seed=0):
    """(reference cfg, port cfg, reference params, port model)."""
    jcfg = dataclasses.replace(jreduced(jget(arch)), dtype=dtype)
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype)
    tree = jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    g = tree["groups"]["0"]
    draw = lambda a, mean, std: (mean + std * rng.normal(size=a.shape)
                                 ).astype(np.float32)
    if arch == "mamba2-780m":
        p = g["ssd"]
        for k in ("conv_x_b", "conv_b_b", "conv_c_b"):
            p[k] = draw(p[k], 0.0, 0.1)
        for k, mean, std in (("A_log", 0.0, 0.5), ("dt_bias", 0.0, 0.5),
                             ("D", 1.0, 0.1), ("ln", 1.0, 0.1),
                             ("norm", 1.0, 0.1)):
            p[k] = draw(p[k], mean, std)
    else:
        for k in ("bq", "bk", "bv"):
            g["attn"][k] = draw(g["attn"][k], 0.0, 0.1)
        for k in ("ln1", "ln2"):
            g[k] = draw(g[k], 1.0, 0.1)
    return jcfg, cfg, tree, params_from_jax(tree, cfg)


@pytest.mark.parametrize("arch", sorted(REGISTERED))
def test_configs_are_the_reference_s(arch):
    """Every registered config, and its reduced form, field for field the
    reference's; so is ``LONG_CONTEXT_ARCHS``."""
    for port, ref in ((get_config(arch), jget(arch)),
                      (reduced(get_config(arch)), jreduced(jget(arch)))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert LONG_CONTEXT_ARCHS == JLONG


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(dtype):
    """Half rotation with f32 angles at qwen2's theta, positions up to
    1023: float32 within 1e-5 (cos/sin of the same f32 angles may differ
    in their last bit between libraries), bfloat16 within one bf16 ulp."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 7, 3, 64)).astype(np.float32)
    pos = np.array([0, 1, 2, 100, 511, 512, 1023], np.int32)
    want = jrope(jnp.asarray(x, dtype), jnp.asarray(pos), 1e6)
    got = rope(torch.from_numpy(x).to(getattr(torch, dtype)),
               torch.from_numpy(pos), 1e6)
    tol = 1e-5 if dtype == "float32" else 1.6e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_exactly(arch):
    _, _, tree, model = _pair(arch, "float32")
    back = params_to_numpy(model)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(leaves) == len(jax.tree.leaves(back))
    for path, a in leaves:
        b = back
        for p in path:
            b = b[p.key]
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def _flat_shapes(tree, prefix=""):
    """{"a.b": shape} of a nested dict of ParamDefs."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_shapes(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v.shape
    return out


@pytest.mark.parametrize("arch", sorted(REGISTERED))
def test_full_width_shapes_equal_reference_on_meta(arch):
    """The arch at full width, built on the meta device (no allocation):
    every layer's parameter has the shape of the reference's stacked
    leaf of its pattern position without the layer axis, or of its tail
    leaf (recurrentgemma-2b's (R, R)); ``lm_head`` where the embeddings
    are untied; the MoE decoders' counts the reference's ``param_count``
    plus the final norm's d, which it leaves out."""
    cfg = get_config(arch)
    model = init_model(cfg, device="meta")
    ref = jmodel_defs(jget(arch))
    assert tuple(model.embed.shape) == ref["embed"].shape
    assert tuple(model.final_norm.shape) == ref["final_norm"].shape
    assert ("lm_head" in ref) == (model.lm_head is not None)
    if model.lm_head is not None:
        assert tuple(model.lm_head.shape) == ref["lm_head"].shape
    n_pat = len(cfg.layer_pattern)
    n_body = cfg.n_groups * n_pat
    assert len(model.blocks) == cfg.n_layers == n_body + len(
        ref.get("tail", {}))
    for i, blk in enumerate(model.blocks):
        got = {n: tuple(p.shape) for n, p in blk.named_parameters()}
        if i < n_body:
            want = _flat_shapes(ref["groups"][str(i % n_pat)])
            assert got == {n: s[1:] for n, s in want.items()}
        else:
            assert got == _flat_shapes(ref["tail"][str(i - n_body)])
        assert all(p.is_meta for p in blk.parameters())
    total = sum(p.numel() for p in model.parameters())
    assert total == sum(
        int(np.prod(d.shape)) for d in jax.tree.leaves(
            ref, is_leaf=lambda x: hasattr(x, "init")))
    if cfg.is_moe:
        assert total == jget(arch).param_count() + cfg.d_model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    jcfg, cfg, tree, model = _pair(arch, dtype)
    tol_prefill, tol_decode = TOL[dtype]
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(B, S + N)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, tree)
    jl, jc = jprefill(jp, jnp.asarray(toks[:, :S]), jcfg, max_len=S + N)
    tl, tc = prefill(model, torch.from_numpy(toks[:, :S]), max_len=S + N)
    assert tl.dtype == torch.float32 and tl.shape == (B, cfg.vocab_size)
    assert _rel(jl, tl) <= tol_prefill
    assert tc["length"] == int(jc["length"]) == S
    kind, names = CACHE[arch]
    for i, layer in enumerate(tc["layers"]):
        assert sorted(layer) == sorted(names)
        for name in names:
            got = layer[name]
            want = np.asarray(jc["groups"]["0"][kind][name][i], np.float32)
            assert got.shape == want.shape
            if kind == "ssd":
                assert got.dtype == (torch.float32 if name == "ssm"
                                     else getattr(torch, dtype))
                assert _rel(want, got) <= tol_prefill, name
                continue
            assert got.dtype == torch.bfloat16
            assert got.shape == (B, S + N, cfg.n_kv_heads, cfg.head_dim)
            if dtype == "float32":
                np.testing.assert_allclose(got.float().numpy(), want,
                                           rtol=2 ** -7, atol=1e-6)
            else:
                assert _rel(want, got) <= 2e-2
    for i in range(N):
        step = toks[:, S + i:S + i + 1]
        jl, jc = jdecode(jp, jc, jnp.asarray(step), jcfg)
        tl, tc = decode_step(model, tc, torch.from_numpy(step))
        assert _rel(jl, tl) <= tol_decode, i
    assert tc["length"] == S + N


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_forward_equals_prefill_plus_decode(arch, dtype):
    """The port's own forward over S + N tokens ≡ prefill of S and N
    decode steps (bound 2e-2, as ``tests/test_decode_consistency.py``)."""
    _, cfg, _, model = _pair(arch, dtype, seed=3)
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, size=(B, S + N)).astype(np.int32))
    h, cache = forward(model, toks)
    assert cache is None
    want = _head(h[:, -1], model)
    logits, cache = prefill(model, toks[:, :S], max_len=S + N)
    for i in range(N):
        logits, cache = decode_step(model, cache, toks[:, S + i:S + i + 1])
    assert float((logits - want).abs().max() / want.abs().max()) < 2e-2


def test_unported_features_raise():
    """What item 10 still queues raises and cites it: an ``ssd`` block
    mixed with attention (or with MoE).  Modality frontends and
    sinusoidal positions are ported (both frontend models are
    registered); an unknown arch raises ``KeyError``."""
    cfg = reduced(get_config("qwen2-0.5b"))
    for change in ({"layer_pattern": ("ssd", "local")},
                   {"layer_pattern": ("ssd", "moe")}):
        with pytest.raises(NotImplementedError, match="item 10"):
            init_model(dataclasses.replace(cfg, **change), device="meta")
    for change in ({"frontend_tokens": 16}, {"pos_embed": "sinusoidal"}):
        init_model(dataclasses.replace(cfg, **change), device="meta")
    for arch in ("internvl2-2b", "musicgen-large"):
        assert get_config(arch).frontend_tokens
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("internvl3-2b")
