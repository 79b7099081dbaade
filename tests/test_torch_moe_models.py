"""The MoE decoders qwen3-moe-30b-a3b and dbrx-132b in the port against
the reference, on the same weights.

The reduced model of both packages (``reduced``: 2 ``moe`` layers,
d_model 256, 4 experts top 2, vocab 512; qwen3-moe 4 query heads on one
KV head of 64, d_ff 768; dbrx 6 on one of 42, d_ff 1024), on the
reference's ``init_model`` weights with the norm gains redrawn from
numpy so that they matter, carried across by ``params_from_jax`` (the
experts' ``(E, d, f)`` leaves stacked to ``(G, E, d, f)`` in the
reference's tree):

* prefill of S 96 tokens and 4 decode steps, logits and every layer's
  cache against the reference's ``prefill`` / ``decode_step``, in
  float32 and bfloat16 compute, at the capacity factor 8.0 under which
  no token is dropped, as ``tests/test_decode_consistency.py`` runs the
  reference (drops depend on the call's token count).  Tolerances as
  ``tests/test_torch_local_global.py`` (max |Δ| / max |logits|): float32
  1e-4 at prefill, 5e-3 in decode; bfloat16 2e-2;
* the port's own teacher-forced forward ≡ prefill + decode (bound 2e-2,
  as the reference's test), at factor 8.0;
* ``loss_fn`` (the router's load-balance term included) and its
  gradients (float32, remat, the config's factor 1.25)
  against ``jax.value_and_grad`` (``tests/test_torch_train.py``'s
  tolerances), and its ``aux`` against the reference's;
* the serving engine's greedy tokens against the reference engine's, at
  factor 1.25 (both engines prefill a wave's B·S tokens and decode the
  group's batch), up to each request's first near tie;
* the launchers serving and training each reduced model on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.models import init_model as jinit, loss_fn as jloss  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.steps import make_grad_fn  # noqa: E402
from repro_torch.models import (decode_step, forward, loss_fn,  # noqa: E402
                                prefill)
from repro_torch.models.transformer import _head  # noqa: E402
from repro_torch.serving import ServeConfig, ServingEngine  # noqa: E402
from test_torch_local_global import B, N, S, TOL, _rel, _tokens  # noqa: E402
from test_torch_local_global import jdecode, jprefill  # noqa: E402
from test_torch_train import _as_port, _close_trees  # noqa: E402

ARCHS = ("qwen3-moe-30b-a3b", "dbrx-132b")
#: the capacity factor under which nothing drops at these token counts
NO_DROPS = {"moe_capacity_factor": 8.0}


def _pair(arch, dtype="float32", seed=0, **changes):
    """(reference cfg, port cfg, reference params (numpy), port model)."""
    jcfg = dataclasses.replace(jreduced(jget(arch)), dtype=dtype, **changes)
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype,
                              **changes)
    tree = jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    draw = lambda a: (1.0 + 0.1 * rng.normal(size=a.shape)).astype(
        np.float32)
    g = tree["groups"]["0"]
    for k in ("ln1", "ln2"):
        g[k] = draw(g[k])
    tree["final_norm"] = draw(tree["final_norm"])
    assert g["moe"]["w_gate"].shape == (cfg.n_layers, cfg.n_experts,
                                        cfg.d_model, cfg.d_ff)
    return jcfg, cfg, tree, params_from_jax(tree, cfg)


def _check_caches(tc, jc, cfg, dtype, length):
    for i, layer in enumerate(tc["layers"]):
        for name in ("k", "v"):
            want = np.asarray(jc["groups"]["0"]["attn"][name][i], np.float32)
            got = layer[name]
            assert got.dtype == torch.bfloat16
            assert got.shape == want.shape == (B, length, cfg.n_kv_heads,
                                               cfg.head_dim)
            assert _rel(want, got) <= TOL[dtype][1], (i, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    """Prefill logits and caches of S 96 tokens, then 4 decode steps,
    against ``repro.models.prefill`` / ``decode_step`` at factor 8.0."""
    jcfg, cfg, tree, model = _pair(arch, dtype, **NO_DROPS)
    assert cfg.layer_kinds() == ("moe", "moe")
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


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_forward_equals_prefill_plus_decode(arch):
    """The port's forward over S + N tokens ≡ prefill of S and N decode
    steps, bfloat16, at factor 8.0 (bound 2e-2, as
    ``tests/test_decode_consistency.py``)."""
    _, cfg, _, model = _pair(arch, "bfloat16", seed=3, **NO_DROPS)
    toks = torch.from_numpy(_tokens(cfg, 9))
    h, cache = forward(model, toks)
    assert cache is None
    want = _head(h[:, -1], model)
    logits, cache = prefill(model, toks[:, :S], max_len=S + N)
    for i in range(N):
        logits, cache = decode_step(model, cache, toks[:, S + i:S + i + 1])
    assert float((logits - want).abs().max() / want.abs().max()) < 2e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_grads_match_reference(arch):
    """``loss_fn`` (ce + router_aux_coef · aux), its ``aux`` and its
    gradients (remat, factor 1.25) against ``jax.value_and_grad``,
    float32; the router's gradient holds the load-balance term's part."""
    jcfg, cfg, tree, model = _pair(arch, seed=2)
    assert cfg.remat and cfg.moe_capacity_factor == 1.25
    params = model.tree()
    toks = np.random.default_rng(5).integers(0, 512, size=(2, 40)).astype(
        np.int32)
    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(toks)}, jcfg)
    loss, grads = make_grad_fn(cfg, clip_norm=None)(params,
                                                    torch.from_numpy(toks))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _close_trees(grads, _as_port(jg, cfg), "grads")
    with torch.no_grad():
        _, met = loss_fn(params, {"tokens": torch.from_numpy(toks)}, cfg)
    # two layers' Switch losses, each ≈ 1 for a balanced router
    assert 1.0 < float(met["aux"]) < 4.0
    np.testing.assert_allclose(float(met["aux"]), float(jm["aux"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(met["ce"]), float(jm["ce"]), rtol=1e-5)
    # without the load-balance term the router's gradient changes
    no_aux = dataclasses.replace(cfg, router_aux_coef=0.0)
    _, g0 = make_grad_fn(no_aux, clip_norm=None)(params,
                                                 torch.from_numpy(toks))
    r, r0 = grads["layers"][0]["moe"]["router"], g0["layers"][0]["moe"][
        "router"]
    assert float((r - r0).abs().max()) > 1e-3 * float(r.abs().max())


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_generates_reference_tokens(arch, monkeypatch):
    """The serving engine in float32, greedy, batch 2, at the config's
    factor 1.25: prompts of 20–40 tokens left-padded within a wave, 8 new
    tokens each, against the reference engine, up to each request's
    first near tie (top-2 within 5e-3 of max |logit|); most tokens
    compared."""
    jcfg, cfg, tree, model = _pair(arch, seed=4)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (30, 40, 25, 20)]
    seen = []
    real = jengine.sample_token

    def recording(logits, *a, **kw):
        seen.append(np.asarray(logits, np.float32))
        return real(logits, *a, **kw)

    monkeypatch.setattr(jengine, "sample_token", recording)
    new = 8
    ref = jengine.ServingEngine(tree, jcfg, jengine.ServeConfig(
        batch=2, max_len=64, max_new_tokens=new)).generate(prompts)
    assert len(seen) == 2 * new
    got = ServingEngine(model, cfg, ServeConfig(
        batch=2, max_len=64, max_new_tokens=new)).generate(prompts)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_serve_and_train_reduced_model(arch, capsys):
    """``launch.serve --arch … --reduced --device cpu`` and
    ``launch.train`` of the same for three PSP ticks on the CPU, each
    tick logged with a finite loss."""
    run = serve.one_shot(["--arch", arch, "--reduced", "--device", "cpu",
                          "--requests", "2", "--batch", "2",
                          "--prompt-len", "24", "--max-len", "32",
                          "--max-new", "4"])
    assert [len(o) for o in run.outputs] == [4, 4]
    assert run.cfg.n_experts == 4 and run.cfg.d_model == 256
    assert train.main(["--device", "cpu", "--reduced", "--arch", arch,
                       "--d-model", "64", "--barrier", "pbsp", "--steps",
                       "3", "--seq", "24", "--batch", "2", "--log-every",
                       "1"]) == 0
    out = capsys.readouterr().out
    ticks = [line for line in out.splitlines() if line.startswith("tick")]
    assert len(ticks) == 3 and f"arch={arch}" in out
    assert all(np.isfinite(float(line.split()[3])) for line in ticks)
