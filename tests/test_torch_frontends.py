"""The modality models internvl2-2b and musicgen-large in the port against
the reference, on the same weights and the same frontend rows.

Both registered configs equal the reference's field for field, full and
reduced (2 ``attn`` layers, d_model 256, 16 frontend rows, vocab 512,
hd 64: internvl2 2 / 1 heads, RoPE, SwiGLU; musicgen 4 / 4, sinusoidal
positions, the GELU MLP).  The reduced models run on the reference's
``init_model`` weights with the norm gains redrawn from numpy so that
they matter, carried across by ``params_from_jax``; the frontend rows
are seeded N(0, 1) from numpy.  musicgen's fused QKV runs on a config
shrunk to 16 / 16 heads of 16: the reduced 4 heads do not fuse (4 % 16
≠ 0), exactly as in the reference.

Tolerances (max |Δ| / max |reference|): float32 compute 1e-4 for the
hidden states of a teacher-forced forward, the prefill's logits and
every decode step's; bfloat16 compute within 2e-2 or the reference's
own bf16 spread (its bf16 against its float32 compute on the same
inputs), whichever is larger.  ``sinusoidal_pos`` within 1.2e-7 in
float32 at musicgen's width over 8192 positions, its frequency vector
bit for bit.  Gradients as ``tests/test_torch_train.py`` holds them.
The engines' greedy tokens are compared in float32 up to each request's
first near tie (top-2 within 5e-3 of max |logit|), as
``tests/test_torch_moe_models.py`` compares them.
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
                          forward as _jforward, init_model as jinit,
                          loss_fn as jloss, prefill as _jprefill)
from repro.models import layers as jlayers  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.steps import make_grad_fn  # noqa: E402
from repro_torch.models import (decode_step, forward, init_model,  # noqa: E402
                                prefill)
from repro_torch.models.attention import fusable_qkv  # noqa: E402
from repro_torch.models.layers import (_sinusoid_freq, mlp_apply,  # noqa: E402
                                       sinusoidal_pos)
from repro_torch.serving import (InferenceServer, Request,  # noqa: E402
                                 ServeConfig, ServingEngine)
from test_torch_train import _as_port, _close_trees  # noqa: E402

ARCHS = ("internvl2-2b", "musicgen-large")
#: musicgen at 16 / 16 heads of 16: the reference fuses its q/k/v
FUSED = dict(n_heads=16, n_kv_heads=16, head_dim=16)
B, T, N = 2, 40, 4                      # batch, prompt tokens, decode steps
F32_TOL = 1e-4
#: the reference's jitted entry points, compiled once per config
jforward = jax.jit(_jforward, static_argnums=2,
                   static_argnames=("mode", "max_len"))
jprefill = jax.jit(_jprefill, static_argnums=2, static_argnames="max_len")
jdecode = jax.jit(_jdecode, static_argnums=3)


def _rel(want, got):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(want - np.asarray(got, np.float32)).max()
                 / np.abs(want).max())


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
    return jcfg, cfg, tree, params_from_jax(tree, cfg)


def _inputs(cfg, seed, n=T + N, batch=B):
    """Seeded tokens (batch, n) and frontend rows (batch, F, d) ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(batch, n)).astype(np.int32)
    emb = rng.normal(size=(batch, cfg.frontend_tokens, cfg.d_model))
    return toks, emb.astype(np.float32)


def _bf16_bound(run, arch, **changes):
    """2e-2, or the reference's own bf16 spread where larger: ``run(jcfg,
    tree)`` → a list of arrays, compared between bf16 and float32
    compute on the same weights."""
    j16, _, tree, _ = _pair(arch, "bfloat16", **changes)
    j32 = dataclasses.replace(j16, dtype="float32")
    return max([2e-2] + [_rel(b, a) for a, b in zip(run(j16, tree),
                                                    run(j32, tree))])


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    """The registered config and its ``reduced()`` equal the reference's
    field for field; the published sizes (``param_count``)."""
    for ours, ref in ((get_config(arch), jget(arch)),
                      (reduced(get_config(arch)), jreduced(jget(arch)))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    r = reduced(get_config(arch))
    assert (r.n_layers, r.d_model, r.frontend_tokens, r.vocab_size,
            r.head_dim) == (2, 256, 16, 512, 64)
    want = {"internvl2-2b": 1_889_144_832, "musicgen-large": 2_424_504_320}
    assert get_config(arch).param_count() == want[arch]
    model = init_model(get_config(arch), device="meta")
    assert model.blocks[0].attn.keys() == (
        {"wqkv", "wo"} if arch == "musicgen-large"
        else {"wq", "wk", "wv", "wo"})


def test_sinusoidal_pos_matches_reference():
    """At musicgen's width over positions 0..8191: the frequency vector
    bit for bit (numpy float64, rounded to float32 once, as the
    reference's meets its positions), the table within 1.2e-7."""
    d = get_config("musicgen-large").d_model
    half = d // 2
    want_freq = np.asarray(jnp.asarray(np.exp(
        -np.log(10_000.0) * np.arange(half, dtype=np.float32) / half)))
    got_freq = _sinusoid_freq(half, torch.device("cpu")).numpy()
    assert got_freq.dtype == want_freq.dtype == np.float32
    np.testing.assert_array_equal(got_freq, want_freq)
    pos = np.arange(8192, dtype=np.int32)
    want = np.asarray(jlayers.sinusoidal_pos(jnp.asarray(pos), d))
    got = sinusoidal_pos(torch.from_numpy(pos), d)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= 1.2e-7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_reference(dtype):
    """The plain GELU MLP (tanh GELU; ``w_up``, ``w_down``, no gate)
    against the reference's ``mlp_apply`` on the same weights."""
    jcfg, cfg, tree, model = _pair("musicgen-large", dtype)
    p = tree["groups"]["0"]["mlp"]
    assert set(p) == {"w_up", "w_down"}
    x = np.random.default_rng(3).normal(size=(B, 24, cfg.d_model)).astype(
        np.float32)
    jd = jnp.dtype(dtype)
    want = jlayers.mlp_apply({k: jnp.asarray(v[0]) for k, v in p.items()},
                             jnp.asarray(x, jd), jcfg)
    w = model.blocks[0].weights(getattr(torch, dtype))["mlp"]
    got = mlp_apply(w, torch.from_numpy(x).to(getattr(torch, dtype)), cfg)
    assert got.dtype == getattr(torch, dtype)
    assert _rel(want, got) <= (1e-5 if dtype == "float32" else 2e-2)


def _train_forward(jcfg, tree, toks, emb):
    h, _, _ = jforward(jax.tree.map(jnp.asarray, tree), jnp.asarray(toks),
                       jcfg, embeds=jnp.asarray(emb))
    return [h]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch, changes", [(a, {}) for a in ARCHS]
                         + [("musicgen-large", FUSED)])
def test_forward_with_embeds_matches_reference(arch, changes, dtype):
    """Teacher-forced hidden states (B, F + T, d) of frontend rows and
    tokens against the reference's ``forward``."""
    jcfg, cfg, tree, model = _pair(arch, dtype, **changes)
    assert fusable_qkv(cfg) == bool(changes)
    toks, emb = _inputs(cfg, 5)
    want = _train_forward(jcfg, tree, toks, emb)[0]
    got, cache = forward(model, torch.from_numpy(toks),
                         embeds=torch.from_numpy(emb))
    assert cache is None
    assert got.shape == (B, cfg.frontend_tokens + T + N, cfg.d_model)
    bound = (F32_TOL if dtype == "float32" else _bf16_bound(
        lambda j, t: _train_forward(j, t, toks, emb), arch, **changes))
    assert _rel(want, got) <= bound


def _prefill_decode(jcfg, tree, toks, emb, max_len):
    jp = jax.tree.map(jnp.asarray, tree)
    jl, jc = jprefill(jp, jnp.asarray(toks[:, :T]), jcfg,
                      embeds=jnp.asarray(emb), max_len=max_len)
    out = [jl]
    for i in range(N):
        jl, jc = jdecode(jp, jc, jnp.asarray(toks[:, T + i:T + i + 1]), jcfg)
        out.append(jl)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch, changes", [(a, {}) for a in ARCHS]
                         + [("musicgen-large", FUSED)])
def test_prefill_and_decode_with_embeds_match_reference(arch, changes,
                                                        dtype):
    """Prefill of F rows + T tokens (its clock F + T, its caches) and N
    decode steps (the positions, sinusoidal or RoPE, carried on from the
    cache's clock) against the reference's ``prefill`` / ``decode_step``."""
    jcfg, cfg, tree, model = _pair(arch, dtype, **changes)
    toks, emb = _inputs(cfg, 6)
    F = cfg.frontend_tokens
    max_len = F + T + N
    want = _prefill_decode(jcfg, tree, toks, emb, max_len)
    tl, tc = prefill(model, torch.from_numpy(toks[:, :T]),
                     embeds=torch.from_numpy(emb), max_len=max_len)
    assert tc["length"] == F + T
    for layer in tc["layers"]:
        assert layer["k"].shape == (B, max_len, cfg.n_kv_heads, cfg.head_dim)
    got = [tl]
    for i in range(N):
        tl, tc = decode_step(model, tc,
                             torch.from_numpy(toks[:, T + i:T + i + 1]))
        got.append(tl)
    assert tc["length"] == max_len
    bound = (F32_TOL if dtype == "float32" else _bf16_bound(
        lambda j, t: _prefill_decode(j, t, toks, emb, max_len), arch,
        **changes))
    for i, (w, g) in enumerate(zip(want, got)):
        assert _rel(w, g) <= bound, i
    with pytest.raises(ValueError, match="decode step"):
        model(torch.from_numpy(toks[:, :1]), embeds=torch.from_numpy(emb),
              cache=tc, mode="decode")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_with_embeds_match_reference(arch):
    """``loss_fn`` with ``batch["embeds"]`` (every token predicted from
    the position before it, the first from the last frontend row) and
    its gradients (float32, remat) against ``jax.value_and_grad``; the
    frontend rows change the loss."""
    jcfg, cfg, tree, model = _pair(arch, seed=2)
    toks, emb = _inputs(cfg, 8, n=24)
    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, tree),
        {"tokens": jnp.asarray(toks), "embeds": jnp.asarray(emb)}, jcfg)
    batch = {"tokens": torch.from_numpy(toks), "embeds": torch.from_numpy(emb)}
    loss, grads = make_grad_fn(cfg, clip_norm=None)(model.tree(), batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jm["ce"]), rtol=1e-5)
    _close_trees(grads, _as_port(jg, cfg), "grads")
    plain, _ = make_grad_fn(cfg, clip_norm=None)(model.tree(), batch[
        "tokens"])
    jplain, _ = jloss(jax.tree.map(jnp.asarray, tree),
                      {"tokens": jnp.asarray(toks)}, jcfg)
    np.testing.assert_allclose(float(plain), float(jplain), rtol=1e-5)
    assert abs(float(plain) - float(loss)) > 1e-4


@pytest.mark.parametrize("arch, changes", [(a, {}) for a in ARCHS]
                         + [("musicgen-large", FUSED)])
def test_params_round_trip_exactly(arch, changes):
    """``params_from_jax`` then ``params_to_numpy``: every leaf of the
    reference's tree back bit for bit (the GELU MLP's ``w_up`` /
    ``w_down``, the fused ``wqkv``, the untied ``lm_head``)."""
    _, cfg, tree, model = _pair(arch, **changes)
    back = params_to_numpy(model)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(leaves) == len(jax.tree.leaves(back))
    keys = {p[-1].key for p, _ in leaves}
    assert "lm_head" in keys
    assert ({"w_up", "w_down"} <= keys) == (arch == "musicgen-large")
    assert ("wqkv" in keys) == bool(changes)
    for path, a in leaves:
        b = back
        for p in path:
            b = b[p.key]
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def _serve_cfg(**kw):
    base = dict(batch=2, max_len=48, max_new_tokens=6)
    base.update(kw)
    return ServeConfig(**base)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_generates_reference_tokens(arch, monkeypatch):
    """Both engines in float32, greedy, batch 2, on the same weights and
    each request's own frontend rows (prompts of 7–14 tokens,
    left-padded within a wave; 6 new tokens): the port's tokens are the
    reference's up to each request's first near tie, most compared."""
    jcfg, cfg, tree, model = _pair(arch, seed=4)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (10, 14, 7, 12)]
    embeds = rng.normal(size=(4, cfg.frontend_tokens, cfg.d_model)).astype(
        np.float32)
    seen = []
    real = jengine.sample_token

    def recording(logits, *a, **kw):
        seen.append(np.asarray(logits, np.float32))
        return real(logits, *a, **kw)

    monkeypatch.setattr(jengine, "sample_token", recording)
    new = 6
    ref = jengine.ServingEngine(tree, jcfg, jengine.ServeConfig(
        batch=2, max_len=48, max_new_tokens=new)).generate(prompts, embeds)
    assert len(seen) == 2 * new
    eng = ServingEngine(model, cfg, _serve_cfg())
    got = eng.generate(prompts, list(embeds))
    assert eng.prefill_calls == 2
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
    with pytest.raises(ValueError, match="embeddings"):
        eng.generate(prompts, list(embeds[:3]))


def test_engine_rounds_rows_to_bf16_and_zero_fills():
    """The engine rounds a block's rows to bfloat16 before the prefill in
    float32 compute too (as the reference's engine), and serves a
    request without rows as one with zero rows."""
    _, cfg, _, model = _pair("internvl2-2b")
    F, d = cfg.frontend_tokens, cfg.d_model
    prompt = np.arange(1, 9, dtype=np.int32)
    emb = np.random.default_rng(1).normal(size=(F, d)).astype(np.float32)
    rounded = torch.from_numpy(emb).bfloat16().float().numpy()
    assert not np.array_equal(rounded, emb)
    out = {}
    for name, rows in (("raw", emb), ("rounded", rounded),
                       ("none", None), ("zeros", np.zeros((F, d)))):
        out[name] = ServingEngine(model, cfg, _serve_cfg()).generate(
            [prompt], None if rows is None else [rows])[0]
    np.testing.assert_array_equal(out["raw"], out["rounded"])
    np.testing.assert_array_equal(out["none"], out["zeros"])
    logits, _ = prefill(model, torch.from_numpy(prompt[None]),
                        embeds=torch.from_numpy(rounded[None]))
    assert int(logits.argmax(-1)[0]) == out["raw"][0]


@pytest.mark.parametrize("arch", ARCHS)
def test_per_wave_embeds(arch):
    """The port's twin of the reference's ``test_per_wave_embeds``: waves
    after the first decode against their own requests' rows, each equal
    to the request served alone with its rows, and the rows change the
    tokens."""
    cfg = reduced(get_config(arch))
    model = init_model(cfg, seed=0)
    eng = ServingEngine(model, cfg, ServeConfig(batch=2, max_new_tokens=4))
    prompt = np.asarray([1, 2, 3, 4], np.int32)
    rng = np.random.default_rng(0)
    embeds = (rng.normal(size=(4, cfg.frontend_tokens, cfg.d_model)) * 3
              ).astype(np.float32)
    outs = eng.generate([prompt] * 4, embeds=list(embeds))
    for i in (2, 3):
        solo = ServingEngine(model, cfg, ServeConfig(batch=2,
                                                     max_new_tokens=4))
        want = solo.generate([prompt], embeds=[embeds[i]])[0]
        np.testing.assert_array_equal(outs[i], want, err_msg=str(i))
    assert not all(np.array_equal(outs[0], outs[i]) for i in (2, 3))


@pytest.mark.parametrize("arch", ARCHS)
def test_left_padded_admission_with_frontend(arch):
    """A request admitted into a running group (F > 0) is left-padded to
    the group's clock less its F rows, and decodes exactly as that
    padded prompt served alone with its own rows; the admission needs
    prompt + F ≤ the clock, so a prompt too long for it opens a group of
    its own."""
    cfg = reduced(get_config(arch))
    F = cfg.frontend_tokens
    model = init_model(cfg, seed=0)
    rng = np.random.default_rng(2)
    rows = lambda: rng.normal(size=(F, cfg.d_model)).astype(np.float32)
    eng = ServingEngine(model, cfg, _serve_cfg(batch=4, max_len=64,
                                               max_groups=2))
    for lo in (1, 2):
        eng.submit(Request(prompt=np.arange(lo, lo + 7, dtype=np.int32),
                           embed=rows()))
    eng.step()
    eng.step()
    g = eng._groups[0]
    clock = g.length
    assert clock == 7 + F + 2
    late, late_rows = np.arange(3, 6, dtype=np.int32), rows()
    rid = eng.submit(Request(prompt=late, embed=late_rows))
    eng.admit_queued()
    assert len(eng._groups) == 1 and g.length == clock
    big = eng.submit(Request(prompt=np.arange(1, clock - F + 2,
                                              dtype=np.int32)))
    eng.admit_queued()          # a free slot, but prompt + F > the clock
    assert len(eng._groups) == 2 and len(g.free()) == 1
    assert eng._groups[1].length == clock + 1
    comps = {c.req_id: c for c in eng.drain()}
    assert len(comps[big].tokens) == 6
    solo = ServingEngine(model, cfg, _serve_cfg())
    padded = np.concatenate([np.zeros(clock - F - late.size, np.int32), late])
    sid = solo.submit(Request(prompt=padded, embed=late_rows))
    want = {c.req_id: c for c in solo.drain()}
    np.testing.assert_array_equal(comps[rid].tokens, want[sid].tokens)


def test_submit_counts_frontend_and_checks_shape():
    """``submit`` counts F in a request's need (prompt + F + max_new ≤
    max_len) and refuses rows of the wrong shape."""
    cfg = reduced(get_config("musicgen-large"))
    eng = ServingEngine(init_model(cfg, seed=0), cfg,
                        _serve_cfg(max_len=30, max_new_tokens=6))
    F = cfg.frontend_tokens
    ok = np.ones(30 - F - 6, np.int32)
    eng.submit(Request(prompt=ok))
    with pytest.raises(ValueError, match=f"frontend {F}"):
        eng.submit(Request(prompt=np.ones(ok.size + 1, np.int32)))
    with pytest.raises(ValueError, match="embed shape"):
        eng.submit(Request(prompt=ok, embed=np.zeros((F - 1, cfg.d_model))))
    eng.submit(Request(prompt=ok, embed=np.zeros((F, cfg.d_model))))


def test_server_readmits_request_with_its_rows():
    """A decode-worker death re-admits every live request from the
    server's own copy: the re-decoded completion is the uninterrupted
    one, its frontend rows included."""
    cfg = reduced(get_config("internvl2-2b"))
    model = init_model(cfg, seed=0)
    rng = np.random.default_rng(4)
    emb = (rng.normal(size=(cfg.frontend_tokens, cfg.d_model)) * 3).astype(
        np.float32)
    prompt = np.arange(1, 6, dtype=np.int32)
    scfg = _serve_cfg(max_new_tokens=12)
    want = ServingEngine(model, cfg, scfg).generate([prompt], [emb])[0]
    zero = ServingEngine(model, cfg, scfg).generate([prompt])[0]
    assert not np.array_equal(want, zero)
    eng, box = ServingEngine(model, cfg, scfg), {}
    real_step = eng.step

    def step():                 # the worker dies after its second step
        out = real_step()
        box["steps"] = box.get("steps", 0) + 1
        if box["steps"] == 2:
            box["srv"].inject_worker_fault()
        return out

    eng.step = step
    with InferenceServer(eng) as srv:
        box["srv"] = srv
        comp = srv.submit(Request(prompt=prompt, embed=emb)).result(
            timeout=120)
    assert srv.stats.worker_restarts == 1 and srv.stats.readmitted == 1
    np.testing.assert_array_equal(comp.tokens, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_serve_and_train_reduced_model(arch, capsys):
    """``launch.serve --arch … --reduced --device cpu`` (no rows: the
    engine zero-fills them) and ``one_shot`` with each request's rows,
    and ``launch.train`` of the same (tokens only) for three PSP ticks
    on the CPU, each tick logged with a finite loss."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--requests",
            "2", "--batch", "2", "--prompt-len", "8", "--max-len", "32",
            "--max-new", "4"]
    run = serve.one_shot(argv)
    F = run.cfg.frontend_tokens
    assert F == 16 and [len(o) for o in run.outputs] == [4, 4]
    assert run.prefill_tokens == 2 * (8 + F)
    rows = [np.full((F, run.cfg.d_model), 3.0 * i, np.float32)
            for i in (1, -1)]
    given = serve.one_shot(argv, embeds=rows)
    assert given.embeds is rows
    assert any(not np.array_equal(a, b)
               for a, b in zip(run.outputs, given.outputs))
    with pytest.raises(ValueError, match="embeddings"):
        serve.one_shot(argv, embeds=rows[:1])
    assert train.main(["--device", "cpu", "--reduced", "--arch", arch,
                       "--d-model", "64", "--barrier", "pbsp", "--steps",
                       "3", "--seq", "24", "--batch", "2", "--log-every",
                       "1"]) == 0
    out = capsys.readouterr().out
    ticks = [line for line in out.splitlines() if line.startswith("tick")]
    assert len(ticks) == 3 and f"arch={arch}" in out
    assert all(np.isfinite(float(line.split()[3])) for line in ticks)
