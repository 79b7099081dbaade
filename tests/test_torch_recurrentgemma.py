"""recurrentgemma-2b (Griffin: RG-LRU blocks and local attention, an
(R, R) tail) in the port against the reference, on the same weights.

The reduced model of both packages (``reduced``: one (R, R, A) group and
the (R, R) tail, d_model 256, recurrence width 256 in 2 gate blocks, 2
query heads on 1 KV head of 64, window 64, vocab 512), on the
reference's ``init_model`` weights with ``Lambda``, the gate and conv
biases and the norm gains redrawn from numpy so that they matter,
carried across by ``params_from_jax`` (the tail under ``tail`` in the
reference's tree):

* prefill of S 96 tokens (past the window) and 4 decode steps, logits
  and every layer's cache against the reference's ``prefill`` /
  ``decode_step``, in float32 and bfloat16 compute.  Tolerances as
  ``tests/test_torch_local_global.py`` (max |Δ| / max |logits|): float32
  1e-4 at prefill and 5e-3 in decode, bfloat16 2e-2; the caches (ring
  keys and values, the RG-LRU conv and f32 states) within 5e-3 of their
  largest entry in float32 (one bf16 ulp of a cache entry, a state fed
  by matrix products summed in another order) and 2e-2 in bfloat16;
* ``loss_fn`` and its gradients (float32, remat) against
  ``jax.value_and_grad`` (``tests/test_torch_train.py``'s tolerances);
* ``params_from_jax`` / ``params_to_numpy``: the reference's tree back
  bit for bit, tail included; a snapshot the port publishes, restored by
  the reference's strict watcher bit for bit;
* the serving engine's greedy tokens against the reference engine's, up
  to each request's first near tie (``tests/test_torch_local_serving.py``);
* the launcher serving and training the reduced model on the CPU.
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
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.steps import make_grad_fn  # noqa: E402
from repro_torch.models import decode_step, init_cache, prefill  # noqa: E402
from repro_torch.serving import ServeConfig, ServingEngine  # noqa: E402
from test_torch_local_global import B, N, S, TOL, W, _rel, _tokens  # noqa: E402,E501
from test_torch_local_global import jdecode, jprefill  # noqa: E402
from test_torch_train import _as_port, _close_trees  # noqa: E402

ARCH = "recurrentgemma-2b"
#: the caches' tolerance, as a share of their largest entry
CACHE_TOL = {"float32": 5e-3, "bfloat16": 2e-2}


def _pair(dtype, seed=0):
    """(reference cfg, port cfg, reference params (numpy), port model)."""
    jcfg = dataclasses.replace(jreduced(jget(ARCH)), dtype=dtype)
    cfg = dataclasses.replace(reduced(get_config(ARCH)), dtype=dtype)
    tree = jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    draw = lambda a, mean, sd: (mean + sd * rng.normal(size=a.shape)).astype(
        np.float32)
    for blocks in (tree["groups"], tree["tail"]):
        for blk in blocks.values():
            for k in ("ln1", "ln2"):
                blk[k] = draw(blk[k], 0.0, 0.1)   # the gemma gain is 1 + w
            if "rglru" in blk:
                p = blk["rglru"]
                for k in ("conv_b", "a_gate_b", "i_gate_b"):
                    p[k] = draw(p[k], 0.0, 0.3)
                p["Lambda"] = draw(p["Lambda"], 0.0, 1.0)
    tree["final_norm"] = draw(tree["final_norm"], 0.0, 0.1)
    return jcfg, cfg, tree, params_from_jax(tree, cfg)


def _ref_layer(jc, cfg, i):
    """Layer i's cache in the reference's tree (stacked groups, tail)."""
    n, kind = len(cfg.layer_pattern), cfg.layer_kinds()[i]
    key = "attn" if kind == "local" else kind
    if i >= cfg.n_groups * n:
        return jc["tail"][str(i - cfg.n_groups * n)][key]
    return jax.tree.map(lambda a: a[i // n], jc["groups"][str(i % n)][key])


def _check_caches(tc, jc, cfg, dtype):
    for i, (kind, layer) in enumerate(zip(cfg.layer_kinds(), tc["layers"])):
        ref = _ref_layer(jc, cfg, i)
        names = ("k", "v") if kind == "local" else ("conv", "h")
        assert set(layer) == set(names), (i, set(layer))
        for name in names:
            want = np.asarray(ref[name], np.float32)
            assert layer[name].shape == want.shape, (i, name)
            if kind == "local":
                assert want.shape[1] == W and layer[name].dtype == (
                    torch.bfloat16)
            assert _rel(want, layer[name]) <= CACHE_TOL[dtype], (i, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    """Prefill logits and caches at S 96 > window 64, then 4 decode steps
    (the ring wraps, the RG-LRU states carry on), against
    ``repro.models.prefill`` / ``decode_step``."""
    jcfg, cfg, tree, model = _pair(dtype)
    assert cfg.layer_kinds() == ("rglru", "rglru", "local", "rglru", "rglru")
    tol_prefill, tol_decode = TOL[dtype]
    toks = _tokens(cfg, 7)
    jp = jax.tree.map(jnp.asarray, tree)
    jl, jc = jprefill(jp, jnp.asarray(toks[:, :S]), jcfg, max_len=S + N)
    tl, tc = prefill(model, torch.from_numpy(toks[:, :S]), max_len=S + N)
    assert tl.dtype == torch.float32 and tl.shape == (B, cfg.vocab_size)
    assert _rel(jl, tl) <= tol_prefill
    assert tc["length"] == int(jc["length"]) == S
    _check_caches(tc, jc, cfg, dtype)
    for i in range(N):
        step = toks[:, S + i:S + i + 1]
        jl, jc = jdecode(jp, jc, jnp.asarray(step), jcfg)
        tl, tc = decode_step(model, tc, torch.from_numpy(step))
        assert _rel(jl, tl) <= tol_decode, i
    assert tc["length"] == S + N
    _check_caches(tc, jc, cfg, dtype)


def test_loss_and_grads_match_reference():
    """``loss_fn`` and its gradients (remat, the plain RG-LRU scan under
    autograd, the tail) against ``jax.value_and_grad``, float32."""
    jcfg, cfg, tree, model = _pair("float32", seed=3)
    assert cfg.remat
    params = model.tree()
    toks = np.random.default_rng(5).integers(0, 512, size=(2, 96)).astype(
        np.int32)
    (jl, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True),
                          static_argnums=2)(
        jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(toks)}, jcfg)
    loss, grads = make_grad_fn(cfg, clip_norm=None)(params,
                                                    torch.from_numpy(toks))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _close_trees(grads, _as_port(jg, cfg), "grads")


def test_params_and_snapshots_round_trip_with_the_tail(tmp_path):
    """The reference's tree (groups and tail) through ``params_from_jax``
    and ``params_to_numpy`` bit for bit; a port snapshot restored by the
    reference's strict ``SnapshotWatcher`` bit for bit."""
    from repro.serving import snapshot_bus as jbus
    from repro_torch.serving import SnapshotPublisher
    _, cfg, tree, model = _pair("float32", seed=2)
    assert set(tree["tail"]) == {"0", "1"}
    back = params_to_numpy(model)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(leaves) == len(jax.tree.leaves(back))
    for path, a in leaves:
        b = back
        for p in path:
            b = b[p.key]
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    snaps = str(tmp_path / "snaps")
    with SnapshotPublisher(snaps, cfg, async_write=False) as pub:
        pub.publish(3, model)
    restored, version = jbus.SnapshotWatcher(snaps, tree, strict=True).poll()
    assert version == 3
    for path, leaf in jax.tree_util.tree_flatten_with_path(restored)[0]:
        b = back
        for p in path:
            b = b[p.key]
        assert np.array_equal(np.asarray(leaf), b), path


def test_cache_defs():
    """``init_cache`` at full width: a local layer's ring of the window's
    2048 slots of one KV head of 256; an RG-LRU layer's bf16 conv state
    (K − 1 = 3 rows) and f32 state of the recurrence width."""
    cfg = get_config(ARCH)
    cache = init_cache(cfg, 4, 8192, device="meta")
    assert len(cache["layers"]) == 26
    for kind, layer in zip(cfg.layer_kinds(), cache["layers"]):
        if kind == "local":
            assert layer["k"].shape == (4, 2048, 1, 256)
        else:
            assert layer["conv"].shape == (4, 3, 2560)
            assert layer["conv"].dtype == torch.bfloat16
            assert layer["h"].shape == (4, 2560)
            assert layer["h"].dtype == torch.float32


def test_engine_generates_reference_tokens(monkeypatch):
    """The serving engine in float32, greedy, batch 2: prompts of 66–90
    tokens (past the window) left-padded within a wave, 8 new tokens
    each, against the reference engine, up to each request's first near
    tie (top-2 within 5e-3 of max |logit|); most tokens compared."""
    jcfg, cfg, tree, model = _pair("float32", seed=2)
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
    assert len(seen) == 2 * new
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


def test_launchers_serve_and_train_reduced_model(capsys):
    """``launch.serve --arch recurrentgemma-2b --reduced --device cpu``
    past the window, and ``launch.train`` of the same for three PSP ticks
    on the CPU, each tick logged with a finite loss."""
    run = serve.one_shot(["--arch", ARCH, "--reduced", "--device", "cpu",
                          "--requests", "2", "--batch", "2",
                          "--prompt-len", "70", "--max-len", "80",
                          "--max-new", "4"])
    assert [len(o) for o in run.outputs] == [4, 4]
    assert train.main(["--device", "cpu", "--reduced", "--arch", ARCH,
                       "--d-model", "64", "--barrier", "pbsp", "--steps",
                       "3", "--seq", "80", "--batch", "2", "--log-every",
                       "1"]) == 0
    out = capsys.readouterr().out
    ticks = [line for line in out.splitlines() if line.startswith("tick")]
    assert len(ticks) == 3 and f"arch={ARCH}" in out
    assert all(np.isfinite(float(line.split()[3])) for line in ticks)
