"""The port's LM training path against the reference's: ``SyntheticLM``,
``loss_fn`` and its gradients, PSP ticks of the reduced LM, the
reference layout of the trees, softplus's gradient, and the training
launcher.

Models (``ARCHS``): ``reduced(get_config("qwen2-0.5b"))`` (GQA 2:1, hd 64
or 32 at d_model 256 or 64) and ``reduced(get_config("mamba2-780m"))``
(SSD heads of hd 16, N 32, one group; 32 or 8 heads at d_model 256 or
64; one chunk of the 40- or 16-step sequence), vocab 512, in float32
compute, remat on as in the configs, on the reference's ``init_model``
weights carried across by ``params_from_jax``, with the parameters the
init leaves constant redrawn from numpy so that they matter: qwen2's
norm gains and QKV biases; mamba2's norm gains (``ln``, ``norm``),
``dt_bias`` and ``D``.  Tolerances (float32 sums in another order): the
loss rtol 1e-5; every gradient and parameter leaf rtol 1e-4, atol
1e-5·max(1, max|leaf|).  PSP ticks run the reference's tick unjitted, op by
op (only its gradient function is compiled), and replay its draws into
the port (as ``tests/test_torch_spmd_psp.py`` does); their control
plane must be equal bit for bit.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.core import spmd_psp as jsp  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import init_model as jinit, loss_fn as jloss  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import (from_reference_layout,  # noqa: E402
                                 params_from_jax, to_reference_layout)
from repro_torch.core import spmd_psp as sp  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import (make_grad_fn,  # noqa: E402
                                      make_psp_train_step)
from repro_torch.models import loss_fn  # noqa: E402
from repro_torch.models.ssm import _softplus  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from test_torch_spmd_psp import CONTROL, _init_record, _tick_record  # noqa: E402,E501

ARCH = "qwen2-0.5b"
ARCHS = ("qwen2-0.5b", "mamba2-780m")
#: the small width per arch (mamba2's 16 projection blocks need 16 SSM
#: heads of 16: d_inner 256)
SMALL_D = {"qwen2-0.5b": 64, "mamba2-780m": 128}


def _pair(d_model=256, seed=0, arch=ARCH):
    """(reference cfg, port cfg, reference params (numpy), port tree)."""
    jcfg = dataclasses.replace(jreduced(jget(arch), d_model=d_model),
                               dtype="float32")
    cfg = dataclasses.replace(reduced(get_config(arch), d_model=d_model),
                              dtype="float32")
    assert cfg.remat and jcfg.remat
    tree = jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    g = tree["groups"]["0"]
    noise = lambda a, base: (base + 0.1 * rng.normal(size=a.shape)).astype(
        np.float32)
    if "ssd" in g:
        for k in ("dt_bias", "D", "ln", "norm"):
            g["ssd"][k] = noise(g["ssd"][k], 1.0 if k in ("ln", "norm")
                                else g["ssd"][k])
    else:
        for k in ("bq", "bk", "bv"):
            g["attn"][k] = noise(g["attn"][k], 0.0)
        for k in ("ln1", "ln2"):
            g[k] = noise(g[k], 1.0)
    return jcfg, cfg, tree, params_from_jax(tree, cfg).tree()


def _as_port(jtree, cfg):
    """A tree in the reference's layout (stacked groups) → the port's."""
    return params_from_jax(jax.tree.map(np.asarray, jtree), cfg).tree()


def _close_trees(got, want, what):
    for i, (g, w) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        w = w.numpy()
        np.testing.assert_allclose(
            g.detach().numpy(), w, rtol=1e-4,
            atol=1e-5 * max(1.0, float(np.abs(w).max())),
            err_msg=f"{what}: leaf {i}")


def test_synthetic_lm_replays_reference_tokens():
    """Same seed, same shard: the same int32 tokens, batch after batch."""
    want = iter(JSyntheticLM(512, 24, 3, seed=4, n_shards=2, shard=1))
    got = iter(SyntheticLM(512, 24, 3, seed=4, n_shards=2, shard=1))
    for _ in range(3):
        w, g = next(want)["tokens"], next(got)["tokens"]
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """``loss_fn`` and its gradients (remat on, chunked CE; mamba2's SSD
    through ``ops.ssd``'s autograd Function and the plain backward)
    against ``jax.value_and_grad(repro.models.loss_fn)``."""
    jcfg, cfg, tree, params = _pair(arch=arch)
    toks = np.random.default_rng(7).integers(0, 512, size=(2, 40)).astype(
        np.int32)
    (jl, _), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(toks)}, jcfg)
    grad_fn = make_grad_fn(cfg, clip_norm=None)
    loss, grads = grad_fn(params, torch.from_numpy(toks))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _close_trees(grads, _as_port(jg, cfg), "grads")
    with torch.no_grad():
        np.testing.assert_allclose(
            float(loss_fn(params, {"tokens": torch.from_numpy(toks)},
                          cfg)[0]), float(jl), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_psp_ticks_of_reduced_lm_match_reference(arch):
    """Three PSP ticks of a reduced LM (W 3, pbsp, AdamW on a warm-up
    cosine, clipped grads): the control plane bit for bit, the server
    parameters and AdamW moments within tolerance."""
    jcfg, cfg, tree, params = _pair(d_model=SMALL_D[arch], arch=arch)
    kw = dict(barrier="pbsp", n_workers=3, sample_size=2, staleness=1,
              straggler_frac=0.34)
    jp, tp = jsp.PSPConfig(**kw), sp.PSPConfig(**kw)
    jo = jopt.adamw(jopt.warmup_cosine(3e-3, 2, 10))
    to = topt.adamw(topt.warmup_cosine(3e-3, 2, 10))
    toks = np.random.default_rng(3).integers(0, 512, size=(3, 3, 2, 16))

    @jax.jit
    def jgrad(p, t):
        (loss, _), g = jax.value_and_grad(jloss, has_aux=True)(
            p, {"tokens": t}, jcfg)
        return loss, jopt.clip_by_norm(g, 1.0)

    # the tick itself unjitted, op by op (no contraction into an FMA);
    # only the gradient function is compiled
    js = jsp.psp_init(jp, jax.tree.map(jnp.asarray, tree), jo.init,
                      jax.random.PRNGKey(1))
    recs, states = [], []
    for t in range(3):
        recs.append(_tick_record(tp, js.key))
        js, _ = jsp.psp_train_step(jp, jgrad, jo.update, js,
                                   jnp.asarray(toks[t], jnp.int32))
        states.append(js)
    noise = sp.ReplayNoise(_init_record(3), recs)
    st = sp.psp_init(tp, params, to.init, noise)
    step = make_psp_train_step(cfg, tp, to, noise)
    for t in range(3):
        st, m = step(st, torch.from_numpy(toks[t].astype(np.int32)))
        js = states[t]
        for f in CONTROL:
            np.testing.assert_array_equal(getattr(st, f).numpy(),
                                          np.asarray(getattr(js, f)),
                                          err_msg=f"{f} after tick {t}")
        _close_trees(st.server_params, _as_port(js.server_params, cfg),
                     f"server params after tick {t}")
    assert int(st.total_pushes) > 0 and int(st.opt_state["step"]) > 0
    _close_trees(st.opt_state["mu"], _as_port(js.opt_state["mu"], cfg),
                 "AdamW mu")


def test_reference_layout_restacks_ssd_trees():
    """``to_reference_layout`` stacks a mamba2 tree's ``layers`` into the
    reference's ``groups`` (and behind a views axis), leaf for leaf the
    reference's tree; ``from_reference_layout`` undoes it."""
    _, cfg, tree, params = _pair(d_model=SMALL_D["mamba2-780m"],
                                 arch="mamba2-780m")
    got = to_reference_layout(params, cfg)
    assert set(got) == set(tree) and set(got["groups"]["0"]["ssd"]) == set(
        tree["groups"]["0"]["ssd"])
    for a, b in zip(jax.tree.leaves(tree), tree_leaves(got)):
        np.testing.assert_array_equal(b.numpy(), a)
    views = tree_map(lambda t: torch.stack([t, 2 * t]), params)
    stacked = to_reference_layout(views, cfg, axis=1)
    for a, b in zip(jax.tree.leaves(tree), tree_leaves(stacked)):
        np.testing.assert_array_equal(b[1].numpy(), 2 * a)
    back = from_reference_layout(got, cfg)
    for a, b in zip(tree_leaves(params), tree_leaves(back)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("x", [0.0, -30.0, -3.5, -1e-3, 1e-3, 0.7, 3.5,
                               30.0])
def test_softplus_gradient_matches_reference(x):
    """The port's softplus (mamba2's dt) against ``jax.nn.softplus``:
    the value, and the gradient ``jax.grad`` gives (sigmoid; 0.5 at 0,
    where autograd of max(x, 0) + log1p(exp(−|x|)) would give 1), within
    four float32 ulps (the two libraries' exp and log1p may round
    differently), and exactly 0.5 at 0."""
    t = torch.tensor(x, dtype=torch.float32, requires_grad=True)
    y = _softplus(t)
    (g,) = torch.autograd.grad(y, t)
    y = y.detach()
    want_y = float(jax.nn.softplus(jnp.float32(x)))
    want_g = float(jax.grad(jax.nn.softplus)(jnp.float32(x)))
    np.testing.assert_allclose(float(y), want_y, rtol=4.8e-7, atol=0)
    np.testing.assert_allclose(float(g), want_g, rtol=4.8e-7, atol=0)
    if x == 0.0:
        assert float(g) == want_g == 0.5


SMALL = ["--device", "cpu", "--reduced", "--steps", "2", "--seq", "16",
         "--batch", "2"]


def _small(arch):
    return [*SMALL, "--arch", arch, "--d-model", str(SMALL_D[arch])]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("barrier", ["none", "pbsp"])
def test_launcher_runs_on_cpu(barrier, arch, capsys):
    assert train.main([*_small(arch), "--barrier", barrier]) == 0
    out = capsys.readouterr().out
    assert "device=cpu" in out and ("tick" in out or "step" in out)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_raises_on_unported_flags(arch, tmp_path, capsys):
    """Every flag of the reference's launcher is ported: the checkpoint
    and publish flags run on the CPU (none raises NotImplementedError);
    only a CUDA run without a card raises."""
    ck, pub = str(tmp_path / "ck"), str(tmp_path / "pub")
    assert train.main([*_small(arch), "--barrier", "pbsp", "--ckpt-dir", ck,
                       "--save-every", "1", "--keep", "1", "--resume",
                       "--publish-dir", pub, "--publish-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "checkpoint: step 2" in out and "published 3 snapshots" in out
    assert sorted(os.listdir(ck)) == ["step_00000002.npz",
                                      "step_00000002.npz.json"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            train.main(["--reduced", "--steps", "1"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("barrier", ["none", "pbsp"])
def test_launcher_resume_continues_the_run(barrier, arch, tmp_path, capsys):
    """``--resume`` in-process: 2 steps, then 2 more from the checkpoint,
    end where 4 uninterrupted steps end, leaf for leaf."""
    mode = ["--barrier", barrier, "--save-every", "2"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    four = [*_small(arch), *mode, "--steps", "4"]
    assert train.main([*four, "--ckpt-dir", a]) == 0
    # the first leg runs the same schedule (--steps 4), killed after 2
    assert train.main([*four, "--ckpt-dir", b]) == 0
    os.remove(os.path.join(b, "step_00000004.npz"))
    assert train.main([*four, "--ckpt-dir", b, "--resume"]) == 0
    assert "resumed step 2" in capsys.readouterr().out
    with np.load(os.path.join(a, "step_00000004.npz")) as x, \
            np.load(os.path.join(b, "step_00000004.npz")) as y:
        assert set(x.files) == set(y.files)
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
