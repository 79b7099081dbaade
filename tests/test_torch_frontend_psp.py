"""PSP training of the reduced musicgen-large against the reference's,
and its PSP archives read by the reference.

The reduced model of both packages at d_model 64 (2 ``attn`` layers, 4
query heads on 4 KV heads of 16, sinusoidal positions, the GELU MLP,
d_ff 256, vocab 512, 16 frontend rows that the trainer does not feed:
both packages' trainers feed tokens only), float32 compute, on the
reference's ``init_model`` weights with the norm gains redrawn from
numpy, carried across by ``params_from_jax``:

* three PSP ticks (W 3, ``pbsp``, AdamW on a warm-up cosine, clipped
  gradients, 2 × 40 tokens a worker) as ``tests/test_torch_moe_psp.py``
  runs qwen3-moe's: the reference's tick op by op with its draws
  replayed into the port (``ReplayNoise``); the control plane bit for
  bit, the server parameters and AdamW's first moment within
  ``tests/test_torch_train.py``'s tolerances;
* a port PSP checkpoint of musicgen at 16 / 16 heads (the fused
  ``wqkv`` and the GELU MLP's ``w_up`` / ``w_down`` behind W in the
  views) restored by the reference bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.checkpoint import restore_checkpoint as jrestore  # noqa: E402
from repro.checkpoint.checkpoint import _flatten as jflatten  # noqa: E402
from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.core import spmd_psp as jsp  # noqa: E402
from repro.models import init_model as jinit, loss_fn as jloss  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.checkpoint.checkpoint import _flatten  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import spmd_psp as sp  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import make_psp_train_step  # noqa: E402
from test_torch_spmd_psp import CONTROL, _init_record, _tick_record  # noqa: E402,E501
from test_torch_train import _as_port, _close_trees  # noqa: E402

ARCH = "musicgen-large"
#: musicgen at 16 / 16 heads of 16: the reference fuses its q/k/v
FUSED = dict(n_heads=16, n_kv_heads=16, head_dim=16)


def _train_pair(seed=0, **changes):
    """(reference cfg, port cfg, reference params (numpy), port tree)."""
    jcfg = dataclasses.replace(jreduced(jget(ARCH), d_model=64),
                               dtype="float32", **changes)
    cfg = dataclasses.replace(reduced(get_config(ARCH), d_model=64),
                              dtype="float32", **changes)
    tree = jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    for k in ("ln1", "ln2"):
        a = tree["groups"]["0"][k]
        tree["groups"]["0"][k] = (1.0 + 0.1 * rng.normal(size=a.shape)
                                  ).astype(np.float32)
    return jcfg, cfg, tree, params_from_jax(tree, cfg).tree()


def test_psp_ticks_of_reduced_musicgen_match_reference():
    """Three PSP ticks: the control plane bit for bit, the server params
    and AdamW's first moment within tolerance, after every tick."""
    jcfg, cfg, tree, params = _train_pair()
    assert cfg.remat and cfg.pos_embed == "sinusoidal"
    assert set(params["layers"][0]["mlp"]) == {"w_up", "w_down"}
    kw = dict(barrier="pbsp", n_workers=3, sample_size=2, staleness=1,
              straggler_frac=0.34)
    jp, tp = jsp.PSPConfig(**kw), sp.PSPConfig(**kw)
    jo = jopt.adamw(jopt.warmup_cosine(3e-3, 2, 10))
    to = topt.adamw(topt.warmup_cosine(3e-3, 2, 10))
    toks = np.random.default_rng(3).integers(0, 512, size=(3, 3, 2, 40))

    @jax.jit
    def jgrad(p, t):
        (loss, _), g = jax.value_and_grad(jloss, has_aux=True)(
            p, {"tokens": t}, jcfg)
        return loss, jopt.clip_by_norm(g, 1.0)

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
        st, _ = step(st, torch.from_numpy(toks[t].astype(np.int32)))
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


def test_port_checkpoint_read_by_reference(tmp_path):
    """A port PSP checkpoint of musicgen at 16 / 16 heads restores in the
    reference bit for bit: ``wqkv`` as ``(G, d, 16, 3, hd)`` under
    ``server_params/groups/0/attn/``, ``[W, G, …]`` in the views, the
    GELU MLP's ``w_up`` / ``w_down`` beside it."""
    jcfg, cfg, tree, params = _train_pair(seed=1, **FUSED)
    kw = dict(barrier="pbsp", n_workers=2, sample_size=1, staleness=3,
              straggler_frac=0.25)
    js = jsp.psp_init(jsp.PSPConfig(**kw), jax.tree.map(jnp.asarray, tree),
                      jopt.adamw(3e-3).init, jax.random.PRNGKey(1))
    noise = sp.GeneratorNoise(1)
    st = sp.psp_init(sp.PSPConfig(**kw), params, topt.adamw(3e-3).init,
                     noise)
    d = str(tmp_path / "ck")
    save_checkpoint(d, 3, train.psp_archive(st, noise, cfg))
    tpl = {k: v for k, v in jsp.state_to_tree(js).items() if k != "key"}
    got, step = jrestore(d, tpl)
    assert step == 3
    want = _flatten(train.psp_archive(st, noise, cfg))
    got = jflatten(got)
    assert set(got) == set(want) - {"noise_state"}
    D, hd = cfg.d_model, cfg.head_dim
    assert got["server_params/groups/0/attn/wqkv"].shape == (2, D, 16, 3, hd)
    assert got["views/groups/0/mlp/w_up"].shape == (2, 2, D, cfg.d_ff)
    for k, v in got.items():
        assert np.array_equal(v, want[k]), k
