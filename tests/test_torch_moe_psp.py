"""PSP training of the reduced qwen3-moe-30b-a3b against the reference's,
and its PSP archives read across the packages.

The reduced model of both packages at d_model 64 (2 ``moe`` layers of 4
experts, top 2, d_ff 256; 4 query heads on one KV head of 16; vocab
512), float32 compute, on the reference's ``init_model`` weights with
the norm gains redrawn from numpy, carried across by
``params_from_jax``:

* three PSP ticks (W 3, ``pbsp``, AdamW on a warm-up cosine, clipped
  gradients, 2 × 40 tokens a worker, the config's capacity factor 1.25)
  as ``tests/test_torch_local_psp.py`` runs danube's: the
  reference's tick op by op with its draws replayed into the port
  (``ReplayNoise``); the control plane bit for bit, the server
  parameters and AdamW's moments within ``tests/test_torch_train.py``'s
  tolerances;
* a port PSP checkpoint (the experts' ``(E, d, f)`` leaves stacked to
  ``(G, E, d, f)``, behind W in the views) restored by the reference bit
  for bit, and a reference PSP checkpoint restored by the port through
  ``launch.train.restore_psp`` bit for bit; a port snapshot read by the
  reference's strict ``SnapshotWatcher`` bit for bit, and a reference
  snapshot by the port's.
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
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.checkpoint.checkpoint import _flatten as jflatten  # noqa: E402
from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.core import spmd_psp as jsp  # noqa: E402
from repro.models import init_model as jinit, loss_fn as jloss  # noqa: E402
from repro.serving import snapshot_bus as jbus  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.checkpoint.checkpoint import _flatten  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.core import spmd_psp as sp  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import make_psp_train_step  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving import SnapshotPublisher, SnapshotWatcher  # noqa: E402,E501
from test_torch_spmd_psp import CONTROL, _init_record, _tick_record  # noqa: E402,E501
from test_torch_train import _as_port, _close_trees  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"


def _train_pair(seed=0):
    """(reference cfg, port cfg, reference params (numpy), port tree)."""
    jcfg = dataclasses.replace(jreduced(jget(ARCH), d_model=64),
                               dtype="float32")
    cfg = dataclasses.replace(reduced(get_config(ARCH), d_model=64),
                              dtype="float32")
    tree = jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    for k in ("ln1", "ln2"):
        a = tree["groups"]["0"][k]
        tree["groups"]["0"][k] = (1.0 + 0.1 * rng.normal(size=a.shape)
                                  ).astype(np.float32)
    return jcfg, cfg, tree, params_from_jax(tree, cfg).tree()


def test_psp_ticks_of_reduced_qwen3_moe_match_reference():
    """Three PSP ticks: the control plane bit for bit, the server params
    and AdamW's first moment within tolerance, after every tick."""
    jcfg, cfg, tree, params = _train_pair()
    assert cfg.remat and cfg.moe_capacity_factor == 1.25
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


def _states(cfg, tree, params):
    kw = dict(barrier="pbsp", n_workers=2, sample_size=1, staleness=3,
              straggler_frac=0.25)
    js = jsp.psp_init(jsp.PSPConfig(**kw), jax.tree.map(jnp.asarray, tree),
                      jopt.adamw(3e-3).init, jax.random.PRNGKey(1))
    noise = sp.GeneratorNoise(1)
    st = sp.psp_init(sp.PSPConfig(**kw), params, topt.adamw(3e-3).init,
                     noise)
    return js, st, noise


def test_port_checkpoint_and_snapshot_read_by_reference(tmp_path):
    """A port PSP checkpoint restores in the reference bit for bit (the
    experts under ``server_params/groups/0/moe/`` as ``(G, E, d, f)``,
    ``[W, G, E, d, f]`` in the views), and back in the port through
    ``restore_psp``; a port snapshot of the server params is restored by
    the reference's strict ``SnapshotWatcher`` bit for bit."""
    jcfg, cfg, tree, params = _train_pair(seed=1)
    js, st, noise = _states(cfg, tree, params)
    d = str(tmp_path / "ck")
    save_checkpoint(d, 3, train.psp_archive(st, noise, cfg))
    tpl = {k: v for k, v in jsp.state_to_tree(js).items() if k != "key"}
    got, step = jrestore(d, tpl)
    assert step == 3
    want = _flatten(train.psp_archive(st, noise, cfg))
    got = jflatten(got)
    assert set(got) == set(want) - {"noise_state"}
    E, D, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert got["server_params/groups/0/moe/w_gate"].shape == (2, E, D, f)
    assert got["views/groups/0/moe/w_down"].shape == (2, 2, E, f, D)
    for k, v in got.items():
        assert np.array_equal(v, want[k]), k
    back, _ = train.restore_psp(d, st, noise, cfg, reseed=2)
    again = _flatten(train.psp_archive(back, noise, cfg))
    for k, v in want.items():
        assert np.array_equal(again[k], v), k

    snaps = str(tmp_path / "snaps")
    server = Model(cfg, st.server_params)
    with SnapshotPublisher(snaps, cfg, async_write=False) as pub:
        pub.publish(5, server)
    restored, version = jbus.SnapshotWatcher(snaps, tree, strict=True).poll()
    assert version == 5
    flat_a = jax.tree_util.tree_flatten_with_path(restored)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(
        params_to_numpy(server))[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert np.array_equal(np.asarray(leaf), flat_b[path]), path


def test_reference_checkpoint_and_snapshot_read_by_port(tmp_path):
    """A reference PSP checkpoint (its state after one tick, so that
    the views, moments and control plane are not their initial values)
    restores in the port through ``restore_psp`` with every leaf equal
    to the reference's; a reference snapshot of its server params loads
    into the port's ``SnapshotWatcher`` as a model whose tree is the
    reference's bit for bit."""
    jcfg, cfg, tree, params = _train_pair(seed=2)
    js, st, noise = _states(cfg, tree, params)
    jo = jopt.adamw(3e-3)

    def jgrad(p, t):
        (loss, _), g = jax.value_and_grad(jloss, has_aux=True)(
            p, {"tokens": t}, jcfg)
        return loss, g

    toks = np.random.default_rng(4).integers(0, 512, size=(2, 2, 24))
    js, _ = jsp.psp_train_step(jsp.PSPConfig(
        barrier="pbsp", n_workers=2, sample_size=1, staleness=3,
        straggler_frac=0.25), jgrad, jo.update, js,
        jnp.asarray(toks, jnp.int32))
    d = str(tmp_path / "ck")
    jsave(d, 1, jsp.state_to_tree(js))
    back, step = train.restore_psp(d, st, noise, cfg, reseed=2)
    assert step == 1
    want = jflatten(jsp.state_to_tree(js))
    got = _flatten(train.psp_archive(back, noise, cfg))
    assert set(got) == set(want) - {"key"} | {"noise_state"}
    assert want["views/groups/0/moe/w_up"].shape == (
        2, 2, cfg.n_experts, cfg.d_model, cfg.d_ff)
    for k, v in want.items():
        if k != "key":
            assert np.array_equal(got[k], np.asarray(v)), k

    snaps = str(tmp_path / "snaps")
    server = jax.tree.map(np.asarray, js.server_params)
    jbus.SnapshotPublisher(snaps, async_write=False).publish(7, server)
    model, version = SnapshotWatcher(snaps, params_to_numpy(
        Model(cfg, params)), cfg, "cpu").poll()
    assert version == 7
    flat = dict(jax.tree_util.tree_flatten_with_path(
        params_to_numpy(model))[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(server)[0]:
        assert np.array_equal(flat[path], leaf), path
