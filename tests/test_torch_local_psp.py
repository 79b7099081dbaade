"""PSP training of the sliding-window and local/global decoders against
the reference's: three PSP ticks of the reduced h2o-danube-1.8b, and
the port's PSP checkpoints and snapshots of qwen1.5-4b and gemma2-27b
(untied ``lm_head``, fused ``wqkv``, post-norms, two pattern
positions) read by the reference.  Models, weights and tolerances as
``tests/test_torch_local_train.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.core import spmd_psp as jsp  # noqa: E402
from repro.models import loss_fn as jloss  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.core import spmd_psp as sp  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import make_psp_train_step  # noqa: E402
from test_torch_local_global import FUSED  # noqa: E402
from test_torch_local_train import _train_pair  # noqa: E402
from test_torch_spmd_psp import CONTROL, _init_record, _tick_record  # noqa: E402,E501
from test_torch_train import _as_port, _close_trees  # noqa: E402


def test_psp_ticks_of_reduced_danube_match_reference():
    """Three PSP ticks of the reduced h2o-danube-1.8b (d_model 64 under
    its 4 heads of 64; W 3, pbsp, AdamW on a warm-up cosine, clipped
    grads, 72 tokens a sequence: past the window) as
    ``tests/test_torch_train.py`` runs them for qwen2: the control plane
    bit for bit, the server parameters and AdamW moments within
    tolerance."""
    jcfg, cfg, tree, params = _train_pair("h2o-danube-1.8b", d_model=64)
    kw = dict(barrier="pbsp", n_workers=3, sample_size=2, staleness=1,
              straggler_frac=0.34)
    jp, tp = jsp.PSPConfig(**kw), sp.PSPConfig(**kw)
    jo = jopt.adamw(jopt.warmup_cosine(3e-3, 2, 10))
    to = topt.adamw(topt.warmup_cosine(3e-3, 2, 10))
    toks = np.random.default_rng(3).integers(0, 512, size=(3, 3, 2, 72))

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


@pytest.mark.parametrize("arch, changes", [("qwen1.5-4b", {}),
                                           ("gemma2-27b", {}),
                                           ("gemma2-27b", FUSED)])
def test_archives_keep_the_reference_layout(arch, changes, tmp_path):
    """A port PSP checkpoint (``lm_head``, ``wqkv``, the post-norms and
    both pattern positions' groups, in the state, AdamW's moments and the
    views) restores in the reference bit for bit, and back in the port
    through ``launch.train.restore_psp``; a port snapshot of the server
    params is restored by the reference's strict ``SnapshotWatcher`` bit
    for bit."""
    from repro.checkpoint import restore_checkpoint as jrestore
    from repro.checkpoint.checkpoint import _flatten as jflatten
    from repro.serving import snapshot_bus as jbus
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.convert import params_to_numpy
    from repro_torch.models import Model
    from repro_torch.serving import SnapshotPublisher
    jcfg, cfg, tree, params = _train_pair(arch, **changes)
    kw = dict(barrier="pbsp", n_workers=2, sample_size=2, staleness=3,
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
    assert any(k.startswith("server_params/groups/") for k in got)
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
