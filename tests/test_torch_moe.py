"""The port's MoE FFN (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``, no mesh: its unsharded path through
``_moe_core``), on the same numpy-seeded inputs.

Configurations: the reduced qwen3-moe-30b-a3b and dbrx-132b of both
packages (4 experts, top 2; d_model 256, d_ff 768 and 1024), and the
same with 16 experts top 4 where ties need more room; 2 × 24 tokens.
Inside the reference, the routing (its top-k indices and renormalised
weights) and the dispatch (each pair's slot, and whether it was kept)
are read from a transcription of ``_moe_core``'s lines, itself held bit
for bit to ``_moe_core``'s outputs first.

* float32: top-k indices, slots and drops exact; the renormalised
  weights exact from the reference's own probabilities
  (:func:`~repro_torch.models.moe.select`), and end to end within rtol
  1e-5, atol 1e-6 (the router products sum in another order, and the
  frameworks' ``exp`` differ in the last bit); y within 1e-5 of max
  |y|; the auxiliary loss within 1e-6 relative;
* a router that overloads one expert (tokens dropped at the capacity
  factor 1.25), and the same at factor 8.0 (none dropped);
* a router with duplicated columns: tied scores in every row, the lower
  expert first as in ``jax.lax.top_k``;
* bfloat16, with drops: the routing as in float32, y within 2e-2 of max
  |y| and most of its entries bit for bit (the expert products round in
  bf16 in both; each token's k contributions are added in ascending
  expert order, the order of the reference's scatter-add, so the sum
  itself rounds alike);
* gradients of x, the router and the three expert weights (with the
  auxiliary loss's) against ``jax.vjp`` in float32: rtol 1e-4, atol
  1e-5·max(1, max |g|).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ARCHS = ("qwen3-moe-30b-a3b", "dbrx-132b")
B, S = 2, 24


def _cfgs(arch, **changes):
    return (dataclasses.replace(jreduced(jget(arch)), **changes),
            dataclasses.replace(reduced(get_config(arch)), **changes))


def _inputs(cfg, seed, *, skew=0.0, tie=False):
    """x (B, S, D) and the four weights, numpy float32."""
    rng = np.random.default_rng(seed)
    D, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    router = 0.3 * rng.normal(size=(D, E))
    if tie:                       # expert 2j + 1 scores as expert 2j
        router[:, 1::2] = router[:, 0::2]
    x = rng.normal(size=(B, S, D))
    if skew:                      # a shared direction that expert 0 likes
        u = rng.normal(size=D)
        x += skew * u
        router[:, 0] += skew * u / np.linalg.norm(u) ** 2
    p = {"router": router,
         "w_gate": 0.05 * rng.normal(size=(E, D, f)),
         "w_up": 0.05 * rng.normal(size=(E, D, f)),
         "w_down": 0.05 * rng.normal(size=(E, f, D))}
    return (x.astype(np.float32),
            {k: v.astype(np.float32) for k, v in p.items()})


def _ref_core(x, router, w_gate, w_up, w_down, cfg, capacity):
    """``repro.models.moe._moe_core`` line for line (``first_expert`` 0,
    all experts local), returning its routing and dispatch as well."""
    T, D = x.shape
    E, k, dtype = cfg.n_experts, cfg.n_experts_per_token, x.dtype
    logits = (x @ router.astype(dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_i = jax.lax.top_k(probs, k)
    top_p = top_p / jnp.sum(top_p, axis=-1, keepdims=True)
    counts = jnp.zeros((E,), jnp.float32).at[top_i.reshape(-1)].add(1.0)
    aux = E * jnp.sum(counts / (T * k) * jnp.mean(probs, axis=0))
    flat_e = top_i.reshape(-1)
    flat_t = jnp.repeat(jnp.arange(T), k)
    order = jnp.argsort(flat_e)
    se, st, sw = flat_e[order], flat_t[order], top_p.reshape(-1)[order]
    group_start = jnp.searchsorted(se, jnp.arange(E))
    pos = jnp.arange(T * k) - group_start[se]
    ok = pos < capacity
    slot = jnp.where(ok, se * capacity + pos, E * capacity)
    buf = jnp.zeros((E * capacity + 1, D), dtype).at[slot].set(x[st])
    h = buf[:E * capacity].reshape(E, capacity, D)
    g = jnp.einsum("ecd,edf->ecf", h, w_gate.astype(dtype))
    u = jnp.einsum("ecd,edf->ecf", h, w_up.astype(dtype))
    o = jnp.einsum("ecf,efd->ecd", jax.nn.silu(g) * u, w_down.astype(dtype))
    o_flat = o.reshape(E * capacity, D)
    contrib = jnp.where(ok, sw, 0.0).astype(dtype)[:, None] * \
        o_flat[jnp.minimum(slot, E * capacity - 1)]
    y = jnp.zeros((T, D), dtype).at[st].add(
        jnp.where(ok[:, None], contrib, 0))
    # the dispatch back in the (token, choice) layout of top_i
    inv = jnp.argsort(order)
    return y, aux, {"probs": probs, "top_p": top_p, "top_i": top_i,
                    "slot": slot[inv].reshape(T, k),
                    "ok": ok[inv].reshape(T, k)}


def _both(arch, dtype, seed, **kw):
    """Run both packages on one input: (jcfg, cfg, x, p, reference
    (y, aux, parts), port (y, aux, parts))."""
    changes = kw.pop("changes", {})
    jcfg, cfg = _cfgs(arch, **changes)
    x, p = _inputs(cfg, seed, **kw)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    xt = x.reshape(B * S, -1)
    cap = moe.capacity(B * S, cfg)
    assert cap == jmoe._capacity(B * S, jcfg)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jy, jaux, jparts = _ref_core(jnp.asarray(xt, jdt), *jp.values(), jcfg,
                                 cap)
    y0, aux0 = jmoe._moe_core(jnp.asarray(xt, jdt), *jp.values(), jcfg, 0,
                              cap)
    np.testing.assert_array_equal(np.asarray(jy, np.float32),
                                  np.asarray(y0, np.float32))
    assert float(jaux) == float(aux0)
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p.items()}
    tx = torch.from_numpy(xt).to(tdt)
    top_p, top_i, aux = moe.route(tx, tp["router"], cfg)
    h, slot, ok = moe.dispatch(tx, top_i, cap, cfg.n_experts)
    o = moe.experts(h, tp["w_gate"], tp["w_up"], tp["w_down"])
    y = moe.combine(o, top_p, top_i, slot, ok)
    ty, taux = moe.moe_apply(tp, torch.from_numpy(x).to(tdt), cfg)
    assert torch.equal(ty.reshape(B * S, -1), y) and torch.equal(taux, aux)
    return (jcfg, cfg, x, p, (jy, jaux, jparts),
            (y, aux, {"top_p": top_p, "top_i": top_i, "slot": slot,
                      "ok": ok}))


def _check_routing(jparts, parts, k):
    """Indices, slots and drops exact; the weights exact from the
    reference's probabilities, and within rtol 1e-5, atol 1e-6 from the
    port's own."""
    for name in ("top_i", "slot", "ok"):
        np.testing.assert_array_equal(parts[name].numpy(),
                                      np.asarray(jparts[name]),
                                      err_msg=name)
    np.testing.assert_allclose(parts["top_p"].numpy(),
                               np.asarray(jparts["top_p"]), rtol=1e-5,
                               atol=1e-6)
    top_p, top_i = moe.select(torch.from_numpy(np.array(jparts["probs"])),
                              k)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jparts["top_i"]))
    np.testing.assert_array_equal(top_p.numpy(), np.asarray(jparts["top_p"]))


def _rel(want, got):
    want = np.asarray(want, np.float32)
    return float(np.abs(want - got.float().numpy()).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", ["drops", "factor8", "plain"])
def test_float32_routing_dispatch_and_output(arch, case):
    """float32: the routing and dispatch exact; y within 1e-5 of max |y|;
    aux within 1e-6.  ``drops``: one expert overloaded at factor 1.25
    (some pairs dropped); ``factor8``: the same input at factor 8.0
    (none dropped); ``plain``: an unskewed router at 1.25."""
    kw = {"skew": 0.0 if case == "plain" else 3.0}
    if case == "factor8":
        kw["changes"] = {"moe_capacity_factor": 8.0}
    jcfg, cfg, x, p, (jy, jaux, jparts), (y, aux, parts) = _both(
        arch, "float32", 1, **kw)
    _check_routing(jparts, parts, cfg.n_experts_per_token)
    dropped = int((~parts["ok"]).sum())
    if case == "drops":
        assert dropped > 0
    if case == "factor8":
        assert dropped == 0
    assert _rel(jy, y) <= 1e-5
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("experts", [(4, 2), (16, 4)])
def test_tied_router_scores_order_as_jax_top_k(arch, experts):
    """Every expert 2j + 1 scores exactly as expert 2j: every row's top k
    hold tied pairs, and the port picks and orders them as
    ``jax.lax.top_k`` (lower index first), with the slots that follow
    from that."""
    E, k = experts
    jcfg, cfg, x, p, (jy, _, jparts), (y, _, parts) = _both(
        arch, "float32", 2, tie=True,
        changes={"n_experts": E, "n_experts_per_token": k})
    jti = np.asarray(jparts["top_i"])
    # ties in every row: each pair's scores are equal in both packages
    scores = np.asarray(jax.nn.softmax(
        jnp.asarray(x.reshape(B * S, -1)) @ jnp.asarray(p["router"]), -1))
    assert (scores[:, 0::2] == scores[:, 1::2]).all()
    got = parts["top_i"].numpy()
    np.testing.assert_array_equal(got, jti)
    # of a tied pair taken whole, the even (lower) expert comes first
    assert (got[:, 0] % 2 == 0).all()
    assert np.any(got[:, 1] == got[:, 0] + 1)
    _check_routing(jparts, parts, cfg.n_experts_per_token)
    assert _rel(jy, y) <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_matches_reference(arch):
    """bfloat16 compute, at factor 1.25 with drops: where the float32
    logits of the two packages pick the same experts, so do the bf16
    ones here (the router product rounds alike); y within 2e-2 of max
    |y|, most entries bit for bit."""
    jcfg, cfg, x, p, (jy, jaux, jparts), (y, aux, parts) = _both(
        arch, "bfloat16", 3, skew=3.0)
    _check_routing(jparts, parts, cfg.n_experts_per_token)
    assert int((~parts["ok"]).sum()) > 0
    assert y.dtype == torch.bfloat16
    assert _rel(jy, y) <= 2e-2
    same = np.asarray(jy, np.float32) == y.float().numpy()
    assert same.mean() > 0.5, same.mean()
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("skew", [0.0, 3.0])
def test_gradients_match_jax_vjp(arch, skew):
    """Gradients of x, the router and the three expert weights, under a
    random cotangent of y and 1 of the auxiliary loss, against
    ``jax.vjp`` of ``moe_apply`` (float32; skew 3: with drops)."""
    jcfg, cfg = _cfgs(arch)
    x, p = _inputs(cfg, 4, skew=skew)
    rng = np.random.default_rng(5)
    dy = rng.normal(size=x.shape).astype(np.float32)
    names = ("router", "w_gate", "w_up", "w_down")

    def jf(x, *w):
        return jmoe.moe_apply(dict(zip(names, w)), x, jcfg)

    (jy, jaux), vjp = jax.vjp(jf, jnp.asarray(x),
                              *(jnp.asarray(p[n]) for n in names))
    jg = vjp((jnp.asarray(dy), jnp.ones((), jnp.float32)))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = {n: torch.from_numpy(p[n]).requires_grad_(True) for n in names}
    y, aux = moe.moe_apply(tw, tx, cfg)
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum() + aux,
                              [tx, *tw.values()])
    assert _rel(jy, y.detach()) <= 1e-5
    for name, g, w in zip(("x",) + names, got, jg):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=1e-4,
            atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=name)
    # the auxiliary loss alone: its gradient reaches x and the router
    # through the mean probabilities, not through the counts
    jg = vjp((jnp.zeros_like(jy), jnp.ones((), jnp.float32)))
    got = torch.autograd.grad(moe.moe_apply(tw, tx, cfg)[1],
                              [tx, tw["router"]])
    for name, g, w in zip(("x", "router"), got, jg[:2]):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(
            g.numpy(), w, rtol=1e-4,
            atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=name)


def test_capacity_matches_reference():
    """``capacity`` is ``_capacity`` at the token counts the engine and
    trainer use: qwen3-moe's 4 × 512 prefill 160, a 4-token decode step
    8, 2 × 512 training tokens 80; dbrx's prefill 640."""
    q, d = get_config("qwen3-moe-30b-a3b"), get_config("dbrx-132b")
    jq, jd = jget("qwen3-moe-30b-a3b"), jget("dbrx-132b")
    for cfg, jcfg, T, want in ((q, jq, 2048, 160), (q, jq, 4, 8),
                               (q, jq, 1024, 80), (d, jd, 2048, 640)):
        assert moe.capacity(T, cfg) == jmoe._capacity(T, jcfg) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_records_and_replays(arch):
    """``moe.routing`` records each call's experts (the top k of
    ``route``), and a replay of its own record gives the same output bit
    for bit; replaying other experts routes the tokens to them, at the
    call's own probabilities of those experts, renormalised (the
    reference's ``top_p`` gathered at the replayed indices)."""
    jcfg, cfg, x, p, (jy, _, jparts), (y, aux, parts) = _both(
        arch, "float32", 5)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x)
    with moe.routing() as rec:
        ty, taux = moe.moe_apply(tp, tx, cfg)
    assert len(rec) == 1 and torch.equal(rec[0], parts["top_i"])
    with moe.routing(rec) as again:
        ry, raux = moe.moe_apply(tp, tx, cfg)
    assert torch.equal(again[0], rec[0])
    assert torch.equal(ry, ty) and torch.equal(raux, taux)
    E, k = cfg.n_experts, cfg.n_experts_per_token
    other = (rec[0] + 1) % E             # still k distinct experts a token
    with moe.routing([other]) as own:
        top_p, top_i, _ = moe.route(tx.reshape(B * S, -1), tp["router"], cfg)
    assert torch.equal(own[0], rec[0]) and torch.equal(top_i, other)
    probs = np.asarray(jparts["probs"])
    want = np.take_along_axis(probs, other.numpy(), axis=1)
    np.testing.assert_allclose(top_p.numpy(), want / want.sum(-1,
                                                              keepdims=True),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(RuntimeError):
        with moe.routing(), moe.routing():
            pass
