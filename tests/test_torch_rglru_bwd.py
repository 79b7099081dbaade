"""The port's RG-LRU backward against the reference's autodiff.

``rglru_scan_bwd_ref`` (the plain backward: explicit formulas, the
reverse recurrence as a doubling scan) against ``jax.vjp`` of the
reference's scan, that is the lines of
``repro.models.rglru.rglru_apply`` from the gate pre-activations to
``cast(h)·gate`` with the reference's own constants (``_C``,
``_MAX_SQRT_ARG``), run eagerly; the transcription is first held to the
reference's block on the same weights, so that it is the reference's
scan.  Cotangents of x, r_pre, i_pre, Λ and the gate, h_last's cotangent
given and None, float32 and bfloat16.  Tolerances as a share of each
cotangent's max |reference|: float32 1e-4 (the reference's tree and the
port's doubling sum in other orders), bfloat16 2e-2 (a bf16 rounding of
the state or of a product moves a cotangent by a bf16 ulp).

The same function against torch autograd through ``rglru_scan_ref``
(float32 1e-5, bfloat16 within one bf16 ulp of max |autograd|: the
same roundings, summed in another order), with and without h0, the gate
and h_last's cotangent, and at the edge where ``r_pre`` is below −20:
``exp(2·log a)`` rounds to 1, ``mult`` is 0 and sqrt's gradient is
infinite, so dr_pre and dΛ are ±inf or NaN at the same places in both.
``ops.rglru_scan``'s ``_RGLRU`` Function on the CPU (the plain pair),
h_last's or y's cotangent alone arriving as None.  The forward's
entering states (``return_states``).  And the backward kernel's order
(``_kernel_order_bwd``, test code: the three launches of
``kernels/csrc/rglru_scan.cu`` rehearsed in float32: each 64-step tile's
map of the carried ``a·dh``, composed from h_last's cotangent through
the later tiles, then the tile's steps from last to first) against a
float64 reverse recurrence.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.rglru_scan import (  # noqa: E402
    C, SEG, rglru_scan_bwd_ref, rglru_scan_ref, softplus)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B, W = 2, 64
NAMES = ("dx", "dr_pre", "di_pre", "dlam", "dh0", "dgate")


def _inputs(S, dtype, seed, h0=True, gate=True, edge=False):
    """x, r_pre, i_pre, gate, dy (B, S, W) in ``dtype``; Λ (W,), h0 and
    dh (B, W) float32; numpy, seeded (the gate pre-activations ~ N(0,
    2²), Λ ~ U(−4, 4)); ``edge``: r_pre −30 at every 7th step and
    channel."""
    rng = np.random.default_rng(seed)
    t = lambda *shape, s=1.0: torch.from_numpy(
        (s * rng.normal(size=shape)).astype(np.float32))
    dt = DTYPES[dtype]
    x, rp, ip, g, dy = (t(B, S, W, s=2.0 if k in (1, 2) else 1.0)
                        for k in range(5))
    if edge:
        rp[:, ::7, ::7] = -30.0
    lam = torch.from_numpy(rng.uniform(-4, 4, W).astype(np.float32))
    h0_, dh = t(B, W), t(B, W)
    return (x.to(dt), rp.to(dt), ip.to(dt), lam, h0_ if h0 else None,
            g.to(dt) if gate else None, dy.to(dt), dh)


def _ref_scan(dtype):
    """The reference's scan (``rglru_apply``'s lines from the gate
    pre-activations on, its constants): (xb, r_pre, i_pre, Λ, gate) →
    (cast(h)·gate, h_last)."""
    def f(xb, r_pre, i_pre, lam, gate):
        r = jax.nn.sigmoid(r_pre.astype(jnp.float32))
        i = jax.nn.sigmoid(i_pre.astype(jnp.float32))
        log_a = -jrglru._C * jax.nn.softplus(lam.astype(jnp.float32)) * r
        a = jnp.exp(log_a)
        mult = jnp.sqrt(jnp.clip(1.0 - jnp.exp(2.0 * log_a), 0.0,
                                 jrglru._MAX_SQRT_ARG))
        bterm = mult * i * xb.astype(jnp.float32)

        def combine(c1, c2):
            return c1[0] * c2[0], c1[1] * c2[0] + c2[1]

        hs = jax.lax.associative_scan(combine, (a, bterm), axis=1)[1]
        return hs.astype(dtype) * gate, hs[:, -1]
    return f


def test_transcription_is_the_reference_scan():
    """``_ref_scan`` fed the reference block's own gate pre-activations
    (its ``_causal_conv`` and ``_block_diag`` on its weights) reproduces
    ``rglru_apply``'s output and prefill state bit for bit."""
    jcfg = jreduced(jget("recurrentgemma-2b"))
    p = jinit_params(jrglru.rglru_defs(jcfg), jax.random.PRNGKey(0),
                     dtype=jnp.float32)
    rng = np.random.default_rng(1)
    p["Lambda"] = jnp.asarray(rng.uniform(-2, 2, p["Lambda"].shape),
                              jnp.float32)
    x = jnp.asarray(rng.normal(size=(B, 40, jcfg.d_model)), jnp.float32)
    out, cache = jrglru.rglru_apply(p, x, cfg=jcfg, mode="prefill")
    gate = jax.nn.gelu(x @ p["w_y"], approximate=True)
    xb, _ = jrglru._causal_conv(x @ p["w_x"], p["conv_w"], p["conv_b"])
    r_pre = jrglru._block_diag(xb, p["a_gate_w"], p["a_gate_b"])
    i_pre = jrglru._block_diag(xb, p["i_gate_w"], p["i_gate_b"])
    y, h_last = _ref_scan(jnp.float32)(xb, r_pre, i_pre, p["Lambda"], gate)
    np.testing.assert_array_equal(np.asarray(y @ p["w_out"]),
                                  np.asarray(out))
    np.testing.assert_array_equal(np.asarray(h_last), np.asarray(cache["h"]))


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_ref_matches_reference_vjp(dtype, with_dh):
    """dx, dr_pre, di_pre, dΛ, dgate of ``rglru_scan_bwd_ref`` against
    ``jax.vjp`` of the reference's scan (h0 = 0, as the reference's
    train and prefill start), h_last's cotangent given or None (zero)."""
    x, rp, ip, lam, _, g, dy, dh = _inputs(150, dtype, seed=7)
    jdt = jnp.dtype(dtype)
    j = lambda t: jnp.asarray(t.float().numpy()).astype(
        jdt if t.dtype == DTYPES[dtype] else jnp.float32)
    _, vjp = jax.vjp(_ref_scan(jdt), j(x), j(rp), j(ip), j(lam), j(g))
    jdh = j(dh) if with_dh else jnp.zeros((B, W), jnp.float32)
    want = vjp((j(dy), jdh))
    got = rglru_scan_bwd_ref(x, rp, ip, lam, dy, None, g,
                             dh if with_dh else None)
    assert got[4] is None
    tol = 1e-4 if dtype == "float32" else 2e-2
    for name, w_, g_ in zip(("dx", "dr_pre", "di_pre", "dlam", "dgate"),
                            want, (*got[:4], got[5])):
        w_ = np.asarray(w_.astype(jnp.float32))
        assert g_.dtype == (torch.float32 if name == "dlam"
                            else DTYPES[dtype]), name
        err = np.abs(g_.float().numpy() - w_).max() / np.abs(w_).max()
        assert err <= tol, (name, err)


def _autograd(x, rp, ip, lam, h0, g, dy, dh):
    """Cotangents of ``rglru_scan_ref``'s inputs by torch autograd, in
    ``NAMES`` order (None for an input not given)."""
    ins = [t.detach().clone().requires_grad_(True) if t is not None
           else None for t in (x, rp, ip, lam, h0, g)]
    y, h_last = rglru_scan_ref(*ins)
    outs, cots = [y], [dy]
    if dh is not None:
        outs.append(h_last)
        cots.append(dh)
    leaves = [t for t in ins if t is not None]
    grads = iter(torch.autograd.grad(outs, leaves, cots))
    got = [next(grads) if t is not None else None for t in ins]
    return got[0], got[1], got[2], got[3], got[4], got[5]


def _close(got, want, dtype, what):
    """Equal non-finite entries; finite ones within 1e-5 of max |want|
    in float32 and one bf16 ulp of it in bfloat16."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    bad = ~torch.isfinite(want)
    assert torch.equal(bad, ~torch.isfinite(got)), what
    assert torch.equal(torch.isnan(want), torch.isnan(got)), what
    assert torch.equal(want[torch.isinf(want)], got[torch.isinf(got)]), what
    a, b = want.double()[~bad], got.double()[~bad]
    top = float(a.abs().max()) if a.numel() else 0.0
    tol = 1e-5 * top if dtype == "float32" else 2.0 ** -7 * top
    assert float((a - b).abs().max()) <= tol, what


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_ref_matches_autograd(dtype, with_h0, gated, with_dh):
    """Every cotangent of ``rglru_scan_bwd_ref`` against torch autograd
    through ``rglru_scan_ref`` on the same inputs."""
    x, rp, ip, lam, h0, g, dy, dh = _inputs(
        100, dtype, seed=11, h0=with_h0, gate=gated)
    dh = dh if with_dh else None
    want = _autograd(x, rp, ip, lam, h0, g, dy, dh)
    got = rglru_scan_bwd_ref(x, rp, ip, lam, dy, h0, g, dh)
    for name, a, b in zip(NAMES, got, want):
        assert (a is None) == (b is None), name
        if a is not None:
            _close(a, b, "float32" if name in ("dlam", "dh0") else dtype,
                   name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_ref_at_the_edge_matches_autograd(dtype):
    """r_pre = −30 every 7th step and channel: exp(2·log a) rounds to 1,
    mult is 0 and sqrt's gradient infinite; dr_pre (and dΛ on those
    channels) are non-finite in both at the same places, dx 0 there, and
    everything else agrees."""
    x, rp, ip, lam, h0, g, dy, dh = _inputs(100, dtype, seed=13, edge=True)
    want = _autograd(x, rp, ip, lam, h0, g, dy, dh)
    got = rglru_scan_bwd_ref(x, rp, ip, lam, dy, h0, g, dh)
    assert not torch.isfinite(want[1][:, ::7, ::7]).any()
    assert not torch.isfinite(want[3][::7]).any()
    assert (got[0][:, ::7, ::7] == 0).all()
    for name, a, b in zip(NAMES, got, want):
        _close(a, b, "float32" if name in ("dlam", "dh0") else dtype, name)


def test_rglru_function_on_the_cpu():
    """``ops.rglru_scan`` under autograd on CPU tensors runs ``_RGLRU`` with
    the plain pair: its gradients are ``rglru_scan_bwd_ref``'s, whether
    both outputs, y alone or h_last alone carry a cotangent (the unused
    one arrives as None)."""
    x, rp, ip, lam, h0, g, dy, dh = _inputs(70, "float32", seed=17)
    for use in ("both", "y", "h_last"):
        ins = [t.clone().requires_grad_(True) for t in (x, rp, ip, lam, h0,
                                                         g)]
        y, h_last = ops.rglru_scan(*ins)
        outs = {"both": [(y, dy), (h_last, dh)], "y": [(y, dy)],
                "h_last": [(h_last, dh)]}[use]
        torch.autograd.backward([o for o, _ in outs], [c for _, c in outs])
        want = rglru_scan_bwd_ref(
            x, rp, ip, lam, dy if use != "h_last" else torch.zeros_like(dy),
            h0, g, dh if use != "y" else None)
        for name, t, w_ in zip(NAMES, ins, want):
            assert torch.equal(t.grad, w_), (use, name)


@pytest.mark.parametrize("S", [1, 64, 130])
def test_states_are_the_h_entering_each_tile(S):
    """``return_states``: h0 entering the first 64-step tile, then h at
    the step before each later tile's first."""
    x, rp, ip, lam, h0, g, _, _ = _inputs(S, "float32", seed=S)
    y, h_last, st = rglru_scan_ref(x, rp, ip, lam, h0, g,
                                   return_states=True)
    assert st.shape == (B, -(-S // SEG), W) and st.dtype == torch.float32
    torch.testing.assert_close(st[:, 0], h0, rtol=0, atol=0)
    _, h_all = rglru_scan_ref(x, rp, ip, lam, h0)
    for s in range(1, st.shape[1]):
        _, h_at = rglru_scan_ref(x[:, :SEG * s], rp[:, :SEG * s],
                                 ip[:, :SEG * s], lam, h0)
        torch.testing.assert_close(st[:, s], h_at, rtol=1e-6, atol=1e-6)


def _kernel_order_bwd(a, g, dh_last):
    """dh_t = g_t + a_{t+1}·dh_{t+1} (dh_{S−1} = g_{S−1} + dh_last) in
    float32 in the backward kernel's order: each SEG-step tile's map c ↦
    A·c + P of the carry c = a·dh entering its last step (A the product
    of its a, P = a_{t0}·dh_{t0} at c = 0: ``bwd_map_kernel``); the carry
    entering a tile composed from dh_last through the maps of the later
    tiles, the last first, then the tile's steps from last to first
    (``bwd_main_kernel``).  Also returns dh0 = a_0·dh_0."""
    S = a.shape[1]
    nseg = -(-S // SEG)
    maps = []
    for s in range(nseg):
        t0, t1 = s * SEG, min(S, s * SEG + SEG)
        P = torch.zeros_like(a[:, 0])
        an = torch.zeros_like(P)
        A = torch.ones_like(P)
        for t in range(t1 - 1, t0 - 1, -1):
            P = g[:, t] + an * P
            an = a[:, t]
            A = A * a[:, t]
        maps.append((A, an * P))
    dh = torch.empty_like(g)
    c0 = None
    for s in range(nseg):
        c = dh_last.clone()
        for k in range(nseg - 1, s, -1):
            c = maps[k][0] * c + maps[k][1]
        for t in range(min(S, s * SEG + SEG) - 1, s * SEG - 1, -1):
            dh[:, t] = g[:, t] + c
            c = a[:, t] * dh[:, t]
        if s == 0:
            c0 = c
    return dh, c0


@pytest.mark.parametrize("S", [1, 37, 64, 65, 200])
def test_kernel_order_matches_float64_recurrence(S):
    """``_kernel_order_bwd`` against the reverse recurrence in float64,
    one step at a time: dh at 1e-5 of max |dh|, dh0 likewise."""
    rng = np.random.default_rng(S)
    lam = torch.from_numpy(rng.uniform(-4, 4, 100).astype(np.float32))
    rp = torch.from_numpy(2 * rng.normal(size=(B, S, 100)).astype(
        np.float32))
    a = torch.exp(-C * softplus(lam) * torch.sigmoid(rp))
    g = torch.from_numpy(rng.normal(size=(B, S, 100)).astype(np.float32))
    dh_last = torch.from_numpy(rng.normal(size=(B, 100)).astype(np.float32))
    got, dh0 = _kernel_order_bwd(a, g, dh_last)
    want = torch.empty_like(g, dtype=torch.float64)
    c = dh_last.double()
    for t in range(S - 1, -1, -1):
        want[:, t] = g[:, t].double() + c
        c = a[:, t].double() * want[:, t]
    scale = float(want.abs().max())
    assert float((got.double() - want).abs().max()) <= 1e-5 * scale
    assert float((dh0.double() - c).abs().max()) <= 1e-5 * scale
