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
(``_kernel_order_bwd``, test code: the composition order of
``kernels/csrc/rglru_scan.cu``'s backward rehearsed in float32, its
block shape read from the source: each chunk's maps, the warp's shuffle
scans and the warps in order, forward for h from the h entering each
64-step tile and backward for the carried ``a·dh``, chained from the
last segment's tile to the first, the steps past S masked out of the
carry) against a float64 recurrence, at the kernel's block shape and at
one other.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
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


def _bwd_constants():
    """(threads a block, steps a tile, threads across a tile's row) of
    the backward kernel, as ``rglru_scan.cu`` defines them."""
    text = (_build.CSRC / "rglru_scan.cu").read_text()
    get = lambda name: int(re.search(rf"constexpr int {name} = (\d+);",
                                     text).group(1))
    return get("BWD_THREADS"), get("BWD_SEG"), get("BWD_GROUPS")


def _warp_scan(A, P, cpw, later_first):
    """The warp's Hillis–Steele shuffle scan over its ``cpw`` chunks
    (dim 3) of the maps x ↦ A·x + P: earlier chunks first (``__shfl_up``,
    h) or later ones first (``__shfl_down``, the carry)."""
    off = 1
    while off < cpw:
        if later_first:
            An = torch.cat([A[:, :, :, off:], torch.ones_like(A[:, :, :, :off])],
                           3)
            Pn = torch.cat([P[:, :, :, off:],
                            torch.zeros_like(P[:, :, :, :off])], 3)
            live = (torch.arange(cpw) + off < cpw).view(cpw, 1)
        else:
            An = torch.cat([torch.ones_like(A[:, :, :, :off]),
                            A[:, :, :, :-off]], 3)
            Pn = torch.cat([torch.zeros_like(P[:, :, :, :off]),
                            P[:, :, :, :-off]], 3)
            live = (torch.arange(cpw) >= off).view(cpw, 1)
        P = torch.where(live, A * Pn + P, P)
        A = torch.where(live, A * An, A)
        off *= 2
    return A, P


def _kernel_order_bwd(a, b, g, h0, dh_last, threads, seg, groups):
    """The backward kernel's order in float32 (every product and sum
    rounded alone, as its ``-fmad=false`` build), for the maps h ↦ a·h + b
    (forward) and c ↦ a·(g + c) of the carry c = a_{t+1}·dh_{t+1}
    (backward): a tile is ``seg`` steps, a chunk L = seg·groups / threads
    steps of a thread, ``32 / groups`` chunks a warp.  Each chunk composes
    its maps (h's first step first, the carry's last step first, steps
    past S the identity: their a and g are poisoned here, as the zero
    fill would make them wrong), the warp's chunks by ``_warp_scan``, the
    warps' maps are applied in order to the h entering the tile (h0 in the
    first; the forward's h handed from tile to tile) and in reverse to the
    carry entering it (dh_last in the last segment, else the carry the
    next segment's tile left), each chunk's from its warp's through the
    chunks before (h) or after (the carry) it; then each chunk's steps:
    h forward from the h entering it, dh_t = g_t + c and c = a_t·dh_t
    from its last step.  Returns (h_{t−1}, dh, dh0 = a_0·dh_0).

    A mirror of the order, not the kernel: it shares only the constants
    read from the source, so it checks that the chosen order is sound in
    float32; the kernel itself is checked only on a card (``chip_smoke.py``
    phase 5 and ``tests/test_torch_cuda.py``)."""
    Bn, S, W = a.shape
    nch, cpw, nwarp = threads // groups, 32 // groups, threads // 32
    L = seg // nch
    nseg = -(-S // seg)
    pad = nseg * seg - S
    shape = (Bn, nseg, nwarp, cpw, L, W)
    fill = lambda t, v: torch.cat([t, torch.full((Bn, pad, W), v)], 1).view(
        shape)
    a, b, g = fill(a, 0.5), fill(b, 0.0), fill(g, 1.0)
    live = (torch.arange(nseg * seg) < S).view(1, nseg, nwarp, cpw, L, 1)
    # h: the chunks' maps, the warps', the tiles' entering h in order
    A, H = a[..., 0, :], b[..., 0, :]
    for k in range(1, L):
        H = a[..., k, :] * H + b[..., k, :]
        A = A * a[..., k, :]
    A, H = _warp_scan(A, H, cpw, later_first=False)
    h = h0.clone()
    hw = torch.empty(Bn, nseg, nwarp, W)
    for s in range(nseg):
        for w in range(nwarp):
            hw[:, s, w] = h
            h = A[:, s, w, -1] * h + H[:, s, w, -1]
    hw = hw[:, :, :, None]
    hc = torch.cat([hw, A[:, :, :, :-1] * hw + H[:, :, :, :-1]], 3)
    # the carry: the chunks' maps from their last step, the warps' later
    # ones first, the tiles from the last segment
    Ac, Pc = torch.ones_like(A), torch.zeros_like(A)
    for k in range(L - 1, -1, -1):
        ok = live[..., k, :]
        Pc = torch.where(ok, a[..., k, :] * (g[..., k, :] + Pc), Pc)
        Ac = torch.where(ok, a[..., k, :] * Ac, Ac)
    Ac, Pc = _warp_scan(Ac, Pc, cpw, later_first=True)
    c = dh_last.clone()
    cw = torch.empty(Bn, nseg, nwarp, W)
    for s in range(nseg - 1, -1, -1):
        for w in range(nwarp - 1, -1, -1):
            cw[:, s, w] = c
            c = Ac[:, s, w, 0] * c + Pc[:, s, w, 0]
    dh0 = c
    cw = cw[:, :, :, None]
    cc = torch.cat([Ac[:, :, :, 1:] * cw + Pc[:, :, :, 1:], cw], 3)
    # each chunk's steps
    hp, dh = torch.empty(shape), torch.empty(shape)
    for k in range(L):
        hp[..., k, :] = hc
        hc = a[..., k, :] * hc + b[..., k, :]
    for k in range(L - 1, -1, -1):
        dh[..., k, :] = g[..., k, :] + cc
        cc = torch.where(live[..., k, :], a[..., k, :] * dh[..., k, :], cc)
    cut = lambda t: t.reshape(Bn, nseg * seg, W)[:, :S]
    return cut(hp), cut(dh), dh0


def _order_case(S, shape):
    """_kernel_order_bwd at ``shape`` (threads, steps a tile, threads
    across a row) against the float64 recurrence: h_{t−1} within 1e-5 of max |h|,
    dh and dh0 within 1e-5 of max |dh|; W 100, h0 and dh_last drawn."""
    rng = np.random.default_rng(S)
    W_ = 100
    f = lambda *s, sc=1.0: torch.from_numpy(
        (sc * rng.normal(size=s)).astype(np.float32))
    lam = torch.from_numpy(rng.uniform(-4, 4, W_).astype(np.float32))
    rp, ip, x = f(B, S, W_, sc=2.0), f(B, S, W_, sc=2.0), f(B, S, W_)
    g, h0, dh_last = f(B, S, W_), f(B, W_), f(B, W_)
    log_a = -C * softplus(lam) * torch.sigmoid(rp)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 0.0, 1.0)) \
        * torch.sigmoid(ip) * x
    hp, dh, dh0 = _kernel_order_bwd(a, b, g, h0, dh_last, *shape)
    ad, bd = a.double(), b.double()
    h = h0.double()
    want_h = torch.empty(B, S, W_, dtype=torch.float64)
    for t in range(S):
        want_h[:, t] = h
        h = ad[:, t] * h + bd[:, t]
    want = torch.empty_like(want_h)
    c = dh_last.double()
    for t in range(S - 1, -1, -1):
        want[:, t] = g[:, t].double() + c
        c = ad[:, t] * want[:, t]
    scale_h = float(want_h.abs().max())
    assert float((hp.double() - want_h).abs().max()) <= 1e-5 * scale_h
    scale = float(want.abs().max())
    assert float((dh.double() - want).abs().max()) <= 1e-5 * scale
    assert float((dh0.double() - c).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("S", [1, 37, 64, 65, 200])
def test_kernel_order_matches_float64_recurrence(S):
    """``_kernel_order_bwd`` at the kernel's block shape (read from
    ``rglru_scan.cu``) against the float64 recurrences: S inside one
    tile, a whole tile, one step into a second (63 masked steps first in
    the carry's walk), several."""
    _order_case(S, _bwd_constants())


@pytest.mark.parametrize("S", [1, 37, 64, 65, 200])
def test_kernel_order_at_another_block_shape(S):
    """The same at blocks of 128 threads (4 steps a chunk)."""
    threads, seg, groups = _bwd_constants()
    _order_case(S, (128, seg, groups))
