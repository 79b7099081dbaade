"""The port's RG-LRU block and scan against the reference's.

``repro_torch.models.rglru.rglru_apply`` against
``repro.models.rglru.rglru_apply`` on the same weights and inputs (numpy,
seeded), at the reduced recurrentgemma width (d_model 256, recurrence
width 256 in 2 gate blocks of 128, conv 4), S 96: train, prefill (its
conv state and last h), and 4 decode steps chained from the prefill's
cache, in float32 and bfloat16.  The reference's ``Lambda`` and the
gate and conv biases are redrawn from numpy so that they matter.
Tolerances, as a share of max |reference output|: float32 1e-5 (the
reference's ``associative_scan`` and the port's doubling scan sum in
other orders), bfloat16 2e-2 (one bf16 rounding of the state before the
gate, as in both packages, moves an output by a bf16 ulp); the f32 state
within 1e-5 of its largest entry in float32 and 1e-3 in bfloat16 (its
inputs carry the bf16 roundings of the conv and gate products); the conv
state (the input projection's last K−1 rows) within the outputs'
tolerance (the two packages' matrix products sum in other orders).

``rglru_scan_ref`` against a float64 sequential recurrence (1e-5 of max
|h|, with and without h0, with and without the gate), and its
gradients (through ``rglru_apply``, float32) against ``jax.vjp`` of the
reference's block, 1e-4 of each leaf's largest entry (through
``ops.rglru_scan``'s ``_RGLRU`` Function: ``rglru_scan_bwd_ref``).  On
the kernel path (``impl="cuda"``) under autograd ``ops.rglru_scan``
reaches the kernel's checks, which refuse CPU tensors, as do the
backward kernel's.

The CUDA kernel's order of composition, rehearsed in plain PyTorch
(``_kernel_order_scan``, test code only: it checks the soundness of the
order, not the kernel, which runs only on a card): each thread's chunk of steps composed in order, the warp's
chunks by its shuffle scan, the warps' maps carried in order from the h
entering the tile, and that h handed from one segment's tile to the
next; the constants are read from ``kernels/csrc/rglru_scan.cu`` (and one
other block shape).  Against the float64 oracle at 1e-5 of max |h|, at
S 1 (the decode kernel's order), 37, a segment + 1 and three segments +
1, W 100 (not a multiple of a 16-byte vector or a tile's row), with and
without h0, gated and ungated.
"""
import dataclasses
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
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.rglru_scan import (  # noqa: E402
    C, rglru_scan_bwd_cuda, rglru_scan_ref, softplus)
from repro_torch.models.rglru import F32_PARAMS, rglru_apply  # noqa: E402

ARCH = "recurrentgemma-2b"
B, S, N = 2, 96, 4
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 1e-3)}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(dtype):
    return (dataclasses.replace(jreduced(jget(ARCH)), dtype=dtype),
            dataclasses.replace(reduced(get_config(ARCH)), dtype=dtype))


def _weights(jcfg, seed=0):
    """The reference's initialisation, Λ and the biases redrawn (numpy)."""
    tree = jax.tree.map(np.asarray, jinit_params(
        jrglru.rglru_defs(jcfg), jax.random.PRNGKey(seed),
        dtype=jnp.float32))
    rng = np.random.default_rng(seed + 1)
    for k in ("conv_b", "a_gate_b", "i_gate_b"):
        tree[k] = (0.3 * rng.normal(size=tree[k].shape)).astype(np.float32)
    tree["Lambda"] = rng.uniform(-2.0, 2.0, tree["Lambda"].shape).astype(
        np.float32)
    return tree


def _port(tree, dtype):
    """The port's weights: all but ``Lambda`` in the compute dtype."""
    return {k: torch.from_numpy(v.copy()) if k in F32_PARAMS
            else torch.from_numpy(v.copy()).to(DTYPES[dtype])
            for k, v in tree.items()}


def _x(cfg, dtype, n=S, seed=3):
    x = np.random.default_rng(seed).normal(size=(B, n, cfg.d_model))
    return x.astype(np.float32)


def _rel(want, got):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(want - got.float().detach().numpy()).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_apply_matches_reference(dtype):
    """Train and prefill outputs, the prefill cache, then decode steps
    chained from it, against the reference's ``rglru_apply``."""
    jcfg, cfg = _cfgs(dtype)
    tree = _weights(jcfg)
    jp, p = jax.tree.map(jnp.asarray, tree), _port(tree, dtype)
    tol, tol_h = TOL[dtype]
    xs = _x(cfg, dtype, S + N)
    jx = jnp.asarray(xs).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(xs).to(DTYPES[dtype])
    for mode in ("train", "prefill"):
        jo, jc = jrglru.rglru_apply(jp, jx[:, :S], cfg=jcfg, mode=mode)
        to, tc = rglru_apply(p, tx[:, :S], cfg=cfg, mode=mode)
        assert to.dtype == DTYPES[dtype] and to.shape == (B, S, cfg.d_model)
        assert _rel(jo, to) <= tol, mode
    assert tc["h"].dtype == torch.float32 and tc["h"].shape == (
        B, cfg.lru_width)
    assert tc["conv"].dtype == DTYPES[dtype] and tc["conv"].shape == (
        B, cfg.conv_width - 1, cfg.lru_width)
    assert _rel(jc["h"], tc["h"]) <= tol_h
    assert _rel(jc["conv"], tc["conv"]) <= tol
    for i in range(N):
        step = slice(S + i, S + i + 1)
        jo, jc = jrglru.rglru_apply(jp, jx[:, step], cfg=jcfg, cache=jc,
                                    mode="decode")
        to, tc = rglru_apply(p, tx[:, step], cfg=cfg, cache=tc,
                             mode="decode")
        assert _rel(jo, to) <= tol, i
        assert _rel(jc["h"], tc["h"]) <= tol_h, i
        assert _rel(jc["conv"], tc["conv"]) <= tol, i


def _oracle(x, r_pre, i_pre, lam, h0):
    """The recurrence in float64, one step at a time."""
    f = lambda t: t.double()
    r, i = torch.sigmoid(f(r_pre)), torch.sigmoid(f(i_pre))
    sp = torch.nn.functional.softplus(f(lam))
    log_a = -8.0 * sp * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1 - torch.exp(2 * log_a), 0, 1)) * i * f(x)
    h = f(h0) if h0 is not None else torch.zeros_like(a[:, 0])
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, 1)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S_", [1, 37, 96])
def test_scan_ref_matches_sequential_oracle(S_, with_h0):
    """The doubling scan ≡ the step-by-step recurrence (float64), with
    and without h0; y gated and ungated; h_last its last step."""
    rng = np.random.default_rng(S_)
    W = 64
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32))
    x, rp, ip, gate = (t(B, S_, W) for _ in range(4))
    lam = torch.from_numpy(rng.uniform(-3, 3, W).astype(np.float32))
    h0 = t(B, W) if with_h0 else None
    want = _oracle(x, rp, ip, lam, h0)
    scale = float(want.abs().max())
    y, h_last = rglru_scan_ref(x, rp, ip, lam, h0)
    assert y.dtype == h_last.dtype == torch.float32
    assert float((y.double() - want).abs().max()) <= 1e-5 * scale
    assert float((h_last.double() - want[:, -1]).abs().max()) <= 1e-5 * scale
    yg, _ = rglru_scan_ref(x, rp, ip, lam, h0, gate)
    assert float((yg.double() - want * gate.double()).abs().max()) <= (
        1e-5 * float((want * gate.double()).abs().max()))


def test_gradients_match_reference_vjp():
    """∂(⟨out, g⟩) with respect to x and every weight, float32, through
    the plain scan, against ``jax.vjp`` of the reference's block."""
    jcfg, cfg = _cfgs("float32")
    tree = _weights(jcfg, seed=4)
    xs = _x(cfg, "float32", S, seed=5)
    g = np.random.default_rng(6).normal(size=(B, S, cfg.d_model)).astype(
        np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    f = lambda p, x: jrglru.rglru_apply(p, x, cfg=jcfg, mode="train")[0]
    _, vjp = jax.vjp(f, jp, jnp.asarray(xs))
    jgp, jgx = vjp(jnp.asarray(g))
    p = {k: v.requires_grad_(True) for k, v in _port(tree, "float32").items()}
    x = torch.from_numpy(xs).requires_grad_(True)
    out, _ = rglru_apply(p, x, cfg=cfg, mode="train")
    out.backward(torch.from_numpy(g))
    assert _rel(jgx, x.grad) <= 1e-4
    for k in tree:
        assert _rel(jgp[k], p[k].grad) <= 1e-4, k


def test_kernel_path_under_autograd_raises():
    """``impl="cuda"`` with autograd recording runs the ``_RGLRU``
    Function on the kernel, whose forward reaches the kernel's checks and
    raises there on CPU tensors, as it does without autograd: nothing
    falls back to the plain version (the name is kept from when autograd
    on the kernel path raised)."""
    x = torch.zeros(1, 4, 32, requires_grad=True)
    lam = torch.ones(32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.rglru_scan(x, x, x, lam, impl="cuda")
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor"):
        ops.rglru_scan(x, x, x, lam, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        rglru_scan_bwd_cuda(x, x, x, lam, x, torch.zeros(1, 1, 32))


def _kernel_constants():
    """(threads a block, steps a thread, 16-byte vectors a row, the
    decode kernel's most steps) as ``rglru_scan.cu`` defines them."""
    text = (_build.CSRC / "rglru_scan.cu").read_text()
    get = lambda name: int(re.search(rf"constexpr int {name} = (\d+);",
                                     text).group(1))
    return (get("PREFILL_THREADS"), get("PREFILL_L"),
            get("ROW_BYTES") // 16, get("DECODE_L"))


def _kernel_order_scan(x, r_pre, i_pre, lam, h0, gate, threads, L, groups,
                       decode_l):
    """The RG-LRU scan in float32 with the CUDA kernel's order of
    composition (every product and sum rounded alone, as the kernel's
    ``-fmad=false`` build): a thread composes the maps h ↦ a·h + b of its
    L steps; the 32 / groups chunks of a warp that share channels
    compose theirs by a Hillis–Steele scan (offsets 1, 2, …); the warps'
    maps are applied in order to the h entering the tile (a segment of
    threads / groups · L steps), from h0 in the first segment and from
    the h leaving the segment before in the others; each chunk is then
    rescanned from the h entering it.  At most ``decode_l`` steps: one
    walk from h0.  Returns (y, h_last) as ``rglru_scan_ref``.

    A mirror of the order, not the kernel: it shares only the constants
    read from the source, so it checks that the chosen order is sound in
    float32, and would go on passing if the kernel's order drifted from
    it.  The kernel itself is checked only on a card (``chip_smoke.py``'s
    phase 5 and ``tests/test_torch_cuda.py``)."""
    r, i = torch.sigmoid(r_pre.float()), torch.sigmoid(i_pre.float())
    log_a = -C * softplus(lam.float()) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 0.0, 1.0))
    b = mult * i * x.float()
    Bn, S, W = x.shape
    h_in = h0.float() if h0 is not None else torch.zeros(Bn, W)
    if S <= decode_l:
        h, hs = h_in, []
        for t in range(S):
            h = a[:, t] * h + b[:, t]
            hs.append(h)
        hs = torch.stack(hs, 1)
    else:
        cpw, nwarp = 32 // groups, threads // 32
        seg = threads // groups * L
        nseg = -(-S // seg)
        pad = nseg * seg - S  # steps past S: the identity map
        a = torch.cat([a, torch.ones(Bn, pad, W)], 1)
        b = torch.cat([b, torch.zeros(Bn, pad, W)], 1)
        a = a.view(Bn, nseg, nwarp, cpw, L, W)
        b = b.view(Bn, nseg, nwarp, cpw, L, W)
        A, H = a[..., 0, :], b[..., 0, :]
        for k in range(1, L):
            H = a[..., k, :] * H + b[..., k, :]
            A = A * a[..., k, :]
        off = 1
        while off < cpw:  # the warp's shuffle scan, earlier chunks first
            Ap = torch.cat([torch.ones_like(A[..., :off, :]),
                            A[..., :-off, :]], 3)
            Hp = torch.cat([torch.zeros_like(H[..., :off, :]),
                            H[..., :-off, :]], 3)
            live = (torch.arange(cpw) >= off).view(cpw, 1)
            H = torch.where(live, A * Hp + H, H)
            A = torch.where(live, A * Ap, A)
            off *= 2
        h, hw = h_in, []
        for s in range(nseg):  # segments, then warps, in order
            for w in range(nwarp):
                hw.append(h)
                h = A[:, s, w, -1] * h + H[:, s, w, -1]
        hw = torch.stack(hw, 1).view(Bn, nseg, nwarp, 1, W)
        hc = torch.cat([hw, A[..., :-1, :] * hw + H[..., :-1, :]], 3)
        hs = []
        for k in range(L):
            hc = a[..., k, :] * hc + b[..., k, :]
            hs.append(hc)
        hs = torch.stack(hs, 4).reshape(Bn, nseg * seg, W)[:, :S]
    y = hs.to(x.dtype)
    if gate is not None:
        y = y * gate
    return y, hs[:, -1]


def _shapes():
    """The kernel's block shape, and one other (128 threads, 8 steps)."""
    threads, L, groups, decode_l = _kernel_constants()
    return [(threads, L, groups, decode_l), (128, 8, groups, decode_l)]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("n_seg", ["1", "37", "seg+1", "3seg+1"])
@pytest.mark.parametrize("shape", [0, 1])
def test_kernel_order_matches_sequential_oracle(shape, n_seg, with_h0):
    """The kernel's composition order (``_kernel_order_scan``) ≡ the
    step-by-step recurrence (float64) within 1e-5 of max |h|: y gated and
    ungated, h_last, W 100."""
    threads, L, groups, decode_l = _shapes()[shape]
    seg = threads // groups * L
    S_ = {"1": 1, "37": 37, "seg+1": seg + 1, "3seg+1": 3 * seg + 1}[n_seg]
    rng = np.random.default_rng(S_ + 7 * shape)
    W = 100
    t = lambda *shape_: torch.from_numpy(rng.normal(size=shape_).astype(
        np.float32))
    x, gate = t(B, S_, W), t(B, S_, W)
    rp, ip = 2 * t(B, S_, W), 2 * t(B, S_, W)
    lam = torch.from_numpy(rng.uniform(-4, 4, W).astype(np.float32))
    h0 = t(B, W) if with_h0 else None
    want = _oracle(x, rp, ip, lam, h0)
    scale = float(want.abs().max())
    consts = (threads, L, groups, decode_l)
    y, h_last = _kernel_order_scan(x, rp, ip, lam, h0, None, *consts)
    assert y.shape == (B, S_, W) and h_last.shape == (B, W)
    assert float((y.double() - want).abs().max()) <= 1e-5 * scale
    assert float((h_last.double() - want[:, -1]).abs().max()) <= 1e-5 * scale
    yg, _ = _kernel_order_scan(x, rp, ip, lam, h0, gate, *consts)
    wg = want * gate.double()
    assert float((yg.double() - wg).abs().max()) <= 1e-5 * float(
        wg.abs().max())
