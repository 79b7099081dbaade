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
reference's block, 1e-4 of each leaf's largest entry.  On the kernel
path (``impl="cuda"``) under autograd ``ops.rglru_scan`` raises: its
backward kernel is still to come.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan_ref  # noqa: E402
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
    """``impl="cuda"`` with autograd recording raises before any launch
    (no backward kernel yet), citing the ROADMAP item; without autograd
    it reaches the kernel's checks, which refuse CPU tensors."""
    x = torch.zeros(1, 4, 32, requires_grad=True)
    lam = torch.ones(32)
    with pytest.raises(NotImplementedError, match="item 10f"):
        ops.rglru_scan(x, x, x, lam, impl="cuda")
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor"):
        ops.rglru_scan(x, x, x, lam, impl="cuda")
