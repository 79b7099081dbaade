"""The port's plain SSD scan (``repro_torch.kernels.ssd_scan.ssd_ref``,
through ``ops.ssd(impl="ref")``) and its plain backward (``ssd_bwd_ref``)
against the reference's.

Inputs are drawn with numpy from a seed at B 2, nh 4, hd 16, N 32 and
handed to both packages: x, B and C rounded to the dtype once, dt and A
in float32.  Two decay regimes: slow (dt ∈ [0, 0.1], A ∈ [−1, −0.5], so
dt·A ∈ [−0.1, 0] and the state carries across chunks) and model-like
(dt = softplus(N(0, 0.8²)), A = −1, so the state decays within a chunk).

* Against ``repro.models.ssm.ssd_chunked`` (y and the final state):
  float32 within rtol 1e-5, atol 1e-5·max(1, max|ref|) (the same dual
  form, products summed in another order); bfloat16 within 2e-2 (y
  rounds to bf16 after float32 work that differs in its last bits).
* Against the TPU kernel ``ssd_scan_tpu(..., interpret=True)`` and the
  sequential recurrence ``repro.kernels.ref.ssd_ref``, on the same
  inputs with B and C repeated per head, in float32 within rtol 1e-3,
  atol 1e-4 (``tests/test_kernels.py``'s tolerance for those two).

The bfloat16 CUDA route's precision plan, emulated here in float32 at
mamba2-780m's hd 64 and N 128 (S 512, 4 heads, one group, inputs from
``chip_smoke.ssd_inputs``): x, B and C are exact bf16 operands; the three
f32 operands (x·dt·decay against B, P against x, H_in against C) are
split into bf16 hi + lo; sums in f32.  Held to ``ssd_ref`` under
``chip_smoke``'s phase 5 tolerances (the final state rtol 1e-4, atol
1e-5·max(1, max|h|); y 2e-2); and a single bf16 rounding of the state
operand is shown to miss the final state's tolerance.

The bfloat16 backward kernels' precision plan, emulated in float32 the
same way at the same shape with a random cotangent of the final state:
x, B, C and dy exact; dy·exp(cum), the state gradient G_c, the entering
state H_c and S = (C·Bᵀ) ⊙ L split into hi + lo; D = dt_j (dy·xᵀ) ⊙ L
rounded once.  Held to ``ssd_bwd_ref`` under ``chip_smoke``'s phase 5
tolerances (``ssd_bwd_close``); a single bf16 rounding of any of the four
split operands is shown to miss the ddt tolerance.

The backward (``ssd_bwd_ref``, on ``ssd_ref``'s cum and entering states)
against ``jax.vjp`` of ``ssd_chunked`` over the same grid, with a
nonzero cotangent of the final state, and against ``torch.autograd``
through ``ssd_ref`` (tolerances at ``BWD_TOL`` and the tests); the
entering states against the reference's scan; ``ops.ssd`` under
autograd on the CPU.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_tpu  # noqa: E402
from repro.models.ssm import ssd_chunked as jssd_chunked  # noqa: E402
from repro_torch.kernels import ops, ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan import (ssd_bwd_ref, ssd_cuda,  # noqa: E402
                                          ssd_ref)

B, NH, HD, N = 2, 4, 16, 32
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}


def _inputs(S, ng, decay, seed):
    """x (B, S, nh, hd), dt (B, S, nh), A (nh,), Bm, Cm (B, S, ng, N) as
    float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, S, NH, HD)) * 0.5).astype(np.float32)
    if decay == "slow":
        dt = rng.uniform(0.0, 0.1, size=(B, S, NH)).astype(np.float32)
        A = -rng.uniform(0.5, 1.0, size=NH).astype(np.float32)
    else:
        dt = np.logaddexp(rng.normal(0.0, 0.8, size=(B, S, NH)),
                          0.0).astype(np.float32)
        A = -np.ones(NH, np.float32)
    Bm = (rng.normal(size=(B, S, ng, N)) * 0.3).astype(np.float32)
    Cm = (rng.normal(size=(B, S, ng, N)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


def _both(arrs, dtype):
    """The inputs in both packages: x, Bm, Cm rounded to ``dtype``."""
    x, dt, A, Bm, Cm = arrs
    jx = [jnp.asarray(a, dtype) for a in (x, Bm, Cm)]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, Bm, Cm)]
    j = (jx[0], jnp.asarray(dt), jnp.asarray(A), jx[1], jx[2])
    t = (tx[0], torch.from_numpy(dt), torch.from_numpy(A), tx[1], tx[2])
    return j, t


def _close(got, want, rtol, atol_scale):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=atol_scale * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decay", ["slow", "model"])
@pytest.mark.parametrize("ng", [1, 2])
@pytest.mark.parametrize("chunk", [32, 128])
@pytest.mark.parametrize("S", [32, 256])
def test_ssd_ref_matches_ssd_chunked(S, chunk, ng, decay, dtype):
    j, t = _both(_inputs(S, ng, decay, seed=S + chunk + ng), dtype)
    jy, jh = jssd_chunked(*j, chunk=chunk)
    y, h = ops.ssd(*t, chunk=chunk, impl="ref")
    assert y.dtype == getattr(torch, dtype) and y.shape == (B, S, NH, HD)
    assert h.dtype == torch.float32 and h.shape == (B, NH, HD, N)
    rtol, atol = TOL[dtype]
    _close(y, jy, rtol, atol)
    _close(h, jh, *TOL["float32"])


@pytest.mark.parametrize("decay", ["slow", "model"])
@pytest.mark.parametrize("ng", [1, 2])
@pytest.mark.parametrize("chunk", [32, 128])
@pytest.mark.parametrize("S", [32, 256])
def test_ssd_ref_matches_tpu_kernel_and_recurrence(S, chunk, ng, decay):
    arrs = _inputs(S, ng, decay, seed=7 * S + chunk + ng)
    x, dt, A, Bm, Cm = arrs
    rep = NH // ng
    Bh, Ch = (np.repeat(a, rep, axis=2) for a in (Bm, Cm))  # (B,S,nh,N)
    heads = lambda a: np.moveaxis(a, 2, 1).reshape(B * NH, S, -1)
    xdt = heads(x * dt[..., None])
    dA = heads((dt * A)[..., None])[..., 0]
    tpu = ssd_scan_tpu(jnp.asarray(xdt), jnp.asarray(dA),
                       jnp.asarray(heads(Bh)), jnp.asarray(heads(Ch)),
                       chunk=chunk, interpret=True)
    seq = jref.ssd_ref(*(jnp.asarray(a) for a in (x, dt, A, Bh, Ch)))
    y, _ = ops.ssd(*(torch.from_numpy(a) for a in arrs), chunk=chunk,
                   impl="ref")
    y_heads = y.permute(0, 2, 1, 3).reshape(B * NH, S, HD)
    np.testing.assert_allclose(y_heads.numpy(), np.asarray(tpu),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(y.numpy(), np.asarray(seq), rtol=1e-3,
                               atol=1e-4)


def test_ssd_rejects_ragged_chunks():
    """S must be a multiple of min(chunk, S), as the reference asserts."""
    t = [torch.from_numpy(a) for a in _inputs(200, 1, "slow", seed=0)]
    with pytest.raises(ValueError, match="not a multiple"):
        ops.ssd(*t, chunk=128, impl="ref")
    ops.ssd(*t, chunk=40, impl="ref")          # 200 = 5 chunks of 40
    with pytest.raises(ValueError, match="not a multiple"):
        ops.ssd(*(a[:, :7] if a.dim() > 1 else a for a in t), chunk=4)


def test_ssd_dispatch_on_cpu():
    """``auto`` runs the plain version on CPU tensors; ``cuda`` raises in
    the wrapper's checks instead of falling back."""
    t = [torch.from_numpy(a) for a in _inputs(64, 2, "model", seed=1)]
    for got, want in zip(ops.ssd(*t), ssd_ref(*t)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.ssd(*t, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd_cuda(*t)


def _smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _emulate_bf16_route(x, dt, A, Bm, Cm, chunk, split_state=True):
    """The bfloat16 kernels' arithmetic (``kernels/csrc/ssd_scan.cu``) in
    float32 on the CPU: chunk states, the f32 recurrence across chunks,
    then y.  Each f32 operand of a product is rounded to bf16 hi + lo
    (``split_state=False``: the state operand x·dt·decay to hi alone)."""
    f32, bf = torch.float32, torch.bfloat16
    rnd = lambda a: a.to(bf).to(f32)

    def parts(a, split=True):
        hi = rnd(a)
        return (hi, rnd(a - hi)) if split else (hi,)

    Bsz, S, nh, hd = x.shape
    ng, N = Bm.shape[2], Bm.shape[3]
    Q, rep = min(chunk, S), nh // ng
    nc = S // Q
    xc = x.to(f32).reshape(Bsz, nc, Q, nh, hd)
    dtc = dt.reshape(Bsz, nc, Q, nh)
    Bh, Ch = (t.to(f32).reshape(Bsz, nc, Q, ng, N).repeat_interleave(rep, 3)
              for t in (Bm, Cm))
    cum = torch.cumsum(dtc * A, dim=2)                     # (B, nc, Q, nh)
    seg = cum[:, :, -1]
    xw = xc * (dtc * torch.exp(seg[:, :, None] - cum))[..., None]
    states = sum(torch.einsum("bcqhd,bcqhn->bchdn", p, Bh)
                 for p in parts(xw, split_state))
    h = torch.zeros(Bsz, nh, hd, N, dtype=f32)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * torch.exp(seg[:, c])[:, :, None, None] + states[:, c]
    G = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()[None, None, :, :, None]
    L = torch.where(causal, torch.exp(cum[:, :, :, None] - cum[:, :, None]),
                    torch.zeros((), dtype=f32))
    P = G * L * dtc[:, :, None]
    y = sum(torch.einsum("bcijh,bcjhd->bcihd", p, xc) for p in parts(P))
    y = y + torch.exp(cum)[..., None] * sum(
        torch.einsum("bcihn,bchdn->bcihd", Ch, p)
        for p in parts(torch.stack(h_in, dim=1)))
    return y.reshape(Bsz, S, nh, hd).to(x.dtype), h


def _precision_case(decay, split_state):
    """(emulated y, h), (plain y, h), chip_smoke at hd 64, N 128, S 512."""
    smoke = _smoke()
    args = smoke.ssd_inputs(np, torch, 1, 512, 4, 1, 64, 128, decay,
                            "bfloat16", torch.device("cpu"), seed=5)
    return (_emulate_bf16_route(*args, 128, split_state),
            ssd_ref(*args, 128), smoke)


@pytest.mark.parametrize("decay", ["slow", "model"])
def test_bf16_route_split_operands_hold_phase5_tolerances(decay):
    (y, h), (y_r, h_r), smoke = _precision_case(decay, split_state=True)
    smoke.check_close(np, y, y_r, "bfloat16", f"{decay} y", smoke.SSD_F32)
    err = smoke.check_close(np, h, h_r, "float32", f"{decay} h",
                            smoke.SSD_F32)
    assert err < 1e-5 * float(h_r.abs().max())


@pytest.mark.parametrize("decay", ["slow", "model"])
def test_bf16_route_single_rounded_state_operand_misses_h_tolerance(decay):
    """Why the kernels split: one bf16 rounding of x·dt·decay puts the
    final state outside phase 5's tolerance."""
    (_, h), (_, h_r), smoke = _precision_case(decay, split_state=False)
    with pytest.raises(AssertionError, match="max \\|diff\\|"):
        smoke.check_close(np, h, h_r, "float32", f"{decay} h",
                          smoke.SSD_F32)


# --------------------------------------------------------------------------
# The backward
# --------------------------------------------------------------------------

def _emulate_bf16_bwd(x, dt, A, Bm, Cm, dy, cum, states, dh, chunk,
                      single=""):
    """The bfloat16 backward kernels' arithmetic (``ssd_scan.cu``'s
    ``bwd_gscan_kernel`` and ``bwd_chunk_kernel``) in float32 on the CPU.
    x, B, C and dy are exact bf16 operands; the f32 operands of products
    are rounded to bf16 hi + lo: dy·exp(cum) in the state gradient's scan
    ("W"), its output G_c ("G"), the entering state H_c ("H", the
    forward's hi + lo, rounded again) and S = (C·Bᵀ) ⊙ L ("S"); D =
    dt_j (dy·xᵀ) ⊙ L is rounded to hi alone.  ``single`` names operands
    rounded to hi alone instead.  dsc, C·Bᵀ, M = D ⊙ C·Bᵀ, the exps and
    every sum in f32; <H_c, G_c> on both as hi + lo."""
    f32, bf = torch.float32, torch.bfloat16
    rnd = lambda a: a.to(bf).to(f32)

    def parts(a, name):
        hi = rnd(a)
        return (hi,) if name in single else (hi, rnd(a - hi))

    Bsz, S, nh, hd = x.shape
    ng, N = Bm.shape[2], Bm.shape[3]
    Q, rep = min(chunk, S), nh // ng
    nc = S // Q
    xc = x.to(f32).reshape(Bsz, nc, Q, nh, hd)
    dtc = dt.reshape(Bsz, nc, Q, nh)
    dyc = dy.to(f32).reshape(Bsz, nc, Q, nh, hd)
    Bh, Ch = (t.to(f32).reshape(Bsz, nc, Q, ng, N).repeat_interleave(rep, 3)
              for t in (Bm, Cm))
    cq = cum.permute(0, 1, 3, 2)                            # (B, nc, Q, nh)
    seg = cq[:, :, -1]
    g = torch.zeros(Bsz, nh, hd, N, dtype=f32) if dh is None else dh
    gout = [None] * nc
    for c in range(nc - 1, -1, -1):
        gout[c] = g
        w = dyc[:, c] * torch.exp(cq[:, c])[..., None]
        g = g * torch.exp(seg[:, c])[:, :, None, None] + sum(
            torch.einsum("bqhd,bqhn->bhdn", p, Ch[:, c]) for p in parts(w, "W"))
    G = torch.stack(gout, dim=1)
    hdot = (sum(parts(states, "")) * sum(parts(G, ""))).sum((-2, -1))
    Gp, Hp = parts(G, "G"), parts(states, "H")
    L = ssd_scan._decay_matrix(cq)
    CB = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)
    D = torch.einsum("bcihd,bcjhd->bcijh", dyc, xc) * dtc[:, :, None] * L
    M = D * CB
    e_in, e_out = torch.exp(cq), torch.exp(seg[:, :, None] - cq)
    dCs = e_in[..., None] * sum(torch.einsum("bcihd,bchdn->bcihn", dyc, p)
                                for p in Hp)
    dBs = (e_out * dtc)[..., None] * sum(
        torch.einsum("bcjhd,bchdn->bcjhn", xc, p) for p in Gp)
    dxs = e_out[..., None] * sum(torch.einsum("bcjhn,bchdn->bcjhd", Bh, p)
                                 for p in Gp)
    Dp = (rnd(D),)
    dC_h = sum(torch.einsum("bcijh,bcjhn->bcihn", p, Bh) for p in Dp) + dCs
    dB_h = sum(torch.einsum("bcijh,bcihn->bcjhn", p, Ch) for p in Dp) + dBs
    dxdt = sum(torch.einsum("bcijh,bcihd->bcjhd", p, dyc)
               for p in parts(CB * L, "S")) + dxs
    st = (Bh * dBs).sum(-1)
    dcum = M.sum(3) - M.sum(2) + (Ch * dCs).sum(-1) - st
    dcum[:, :, -1] += st.sum(2) + torch.exp(seg) * hdot
    ddA = dcum.flip(2).cumsum(2).flip(2)
    ddt = ddA * A + (dxdt * xc).sum(-1)
    dA = (ddA * dtc).sum((0, 1, 2))
    dx = (dxdt * dtc[..., None]).reshape(Bsz, S, nh, hd)
    dB, dC = (t.reshape(Bsz, S, ng, rep, N).sum(3) for t in (dB_h, dC_h))
    return (dx.to(x.dtype), ddt.reshape(Bsz, S, nh), dA, dB.to(Bm.dtype),
            dC.to(Cm.dtype))


def _bwd_precision_case(decay, single):
    """The emulated bf16 backward and ``ssd_bwd_ref`` at mamba2-780m's hd
    64 and N 128 (S 512, 4 heads, one group, a random cotangent of the
    final state), and chip_smoke."""
    smoke = _smoke()
    cpu = torch.device("cpu")
    args = smoke.ssd_inputs(np, torch, 1, 512, 4, 1, 64, 128, decay,
                            "bfloat16", cpu, seed=5)
    dy = smoke.ssd_inputs(np, torch, 1, 512, 4, 1, 64, 128, decay,
                          "bfloat16", cpu, seed=1005)[0]
    dh = torch.from_numpy(np.random.default_rng(2005).normal(
        size=(1, 4, 64, 128)).astype(np.float32))
    _, _, cum, st = ssd_ref(*args, 128, return_states=True)
    return (_emulate_bf16_bwd(*args, dy, cum, st, dh, 128, single),
            ssd_bwd_ref(*args, dy, cum, st, dh, 128), smoke)


@pytest.mark.parametrize("decay", ["slow", "model"])
def test_bf16_bwd_route_holds_phase5_tolerances(decay):
    """The bf16 backward's precision plan within ``chip_smoke``'s phase 5
    tolerances (``ssd_bwd_close``): ``SSD_BWD_DT`` for ddt and dA,
    2e-2·max|plain| for dx, dB, dC."""
    got, want, smoke = _bwd_precision_case(decay, "")
    smoke.ssd_bwd_close(np, got, want, "bfloat16", f"{decay} emulated")


@pytest.mark.parametrize("operand", ["W", "G", "H", "S"])
@pytest.mark.parametrize("decay", ["slow", "model"])
def test_bf16_bwd_single_rounded_operand_misses_tolerance(decay, operand):
    """Why the backward kernels split each of these operands: one bf16
    rounding of it puts ddt outside phase 5's tolerance."""
    got, want, smoke = _bwd_precision_case(decay, operand)
    with pytest.raises(AssertionError, match="ddt: max \\|diff\\|"):
        smoke.ssd_bwd_close(np, got, want, "bfloat16", f"{decay} {operand}")


#: the backward's tolerance in float32: rtol, and atol as a share of
#: max(1, max |ref|) (float32 sums in another order; dA sums B·S terms)
BWD_TOL = (1e-5, 2e-5)
GRADS = ("dx", "ddt", "dA", "dB", "dC")


def _overflows(S, chunk, decay):
    """Whether a chunk's decay exp(cum_i − cum_j) overflows float32 above
    the diagonal (the model-like regime over 128 steps: −cum reaches
    ≈ 91, past log(float32 max) ≈ 88.7)."""
    return decay == "model" and min(S, chunk) == 128


def _cotangents(S, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, NH, HD)).astype(np.float32),
            rng.normal(size=(B, NH, HD, N)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decay", ["slow", "model"])
@pytest.mark.parametrize("ng", [1, 2])
@pytest.mark.parametrize("chunk", [32, 128])
@pytest.mark.parametrize("S", [32, 256])
def test_ssd_bwd_ref_matches_vjp_of_ssd_chunked(S, chunk, ng, decay, dtype):
    """``ssd_bwd_ref`` on ``ssd_ref``'s cum and states against
    ``jax.vjp`` of the reference's ``ssd_chunked``, with a nonzero
    cotangent of the final state.  float32 within ``BWD_TOL``; with
    bf16 x, B, C (and dy) the bf16 gradients dx, dB, dC within 2e-2 (one
    bf16 rounding of float32 values that differ in their last bits), ddt
    and dA within ``BWD_TOL``.  Where the decay overflows above the
    diagonal the reference's dt and A gradients are NaN (its mask
    multiplies the overflowed exp by a zero cotangent: 0·inf); there they
    are held to float64 autograd through ``ssd_ref`` (whose mask selects
    before the exp) within ``BWD_TOL``."""
    arrs = _inputs(S, ng, decay, seed=S + chunk + ng)
    dy, dh = _cotangents(S, seed=3 * S + chunk + ng)
    j, t = _both(arrs, dtype)
    jdy = jnp.asarray(dy, dtype)
    _, vjp = jax.vjp(lambda *a: jssd_chunked(*a, chunk=chunk), *j)
    want = vjp((jdy, jnp.asarray(dh)))
    tdy = torch.from_numpy(dy).to(getattr(torch, dtype))
    _, _, cum, st = ssd_ref(*t, chunk, return_states=True)
    got = ssd_bwd_ref(*t, tdy, cum, st, torch.from_numpy(dh), chunk)
    f64 = None
    if _overflows(S, chunk, decay):
        leaves = [a.double().requires_grad_(True) for a in t]
        y64, h64 = ssd_ref(*leaves, chunk)
        f64 = torch.autograd.grad(
            (y64 * tdy.double()).sum()
            + (h64 * torch.from_numpy(dh).double()).sum(), leaves)
    for i, (name, g, w) in enumerate(zip(GRADS, got, want)):
        assert g.dtype == t[i].dtype and g.shape == t[i].shape, name
        w = np.asarray(w, np.float32)
        if name in ("ddt", "dA") and f64 is not None:
            assert not np.isfinite(w).all(), name
            w = f64[i].numpy()
        tol = (TOL[dtype] if name in ("dx", "dB", "dC") else BWD_TOL)
        _close(g, w, *tol)


@pytest.mark.parametrize("decay", ["slow", "model"])
@pytest.mark.parametrize("ng", [1, 2])
@pytest.mark.parametrize("chunk", [32, 128])
@pytest.mark.parametrize("S", [32, 256])
def test_ssd_bwd_ref_matches_autograd_of_ssd_ref(S, chunk, ng, decay):
    """``ssd_bwd_ref`` against ``torch.autograd`` through ``ssd_ref`` on
    the same float32 inputs and cotangents, within ``BWD_TOL``."""
    t = [torch.from_numpy(a) for a in _inputs(S, ng, decay, seed=S + ng)]
    dy, dh = (torch.from_numpy(a) for a in _cotangents(S, seed=S + chunk))
    leaves = [a.clone().requires_grad_(True) for a in t]
    y, h = ssd_ref(*leaves, chunk)
    want = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), leaves)
    _, _, cum, st = ssd_ref(*t, chunk, return_states=True)
    got = ssd_bwd_ref(*t, dy, cum, st, dh, chunk)
    for g, w in zip(got, want):
        assert torch.isfinite(w).all()
        _close(g, w, *BWD_TOL)


@pytest.mark.parametrize("decay", ["slow", "model"])
@pytest.mark.parametrize("ng", [1, 2])
@pytest.mark.parametrize("chunk", [32, 128])
@pytest.mark.parametrize("S", [32, 256])
def test_return_states_match_reference_scan(S, chunk, ng, decay):
    """``ssd_ref(..., return_states=True)``: y and h as without it; each
    chunk's entering state equal to the state the reference's scan
    carries into it (``ssd_chunked``'s final state over the chunks before
    it; zeros for the first) within the float32 tolerance, and cum the
    prefix sums of dt·A within each chunk."""
    arrs = _inputs(S, ng, decay, seed=5 * S + chunk + ng)
    x, dt, A, Bm, Cm = arrs
    t = [torch.from_numpy(a) for a in arrs]
    y, h, cum, st = ssd_ref(*t, chunk, return_states=True)
    y0, h0 = ssd_ref(*t, chunk)
    assert torch.equal(y, y0) and torch.equal(h, h0)
    Q = min(chunk, S)
    nc = S // Q
    assert cum.shape == (B, nc, NH, Q) and st.shape == (B, nc, NH, HD, N)
    assert not st[:, 0].any()
    for c in range(1, nc):
        _, jh = jssd_chunked(*(jnp.asarray(a[:, :c * Q]) if a.ndim > 1
                               else jnp.asarray(a) for a in arrs),
                             chunk=chunk)
        _close(st[:, c], jh, *TOL["float32"])
    dA = (dt * A).reshape(B, nc, Q, NH)
    _close(cum, np.moveaxis(np.asarray(jnp.cumsum(jnp.asarray(dA), axis=2)),
                            2, 3), *TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_differentiable_on_cpu(dtype):
    """``ops.ssd`` under autograd on CPU tensors: the plain forward, and
    gradients bit for bit ``ssd_bwd_ref``'s (an unused h_final's
    cotangent taken as zeros); ``impl="cuda"`` still raises."""
    arrs = _inputs(64, 2, "model", seed=11)
    _, t = _both(arrs, dtype)
    leaves = [a.clone().requires_grad_(True) for a in t]
    y, h = ops.ssd(*leaves, chunk=32)
    assert y.grad_fn is not None and h.grad_fn is not None
    y_r, h_r, cum, st = ssd_ref(*t, 32, return_states=True)
    assert torch.equal(y.detach(), y_r) and torch.equal(h.detach(), h_r)
    dy = torch.from_numpy(_cotangents(64, seed=2)[0]).to(y.dtype)
    got = torch.autograd.grad(y, leaves, dy)
    want = ssd_bwd_ref(*t, dy, cum, st, None, 32)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.ssd(*leaves, chunk=32, impl="cuda")
