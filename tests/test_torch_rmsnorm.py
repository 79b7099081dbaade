"""The port's plain RMSNorm (``repro_torch.kernels.rmsnorm.rmsnorm_ref``)
against the reference's oracle (``repro.kernels.ref.rmsnorm_ref``) and
its TPU kernel run in interpret mode (``repro.kernels.ops.rmsnorm(...,
impl="interpret")``, i.e. ``rmsnorm_tpu``).

Inputs are drawn with numpy and rounded to the dtype once, identically in
both packages.  Tolerances: float32 rtol 1e-5 / atol 1e-6 (the mean of
squares is summed in another order); bfloat16 rtol / atol 1.6e-2 (one
bf16 ulp of the output, which can round the other way).  Rows 300 is
not a multiple of the TPU kernel's 256-row block; (2, 64) has two
leading axes.

The model's norm (``round_scale=True``) is held to the reference model's
``repro.models.layers`` norm much tighter in bfloat16: equal outputs
wherever the two round the scale ``m·w`` to the same bf16 value, which
is all but the rare rows where ``m`` differs in its last bit (the mean
is summed in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402

TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=1.6e-2, atol=1.6e-2)}
ROWS = {"1": (1,), "7": (7,), "300": (300,), "2x64": (2, 64)}


def _inputs(lead, D, dtype, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=lead + (D,)) * 3).astype(np.float32)
    w = (1 + 0.5 * rng.normal(size=D)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    np.testing.assert_array_equal(np.asarray(jx, np.float32),
                                  tx.float().numpy())
    return jx, jnp.asarray(w), tx, torch.from_numpy(w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [64, 896])
@pytest.mark.parametrize("rows", list(ROWS))
def test_rmsnorm_ref_matches_reference_and_tpu_kernel(rows, D, dtype):
    jx, jw, tx, tw = _inputs(ROWS[rows], D, dtype, seed=D + len(rows))
    got = rmsnorm_ref(tx, tw)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    got = got.float().numpy()
    for want in (jref.rmsnorm_ref(jx, jw),
                 jops.rmsnorm(jx, jw, impl="interpret")):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   **TOL[dtype])


def _bf16_ulp(a):
    """The spacing of bfloat16 values at magnitude ``a`` (8-bit
    significand)."""
    a = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_rmsnorm_matches_reference_layer(dtype):
    """The model's norm (routed through ``ops.rmsnorm`` with
    ``round_scale=True``) against the reference model's
    ``layers.rmsnorm``: equal up to the reduction order in float32; in
    bfloat16 equal on at least 99.8 % of the outputs and within one bf16
    ulp everywhere (both round ``m·w`` to bfloat16 before multiplying;
    with the single-rounding form 26 % of these outputs differed)."""
    jx, jw, tx, tw = _inputs((5, 11), 896, dtype, seed=3)
    got = layers.rmsnorm(tx, tw, 1e-6).float().numpy()
    want = np.asarray(jlayers.rmsnorm(jx, jw, 1e-6, False), np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL[dtype])
        return
    diff = np.abs(got - want)
    assert (diff == 0).mean() >= 0.998, f"{(diff > 0).sum()} outputs differ"
    assert (diff <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))).all()


@pytest.mark.parametrize("gemma", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [64, 896])
@pytest.mark.parametrize("rows", list(ROWS))
def test_rmsnorm_ref_round_scale_matches_model_norm(rows, D, dtype, gemma):
    """``rmsnorm_ref(..., round_scale=True)`` against the reference
    model's ``_rms_fwd``: float32 within rtol 1e-5 / atol 1e-6; bfloat16
    bit for bit wherever the two round the scale ``m·gain`` to the same
    bf16 value, and there the scales are one bf16 ulp apart (``m`` summed
    in another order); at least 99.8 % of the outputs equal."""
    jx, jw, tx, tw = _inputs(ROWS[rows], D, dtype, seed=D + len(rows))
    want, (_, _, jm) = jlayers._rms_fwd(jx, jw, 1e-6, gemma)
    want = np.asarray(want, np.float32)
    gain = 1.0 + tw if gemma else tw
    got = rmsnorm_ref(tx, gain, 1e-6, round_scale=True)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL[dtype])
        return
    m = torch.rsqrt(tx.float().square().mean(-1, keepdim=True) + 1e-6)
    scale = (m * gain).to(torch.bfloat16).float().numpy()
    jscale = np.asarray((jm[..., None] * (1.0 + jw if gemma else jw))
                        .astype(jnp.bfloat16), np.float32)
    same = scale == jscale
    np.testing.assert_array_equal(got[same], want[same])
    apart = np.abs(scale - jscale)[~same]
    np.testing.assert_array_equal(
        apart, _bf16_ulp(np.minimum(np.abs(scale), np.abs(jscale))[~same]))
    assert (got == want).mean() >= 0.998


def test_round_scale_forms_on_cpu():
    """``ops.rmsnorm`` forwards ``round_scale``; the model's norm is the
    two-rounding form; in float32 the two forms are one function, in
    bfloat16 they differ (on these inputs, on many outputs)."""
    _, _, tx, tw = _inputs((5, 11), 896, "bfloat16", seed=3)
    two = rmsnorm_ref(tx, tw, 1e-6, round_scale=True)
    one = rmsnorm_ref(tx, tw, 1e-6)
    torch.testing.assert_close(ops.rmsnorm(tx, tw, round_scale=True), two,
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.rmsnorm(tx, tw), one, rtol=0, atol=0)
    torch.testing.assert_close(layers.rmsnorm(tx, tw, 1e-6), two, rtol=0,
                               atol=0)
    assert (two != one).float().mean() > 0.1
    x32 = tx.float()
    torch.testing.assert_close(rmsnorm_ref(x32, tw, round_scale=True),
                               rmsnorm_ref(x32, tw), rtol=0, atol=0)


def test_dispatch_on_cpu():
    """``auto`` runs the plain version on CPU tensors; ``cuda`` raises
    in the wrapper's checks; an unknown impl raises."""
    x, w = torch.randn(4, 64), torch.rand(64)
    torch.testing.assert_close(ops.rmsnorm(x, w, eps=1e-5),
                               rmsnorm_ref(x, w, 1e-5), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.rmsnorm(x, w, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        rmsnorm_cuda(x, w)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.rmsnorm(x, w, impl="pallas")


# --------------------------------------------------------------------- #
# the backward: rmsnorm_bwd_ref against jax.vjp of the reference        #
# model's rmsnorm (its custom VJP _rms_bwd)                             #
# --------------------------------------------------------------------- #
from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_cuda,  # noqa: E402
                                         rmsnorm_bwd_ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [64, 896])
@pytest.mark.parametrize("rows", list(ROWS))
def test_rmsnorm_bwd_ref_matches_reference_vjp(rows, D, dtype):
    """dx and dw of the model's norm (the plain forward's ``m``, then the
    plain backward) against ``jax.vjp`` of ``repro.models.layers.rmsnorm``.
    float32: rtol 1e-5, atol 1e-6·max|dx| (dx) and 1e-5·max|dw| (dw).
    bfloat16: ``m`` is summed in another order than the reference's, and
    a one-ulp change of it can round a bf16 term of a row the other way:
    dx within two bf16 ulps of the largest of its two rounded terms and
    its two values (each term can round one ulp apart), and equal on at
    least 98 % of the entries; dw within one bf16 ulp of
    Σ_rows |g·m·x| per column (each row's rounded ``cast(g·m)`` may be
    one ulp apart)."""
    jx, jw, tx, tw = _inputs(ROWS[rows], D, dtype, seed=D + len(rows) + 1)
    g = np.random.default_rng(D).normal(size=ROWS[rows] + (D,)).astype(
        np.float32)
    jg, tg = jnp.asarray(g, dtype), torch.from_numpy(g).to(tx.dtype)
    _, vjp = jax.vjp(lambda x, w: jlayers.rmsnorm(x, w, 1e-6, False), jx, jw)
    wdx, wdw = (np.asarray(a, np.float32) for a in vjp(jg))
    _, m = rmsnorm_ref(tx, tw, 1e-6, round_scale=True, return_m=True)
    dx, dw = rmsnorm_bwd_ref(tx, tw, tg, m)
    assert dx.dtype == tx.dtype and dw.dtype == torch.float32
    dx, dw = dx.float().numpy(), dw.numpy()
    if dtype == "float32":
        np.testing.assert_allclose(dx, wdx, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(wdx).max()))
        np.testing.assert_allclose(dw, wdw, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(wdw).max()))
        return
    xf, gf, m = tx.float(), tg.float(), m[..., None]
    term = torch.maximum((m * gf * tw).abs(),
                         (m ** 3 * xf.abs() * (gf * tw * xf).sum(
                             -1, keepdim=True).abs() / D)).numpy()
    term = np.maximum(term, np.maximum(np.abs(dx), np.abs(wdx)))
    assert (np.abs(dx - wdx) <= 2 * _bf16_ulp(term)).all()
    assert (dx == wdx).mean() >= 0.98
    col = (gf * m * xf).abs().reshape(-1, D).sum(0).numpy()
    assert (np.abs(dw - wdw) <= _bf16_ulp(col)).all()


def test_rmsnorm_is_differentiable_on_cpu():
    """``ops.rmsnorm(round_scale=True)`` under autograd runs the custom
    VJP (the plain backward on CPU tensors): in float32 it equals
    autograd through ``rmsnorm_ref``; ``round_scale=False`` has no
    backward; the kernel raises on CPU tensors."""
    _, _, tx, tw = _inputs((3, 5), 64, "float32", seed=11)
    x, w = tx.clone().requires_grad_(True), tw.clone().requires_grad_(True)
    g = torch.randn(3, 5, 64)
    got = torch.autograd.grad(ops.rmsnorm(x, w, round_scale=True), (x, w), g)
    x2, w2 = tx.clone().requires_grad_(True), tw.clone().requires_grad_(True)
    want = torch.autograd.grad(rmsnorm_ref(x2, w2, round_scale=True),
                               (x2, w2), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    with pytest.raises(NotImplementedError):
        ops.rmsnorm(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_bwd_cuda(tx, tw, g, torch.ones(3, 5))
