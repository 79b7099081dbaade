"""The port's plain attention (``repro_torch.kernels.flash_attention.
attention_ref``) against the reference's TPU flash kernel in interpret
mode (``repro.kernels.ops.attention(..., impl="interpret")``, i.e.
``flash_attention_tpu``) and against its oracle
(``repro.kernels.ref.attention_ref``).

The port takes grouped K/V heads natively; the reference gets them
repeated to H heads.  The TPU kernel needs S divisible by its 128 block,
so it is compared at S 128 and 256; the oracle also at S 37 and 200.
Inputs are drawn with numpy and rounded to the dtype once, identically
in both packages.  Tolerances: float32 rtol 1e-5 / atol 1e-6 (softmax
and products summed in another order); bfloat16 rtol / atol 2e-2 (the
output rounds to bf16 after float32 work that differs in its last bits).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref, flash_attention_cuda, tma_strides)

TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
CASES = {"causal": {}, "window32": {"window": 32},
         "softcap50": {"softcap": 50.0}}


def _inputs(S, G, dtype, seed):
    """q (1, S, H, 64), k/v (1, S, KV, 64) with H = KV·G."""
    KV = 1 if G > 1 else 2
    H = KV * G
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(1, S, n, 64)).astype(np.float32)
            for n in (H, KV, KV)]
    jx = [jnp.asarray(a, dtype) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx, G


def _compare(got, want, dtype):
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("G", [1, 7])
@pytest.mark.parametrize("case", list(CASES))
def test_attention_ref_matches_tpu_kernel(case, G, S, dtype):
    (jq, jk, jv), (tq, tk, tv), G = _inputs(S, G, dtype, seed=S + G)
    rep = lambda a: jnp.repeat(a, G, axis=2)
    want = jops.attention(jq, rep(jk), rep(jv), causal=True,
                          impl="interpret", **CASES[case])
    _compare(attention_ref(tq, tk, tv, causal=True, **CASES[case]), want,
             dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [37, 200])
@pytest.mark.parametrize("G", [1, 7])
@pytest.mark.parametrize("case", list(CASES))
def test_attention_ref_matches_oracle_any_length(case, G, S, dtype):
    (jq, jk, jv), (tq, tk, tv), G = _inputs(S, G, dtype, seed=S * G)
    rep = lambda a: jnp.repeat(a, G, axis=2)
    want = jref.attention_ref(jq, rep(jk), rep(jv), causal=True,
                              **CASES[case])
    _compare(attention_ref(tq, tk, tv, causal=True, **CASES[case]), want,
             dtype)


def test_dispatch_on_cpu():
    """``auto`` runs the plain version on CPU tensors; ``cuda`` raises in
    the wrapper's checks instead of falling back."""
    q, k = torch.randn(1, 9, 4, 64), torch.randn(1, 9, 2, 64)
    torch.testing.assert_close(ops.attention(q, k, k),
                               attention_ref(q, k, k), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.attention(q, k, k, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_cuda(q, k, k)


def test_tma_stride_rule():
    """The bf16 kernel's TMA layout rule: the model's contiguous
    ``(B, S, heads, hd)`` passes with its own strides, a size-1 dim takes
    its contiguous stride, and a stride that is not a multiple of 8
    elements or a base off a 16-byte boundary raises."""
    x = torch.zeros(2, 37, 14, 64, dtype=torch.bfloat16)
    assert tma_strides("q", x) == x.stride()[:3]
    one = torch.zeros(1, 200, 1, 64, dtype=torch.bfloat16)[:, :, :, :]
    assert tma_strides("k", one.as_strided(one.shape, (3, 64, 5, 1))) == (
        200 * 64, 64, 64)
    wide = torch.zeros(2, 9, 14 * 64 + 8, dtype=torch.bfloat16)
    assert tma_strides("q", wide[..., :14 * 64].unflatten(-1, (14, 64))) == (
        9 * (14 * 64 + 8), 14 * 64 + 8, 64)
    odd = torch.zeros(1, 9, 14 * 64 + 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="TMA"):
        tma_strides("q", odd[..., :14 * 64].unflatten(-1, (14, 64)))
    flat = torch.zeros(9 * 2 * 64 + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        tma_strides("v", flat[1:].view(1, 9, 2, 64))


# --------------------------------------------------------------------- #
# the backward: attention_bwd_ref against jax.vjp of the reference's    #
# own composition (_repeat_pad_kv, then repro.models.flash's custom VJP) #
# --------------------------------------------------------------------- #
from repro.models.attention import _repeat_pad_kv  # noqa: E402
from repro.models.flash import flash_attention as jflash  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_bwd_ref, flash_attention_bwd_cuda)

#: (causal, window, softcap, block_q, block_k) of the reference's flash:
#: equal square blocks over a causal band take its triangular pair scan,
#: the rest its rectangular band scan
BWD_CASES = {"tri": (True, None, None, 16, 16),
             "tri_softcap": (True, None, 5.0, 16, 16),
             "rect_causal": (True, None, None, 16, 8),
             "window": (True, 12, None, 16, 16),
             "window_softcap": (True, 12, 5.0, 16, 8)}
#: float32: rtol 1e-4, atol 1e-5·max(1, max|g|) (sums in another order);
#: bfloat16 2e-2 of max|g| (the reference rounds its dq blocks and the
#: cotangent products to bf16 where the plain version stays in f32)
BWD_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (0.0, 2e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_attention_bwd_ref_matches_reference_vjp(case, G, dtype):
    causal, window, cap, bq, bk = BWD_CASES[case]
    B, S, KV, hd = 2, 48, 2, 16
    H = KV * G
    rng = np.random.default_rng(len(case) + 10 * G)
    arrs = [rng.normal(size=(B, S, n, hd)).astype(np.float32)
            for n in (H, KV, KV, H)]
    jq, jk, jv, jdo = (jnp.asarray(a, dtype) for a in arrs)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(getattr(torch, dtype))
                       for a in arrs)

    def f(q, k, v):
        return jflash(q, _repeat_pad_kv(k, H, H), _repeat_pad_kv(v, H, H),
                      causal, window, cap, bq, bk)

    jo, vjp = jax.vjp(f, jq, jk, jv)
    want = vjp(jdo)
    kw = dict(causal=causal, window=window, softcap=cap)
    o, lse = attention_ref(tq, tk, tv, return_lse=True, **kw)
    _compare(o, jo, dtype)
    got = attention_bwd_ref(tq, tk, tv, o, lse, tdo, **kw)
    rtol, atol = BWD_TOL[dtype]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tq.dtype and g.shape == tuple(w.shape)
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(
            g.float().numpy(), w, rtol=rtol,
            atol=atol * max(1.0, float(np.abs(w).max())), err_msg=name)


def test_attention_is_differentiable_on_cpu():
    """``ops.attention`` under autograd: the custom backward (plain on CPU
    tensors) gives autograd-through-``attention_ref``'s gradients; with
    no input requiring grad it is the forward alone."""
    _, (q, k, v), _ = _inputs(37, 7, "float32", seed=5)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = ops.attention(*leaves, window=16, softcap=20.0)
    do = torch.randn_like(o)
    got = torch.autograd.grad(o, leaves, do)
    leaves2 = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(
        attention_ref(*leaves2, window=16, softcap=20.0), leaves2, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    assert not ops.attention(q, k, v).requires_grad
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(q, k, v, q, torch.zeros(1, 14, 37), q)
