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
