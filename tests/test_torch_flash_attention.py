"""The port's plain attention (``repro_torch.kernels.flash_attention.
attention_ref``) against the reference's TPU flash kernel in interpret
mode (``repro.kernels.ops.attention(..., impl="interpret")``, i.e.
``flash_attention_tpu``) and against its oracle
(``repro.kernels.ref.attention_ref``).

The port takes grouped K/V heads natively; the reference gets them
repeated to H heads.  The TPU kernel needs S divisible by its 128 block,
so it is compared at S 128 and 256; the oracle also at S 37 and 200.
h2o-danube-1.8b's head dim 80 (the kernel runs it in the hd-128
tiling) is compared with a window and a softcap, forward and backward;
recurrentgemma-2b's head dim 256 (forward only) causal and with a
window, at G 1 and its MQA's 10.
Inputs are drawn with numpy and rounded to the dtype once, identically
in both packages.  Tolerances: float32 rtol 1e-5 / atol 1e-6 (softmax
and products summed in another order); bfloat16 rtol / atol 2e-2 (the
output rounds to bf16 after float32 work that differs in its last bits).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref, flash_attention_cuda, tma_strides)

TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
CASES = {"causal": {}, "window32": {"window": 32},
         "softcap50": {"softcap": 50.0}}


def _inputs(S, G, dtype, seed, hd=64):
    """q (1, S, H, hd), k/v (1, S, KV, hd) with H = KV·G."""
    KV = 1 if G > 1 else 2
    H = KV * G
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(1, S, n, hd)).astype(np.float32)
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


#: the modes held at hd 80: gemma2's local layers run a window with a
#: softcap (here a window shorter than S)
HD80 = {"causal": {}, "window32_softcap50": {"window": 32, "softcap": 50.0}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("case", list(HD80))
def test_attention_ref_at_hd80_matches_tpu_kernel(case, G, dtype):
    """hd 80 at S 128: the plain version against ``flash_attention_tpu``
    in interpret mode and against the reference's oracle."""
    (jq, jk, jv), (tq, tk, tv), G = _inputs(128, G, dtype, seed=80 + G,
                                            hd=80)
    rep = lambda a: jnp.repeat(a, G, axis=2)
    got = attention_ref(tq, tk, tv, causal=True, **HD80[case])
    assert got.shape == tq.shape
    _compare(got, jops.attention(jq, rep(jk), rep(jv), causal=True,
                                 impl="interpret", **HD80[case]), dtype)
    _compare(got, jref.attention_ref(jq, rep(jk), rep(jv), causal=True,
                                     **HD80[case]), dtype)


@pytest.mark.parametrize("rows", [16, 50])
def test_plain_versions_in_query_blocks(monkeypatch, rows):
    """The plain forward and backward form the scores ``_REF_ROWS``
    queries at a time; any block size gives the one-block result (float32
    rtol 1e-5, atol 1e-5·max(1, max|·|): dk and dv add the blocks' sums,
    and the products run as GEMM calls of other shapes)."""
    from repro_torch.kernels import flash_attention as fa
    _, (q, k, v), _ = _inputs(120, 4, "float32", seed=3, hd=80)
    do = torch.from_numpy(np.random.default_rng(4).normal(
        size=q.shape).astype(np.float32))
    kw = dict(window=40, softcap=30.0)
    o, lse = attention_ref(q, k, v, return_lse=True, **kw)
    want = (o, lse) + fa.attention_bwd_ref(q, k, v, o, lse, do, **kw)
    monkeypatch.setattr(fa, "_REF_ROWS", rows)
    o2, lse2 = attention_ref(q, k, v, return_lse=True, **kw)
    got = (o2, lse2) + fa.attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(
            g, w, rtol=1e-5, atol=1e-5 * max(1.0, float(w.abs().max())))


#: the modes held at hd 256: recurrentgemma-2b's local layers run a
#: window (here one shorter than S) on one KV head
HD256 = {"causal": {}, "window32": {"window": 32}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 10])
@pytest.mark.parametrize("case", list(HD256))
def test_attention_ref_at_hd256_matches_tpu_kernel(case, G, dtype):
    """hd 256 at S 128 (G 10: recurrentgemma-2b's MQA, 10 query heads on
    one KV head): the plain version against ``flash_attention_tpu`` in
    interpret mode and against the reference's oracle."""
    (jq, jk, jv), (tq, tk, tv), G = _inputs(128, G, dtype, seed=256 + G,
                                            hd=256)
    rep = lambda a: jnp.repeat(a, G, axis=2)
    got = attention_ref(tq, tk, tv, causal=True, **HD256[case])
    assert got.shape == tq.shape
    _compare(got, jops.attention(jq, rep(jk), rep(jv), causal=True,
                                 impl="interpret", **HD256[case]), dtype)
    _compare(got, jref.attention_ref(jq, rep(jk), rep(jv), causal=True,
                                     **HD256[case]), dtype)


#: the MoE decoders' grouped heads at hd 128: qwen3-moe-30b-a3b's 32
#: query heads on 4 KV heads (G 8) and dbrx-132b's 48 on 8 (G 6)
MOE_GQA = (8, 6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", MOE_GQA)
@pytest.mark.parametrize("case", ["causal", "window32"])
def test_attention_ref_at_moe_gqa_matches_tpu_kernel(case, G, dtype):
    """hd 128 at S 128, G 8 and 6: the plain version against
    ``flash_attention_tpu`` in interpret mode and against the
    reference's oracle."""
    (jq, jk, jv), (tq, tk, tv), G = _inputs(128, G, dtype, seed=128 + G,
                                            hd=128)
    rep = lambda a: jnp.repeat(a, G, axis=2)
    got = attention_ref(tq, tk, tv, causal=True, **CASES[case])
    assert got.shape == tq.shape
    _compare(got, jops.attention(jq, rep(jk), rep(jv), causal=True,
                                 impl="interpret", **CASES[case]), dtype)
    _compare(got, jref.attention_ref(jq, rep(jk), rep(jv), causal=True,
                                     **CASES[case]), dtype)


def test_backward_kernel_refuses_hd256():
    """hd 256 has a forward and a backward kernel: neither wrapper
    refuses it by its head dim, each reaches its device check, which
    refuses CPU tensors (the name is kept from when the backward
    wrapper refused hd 256)."""
    from repro_torch.kernels.flash_attention import (
        BWD_HEAD_DIMS, HEAD_DIMS, flash_attention_bwd_cuda)
    assert 256 in HEAD_DIMS and 256 in BWD_HEAD_DIMS
    q, k = torch.randn(1, 8, 10, 256), torch.randn(1, 8, 1, 256)
    o, lse = attention_ref(q, k, k, return_lse=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_bwd_cuda(q, k, k, o, lse, q)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_cuda(q, k, k)


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
@pytest.mark.parametrize(
    "case, G", [(c, g) for c in list(BWD_CASES) + ["window_softcap_hd80"]
                for g in (1, 3)] + [("tri_hd128", g) for g in MOE_GQA])
def test_attention_bwd_ref_matches_reference_vjp(case, G, dtype):
    """``attention_bwd_ref`` (and the forward) against ``jax.vjp`` of the
    reference's composition, at hd 16, at h2o-danube-1.8b's hd 80 with a
    window and a softcap (``window_softcap_hd80``), and at the MoE
    decoders' hd 128 and grouped heads (``tri_hd128``, G 8 and 6)."""
    hd = int(case.rsplit("_hd", 1)[1]) if "_hd" in case else 16
    causal, window, cap, bq, bk = BWD_CASES[case.rsplit("_hd", 1)[0]]
    B, S, KV = 2, 48, 2
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


# --------------------------------------------------------------------- #
# the bf16 tensor-core backward's roundings, written plainly: it holds  #
# attention_bwd_ref to chip_smoke's bf16 tolerance                       #
# --------------------------------------------------------------------- #
def _smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bwd_as_the_kernel_rounds(q, k, v, o, lse, do, *, window=None,
                              softcap=None):
    """The causal backward with the roundings of the bf16 kernel
    (``csrc/flash_attention.cu``, ``bwd_dkdv_tc_kernel`` and
    ``bwd_dq_tc_kernel``): products of bf16 operands accumulated in f32,
    p as 2^x of the score in log2 units less lse·log2(e), and P and dS
    rounded to bf16 before the products that take them (dV = Pᵀ·dO,
    dK = dSᵀ·Q, dQ = dS·K); dk scaled per head before the group sum."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale, log2e = hd ** -0.5, 1.4426950408889634
    qg = q.float().reshape(B, Sq, KV, G, hd)
    dog = do.float().reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    l2 = (lse * log2e).reshape(B, KV, G, Sq)[..., None]
    t = None
    if softcap is not None:
        t = torch.tanh(s * scale / softcap)
        p = torch.exp2(softcap * t * log2e - l2)
    else:
        p = torch.exp2(s * (scale * log2e) - l2)
    qa = torch.arange(Sq)[:, None]
    ka = torch.arange(Sk)[None, :]
    vis = qa >= ka
    if window is not None:
        vis &= (qa - ka) < window
    delta = (dog * o.float().reshape(B, Sq, KV, G, hd)).sum(-1)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    p, ds = (torch.where(vis, x, 0.0).to(torch.bfloat16).float()
             for x in (p, ds))
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    dk = (torch.einsum("bkgqs,bqkgd->bskgd", ds, qg) * scale).sum(3)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("S", [37, 130])
@pytest.mark.parametrize("G", [1, 7])
@pytest.mark.parametrize("mode", ["causal", "window256", "softcap50",
                                  "window256_softcap50"])
def test_kernel_roundings_fit_the_chip_tolerance(mode, G, S, hd):
    """On bf16 inputs of ``chip_smoke.flash_inputs`` (hd 64 and 80), the
    bf16 kernel's roundings (:func:`_bwd_as_the_kernel_rounds`) land
    within ``chip_smoke.check_bwd``'s bf16 tolerance (2e-2·max|plain|) of
    ``attention_bwd_ref``: the tolerance the card holds the kernel to
    leaves room for the design's own rounding."""
    smoke = _smoke()
    kw = dict(smoke.FLASH_MODES)[mode]
    q, k, v = smoke.flash_inputs(np, torch, 2, S, 2 * G, 2, hd, "bfloat16",
                                 "cpu", seed=S + G)
    do = smoke.flash_inputs(np, torch, 2, S, 2 * G, 2, hd, "bfloat16",
                            "cpu", seed=S + G + 1000)[0]
    o, lse = attention_ref(q, k, v, return_lse=True, **kw)
    want = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    got = _bwd_as_the_kernel_rounds(q, k, v, o, lse, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        smoke.check_bwd(np, g, w, "bfloat16", f"{mode} G={G} S={S} {name}")


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
