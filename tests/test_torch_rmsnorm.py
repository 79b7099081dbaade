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
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_rmsnorm_matches_reference_layer(dtype):
    """The model's norm (routed through ``ops.rmsnorm``) against the
    reference model's ``layers.rmsnorm``: equal up to the reduction
    order in float32, within one bf16 ulp in bfloat16 (the reference
    rounds ``m·w`` to bfloat16 before multiplying)."""
    jx, jw, tx, tw = _inputs((5, 11), 896, dtype, seed=3)
    got = layers.rmsnorm(tx, tw, 1e-6).float().numpy()
    want = np.asarray(jlayers.rmsnorm(jx, jw, 1e-6, False), np.float32)
    np.testing.assert_allclose(got, want, **TOL[dtype])


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
