"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and ``nvcc`` (the kernels build on first use); skips
elsewhere.  Inputs come from ``chip_smoke`` (numpy only, so this file
runs where JAX is not installed).  The fused tick: all nine static
branch cases of ``chip_smoke.tick_problem``, 5 chained ticks each at
``chip_smoke.TICK_SIZES`` (``w`` and ``pulled`` updated in place, every
other input unwritten, two runs bit for bit alike), and a tick in which
every node finishes and starts.
The tick's control plane must match exactly; ``w``, ``pulled`` and
``pol_ema`` within rtol 1e-5, atol 1e-6·max(1, max|plain|), because the
kernel sums the gradient in another order.  RMSNorm and flash
attention: ``chip_smoke``'s phase 5 case grids, at its ``check_close``
tolerances (RMSNorm in both forms, and on an unaligned row; flash
bfloat16 on the tensor cores, where strides that TMA cannot take
raise).  The SSD scan: ``chip_smoke``'s phase 5 grid (S × groups ×
N × decay, then ``SSD_EXTRA``: the serving prefill, 32 chunks, a head
tile that does not divide the group, hd 16 with N and Q not multiples
of 16), y and the final state at ``chip_smoke.SSD_F32`` in float32
(rtol 1e-4, atol 1e-5·max(1, max|plain|)), y within 2e-2 in bfloat16
(the final state as in float32).  The two backward kernels (flash attention's,
RMSNorm's): ``chip_smoke``'s phase 5 backward grids at its tolerances
(``check_flash_bwd``, ``check_rms_bwd``), and the bfloat16 flash
backward's dk/dv and dq kernels must show ``HGMMA`` (``wgmma``) in the
built library's SASS (``chip_smoke.flash_bwd_sass``).
Run on the card with::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)
"""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(9))
def test_cuda_tick_matches_plain(case):
    """One branch case, 5 chained ticks at ``chip_smoke``'s small sizes,
    against the plain version: ``w`` and ``pulled`` returned in the
    input's storage, every other input unwritten, two runs on the same
    inputs bit for bit alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import psp_tick as pt
    smoke = _smoke()
    dev = torch.device("cuda", 0)
    for size in smoke.TICK_SIZES:
        smoke.check_tick_case(np, torch, pt, dev, smoke.CASES[case], *size)


@pytest.mark.cuda
def test_cuda_tick_finish_and_start():
    """Every alive node finishes and starts in one tick: the
    residuals read the old views before the pull overwrites them, so
    ``w`` agrees with the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import psp_tick as pt
    smoke = _smoke()
    dev = torch.device("cuda", 0)
    for size in smoke.TICK_SIZES:
        assert smoke.check_finish_start(np, torch, pt, dev, *size) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rmsnorm_matches_plain(dtype):
    """RMSNorm over ``chip_smoke``'s phase 5 grid (rows × D × form) in
    one dtype, and on a row that is not 16-byte aligned (the scalar
    path): float32 within rtol 1e-5 / atol 1e-6·max(1, max|plain|),
    bfloat16 within 2e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_ref
    smoke = _smoke()
    dev = torch.device("cuda", 0)
    for i, (rows, D, dt, rs) in enumerate(smoke.rms_cases()):
        if dt != dtype:
            continue
        x, w = smoke.rms_inputs(np, torch, rows, D, dt, dev, seed=i)
        smoke.check_close(np, rmsnorm_cuda(x, w, round_scale=rs),
                          rmsnorm_ref(x, w, round_scale=rs), dt,
                          f"rows={rows} D={D} round_scale={rs}")
    x, w = smoke.rms_inputs(np, torch, 7, 896, dtype, dev, seed=99)
    for rs in smoke.ROUND_SCALE:
        smoke.check_close(np, rmsnorm_cuda(smoke.unaligned(torch, x), w,
                                           round_scale=rs),
                          rmsnorm_ref(x, w, round_scale=rs), dtype,
                          f"unaligned round_scale={rs}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_matches_plain(dtype):
    """Flash attention over ``chip_smoke``'s phase 5 grid (mode × GQA ×
    S × hd) in one dtype, at the same tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)
    smoke = _smoke()
    dev = torch.device("cuda", 0)
    for i, ((mode, kw), G, S, hd, dt) in enumerate(smoke.flash_cases()):
        if dt != dtype:
            continue
        q, k, v = smoke.flash_inputs(np, torch, 2, S, 2 * G, 2, hd, dt, dev,
                                     i)
        smoke.check_close(np, flash_attention_cuda(q, k, v, **kw),
                          attention_ref(q, k, v, **kw), dt,
                          f"{mode} G={G} S={S} hd={hd}")
    if dtype == "bfloat16":
        q, k, v = smoke.flash_inputs(np, torch, 1, 64, 14, 2, 64, dtype,
                                     dev)
        bad = torch.zeros(1, 64, 14 * 64 + 4, dtype=q.dtype, device=dev)
        bad = bad[..., :14 * 64].unflatten(-1, (14, 64))
        bad.copy_(q)
        with pytest.raises(ValueError, match="TMA"):
            flash_attention_cuda(bad, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_scan_matches_plain(dtype):
    """The SSD scan over ``chip_smoke``'s phase 5 grid in one dtype, at
    its tolerances; a sequence that is not a multiple of the chunk
    raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.ssd_scan import ssd_cuda, ssd_ref
    smoke = _smoke()
    dev = torch.device("cuda", 0)
    for i, (B, S, nh, ng, hd, N, chunk, decay, dt) in enumerate(
            smoke.ssd_cases()):
        if dt != dtype:
            continue
        args = smoke.ssd_inputs(np, torch, B, S, nh, ng, hd, N, decay, dt,
                                dev, seed=i)
        (y, h), (y_r, h_r) = ssd_cuda(*args, chunk), ssd_ref(*args, chunk)
        what = f"B={B} S={S} nh={nh} ng={ng} hd={hd} N={N} chunk={chunk} {decay}"
        smoke.check_close(np, y, y_r, dt, what, smoke.SSD_F32)
        smoke.check_close(np, h, h_r, "float32", what, smoke.SSD_F32)
    args = smoke.ssd_inputs(np, torch, 1, smoke.SSD_RAGGED, 4, 1, 64, 128,
                            "slow", dtype, dev)
    with pytest.raises(ValueError, match="not a multiple"):
        ssd_cuda(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_bwd_matches_plain(dtype):
    """The flash backward kernel over ``chip_smoke``'s phase 5 backward
    grid (mode × GQA × S × hd) in one dtype, at its tolerances
    (``chip_smoke.check_flash_bwd``: two runs bit for bit alike, the
    forward's lse against the plain one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    smoke = _smoke()
    dev = torch.device("cuda", 0)
    for i, case in enumerate(smoke.flash_bwd_cases()):
        if case[-1] == dtype:
            smoke.check_flash_bwd(np, torch, case, dev, i)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rmsnorm_bwd_matches_plain(dtype):
    """The RMSNorm backward kernel over ``chip_smoke``'s phase 5 backward
    grid and an unaligned row, in one dtype (``chip_smoke.check_rms_bwd``:
    dx within one bf16 ulp in bfloat16, dw at the float32 tolerance, two
    runs bit for bit alike)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    smoke = _smoke()
    dev = torch.device("cuda", 0)
    for i, (rows, D, dt) in enumerate(smoke.rms_bwd_cases()):
        if dt == dtype:
            smoke.check_rms_bwd(np, torch, rows, D, dt, dev, seed=i)
    smoke.check_rms_bwd(np, torch, 7, 896, dtype, dev, seed=99, shift=True)


@pytest.mark.cuda
def test_cuda_flash_attention_bwd_on_tensor_cores():
    """The bfloat16 flash backward's two tensor-core kernels
    (``chip_smoke.FLASH_BWD_TC``) each have ``HGMMA`` instructions in the
    SASS of the built flash library."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import _build
    smoke = _smoke()
    _build.load("flash_attention")
    counts = smoke.flash_bwd_sass(_build._target("flash_attention"))
    assert set(counts) == set(smoke.FLASH_BWD_TC)
    assert all(n > 0 for n in counts.values())
