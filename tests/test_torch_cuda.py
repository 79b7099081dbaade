"""The CUDA tick against its plain PyTorch version, on the card.

Needs an NVIDIA GPU and ``nvcc`` (the kernel builds on first use); skips
elsewhere.  Inputs come from ``chip_smoke.tick_problem`` (numpy only, so
this file runs where JAX is not installed): all nine static branch cases
of the tick, 5 chained ticks each.  The control plane must match exactly;
``w``, ``pulled`` and ``pol_ema`` within rtol 1e-5, atol
1e-6·max(1, max|plain|), because the kernel sums the gradient in another
order.  Run on the card with::

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
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.convert import tick_inputs_to_torch, to_torch
    from repro_torch.kernels.psp_tick import psp_tick_cuda, psp_tick_ref
    smoke = _smoke()
    churn, ragged, k_max, adaptive = smoke.CASES[case]
    dev = torch.device("cuda", 0)
    st, shapes, prm, ln, jn, masked = smoke.tick_problem(
        np, 0, 3, 8, churn, ragged, k_max, 5, 4, adaptive)
    kw = dict(k_max=k_max, has_churn=churn, masked=masked,
              adaptive=adaptive)
    s_r, _, p = tick_inputs_to_torch(st, {}, prm, dev)
    s_k = dict(s_r)
    ln, jn = to_torch(ln, dev), to_torch(jn, dev)
    for i in range(5):
        _, r, _ = tick_inputs_to_torch({}, smoke.draw(np, shapes, 100 + i),
                                       {}, dev)
        t = float(np.float32(0.4 * (i + 1)))
        s_r, o_r = psp_tick_ref(s_r, r, p, t, ln, jn, **kw)
        s_k, o_k = psp_tick_cuda(s_k, r, p, t, ln, jn, **kw)
        smoke.compare(np, s_r, s_k, f"tick {i}")
        smoke.compare(np, o_r, o_k, f"tick {i} out")
