"""The port's roofline (``repro_torch.roofline``): the dispatch counter on
hand-computable cases, the kernels' charges at their boundary, dot
FLOPs of whole steps against the reference's ``analyze_hlo``, and the
sweep tick's row.

Steps are counted at reduced qwen2-0.5b, mamba2-780m, recurrentgemma-2b,
qwen3-moe-30b-a3b and musicgen-large (2 layers (recurrentgemma 5), d
128, B 2, S 256) on ``meta`` tensors, the reference's compiled with no
mesh.  Prefill and decode agree exactly once three stated formulas are
added to the port's count, each a product the reference's plain code
forms and the kernel formula does not charge:

* the reference's RMSNorm sums each row's squares as a dot: 2·rows·D a
  call;
* its plain attention forms every score of its single 256-token tile:
  2 products × 2·B·H·hd·S² a call, against the causal pairs or the band
  the flash formula charges;
* its SSD forms C·Bᵀ for every head, not once a group: B·(S/Q)·(nh −
  ng)·2·Q²·N a call.

Training adds the backward's products and remat: XLA's CSE merges
recomputed products that the port's eager autograd runs again (the
checkpointed blocks, the cross-entropy chunk), so after the same three
formulas on every forward call the two counts agree within 10 %.
"""
import json

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.configs.base import InputShape as JShape  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro.roofline.hlo_cost import analyze_hlo  # noqa: E402

from _torch_threads import one_torch_thread  # noqa: E402,F401
from repro_torch.bench import roofline_bench  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.roofline import HW, kernel_cost as kc  # noqa: E402
from repro_torch.roofline import model_flops, roofline_report  # noqa: E402
from repro_torch.roofline.dispatch_cost import DispatchCost  # noqa: E402

ARCHS = ("qwen2-0.5b", "mamba2-780m", "recurrentgemma-2b",
         "qwen3-moe-30b-a3b", "musicgen-large")
B, S, D = 2, 256, 128
TRAIN_RTOL = 0.10


def test_plain_matmul():
    """A 256³ matmul: 2·256³ FLOPs, three 256² f32 tensors of bytes,
    all of them heavy; a transpose is a view and costs nothing."""
    a = torch.empty(256, 256, device="meta")
    with DispatchCost() as c:
        a @ a.T
    assert c.flops == 2 * 256 ** 3
    assert c.bytes == c.bytes_min == 3 * 256 * 256 * 4
    assert c.ops == {"mm": 1}


def test_loop_trip_count():
    """Eight iterations of w[i] @ x → tanh: every trip dispatches, so
    FLOPs and bytes are 8× one trip's; the slices are views (free) and
    tanh is not heavy."""
    w = torch.empty(8, 512, 512, device="meta")
    x = torch.empty(512, 1, device="meta")
    with DispatchCost() as c:
        for i in range(8):
            x = torch.tanh(w[i] @ x)
    assert c.flops == 8 * 2 * 512 ** 2
    one = 512 * 512 * 4 + 2 * 512 * 4
    assert c.bytes_min == 8 * one
    assert c.bytes == 8 * (one + 2 * 512 * 4)


@pytest.mark.parametrize("window", [None, 16])
def test_attention_charged_at_the_kernel_boundary(window):
    """ops.attention (and its backward) charges the flash formula, the
    causal pairs or the band, and nothing of the plain version's S²
    products inside; RMSNorm its bytes."""
    Bq, Sq, H, KV, hd = 2, 64, 4, 2, 32
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(Bq, Sq, n, hd, generator=g).requires_grad_()
               for n in (H, KV, KV))
    with DispatchCost() as c:
        o = ops.attention(q, k, v, window=window, impl="ref")
        torch.autograd.grad(o.sum(), (q, k, v))
    fwd = kc.attention_flops(Bq, Sq, H, hd, window=window)
    bwd = kc.attention_flops(Bq, Sq, H, hd, window=window, backward=True)
    pairs = Sq * Sq // 2 if window is None else kc.band_pairs(Sq, window)
    assert fwd == 4 * Bq * H * hd * pairs
    assert bwd == 10 * Bq * H * hd * pairs
    assert c.kernels["flash_attention"] == {
        "calls": 1, "flops": fwd, "bytes": kc.attention_bytes(
            Bq, Sq, H, KV, hd, 4, lse=True)}
    assert c.kernels["flash_attention_bwd"] == {
        "calls": 1, "flops": bwd, "bytes": kc.attention_bytes(
            Bq, Sq, H, KV, hd, 4, backward=True)}
    assert c.flops == fwd + bwd                 # o.sum()'s ops: no dot
    x, w = torch.randn(7, 64, generator=g), torch.ones(64)
    with DispatchCost() as c:
        ops.rmsnorm(x, w, impl="ref")
    assert c.kernels["rmsnorm"]["bytes"] == 2 * 7 * 64 * 4 + 64 * 4
    assert dict(c.ops) == {}


def test_report_terms_and_figures():
    """The three terms against the H100's data-sheet figures, and the
    times chip_smoke.py's bounds read."""
    hw = HW()
    assert (hw.peak_flops, hw.f32_flops, hw.hbm_bw, hw.hbm_bytes) == (
        989e12, 67e12, 3.35e12, 80e9)
    rep = roofline_report({"flops": 989e12, "bytes accessed": 3.35e12},
                          chips=1, model_flops_total=989e12)
    assert abs(rep.compute_s - 1.0) < 1e-12
    assert abs(rep.memory_s - 1.0) < 1e-12
    assert rep.collective_s == 0.0 and rep.useful_ratio == 1.0
    rep = roofline_report({"flops": 1.0, "bytes accessed": 1e12},
                          model_flops_total=0.5)
    assert rep.bottleneck == "memory" and rep.useful_ratio == 0.5
    # two of chip_smoke.py's phase-5 bounds: flash at S 4096 and at
    # h2o-danube-1.8b's prefill
    t_ops, t_bytes = kc_times(kc.attention_flops(1, 4096, 14, 64), 0)
    assert f"{t_ops:.4f}" == "0.0304"
    flops = kc.attention_flops(4, 6144, 32, 80, window=4096)
    nbytes = kc.attention_bytes(4, 6144, 32, 8, 80, 2)
    assert f"{max(kc_times(flops, nbytes)):.4f}" == "0.6949"
    assert model_flops(get_config("qwen2-0.5b"),
                       InputShape("x", 10, 2, "decode")) == (
        2.0 * get_config("qwen2-0.5b").param_count(active_only=True) * 2)


def kc_times(flops, nbytes):
    from repro_torch.roofline import times_ms
    return times_ms(flops, nbytes)


def ref_flops(arch, kind):
    """analyze_hlo's dot FLOPs of the reference's step, compiled with no
    mesh."""
    cfg = jreduced(jget(arch), d_model=D)
    shape = JShape("x", S, B, kind)
    rules = jsh.make_rules(cfg, shape, None)
    with jsh.use_rules(rules):
        args, step, donate = jsteps.dryrun_inputs(cfg, shape, rules)
        hlo = jax.jit(step, donate_argnums=donate).lower(*args).compile()
    return analyze_hlo(hlo.as_text()).flops


def port_count(arch, kind, monkeypatch):
    """(the port's dispatch count, the kernel wrappers' forward calls by
    name with their first argument's shape)."""
    cfg = reduced(get_config(arch), d_model=D)
    shape = InputShape("x", S, B, kind)
    calls = []
    for name in ("attention", "rmsnorm", "ssd"):
        fn = getattr(ops, name)

        def rec(x, *a, _fn=fn, _name=name, **kw):
            calls.append((_name, tuple(x.shape), a, kw))
            return _fn(x, *a, **kw)
        monkeypatch.setattr(ops, name, rec)
    args, step, _ = steps.dryrun_inputs(cfg, shape, None, impl="ref")
    with DispatchCost() as c:
        step(*steps.meta_inputs(args, shape))
    return cfg, c, calls


def reference_extra(cfg, calls):
    """The three formulas of the module docstring over the forward
    calls."""
    extra = 0
    for name, shp, a, kw in calls:
        if name == "rmsnorm":
            extra += 2 * int(np.prod(shp[:-1])) * shp[-1]
        elif name == "attention":
            b, s, h, hd = shp
            extra += 4 * b * h * hd * s * s - kc.attention_flops(
                b, s, h, hd, causal=kw.get("causal", True),
                window=kw.get("window"))
        elif name == "ssd":
            b, s, nh, hd = shp
            ng, N = a[2].shape[2:]
            Q = min(kw.get("chunk", 128), s)
            extra += b * (s // Q) * (nh - ng) * 2 * Q * Q * N
    return extra


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dot_flops_match_analyze_hlo(arch, kind, monkeypatch):
    """The port's step FLOPs plus the reference's extra products (the
    module docstring) equal analyze_hlo's: exactly at prefill and
    decode, within 10 % in training."""
    want = ref_flops(arch, kind)
    cfg, c, calls = port_count(arch, kind, monkeypatch)
    got = c.flops + reference_extra(cfg, calls)
    if kind == "train":
        assert abs(got - want) <= TRAIN_RTOL * want, (got, want)
    else:
        assert got == want, (c.flops, got, want)


def test_sweep_tick_row_on_cpu():
    """sweep_tick_row on the CPU runs the plain tick: the counted FLOPs
    and bytes per tick and the roofline terms are filled, the card's
    fields are None."""
    row = roofline_bench.sweep_tick_row(n_nodes=16, dim=4, rows=2,
                                        device="cpu")
    assert row["status"] == "ok" and row["device"] == "cpu"
    assert row["ticks"] > 0 and row["flops_per_tick"] > 0
    assert row["bytes_per_tick"] > 0 and row["host_s"] > 0
    assert row["memory_s"] > 0 and row["bottleneck"] in ("compute",
                                                         "memory")
    assert row["roofline_s"] == max(row["compute_s"], row["memory_s"])
    for key in ("measured_s", "measured_tick_us", "useful_ratio"):
        assert row[key] is None
    json.dumps(row)
