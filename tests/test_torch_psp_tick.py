"""The port's plain tick (``repro_torch.kernels.psp_tick.psp_tick_ref``)
against the reference's ``repro.kernels.psp_tick.psp_tick_ref``.

The reference runs eagerly, under ``jax.disable_jit()``: jitted XLA
contracts ``t0 + base·(1 + (u − ½))`` into a fused multiply-add, which
moves event times by one ulp against any unfused evaluation, while the
eager reference rounds every operation like the port does.  So the
control plane (``pol_ema``'s elementwise update included) must agree
exactly.  The data plane (``w``, ``pulled``) sums its residuals and
gradients in another order than XLA's dot, so it agrees within
rtol 1e-5 / atol 1e-6.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro.kernels.psp_tick import psp_tick_ref as jax_tick  # noqa: E402
from repro_torch.convert import (tick_inputs_to_torch, to_numpy,  # noqa: E402
                                 to_torch)
from repro_torch.kernels import ops, psp_tick  # noqa: E402
from repro_torch.kernels.psp_tick import psp_tick_ref  # noqa: E402
from test_kernels import _tick_problem  # noqa: E402

#: outputs that must match bit for bit (the control plane)
EXACT = ("steps", "alive", "computing", "event_time", "ready", "blocked",
         "pend_leave", "pend_join", "pol_thr", "pol_beta", "pol_ema",
         "fin", "start", "n_fin", "ctrl")
#: the f32 data plane, summed in another order than XLA's
DATA_TOL = dict(rtol=1e-5, atol=1e-6)

CASES = [
    (False, False, 0, False),
    (False, False, 1, False),        # β = 1 shared-uniform path
    (False, False, 3, False),        # shared-score rank path
    (True, False, 2, False),         # churn: per-row masked scores
    (False, True, 2, False),         # ragged padding: dead-slot masking
    (True, True, 2, False),          # churn × ragged
    (False, False, 0, True),         # adaptive full-view (dssp/ebsp) rows
    (False, False, 3, True),         # adaptive incl. β-annealing rows
    (True, True, 2, True),           # adaptive × churn × ragged
]


def _rand_for_tick(rand, i):
    """Fresh noise for chained tick ``i``, shaped like ``rand``."""
    rng = np.random.default_rng(100 + i)
    return {k: (rng.normal(size=v.shape) if k in ("X", "mb")
                else rng.random(v.shape)).astype(np.float32)
            for k, v in rand.items()}


def _compare(ref, port, what):
    for k, v in ref.items():
        got = port[k]
        if k in EXACT:
            np.testing.assert_array_equal(got, np.asarray(v),
                                          err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(got, np.asarray(v), **DATA_TOL,
                                       err_msg=f"{what} {k}")


@pytest.mark.parametrize("churn,ragged,k_max,adaptive", CASES)
def test_ref_tick_matches_reference(churn, ragged, k_max, adaptive):
    """5 chained ticks from ``_tick_problem``: control plane exact, data
    plane within tolerance, row 0 crossing its horizon mid-run."""
    B, P = 3, 8
    state, rand, params, leave_n, join_n, masked = _tick_problem(
        0, B, P, churn, ragged, k_max, adaptive=adaptive)
    kw = dict(k_max=k_max, has_churn=churn, masked=masked,
              adaptive=adaptive)
    s_jax = dict(state)
    s_pt, _, p_pt = tick_inputs_to_torch(state, {}, params)
    ln, jn = to_torch(leave_n), to_torch(join_n)
    for i in range(5):
        t = np.float32(0.4 * (i + 1))
        rand_i = _rand_for_tick(rand, i)
        with jax.disable_jit():
            s_jax, o_jax = jax_tick(s_jax, rand_i, params, t, leave_n,
                                    join_n, **kw)
        _, r_pt, _ = tick_inputs_to_torch({}, rand_i, {})
        s_pt, o_pt = psp_tick_ref(s_pt, r_pt, p_pt, float(t), ln, jn, **kw)
        _compare(s_jax, to_numpy(s_pt), f"tick {i} state")
        _compare(o_jax, to_numpy(o_pt), f"tick {i} out")


@pytest.mark.parametrize("adaptive", (False, True))
def test_frozen_row_is_inert(adaptive):
    """Rows past their horizon do not move: state unchanged (policy state
    included), no finishes, no starts, no control traffic."""
    B, P = 3, 8
    state, rand, params, leave_n, join_n, masked = _tick_problem(
        1, B, P, True, False, 2, adaptive=adaptive)
    params = dict(params, horizon=np.zeros(B, np.float32))
    s, r, p = tick_inputs_to_torch(state, rand, params)
    new, out = psp_tick_ref(s, r, p, 1.0, to_torch(leave_n + 1),
                            to_torch(join_n), k_max=2, has_churn=True,
                            masked=masked, adaptive=adaptive)
    for k, v in to_numpy(new).items():
        np.testing.assert_array_equal(v, state[k], err_msg=f"state {k}")
    assert not out["fin"].any() and not out["start"].any()
    assert int(out["n_fin"].sum()) == 0 and int(out["ctrl"].sum()) == 0


def test_data_plane_rows_are_independent():
    """A row's data-plane bits do not depend on the rows batched with it:
    one row ticked alone equals the same row inside a batch."""
    B, P = 3, 8
    state, rand, params, leave_n, join_n, masked = _tick_problem(
        2, B, P, False, False, 3)
    kw = dict(k_max=3, has_churn=False, masked=masked)
    s, r, p = tick_inputs_to_torch(state, rand, params)
    full, _ = psp_tick_ref(s, r, p, 0.4, to_torch(leave_n),
                           to_torch(join_n), **kw)
    row = lambda d: {k: (v[1:2] if isinstance(v, torch.Tensor)
                         and v.shape[:1] == (B,) else v)
                     for k, v in d.items()}
    one, _ = psp_tick_ref(row(s), r, row(p), 0.4, to_torch(leave_n[1:2]),
                          to_torch(join_n[1:2]), **kw)
    for k in ("w", "pulled"):
        assert torch.equal(one[k][0], full[k][1]), k


def test_dispatch():
    """``auto`` sends CPU tensors to the plain version; unknown impls and
    ``cuda`` on CPU tensors raise instead of running the plain version."""
    B, P = 3, 8
    state, rand, params, leave_n, join_n, masked = _tick_problem(
        3, B, P, False, False, 1)
    s, r, p = tick_inputs_to_torch(state, rand, params)
    call = functools.partial(ops.psp_tick, s, r, p, 0.4, to_torch(leave_n),
                             to_torch(join_n), k_max=1, has_churn=False,
                             masked=masked)
    a, _ = call(impl="auto")
    b, _ = call(impl="ref")
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="unknown impl"):
        call(impl="pallas")
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(impl="cuda")
    assert not ops.use_kernel("auto", torch.device("cpu"))
    assert ops.use_kernel("auto", torch.device("cuda", 0))


@pytest.mark.parametrize("churn,ragged,k_max,adaptive", CASES)
def test_plain_tick_leaves_inputs_unwritten(churn, ragged, k_max, adaptive):
    """Through ``ops.psp_tick`` on CPU tensors (the plain version) the
    tick writes none of its inputs, ``w`` and ``pulled`` included
    (bitwise against copies taken before), and two calls on the same
    inputs give identical outputs."""
    B, P = 3, 8
    state, rand, params, leave_n, join_n, masked = _tick_problem(
        4, B, P, churn, ragged, k_max, adaptive=adaptive)
    s, r, p = tick_inputs_to_torch(state, rand, params)
    ln, jn = to_torch(leave_n), to_torch(join_n)
    inputs = (s, r, {k: v for k, v in p.items()
                     if isinstance(v, torch.Tensor)}, {"ln": ln, "jn": jn})
    before = [{k: v.clone() for k, v in d.items()} for d in inputs]
    kw = dict(k_max=k_max, has_churn=churn, masked=masked,
              adaptive=adaptive)
    got = [ops.psp_tick(s, r, p, 0.4, ln, jn, **kw) for _ in range(2)]
    for part in range(2):
        a, b = got[0][part], got[1][part]
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for was, now in zip(before, inputs):
        for k, v in was.items():
            assert torch.equal(v, now[k]), f"input {k} written"


def test_tick_bytes_hand_counted():
    """``tick_bytes`` on a one-row, three-node tick, counted by hand.

    d = 4, m = 2; fin = [T, F, F], start = [T, T, F]: one finisher (it
    starts too), two starters, one pushed node.
    """
    f32, i32 = torch.float32, torch.int32
    state = {"steps": torch.zeros((1, 3), dtype=i32),          # 12 B
             "alive": torch.ones((1, 3), dtype=torch.bool),     # 3 B
             "w": torch.zeros((1, 4), dtype=f32),               # 16 B
             "pulled": torch.zeros((1, 3, 4), dtype=f32)}       # 48 B
    rand = {"X": torch.zeros((3, 2, 4), dtype=f32),             # 96 B
            "mb": torch.zeros((3, 2), dtype=f32),               # 24 B
            "dur": torch.zeros((1, 3), dtype=f32)}              # 12 B
    params = {"lr": torch.zeros(1, dtype=f32), "eps": 1e-4}     # 4 B
    fin = torch.tensor([[True, False, False]])
    start = torch.tensor([[True, True, False]])
    # both read: steps 12 + alive 3 + w 16 + dur 12 + lr 4 + leave_n and
    # join_n 8, and X and mb of the one pushed node: 2·4·4 + 2·4 = 40
    common = 12 + 3 + 16 + 12 + 4 + 8 + 40
    # in place: reads the finisher's view (16); writes steps, alive, w
    # (31), the two starters' views (32), fin and start (6), n_fin and
    # ctrl (8), the finisher's residual (4·2 = 8)
    assert psp_tick.tick_bytes(state, rand, params, fin, start,
                               in_place=True) == (common + 16,
                                                 31 + 32 + 6 + 8 + 8)
    # fresh output: reads the views of the finisher and of the one
    # non-starter (32); writes every state tensor (79), fin, start, n_fin
    # and ctrl (14)
    assert psp_tick.tick_bytes(state, rand, params, fin, start,
                               in_place=False) == (common + 32, 79 + 14)


def test_params_staging_is_for_the_kernel():
    """``stage_params`` (the kernel's staging) raises on CPU tensors, and
    a staged ``TickParams`` is still the same mapping, which the plain
    version takes as it takes the dict."""
    B, P = 3, 8
    state, rand, params, leave_n, join_n, masked = _tick_problem(
        5, B, P, False, False, 2)
    s, r, p = tick_inputs_to_torch(state, rand, params)
    with pytest.raises(ValueError, match="CUDA tensor"):
        psp_tick.stage_params(p, adaptive=False)
    staged = psp_tick.TickParams(p)
    assert dict(staged) == p
    kw = dict(k_max=2, has_churn=False, masked=masked)
    a, _ = psp_tick_ref(s, r, p, 0.4, to_torch(leave_n), to_torch(join_n),
                        **kw)
    b, _ = psp_tick_ref(s, r, staged, 0.4, to_torch(leave_n),
                        to_torch(join_n), **kw)
    assert all(torch.equal(a[k], b[k]) for k in a)
