"""Expert-parallel MoE (``repro_torch.models.moe.moe_apply`` with a mesh)
over gloo worlds of two and four ranks on the CPU.

The reduced qwen3-moe-30b-a3b with 8 experts (top 2; d_model 64, two
layers), its experts split over a ``(data 1, model n)`` mesh for n 2
and 4, on 2 × 24 tokens at capacity factor 1.25, once with an even
router and once with one that overloads expert 0 (tokens dropped):

* against the reference's ``moe_apply(..., mesh=make_host_mesh(1, n))``
  under ``shard_map`` (one subprocess on four forced host devices): the
  same experts picked and, on every rank, the same (token, choice)
  pairs kept and dropped; y within 1e-5 of max |y| and the auxiliary
  loss within 1e-6 relative (float32; the reference sums the ranks' y
  in another order);
* against the port's one-device path: y and aux within the same
  bounds, each rank's expert gradients its slice of the one-device
  gradients and the token and router gradients the whole one-device
  ones, within rtol 1e-4, atol 1e-5 · max(1, max |g|) (float32);
* the whole model's prefill on one recorded routing (the one-device
  run's experts, replayed): every rank's logits within 1e-5 of max
  |logit| of the one-device logits (float32, far above its 1e-4
  agreement floor for two paths; the bf16 floor of ``ROADMAP.md`` §3
  does not arise).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_dist  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch.mesh import spawn_host_world  # noqa: E402
from repro_torch.models import init_model, moe, prefill  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

from test_torch_moe import _inputs  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
CFG = dataclasses.replace(reduced(get_config(ARCH), d_model=64),
                          n_experts=8, n_experts_per_token=2)
#: what the reference's reduced config must change to be CFG's MoE
CHANGES = {k: getattr(CFG, k) for k in (
    "d_model", "d_ff", "n_experts", "n_experts_per_token",
    "moe_capacity_factor")}
CASES = {"even": dict(seed=0), "drops": dict(seed=1, skew=2.0)}
RANKS = (2, 4)
Y_TOL = 1e-5
AUX_TOL = 1e-6
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _cases():
    return {name: _inputs(CFG, **kw) for name, kw in CASES.items()}


@pytest.fixture(scope="module")
def setup():
    """The inputs, the one-device model's tree and recorded routing, the
    reference's answers and each world's results."""
    cases = _cases()
    ref = _torch_dist.Reference(4, {"moe": ("moe", {
        (name, n): (ARCH, CHANGES, x, p)
        for name, (x, p) in cases.items() for n in RANKS})})
    model = init_model(CFG, seed=0)
    tokens = np.random.default_rng(5).integers(
        0, CFG.vocab_size, (2, 24)).astype(np.int64)
    with moe.routing() as seen:
        logits, _ = prefill(model, torch.from_numpy(tokens))
    tree = tree_map(lambda t: t.numpy(), model.tree())
    replay = [s.numpy() for s in seen]
    worlds = {n: spawn_host_world(n, _torch_dist.moe_world, CFG, cases,
                                  tree, tokens, replay, wall=180.0)
              for n in RANKS}
    return {"cases": cases, "logits": logits.numpy(), "replay": replay,
            "ref": ref.result()["moe"], "worlds": worlds}


def _close(got, want, tol, what):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _one_device(x, p):
    """The one-device path's y, aux and gradients of
    ``sum(y²) + aux``."""
    pt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_apply(pt, xt, CFG)
    (y.square().sum() + aux).backward()
    return (y.detach().numpy(), float(aux.detach()),
            {k: v.grad.numpy() for k, v in pt.items()}, xt.grad.numpy())


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_keeps_and_drops_as_reference(setup, case, n):
    """The experts picked and each rank's kept (token, choice) pairs
    equal the reference's shard for shard; y and aux agree."""
    want = setup["ref"][(case, n)]
    kept = np.logical_or.reduce(want["kept"])
    # the overloaded expert drops tokens; the even router drops none
    assert kept.all() == (case == "even")
    for out in setup["worlds"][n]:
        got = out[case]
        np.testing.assert_array_equal(got["top_i"], want["top_i"])
        np.testing.assert_array_equal(got["ok"], want["kept"][out["rank"]])
        _close(got["y"], want["y"], Y_TOL, f"{case} n={n} y")
        assert abs(got["aux"] - want["aux"]) <= AUX_TOL * abs(want["aux"])


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_one_device_path(setup, case, n):
    """y and aux equal the one-device path's within the bounds, whether
    a rank is given its E/n experts or all E."""
    x, p = setup["cases"][case]
    y1, aux1, _, _ = _one_device(x, p)
    for out in setup["worlds"][n]:
        got = out[case]
        for y, aux in ((got["y"], got["aux"]),
                       (got["y_full_leaves"], got["aux_full_leaves"])):
            _close(y, y1, Y_TOL, f"{case} n={n} y")
            assert abs(aux - aux1) <= AUX_TOL * abs(aux1)


@pytest.mark.parametrize("n", RANKS)
def test_expert_slice_gives_each_rank_its_experts(setup, n):
    """``convert.expert_slice`` (placed by the rules, constrained to
    experts over ``model``) gives rank r experts r·E/n … (r+1)·E/n − 1,
    whole."""
    e_loc = CFG.n_experts // n
    _, p = setup["cases"]["even"]
    for out in setup["worlds"][n]:
        mine = slice(out["rank"] * e_loc, (out["rank"] + 1) * e_loc)
        for k in EXPERT_LEAVES:
            np.testing.assert_array_equal(out["even"]["experts"][k],
                                          p[k][mine], err_msg=k)


@pytest.mark.parametrize("n", RANKS)
def test_gradients_match_one_device(setup, n):
    """Each rank's expert gradients are its slice of the one-device
    gradients; the router's and the tokens' are the whole ones."""
    x, p = setup["cases"]["drops"]
    _, _, g1, gx1 = _one_device(x, p)
    e_loc = CFG.n_experts // n
    for out in setup["worlds"][n]:
        mine = slice(out["rank"] * e_loc, (out["rank"] + 1) * e_loc)
        want = {k: (g[mine] if k in EXPERT_LEAVES else g)
                for k, g in g1.items()}
        for k, g in out["grads"].items():
            _close(g, want[k], 1e-4, f"n={n} grad {k}")
        _close(out["grad_x"], gx1, 1e-4, f"n={n} grad x")


@pytest.mark.parametrize("n", RANKS)
def test_prefill_on_one_routing(setup, n):
    """The whole model with each rank holding its experts only, on the
    one-device run's routing: the logits agree, and the first layer (the
    same input on both paths) picks the recorded experts itself."""
    for out in setup["worlds"][n]:
        _close(out["logits"], setup["logits"], Y_TOL, f"n={n} logits")
        np.testing.assert_array_equal(out["seen"][0], setup["replay"][0])
        assert len(out["seen"]) == len(setup["replay"]) == CFG.n_layers
