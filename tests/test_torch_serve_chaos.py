"""The port's serve and chaos benchmarks (``repro_torch.bench.serve_bench``,
``repro_torch.bench.chaos_bench``) against the reference's
(``benchmarks.serve_bench``, ``benchmarks.chaos_bench``), on the CPU.

* ``serve_load`` at the reference's ``--smoke`` shape has the reference's
  key set at every level and passes the unchanged
  ``tools/check_bench.check_serve({}, res)``: two swaps, traffic on two
  versions, nothing dropped;
* ``chaos_suite(smoke=True)`` passes the unchanged
  ``check_chaos({}, res)``; its serving segment's keys equal the
  reference's ``serving_chaos`` at the smoke shape, its cluster keys
  those ``benchmarks/chaos_bench.py`` builds (written out below);
* the CLIs' exit rules, and the entry points raise without a GPU unless
  asked for the CPU.

No test here reads ``results/benchmarks/``.  The reference runs its own
functions; the schemas compare key sets, as the timings differ.
"""
import json

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from benchmarks import chaos_bench as jchaos  # noqa: E402
from benchmarks import serve_bench as jserve  # noqa: E402
from repro_torch.bench import chaos_bench as tchaos  # noqa: E402
from repro_torch.bench import serve_bench as tserve  # noqa: E402
from tools.check_bench import check_chaos, check_serve  # noqa: E402

#: the reference's --smoke shapes
SERVE_SMOKE = dict(requests=9, rate_rps=16.0, batch=2, max_new=4)
CHAOS_SERVING_SMOKE = dict(requests=10, rate_rps=8.0)
#: the keys benchmarks/chaos_bench.py's cluster_chaos builds
CLUSTER_KEYS = {"workers", "ticks", "dim", "batch", "plan", "nofault",
                "faulted", "goodput_ratio", "recovery_latency_s",
                "victims", "live_restarts", "completed"}
NOFAULT_KEYS = {"pushes", "wall_s", "goodput_pushes_per_s"}
FAULTED_KEYS = NOFAULT_KEYS | {"events", "epochs", "recovery"}


def _keys(x):
    """The nested key sets of a result (dicts only; leaves dropped)."""
    if isinstance(x, dict):
        return {k: _keys(v) for k, v in x.items()}
    return None


@pytest.fixture(scope="module")
def port_serve():
    return tserve.serve_load(**SERVE_SMOKE, device="cpu")


@pytest.fixture(scope="module")
def port_chaos():
    return tchaos.chaos_suite(smoke=True, device="cpu")


def test_serve_schema_equals_reference(port_serve):
    want = jserve.serve_load(**SERVE_SMOKE)
    assert _keys(port_serve) == _keys(want)
    for k in ("arch", "requests", "rate_rps", "batch", "max_new_tokens",
              "prompt_len"):
        assert port_serve[k] == want[k]


def test_serve_passes_check_serve(port_serve):
    assert check_serve({}, port_serve) == []
    assert port_serve["swaps"] == 2 and port_serve["dropped"] == 0
    assert port_serve["total_tokens"] == (SERVE_SMOKE["requests"]
                                          * SERVE_SMOKE["max_new"])
    json.dumps(port_serve)


def test_open_loop_returns_its_engines():
    from repro_torch.configs import get_config, reduced
    from repro_torch.serving import ServeConfig
    cfg = reduced(get_config("qwen2-0.5b"), d_model=64)
    res, engines = tserve.open_loop(
        cfg, ServeConfig(batch=2, max_len=64, max_new_tokens=3), requests=6,
        rate_rps=50.0, prompt_len=5, device="cpu")
    warm, eng = engines
    assert warm.prefill_calls == 1 and eng.prefill_calls >= 3
    assert res["swaps"] == 2 and res["dropped"] == 0
    assert res["decode_steps"] >= 3


def test_chaos_passes_check_chaos(port_chaos):
    assert check_chaos({}, port_chaos) == []
    assert tchaos.invariants_hold(port_chaos)
    assert port_chaos["smoke"] is True


def test_chaos_schema_equals_reference(port_chaos):
    want = jchaos.serving_chaos(**CHAOS_SERVING_SMOKE)
    assert set(port_chaos) == {"smoke", "cluster", "serving"}
    assert set(port_chaos["serving"]) == set(want)
    assert (set(port_chaos["serving"]["publish_faults"])
            == set(want["publish_faults"]))
    c = port_chaos["cluster"]
    assert set(c) == CLUSTER_KEYS
    assert set(c["nofault"]) == NOFAULT_KEYS
    assert set(c["faulted"]) == FAULTED_KEYS
    assert (c["workers"], c["ticks"], c["dim"], c["batch"]) == (3, 24, 16, 4)


def test_serve_cli_exit_rule(monkeypatch, tmp_path, capsys):
    out = tmp_path / "serve.json"
    good = {"arch": "a", "requests": 1, "rate_rps": 1.0,
            "tokens_per_s": 1.0, "wall_s": 1.0, "swaps": 2,
            "dropped": 0, "versions_served": [0, 1],
            "swap_stall_s": {"max": 0.0, "events": []},
            "latency_s": {k: {"p50": 0.0, "p99": 0.0} for k in (
                "per_token", "per_request", "first_token")}}
    monkeypatch.setattr(tserve, "serve_load", lambda **kw: good)
    assert tserve.main(["--out", str(out), "--device", "cpu"]) == 0
    assert json.loads(out.read_text()) == good
    monkeypatch.setattr(tserve, "serve_load",
                        lambda **kw: {**good, "swaps": 1})
    assert tserve.main(["--smoke", "--device", "cpu",
                        "--out", str(out)]) == 1
    assert "FAIL" in capsys.readouterr().out


def test_chaos_cli_exit_rule(monkeypatch, tmp_path, port_chaos):
    out = tmp_path / "chaos.json"
    monkeypatch.setattr(tchaos, "chaos_suite",
                        lambda smoke, device: port_chaos)
    assert tchaos.main(["--smoke", "--out", str(out)]) == 0
    assert json.loads(out.read_text())["smoke"] is True
    bad = {**port_chaos, "serving": {**port_chaos["serving"], "dropped": 1}}
    monkeypatch.setattr(tchaos, "chaos_suite", lambda smoke, device: bad)
    assert tchaos.main(["--smoke", "--out", str(out)]) == 1


def test_default_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve_load(**SERVE_SMOKE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tchaos.serving_chaos(**CHAOS_SERVING_SMOKE)
