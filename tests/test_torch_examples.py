"""The port's examples (``repro_torch.examples``) against the reference's
(``examples/``), on the CPU.

* ``train_e2e`` hands ``repro_torch.launch.train`` the argument list the
  reference hands ``repro.launch.train`` (default, ``--large``, and
  flags passed through);
* ``barrier_sweep``'s stage 1 on the numpy backend equals the
  reference's numpy backend bit for bit (every scenario's steps, error
  trace and counters, and the printed table); stage 2 runs at 2 ticks;
* ``elastic_train`` run straight to N ticks ends where N/2 ticks,
  a checkpoint and ``--resume`` to N end: the final checkpoints (the
  whole PSP state and the noise generator's state) equal bit for bit;
* ``serve_demo`` and ``live_serve --smoke`` exit 0 on ``--device cpu``;
* without a GPU every example raises unless asked for the CPU.
"""
import io
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import examples.barrier_sweep as jsweep  # noqa: E402
import examples.train_e2e as je2e  # noqa: E402
from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.examples import (barrier_sweep, elastic_train,  # noqa: E402
                                  live_serve, serve_demo, train_e2e)

ELASTIC_N = 40


@pytest.mark.parametrize("argv", [
    [], ["--large"], ["--barrier", "bsp", "--steps", "7", "--large"],
    ["--steps", "3", "--ckpt-dir", "/tmp/e2e", "--resume"]],
    ids=["default", "large", "large-bsp", "pass-through"])
def test_train_e2e_arguments_equal_reference(argv, monkeypatch):
    seen = []
    monkeypatch.setattr(je2e, "train_main", lambda args: seen.append(args))
    monkeypatch.setattr(sys, "argv", ["train_e2e.py", *argv])
    je2e.main()
    assert train_e2e.train_args(argv) == seen[0]


def _sweep_capture(module, monkeypatch):
    """Run ``module.simulator_presweep(backend="numpy")``; its printout
    and the sweep's results."""
    real, got = module.run_sweep, []

    def capture(cfgs, **kw):
        got.extend(real(cfgs, **kw))
        return got
    monkeypatch.setattr(module, "run_sweep", capture)
    buf = io.StringIO()
    with redirect_stdout(buf):
        module.simulator_presweep(backend="numpy")
    return buf.getvalue(), got


def test_barrier_sweep_stage1_equals_reference(monkeypatch):
    want_out, want = _sweep_capture(jsweep, monkeypatch)
    got_out, got = _sweep_capture(barrier_sweep, monkeypatch)
    assert got_out == want_out
    assert len(got) == len(want) == 15
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.steps, b.steps)
        np.testing.assert_array_equal(a.errors, b.errors)
        np.testing.assert_array_equal(a.server_updates, b.server_updates)
        assert (a.total_updates, a.control_messages, a.mean_progress,
                a.final_error) == (b.total_updates, b.control_messages,
                                   b.mean_progress, b.final_error)


def test_barrier_sweep_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(barrier_sweep, "TICKS", 2)
    barrier_sweep.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "torch backend" in out and "near-ASP step throughput" in out
    rows = [line.split() for line in out.splitlines()
            if line.split()[:1] and line.split()[0] in barrier_sweep.BARRIERS]
    assert len(rows) == 10 and all(np.isfinite(float(r[1])) for r in rows)


def _npz(d, step):
    with np.load(f"{d}/step_{step:08d}.npz") as z:
        return {k: z[k] for k in z.files}


def test_elastic_train_resume_is_bit_for_bit(tmp_path, capsys):
    straight, split = tmp_path / "straight", tmp_path / "split"
    flags = ["--device", "cpu", "--workers", "6", "--contribution",
             "mean-alive", "--leave-rate", "20", "--join-rate", "20"]
    elastic_train.main([*flags, "--ticks", str(ELASTIC_N),
                        "--ckpt-dir", str(straight)])
    whole = capsys.readouterr().out
    elastic_train.main([*flags, "--ticks", str(ELASTIC_N // 2),
                        "--ckpt-dir", str(split)])
    elastic_train.main([*flags, "--ticks", str(ELASTIC_N),
                        "--ckpt-dir", str(split), "--resume"])
    resumed = capsys.readouterr().out
    assert f"resumed tick {ELASTIC_N // 2}" in resumed
    assert latest_step(str(straight)) == latest_step(str(split)) == ELASTIC_N
    a, b = _npz(straight, ELASTIC_N), _npz(split, ELASTIC_N)
    assert set(a) == set(b) and "noise_state" in a
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    # the churn fired, and both runs end on the same summary
    assert whole.splitlines()[-1] == resumed.splitlines()[-1]
    assert not whole.splitlines()[-1].startswith("0 leave events")


def test_serve_demo_runs_on_cpu(capsys):
    serve_demo.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in lines] == list(serve_demo.ARCHS)
    assert all("8 reqs, 128 tokens" in line for line in lines)


def test_live_serve_smoke_on_cpu(capsys):
    assert live_serve.main(["--smoke", "--device", "cpu"]) == 0
    assert "OK: zero drops" in capsys.readouterr().out


@pytest.mark.parametrize("main", [
    serve_demo.main, barrier_sweep.main, elastic_train.main, live_serve.main,
    train_e2e.main], ids=["serve_demo", "barrier_sweep", "elastic_train",
                          "live_serve", "train_e2e"])
def test_examples_raise_without_a_gpu(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])
