"""The port's checkpoints: the store and the manager (mirroring
``tests/test_checkpoint.py``), the archive layout shared with the
reference, PSP state restored across the two packages in both
directions, and kill-and-resume through the training launcher.

Layout: a port archive of a model tree holds the reference's keys and
shapes (``groups/<j>/…`` stacked over layers; the PSP views ``[W, G, …]``),
apart from the reference's PRNG ``key`` and the port's ``noise_state``.
Restores across the packages are exact (``np.array_equal``); so is the
resumed run against the uninterrupted one.
"""
import dataclasses
import errno
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.checkpoint import (restore_checkpoint as jrestore,  # noqa: E402
                              save_checkpoint as jsave)
from repro.checkpoint.checkpoint import _flatten as jflatten  # noqa: E402
from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.core import spmd_psp as jsp  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    CheckpointPolicy, archive_keys,
                                    latest_step, read_metadata,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.checkpoint.checkpoint import _flatten  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import spmd_psp as sp  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.serving import SnapshotPublisher  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCH = "qwen2-0.5b"


@pytest.fixture(autouse=True)
def _one_thread():
    """The models here are tiny: under a parallel test run, intra-op
    threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# --------------------------------------------------------------------------- #
# storage format
# --------------------------------------------------------------------------- #
class TestStore:
    def test_bf16_roundtrip_through_f32(self, tmp_path):
        tree = {"w": (torch.arange(7, dtype=torch.float32) / 3).bfloat16(),
                "n": {"i": torch.arange(4, dtype=torch.int32),
                      "b": torch.tensor([True, False])}}
        save_checkpoint(str(tmp_path), 5, tree)
        assert _npz(tmp_path / "step_00000005.npz")["w"].dtype == np.float32
        restored, step = restore_checkpoint(str(tmp_path), tree)
        assert step == 5
        assert restored["w"].dtype == torch.bfloat16
        for x, y in zip(tree_leaves(tree), tree_leaves(restored)):
            assert x.dtype == y.dtype and torch.equal(x, y)

    def test_latest_skips_partial_and_corrupt(self, tmp_path):
        tree = {"w": torch.ones(3)}
        save_checkpoint(str(tmp_path), 3, tree)
        np.savez(tmp_path / "step_00000009.npz", w=np.ones(3))
        np.savez(tmp_path / "step_00000007.npz", w=np.ones(3))
        (tmp_path / "step_00000007.npz.json").write_text("{not json")
        assert latest_step(str(tmp_path)) == 3
        restored, step = restore_checkpoint(str(tmp_path), tree)
        assert step == 3 and torch.equal(restored["w"], tree["w"])

    def test_sidecar_lands_before_npz(self, tmp_path):
        save_checkpoint(str(tmp_path), 12, {"w": torch.zeros(2)},
                        {"note": "x"})
        meta = read_metadata(str(tmp_path), 12)
        assert meta["step"] == 12 and meta["note"] == "x"

    def test_restore_shape_mismatch_raises_valueerror(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, {"w": torch.zeros((2, 3))})
        with pytest.raises(ValueError, match=r"w.*\(2, 3\).*\(3, 2\)"):
            restore_checkpoint(str(tmp_path), {"w": torch.zeros((3, 2))})

    def test_restore_missing_leaf_raises_valueerror(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2)})
        with pytest.raises(ValueError, match="no entry.*extra"):
            restore_checkpoint(str(tmp_path), {"w": torch.zeros(2),
                                               "extra": torch.zeros(1)})


# --------------------------------------------------------------------------- #
# manager: policies, async writer, retention, crash hygiene
# --------------------------------------------------------------------------- #
class TestManager:
    def test_step_policy_and_retention(self, tmp_path):
        tree = {"w": torch.arange(4.0)}
        with CheckpointManager(str(tmp_path),
                               CheckpointPolicy(every_steps=2),
                               keep=2) as mgr:
            for t in range(1, 11):
                saved = mgr.maybe_save(t, tree, {"data_step": t})
                assert saved == (t % 2 == 0)
            mgr.wait()
            files = sorted(f for f in os.listdir(tmp_path)
                           if f.endswith(".npz"))
            assert files == ["step_00000008.npz", "step_00000010.npz"]
            assert mgr.latest_step() == 10
            assert read_metadata(str(tmp_path), 10)["data_step"] == 10

    def test_wall_clock_policy(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path),
                                CheckpointPolicy(every_seconds=0.2))
        try:
            assert not mgr.should_save(1)
            time.sleep(0.25)
            assert mgr.should_save(2)
            mgr.save(2, {"w": torch.zeros(1)}, block=True)
            assert not mgr.should_save(3)
        finally:
            mgr.close()
        assert latest_step(str(tmp_path)) == 2

    def test_explicit_save_only_when_no_policy(self, tmp_path):
        with CheckpointManager(str(tmp_path)) as mgr:
            for t in range(1, 5):
                assert not mgr.maybe_save(t, {"w": torch.zeros(1)})
            mgr.save(4, {"w": torch.zeros(1)}, block=True)
        assert latest_step(str(tmp_path)) == 4

    def test_stale_tmp_and_orphan_sidecar_cleanup(self, tmp_path):
        (tmp_path / "dead123.tmp").write_bytes(b"half a checkpoint")
        (tmp_path / "step_00000005.npz.json").write_text('{"step": 5}')
        save_checkpoint(str(tmp_path), 2, {"w": torch.zeros(1)})
        CheckpointManager(str(tmp_path)).close()
        left = sorted(os.listdir(tmp_path))
        assert left == ["step_00000002.npz", "step_00000002.npz.json"]

    def test_writer_error_surfaces_on_wait(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"bad": np.asarray(["not", "numeric"])})
        with pytest.raises(RuntimeError, match="writer thread failed"):
            mgr.wait()
        mgr.close()

    def test_invalid_policy_rejected(self):
        with pytest.raises(ValueError):
            CheckpointPolicy(every_steps=0)
        with pytest.raises(ValueError):
            CheckpointPolicy(every_seconds=-1.0)

    def test_transient_write_fault_retries(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_write=False,
                                write_retries=3, retry_backoff=0.01)
        mgr.inject_write_fault(OSError(errno.ENOSPC, "disk full"))
        mgr.inject_write_fault(OSError(errno.EIO, "flaky mount"))
        mgr.save(1, {"w": torch.zeros(2)})
        assert mgr.retried_writes == 2
        assert latest_step(str(tmp_path)) == 1
        mgr.close()

    def test_write_fault_exhausts_retries(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_write=False,
                                write_retries=1, retry_backoff=0.01)
        for _ in range(2):
            mgr.inject_write_fault(OSError(errno.ENOSPC, "disk full"))
        with pytest.raises(OSError):
            mgr.save(1, {"w": torch.zeros(2)})
        assert latest_step(str(tmp_path)) is None

    def test_async_retry_is_transparent(self, tmp_path):
        with CheckpointManager(str(tmp_path), write_retries=2,
                               retry_backoff=0.01) as mgr:
            mgr.inject_write_fault(OSError(errno.ENOSPC, "disk full"))
            mgr.save(1, {"w": torch.zeros(2)}, block=True)
            assert mgr.retried_writes == 1
        assert latest_step(str(tmp_path)) == 1

    def test_writer_error_surfaces_on_clean_exit(self, tmp_path):
        with pytest.raises(RuntimeError, match="writer thread failed"):
            with CheckpointManager(str(tmp_path), write_retries=0) as mgr:
                mgr.save(1, {"bad": np.asarray(["not", "numeric"])})

    def test_writer_error_does_not_mask_body_exception(self, tmp_path):
        with pytest.raises(ValueError, match="body failed first"):
            with CheckpointManager(str(tmp_path), write_retries=0) as mgr:
                mgr.save(1, {"bad": np.asarray(["not", "numeric"])})
                raise ValueError("body failed first")

    def test_snapshot_is_taken_before_save_returns(self, tmp_path):
        # the trainer updates its tensors in place: the host copy must
        # be finished when save() returns, before the writer runs
        w = torch.arange(4.0)
        with CheckpointManager(str(tmp_path)) as mgr:
            mgr.save(1, {"w": w})
            w.add_(100.0)
            mgr.wait()
        np.testing.assert_array_equal(
            _npz(tmp_path / "step_00000001.npz")["w"], np.arange(4.0))


# --------------------------------------------------------------------------- #
# one archive layout for both packages
# --------------------------------------------------------------------------- #
def _lm_pair(W=2, d_model=64):
    """Reduced qwen2 PSP states of both packages (pbsp, AdamW), the port's
    on the reference's initial weights."""
    jcfg = jreduced(jget(ARCH), d_model=d_model)
    cfg = reduced(get_config(ARCH), d_model=d_model)
    kw = dict(barrier="pbsp", n_workers=W, sample_size=2, staleness=3,
              straggler_frac=0.25)
    jp, tp = jsp.PSPConfig(**kw), sp.PSPConfig(**kw)
    tree = jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(0)))
    js = jsp.psp_init(jp, jax.tree.map(jnp.asarray, tree),
                      jopt.adamw(3e-3).init, jax.random.PRNGKey(1))
    noise = sp.GeneratorNoise(1)
    st = sp.psp_init(tp, params_from_jax(tree, cfg).tree(),
                     topt.adamw(3e-3).init, noise)
    return cfg, tree, js, st, noise


def _linear_pair(W=3, dim=8):
    kw = dict(barrier="pbsp", n_workers=W, sample_size=2, staleness=3,
              straggler_frac=0.34)
    js = jsp.linear_psp_state(jsp.PSPConfig(**kw), dim, 1)
    noise = sp.GeneratorNoise(1)
    st = sp.linear_psp_state(sp.PSPConfig(**kw), dim, noise)
    return None, None, js, st, noise


PAIRS = {"linear": _linear_pair, "lm": _lm_pair}


def _randomize_port(st, seed):
    """Fill every field of a port PSP state with seeded values, in place
    (the views must stay the tensors the state holds)."""
    rng = np.random.default_rng(seed)
    for t in tree_leaves(sp.state_to_tree(st)):
        if t.dtype == torch.bool:
            v = rng.random(t.shape) < 0.5
        elif t.dtype == torch.int32:
            v = rng.integers(-5, 50, t.shape).astype(np.int32)
        else:
            v = rng.normal(size=t.shape).astype(np.float32)
        t.copy_(torch.from_numpy(np.asarray(v)))
    return st


def _randomize_reference(js, seed):
    rng = np.random.default_rng(seed)

    def one(a):
        a = np.asarray(a)
        if a.dtype == bool:
            return jnp.asarray(rng.random(a.shape) < 0.5)
        if a.dtype.kind in "iu":
            return jnp.asarray(rng.integers(0, 50, a.shape).astype(a.dtype))
        return jnp.asarray(rng.normal(size=a.shape).astype(a.dtype))
    return jsp.state_from_tree(jax.tree.map(one, jsp.state_to_tree(js)))


def _key_shapes(arrays):
    return {k: (tuple(np.shape(v)), np.asarray(v).dtype)
            for k, v in arrays.items()}


def test_params_snapshot_layout_matches_reference(tmp_path):
    """A port snapshot of reduced qwen2 holds the keys, shapes and dtypes
    of the reference's archive of the same tree."""
    cfg, tree, _, _, _ = _lm_pair()
    with SnapshotPublisher(str(tmp_path), cfg, async_write=False) as pub:
        pub.publish(1, params_from_jax(tree, cfg))
    got = _npz(tmp_path / "step_00000001.npz")
    assert any(k.startswith("groups/0/attn/") for k in got)
    assert _key_shapes(got) == _key_shapes(jflatten(tree))


@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_psp_state_layout_matches_reference(tmp_path, kind):
    cfg, _, js, st, noise = PAIRS[kind]()
    save_checkpoint(str(tmp_path), 1, train.psp_archive(st, noise, cfg))
    got = _key_shapes(_npz(tmp_path / "step_00000001.npz"))
    want = _key_shapes(jflatten(jsp.state_to_tree(js)))
    assert got.pop("noise_state")[1] == np.uint8
    assert "key" in want
    del want["key"]
    assert got == want


@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_reference_checkpoint_restores_in_port(tmp_path, kind):
    """The reference saves its PSP state; the port's restore_checkpoint
    returns every field equal to the reference's, bit for bit."""
    cfg, _, js, st, noise = PAIRS[kind]()
    js = _randomize_reference(js, 3)
    jsave(str(tmp_path), 7, jsp.state_to_tree(js))
    tpl = train.psp_archive(st, noise, cfg)
    del tpl["noise_state"]
    tree, step = restore_checkpoint(str(tmp_path), tpl)
    assert step == 7
    want = jflatten(jsp.state_to_tree(js))
    got = _flatten(tree)
    assert set(got) == set(want) - {"key"}
    for k, v in got.items():
        assert np.array_equal(v, want[k]), k
    # and the launcher's restore builds a port state holding those values
    back, step = train.restore_psp(str(tmp_path), st, noise, cfg, reseed=2)
    again = _flatten(train.psp_archive(back, noise, cfg))
    for k, v in got.items():
        assert np.array_equal(again[k], v), k


@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_port_checkpoint_restores_in_reference(tmp_path, kind):
    """The port saves its PSP state; the reference's restore_checkpoint
    into ``state_to_tree(st)`` minus ``key`` returns every field equal to
    the port's, bit for bit."""
    cfg, _, js, st, noise = PAIRS[kind]()
    st = _randomize_port(st, 4)
    save_checkpoint(str(tmp_path), 9, train.psp_archive(st, noise, cfg))
    tpl = {k: v for k, v in jsp.state_to_tree(js).items() if k != "key"}
    tree, step = jrestore(str(tmp_path), tpl)
    assert step == 9
    got = jflatten(tree)
    want = _npz(tmp_path / "step_00000009.npz")
    assert set(got) == set(want) - {"noise_state"}
    for k, v in got.items():
        assert np.array_equal(v, want[k]), k


# --------------------------------------------------------------------------- #
# kill-and-resume through the launcher, with a real SIGKILL
# --------------------------------------------------------------------------- #
TRAIN_ARGS = ["--device", "cpu", "--arch", ARCH, "--reduced", "--batch", "2",
              "--seq", "64", "--d-model", "128", "--vocab", "128",
              "--log-every", "50"]
STEPS = 8


def _train(args, wait=True):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env["OMP_NUM_THREADS"] = "1"    # tiny model: threads only contend
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_ARGS,
         *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
    if not wait:
        return proc
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err.decode()[-2000:]
    return out.decode()


@pytest.mark.parametrize("barrier", ["none", "pbsp"])
def test_kill_and_resume_bit_exact(tmp_path, barrier):
    """SIGKILL mid-run + --resume ≡ the uninterrupted run, leaf for leaf
    (the PSP noise generator's state included)."""
    mode = ([] if barrier == "none"
            else ["--barrier", barrier, "--workers", "2"])
    ref, killed = str(tmp_path / "ref"), str(tmp_path / "killed")
    common = [*mode, "--steps", str(STEPS)]
    _train([*common, "--ckpt-dir", ref])

    proc = _train([*common, "--ckpt-dir", killed, "--save-every", "2",
                   "--throttle", "0.3"], wait=False)
    deadline = time.monotonic() + 200
    try:
        while latest_step(killed) is None:
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            assert time.monotonic() < deadline, "no checkpoint appeared"
            time.sleep(0.02)
    finally:
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
    s = latest_step(killed)
    assert s is not None and s < STEPS, f"killed run already at {s}"

    out = _train([*common, "--ckpt-dir", killed, "--resume"])
    assert f"resumed step {s}" in out

    a = _npz(os.path.join(ref, f"step_{STEPS:08d}.npz"))
    b = _npz(os.path.join(killed, f"step_{STEPS:08d}.npz"))
    assert set(a) == set(b)
    assert ("noise_state" in a) == (barrier != "none")
    for k in a:
        assert np.array_equal(a[k], b[k]), f"leaf {k} diverged after resume"


def test_resume_metadata_records_data_stream(tmp_path):
    _train(["--steps", "4", "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert read_metadata(str(tmp_path), 4)["data_step"] == 4


def test_reference_checkpoint_resumes_in_launcher(tmp_path, capsys):
    """A reference PSP checkpoint (no ``noise_state``) resumes in the
    port's launcher, which re-seeds its noise and says so."""
    jcfg = dataclasses.replace(jreduced(jget(ARCH), d_model=64),
                               vocab_size=512)
    jp = jsp.PSPConfig(barrier="pbsp", n_workers=2, sample_size=2,
                       staleness=3, straggler_frac=0.25)
    js = jsp.psp_init(jp, jinit(jcfg, jax.random.PRNGKey(0)),
                      jopt.adamw(3e-3).init, jax.random.PRNGKey(1))
    d = str(tmp_path)
    jsave(d, 2, jsp.state_to_tree(js), {"data_step": 2})
    assert train.main(["--device", "cpu", "--reduced", "--d-model", "64",
                       "--seq", "16", "--batch", "2", "--steps", "4",
                       "--barrier", "pbsp", "--workers", "2",
                       "--ckpt-dir", d, "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed step 2" in out and "re-seeded" in out
    assert latest_step(d) == 4 and "noise_state" in archive_keys(d, 4)


# --------------------------------------------------------------------------- #
# elastic trainer: resume under churn, through the store
# --------------------------------------------------------------------------- #
def test_elastic_resume_equivalence(tmp_path):
    """N ticks + checkpoint + resume N ≡ 2N uninterrupted ticks (churn
    on): the full PSP state and the noise generator's state round-trip
    through the store, and the resumed drive replays the minibatch
    stream, so every leaf matches bit for bit."""
    cfg = sp.PSPConfig(barrier="pssp", n_workers=4, sample_size=2,
                       staleness=3, straggler_frac=0.25,
                       contribution="mean-alive",
                       churn=sp.ChurnConfig(leave_rate=2.0, join_rate=2.0,
                                            horizon=30.0, seed=7))
    dim, n = 8, 12
    noise = sp.GeneratorNoise(1)
    _, it = sp.elastic_drive(cfg, dim, 2 * n, noise=noise)
    for t, (st, _) in enumerate(it):
        if t == n - 1:
            save_checkpoint(str(tmp_path), n,
                            train.psp_archive(st, noise, None))
    full = train.psp_archive(st, noise, None)

    noise2 = sp.GeneratorNoise(1)
    state, step = train.restore_psp(
        str(tmp_path), sp.linear_psp_state(cfg, dim, noise2), noise2, None,
        reseed=2)
    assert step == n
    _, it2 = sp.elastic_drive(cfg, dim, 2 * n, noise=noise2, state=state,
                              start_tick=n)
    for st2, _ in it2:
        pass
    resumed = train.psp_archive(st2, noise2, None)
    a, b = _flatten(full), _flatten(resumed)
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), f"PSPState leaf {k} diverged"
