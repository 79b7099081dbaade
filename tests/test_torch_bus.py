"""The port's snapshot bus and inference server (mirroring
``tests/test_serving.py``'s ``TestSnapshotBus``, ``TestInferenceServer``
and ``TestChaosServing``), the engine's version book, the live serving
launcher, and snapshots carried across the two packages.

Models: ``reduced(get_config("qwen2-0.5b"))`` of the port (bfloat16
compute, CPU), seeds 0 and 1.  Across the packages: a reference snapshot
polled by the port equals ``params_from_jax`` of it exactly, and the
port's server then serves the reference engine's greedy tokens in
float32 (a fair demand only where the reference's top-1 logit leads its
top-2 by more than ``LOGITS_TOL`` of max |logit|, the tolerance of
``tests/test_torch_serving.py``, which the test asserts first); a port
snapshot polled by the reference equals ``params_to_numpy`` exactly.
"""
import dataclasses
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import snapshot_bus as jbus  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.core.faults import make_plan  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.serving import (ChaosPublisher, InferenceServer,  # noqa: E402
                                 Request, ServeConfig, ServingEngine,
                                 SnapshotPublisher, SnapshotWatcher)
from repro_torch.tree import tree_leaves  # noqa: E402

ARCH = "qwen2-0.5b"
#: decode logits tolerance of the float32 parity (tests/test_torch_serving.py)
LOGITS_TOL = 5e-3


@pytest.fixture(autouse=True)
def _one_thread():
    """The models here are tiny: under a parallel test run, intra-op
    threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config(ARCH))
    return cfg, init_model(cfg, seed=0), init_model(cfg, seed=1)


def _scfg(**kw):
    base = dict(batch=2, max_len=64, max_new_tokens=6, max_groups=4)
    base.update(kw)
    return ServeConfig(**base)


def _watcher(d, cfg, p0, **kw):
    return SnapshotWatcher(d, params_to_numpy(p0), cfg=cfg, device="cpu",
                           **kw)


def _junk(d, step, sidecar=None):
    base = os.path.join(d, f"step_{step:08d}.npz")
    with open(base, "wb") as f:
        f.write(b"junk")
    if sidecar is not None:
        with open(base + ".json", "w") as f:
            json.dump(sidecar, f)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a.tree()),
                                                 tree_leaves(b.tree())))


# --------------------------------------------------------------------------- #
# the engine's version book
# --------------------------------------------------------------------------- #
def test_request_and_live_versions(model):
    cfg, p0, p1 = model
    eng = ServingEngine(p0, cfg, _scfg(batch=1), version=0)
    a = eng.submit(Request(prompt=np.asarray([1, 2], np.int32)))
    assert eng.request_versions() == {a: None}     # queued: no pin yet
    eng.admit_queued()
    eng.set_params(p1, 5)
    b = eng.submit(Request(prompt=np.asarray([3], np.int32)))
    assert eng.request_versions() == {a: 0, b: None}
    eng.step()
    assert eng.request_versions() == {a: 0, b: 5}
    assert eng.live_versions() == [0, 5]
    eng.drain()
    assert eng.request_versions() == {} and eng.live_versions() == []


# --------------------------------------------------------------------------- #
# snapshot bus
# --------------------------------------------------------------------------- #
class TestSnapshotBus:
    def test_roundtrip_and_versioning(self, model, tmp_path):
        cfg, p0, p1 = model
        d = str(tmp_path)
        with SnapshotPublisher(d, cfg, every_steps=2,
                               async_write=False) as pub:
            assert not pub.maybe_publish(1, p0)
            assert pub.maybe_publish(2, p0)
            w = _watcher(d, cfg, p0)
            params, version = w.poll()
            assert version == 2 and _same(params, p0)
            assert params.embed.device == torch.device("cpu")
            assert w.poll() is None
            pub.publish(4, p1)
            params, version = w.poll()
            assert version == 4 and _same(params, p1)

    def test_torn_write_never_selected(self, model, tmp_path):
        cfg, p0, _ = model
        d = str(tmp_path)
        with SnapshotPublisher(d, cfg, async_write=False) as pub:
            pub.publish(3, p0)
        _junk(d, 9)
        assert _watcher(d, cfg, p0).poll()[1] == 3

    def test_corrupt_snapshot_skipped_not_fatal(self, model, tmp_path):
        cfg, p0, _ = model
        d = str(tmp_path)
        with SnapshotPublisher(d, cfg, async_write=False) as pub:
            pub.publish(3, p0)
        w = _watcher(d, cfg, p0)
        assert w.poll()[1] == 3
        _junk(d, 11, {"step": 11})
        assert w.poll() is None
        assert w.skipped == 1 and w.loaded_step == 3
        assert w.poll() is None and w.skipped == 1
        with SnapshotPublisher(d, cfg, async_write=False) as pub:
            pub.publish(12, p0)
        assert w.poll()[1] == 12

    def test_config_mismatch_skipped(self, model, tmp_path):
        cfg, p0, _ = model
        d = str(tmp_path)
        other = reduced(get_config(ARCH), d_model=128)
        with SnapshotPublisher(d, other, async_write=False) as pub:
            pub.publish(2, init_model(other, seed=0))
        w = _watcher(d, cfg, p0)
        assert w.poll() is None and w.skipped == 1
        with pytest.raises(ValueError, match="stored shape"):
            _watcher(d, cfg, p0, strict=True).poll()

    def test_blacklist_backoff_schedule(self, model, tmp_path):
        cfg, p0, _ = model
        d = str(tmp_path)
        _junk(d, 11, {"step": 11})
        w = _watcher(d, cfg, p0, backoff_base=0.05, backoff_max=0.1,
                     jitter_seed=0)
        assert w.poll() is None and w.skipped == 1
        assert w.poll() is None and w.skipped == 1 and w.retries == 0
        time.sleep(0.2)
        assert w.poll() is None
        assert w.retries == 1 and w.skipped == 2
        assert w.bad_steps[11].fails == 2

    def test_blacklist_capped(self, model, tmp_path):
        cfg, p0, _ = model
        d = str(tmp_path)
        w = _watcher(d, cfg, p0, blacklist_max=3, backoff_base=1e-4,
                     backoff_max=1e-4, jitter_seed=0)
        for step in range(10, 16):
            _junk(d, step, {"step": step})
            assert w.poll() is None
        assert len(w.bad_steps) == 3 and min(w.bad_steps) == 13

    def test_blacklist_ttl_eviction(self, model, tmp_path):
        cfg, p0, _ = model
        d = str(tmp_path)
        _junk(d, 11, {"step": 11})
        w = _watcher(d, cfg, p0, blacklist_ttl=0.05, backoff_base=1e-4,
                     backoff_max=1e-4, jitter_seed=0)
        assert w.poll() is None and w.bad_steps[11].fails == 1
        time.sleep(0.1)
        assert w.poll() is None
        assert w.bad_steps[11].fails == 1

    def test_half_written_snapshot_recovers_on_retry(self, model, tmp_path):
        cfg, p0, _ = model
        d = str(tmp_path)
        _junk(d, 11, {"step": 11, "version": 11})
        w = _watcher(d, cfg, p0, backoff_base=1e-4, backoff_max=1e-4,
                     jitter_seed=0)
        assert w.poll() is None
        with SnapshotPublisher(d, cfg, async_write=False) as pub:
            pub.publish(11, p0)
        time.sleep(0.01)
        assert w.poll()[1] == 11
        assert w.bad_steps == {}

    def test_strict_watcher_raises(self, model, tmp_path):
        cfg, p0, _ = model
        d = str(tmp_path)
        _junk(d, 11, {"step": 11})
        with pytest.raises(Exception):
            _watcher(d, cfg, p0, strict=True).poll()

    def test_watcher_needs_a_device(self, model, tmp_path):
        cfg, p0, _ = model
        with pytest.raises(TypeError, match="device"):
            SnapshotWatcher(str(tmp_path), params_to_numpy(p0), cfg)


# --------------------------------------------------------------------------- #
# inference server
# --------------------------------------------------------------------------- #
class TestInferenceServer:
    def test_futures_and_hot_swap(self, model, tmp_path):
        cfg, p0, p1 = model
        d = str(tmp_path)
        pub = SnapshotPublisher(d, cfg, async_write=False)
        pub.publish(1, p0)
        eng = ServingEngine(p0, cfg, _scfg(), version=0)
        with InferenceServer(eng, watcher=_watcher(d, cfg, p0),
                             poll_every=2) as srv:
            futs = [srv.submit(Request(
                prompt=np.arange(1, 6, dtype=np.int32))) for _ in range(3)]
            [f.result(timeout=120) for f in futs]
            pub.publish(5, p1)
            deadline = time.monotonic() + 120
            while srv.stats.swaps < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
            fut = srv.submit(Request(prompt=np.arange(2, 6, dtype=np.int32)))
            comp = fut.result(timeout=120)
        assert comp.snapshot_version == 5
        assert srv.stats.swaps == 2
        assert srv.stats.completed == 4 and srv.stats.submitted == 4
        assert len(srv.stats.request_lat) == 4
        assert len(srv.stats.swap_stalls) == 2
        pub.close()

    def test_shutdown_drains(self, model):
        cfg, p0, _ = model
        srv = InferenceServer(ServingEngine(p0, cfg, _scfg()))
        futs = [srv.submit(Request(prompt=np.asarray([1, 2, 3], np.int32)))
                for _ in range(5)]
        srv.shutdown()
        assert all(f.done() for f in futs)
        assert all(len(f.result().tokens) == 6 for f in futs)

    def test_unservable_request_fails_future(self, model):
        cfg, p0, _ = model
        with InferenceServer(ServingEngine(p0, cfg,
                                           _scfg(max_len=16))) as srv:
            fut = srv.submit(Request(prompt=np.arange(30, dtype=np.int32)))
            with pytest.raises(ValueError, match="max_len"):
                fut.result(timeout=60)

    def test_queue_deadline_expires(self, model):
        cfg, p0, _ = model
        with InferenceServer(ServingEngine(p0, cfg, _scfg())) as srv:
            fut = srv.submit(Request(prompt=np.asarray([1, 2], np.int32),
                                     deadline_s=1e-9))
            with pytest.raises(TimeoutError):
                fut.result(timeout=60)
        assert srv.stats.timeouts == 1 and srv.stats.completed == 0

    def test_inflight_deadline_cancels(self, model):
        cfg, p0, _ = model
        eng = ServingEngine(p0, cfg, _scfg(max_new_tokens=64, max_len=128))
        with InferenceServer(eng) as srv:
            doomed = srv.submit(Request(
                prompt=np.asarray([1, 2, 3], np.int32), deadline_s=0.05))
            ok = srv.submit(Request(
                prompt=np.asarray([1, 2, 3], np.int32), max_new_tokens=2))
            with pytest.raises(TimeoutError):
                doomed.result(timeout=120)
            assert len(ok.result(timeout=120).tokens) == 2
        assert srv.stats.timeouts == 1
        assert not eng.has_pending()

    def test_watcher_on_another_device_rejected(self, model, tmp_path):
        cfg, p0, _ = model
        w = SnapshotWatcher(str(tmp_path), params_to_numpy(p0), cfg=cfg,
                            device="meta")
        with pytest.raises(ValueError, match="engine serves on"):
            InferenceServer(ServingEngine(p0, cfg, _scfg()), watcher=w)


class TestChaosServing:
    """Fault-plan-driven storms and decode-worker death."""

    def _storm(self, model, tmp_path, *, corrupt):
        cfg, p0, p1 = model
        d = str(tmp_path)
        plan = make_plan("torn-storm:k=3,at=1"
                         + (",corrupt=1" if corrupt else ""),
                         n_workers=1, ticks=8)
        pub = ChaosPublisher(d, plan, cfg, async_write=False)
        pub.publish(1, p0)
        eng = ServingEngine(p0, cfg, _scfg(), version=0)
        with InferenceServer(eng, watcher=_watcher(
                d, cfg, p0, backoff_base=0.01, backoff_max=0.02,
                jitter_seed=0), poll_every=2) as srv:
            deadline = time.monotonic() + 120
            while srv.stats.swaps < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            futs = []
            for v in range(2, 5):
                pub.publish(v, p1)          # indices 1..3: all bad
                futs.append(srv.submit(Request(
                    prompt=np.arange(1, 5 + v, dtype=np.int32))))
            comps = [f.result(timeout=120) for f in futs]
            assert [c.snapshot_version for c in comps] == [1, 1, 1]
            assert srv.stats.swaps == 1
            pub.publish(6, p1)              # index 4: past the storm
            deadline = time.monotonic() + 120
            while srv.stats.swaps < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
            fut = srv.submit(Request(prompt=np.arange(1, 5,
                                                      dtype=np.int32)))
            assert fut.result(timeout=120).snapshot_version == 6
        assert srv.stats.swaps == 2 and srv.stats.completed == 4
        pub.close()
        return pub, srv

    def test_torn_storm_zero_drops(self, model, tmp_path):
        pub, srv = self._storm(model, tmp_path, corrupt=False)
        assert pub.counters["torn"] == 3
        assert srv.stats.snapshots_skipped == 0

    def test_corrupt_storm_zero_drops(self, model, tmp_path):
        pub, srv = self._storm(model, tmp_path, corrupt=True)
        assert pub.counters["corrupt"] == 3
        assert srv.stats.snapshots_skipped >= 1

    def test_every_publish_fault_executes(self, model, tmp_path):
        """The plan's five publish faults, one publication each."""
        from repro_torch.core.faults import FaultEvent, FaultPlan
        cfg, p0, _ = model
        d = str(tmp_path)
        kinds = ["torn_snapshot", "corrupt_snapshot", "delay_publish",
                 "drop_publish", "disk_full"]
        plan = FaultPlan("mix", 0, 1, 8, tuple(
            FaultEvent(k, i, seconds=0.01) for i, k in enumerate(kinds)))
        pub = ChaosPublisher(d, plan, cfg, async_write=False)
        for step in range(1, 7):
            pub.publish(step, p0)
        assert pub.counters == {"torn": 1, "corrupt": 1, "delayed": 1,
                                "dropped": 1, "disk_full": 1}
        # torn (1) has no sidecar, dropped (4) was never written; the
        # disk-full write (5) was retried into place, as was the clean 6
        assert not os.path.exists(os.path.join(d, "step_00000001.npz.json"))
        assert not os.path.exists(os.path.join(d, "step_00000004.npz"))
        assert pub._mgr.retried_writes == 1
        w = _watcher(d, cfg, p0)
        assert w.poll()[1] == 6
        pub.close()

    def test_worker_death_readmits_bit_exact(self, model, tmp_path):
        cfg, p0, p1 = model
        d = str(tmp_path)
        prompt = np.arange(1, 7, dtype=np.int32)
        scfg = _scfg(max_new_tokens=24, max_len=128)
        ref_eng = ServingEngine(p0, cfg, scfg, version=0)
        ref_eng.submit(Request(prompt=prompt))
        (ref,) = ref_eng.drain()

        pub = SnapshotPublisher(d, cfg, async_write=False)
        eng = ServingEngine(p0, cfg, scfg, version=0)
        with InferenceServer(eng, watcher=_watcher(d, cfg, p0),
                             poll_every=2) as srv:
            fut = srv.submit(Request(prompt=prompt))
            deadline = time.monotonic() + 120
            while ((srv.stats.submitted < 1 or srv.stats.steps < 1)
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            pub.publish(1, p1)
            srv.inject_worker_fault()
            comp = fut.result(timeout=120)
            late = srv.submit(Request(prompt=prompt)).result(timeout=120)
        assert srv.stats.worker_restarts == 1 and srv.stats.readmitted >= 1
        assert comp.snapshot_version == 0
        assert np.array_equal(comp.tokens, ref.tokens)
        assert late.snapshot_version == 1
        pub.close()

    def test_worker_death_exhausts_restarts(self, model):
        cfg, p0, _ = model
        srv = InferenceServer(ServingEngine(p0, cfg, _scfg()),
                              max_restarts=0)
        srv.inject_worker_fault(RuntimeError("boom"))
        deadline = time.monotonic() + 60
        while not srv._stop.is_set() and time.monotonic() < deadline:
            time.sleep(0.005)
        with pytest.raises(RuntimeError, match="serve worker"):
            srv.submit(Request(prompt=np.asarray([1, 2], np.int32)))


# --------------------------------------------------------------------------- #
# across the packages
# --------------------------------------------------------------------------- #
def test_reference_snapshot_served_by_port(monkeypatch, tmp_path):
    """The reference publishes; the port polls the same weights and its
    server serves the reference engine's greedy tokens (float32)."""
    jcfg = dataclasses.replace(jreduced(jget(ARCH)), dtype="float32")
    cfg = dataclasses.replace(reduced(get_config(ARCH)), dtype="float32")
    tree = jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(0)))
    d = str(tmp_path)
    with jbus.SnapshotPublisher(d, async_write=False) as pub:
        pub.publish(7, tree)
    w = SnapshotWatcher(d, params_to_numpy(init_model(cfg, seed=0)),
                        cfg=cfg, device="cpu")
    got, version = w.poll()
    assert version == 7 and _same(got, params_from_jax(tree, cfg))

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 12, 3)]
    seen = []
    real = jengine.sample_token

    def recording(logits, *a, **kw):
        seen.append(np.asarray(logits, np.float32))
        return real(logits, *a, **kw)

    monkeypatch.setattr(jengine, "sample_token", recording)
    scfg = dict(batch=2, max_len=32, max_new_tokens=8)
    ref_eng = jengine.ServingEngine(tree, jcfg, jengine.ServeConfig(**scfg))
    ref = [ref_eng.generate([p])[0] for p in prompts]
    for logits in seen:                 # each group's one active row
        top2 = np.sort(logits[0])[-2:]
        assert top2[1] - top2[0] > LOGITS_TOL * np.abs(logits[0]).max()

    eng = ServingEngine(init_model(cfg, seed=0), cfg, ServeConfig(**scfg),
                        version=0)
    w = SnapshotWatcher(d, params_to_numpy(init_model(cfg, seed=0)),
                        cfg=cfg, device="cpu")
    with InferenceServer(eng, watcher=w, poll_every=1) as srv:
        deadline = time.monotonic() + 120
        while srv.stats.swaps < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        comps = [srv.submit(Request(prompt=p)).result(timeout=120)
                 for p in prompts]     # one at a time, as served above
    assert [c.snapshot_version for c in comps] == [7] * 4
    for a, c in zip(ref, comps):
        np.testing.assert_array_equal(np.asarray(a), c.tokens)


def test_port_snapshot_restored_by_reference(model, tmp_path):
    """The port publishes; the reference's watcher restores arrays equal
    to ``params_to_numpy`` of the published model, bit for bit."""
    cfg, _, p1 = model
    d = str(tmp_path)
    with SnapshotPublisher(d, cfg, async_write=False) as pub:
        pub.publish(4, p1)
    want = params_to_numpy(p1)
    jcfg = jreduced(jget(ARCH))
    tpl = jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(0)))
    params, version = jbus.SnapshotWatcher(d, tpl, strict=True).poll()
    assert version == 4
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert np.array_equal(np.asarray(leaf), flat_b[path]), path


# --------------------------------------------------------------------------- #
# launchers: trainer → bus → live server
# --------------------------------------------------------------------------- #
def test_trainer_publishes_and_live_server_serves(tmp_path, capsys):
    d = str(tmp_path)
    assert train.main(["--device", "cpu", "--reduced", "--steps", "2",
                       "--seq", "16", "--batch", "2", "--barrier", "pbsp",
                       "--publish-dir", d, "--publish-every", "1"]) == 0
    assert "published 3 snapshots" in capsys.readouterr().out
    assert serve.main(["--device", "cpu", "--reduced", "--watch-dir", d,
                       "--requests", "3", "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "loaded snapshot v2" in out and "versions=[2]" in out
    assert "new_tokens=12" in out
