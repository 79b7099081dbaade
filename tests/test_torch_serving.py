"""The port's serving engine: greedy parity with the reference, the
request lifecycle, snapshot pinning and the launcher.

Parity: the reduced qwen2 and mamba2 models in float32, the reference's
weights carried across by ``params_from_jax``, four prompts of mixed
lengths (left-padded within a wave) at batch 2, greedy.  Tokens must be
equal.
That is a fair demand only where the reference's top-1 logit leads its
top-2 by more than the decode logits tolerance (5e-3 of max |logit|,
``tests/test_torch_transformer.py``), so the test first asserts that
margin at every emitted step, recorded from the reference engine.

The lifecycle tests mirror ``tests/test_serving.py::TestLifecycle`` on
the port alone (each reduced model, default bfloat16, CPU).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.serving import (Request, ServeConfig,  # noqa: E402
                                 ServingEngine, sample_token)

#: decode logits tolerance of the float32 parity (relative to max |logit|)
LOGITS_TOL = 5e-3
ARCHS = ["qwen2-0.5b", "mamba2-780m"]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = reduced(get_config(request.param))
    return cfg, init_model(cfg, seed=0), init_model(cfg, seed=1)


def _scfg(**kw):
    base = dict(batch=2, max_len=64, max_new_tokens=6, max_groups=4)
    base.update(kw)
    return ServeConfig(**base)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference_greedy(monkeypatch, arch):
    jcfg = dataclasses.replace(jreduced(jget(arch)), dtype="float32")
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    tree = jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 12, 3)]

    seen = []
    real = jengine.sample_token

    def recording(logits, *a, **kw):
        seen.append(np.asarray(logits, np.float32))
        return real(logits, *a, **kw)

    monkeypatch.setattr(jengine, "sample_token", recording)
    ref = jengine.ServingEngine(tree, jcfg, jengine.ServeConfig(
        batch=2, max_len=32, max_new_tokens=8)).generate(prompts)
    assert len(seen) == 2 * 8          # two waves of two, 8 steps each
    for logits in seen:
        top2 = np.sort(logits, axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        assert (margin > LOGITS_TOL * np.abs(logits).max(-1)).all()

    port = ServingEngine(params_from_jax(tree, cfg), cfg,
                         ServeConfig(batch=2, max_len=32, max_new_tokens=8))
    got = port.generate(prompts)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert port.prefill_calls == 2 and port.decode_steps == 2 * 7


class TestLifecycle:
    def test_submit_step_drain(self, model):
        cfg, params, _ = model
        eng = ServingEngine(params, cfg, _scfg())
        ids = [eng.submit(Request(prompt=np.arange(1, 4 + i, dtype=np.int32)))
               for i in range(3)]
        comps = {c.req_id: c for c in eng.drain()}
        assert sorted(comps) == ids
        assert all(len(c.tokens) == 6 for c in comps.values())
        assert all(c.finish_reason == "length" for c in comps.values())
        assert not eng.has_pending()

    def test_continuous_admission_matches_solo(self, model):
        # a request admitted into a RUNNING group is left-padded to the
        # group clock; by batch-row independence it must decode exactly
        # like a solo request with that padding made explicit
        cfg, params, _ = model
        eng = ServingEngine(params, cfg, _scfg(batch=3, max_groups=1))
        eng.submit(Request(prompt=np.arange(1, 8, dtype=np.int32)))
        eng.submit(Request(prompt=np.arange(2, 9, dtype=np.int32)))
        eng.step()
        eng.step()
        clock = eng._groups[0].length            # pad target at admission
        late = np.arange(3, 6, dtype=np.int32)
        rid = eng.submit(Request(prompt=late))   # joins the running group
        comps = {c.req_id: c for c in eng.drain()}
        solo = ServingEngine(params, cfg, _scfg())
        padded = np.concatenate([np.zeros(clock - late.size, np.int32), late])
        sid = solo.submit(Request(prompt=padded))
        ref = {c.req_id: c for c in solo.drain()}
        assert np.array_equal(comps[rid].tokens, ref[sid].tokens)

    def test_max_new_tokens_per_request(self, model):
        cfg, params, _ = model
        eng = ServingEngine(params, cfg, _scfg())
        a = eng.submit(Request(prompt=np.asarray([1, 2, 3], np.int32),
                               max_new_tokens=2))
        b = eng.submit(Request(prompt=np.asarray([1, 2, 3], np.int32)))
        comps = {c.req_id: c for c in eng.drain()}
        assert len(comps[a].tokens) == 2
        assert len(comps[b].tokens) == 6

    def test_oversized_request_rejected(self, model):
        cfg, params, _ = model
        eng = ServingEngine(params, cfg, _scfg(max_len=16))
        with pytest.raises(ValueError, match="max_len"):
            eng.submit(Request(prompt=np.arange(20, dtype=np.int32)))
        with pytest.raises(ValueError, match="non-empty"):
            eng.submit(Request(prompt=np.asarray([], np.int32)))

    def test_queue_backpressure_max_groups(self, model):
        # more distinct-shaped requests than groups: everything still
        # completes, FIFO, nothing dropped
        cfg, params, _ = model
        eng = ServingEngine(params, cfg, _scfg(batch=2, max_groups=2))
        ids = [eng.submit(Request(prompt=np.arange(1, 4, dtype=np.int32)))
               for _ in range(7)]
        comps = {c.req_id for c in eng.drain()}
        assert comps == set(ids)

    def test_eos_stops_early(self, model):
        cfg, params, _ = model
        eng = ServingEngine(params, cfg, _scfg())
        eng.submit(Request(prompt=np.asarray([1, 2, 3], np.int32)))
        first = None
        while first is None:
            for c in eng.step().completions:
                first = c
        greedy_first = int(first.tokens[0])
        eng2 = ServingEngine(params, cfg, _scfg(eos_id=greedy_first))
        eng2.submit(Request(prompt=np.asarray([1, 2, 3], np.int32)))
        (c,) = eng2.drain()
        assert c.finish_reason == "eos"
        assert len(c.tokens) == 1


def test_set_params_pins_inflight_groups(model):
    """A swap leaves in-flight groups on their pinned model: a request
    in flight at the swap decodes as on the old model alone, one
    admitted after it as on the new model alone."""
    cfg, p0, p1 = model

    def alone(params, prompt):
        eng = ServingEngine(params, cfg, _scfg())
        eng.submit(Request(prompt=prompt))
        return eng.drain()[0].tokens

    a = np.arange(1, 5, dtype=np.int32)
    b = np.arange(2, 8, dtype=np.int32)
    eng = ServingEngine(p0, cfg, _scfg(), version=0)
    ra = eng.submit(Request(prompt=a))
    eng.step()
    eng.step()
    assert eng.set_params(p1) == 1
    rb = eng.submit(Request(prompt=b))
    comps = {c.req_id: c for c in eng.drain()}
    assert comps[ra].snapshot_version == 0
    assert comps[rb].snapshot_version == 1
    np.testing.assert_array_equal(comps[ra].tokens, alone(p0, a))
    np.testing.assert_array_equal(comps[rb].tokens, alone(p1, b))


def test_cancel_and_reset(model):
    cfg, params, _ = model
    eng = ServingEngine(params, cfg, _scfg(max_groups=1))
    ids = [eng.submit(Request(prompt=np.arange(1, 4, dtype=np.int32)))
           for _ in range(3)]
    eng.admit_queued()                      # two in a group, one queued
    assert eng.cancel(ids[0]) and eng.cancel(ids[2])
    assert not eng.cancel(99)
    assert {c.req_id for c in eng.drain()} == {ids[1]}
    eng.submit(Request(prompt=np.arange(1, 4, dtype=np.int32)))
    assert eng.reset() == [3] and not eng.has_pending()


def test_sample_token_rules():
    """Greedy takes the first index on ties; top-k draws only among the
    k largest and repeats under a reseeded generator."""
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [3.0, 3.0, 0.0, 3.0]])
    assert sample_token(logits, None, 0.0).tolist() == [1, 0]
    logits = torch.randn(64, 50, generator=torch.Generator().manual_seed(0))
    draws = []
    for _ in range(2):
        g = torch.Generator().manual_seed(3)
        draws.append(sample_token(logits, g, 0.8, top_k=5))
    assert torch.equal(draws[0], draws[1])
    for row, tok in zip(logits, draws[0]):
        top = set(torch.topk(row, 5).indices.tolist())
        assert int(tok) in top


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_on_cpu_and_without_gpu(monkeypatch, capsys, arch):
    argv = ["--arch", arch, "--reduced", "--requests", "3", "--batch", "2",
            "--prompt-len", "5", "--max-new", "3", "--max-len", "16"]
    assert serve.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}" in out
    assert "new_tokens=9" in out and "device=cpu" in out
    run = serve.one_shot(argv + ["--device", "cpu", "--impl", "ref"])
    assert [len(o) for o in run.outputs] == [3, 3, 3]
    assert len(run.ttft_s) == 2 and run.decode_tokens == 2 * 2 + 1 * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(argv)
