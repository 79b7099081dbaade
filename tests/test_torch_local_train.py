"""Training the sliding-window and local/global decoders: the port's
``loss_fn`` and its gradients against ``jax.value_and_grad`` of the
reference's, and the training launcher on each (PSP ticks against the
reference's and the archives are ``tests/test_torch_local_psp.py``).

Models: ``reduced`` qwen1.5-4b (untied ``lm_head``, QKV bias),
h2o-danube-1.8b (``local`` layers, window 64) and gemma2-27b (local /
global, softcaps, post-norms, the gemma norm), and gemma2 at 16 / 16
heads of 16 (fused ``wqkv``), vocab 512, in float32 compute with remat
on as in the configs, on the reference's ``init_model`` weights with
biases and norm gains redrawn from numpy
(``test_torch_local_global._pair``).  Sequences of 96 tokens, past the
window, so that the flash backward's band cuts the causal triangle.
Tolerances as ``tests/test_torch_train.py``: the loss rtol 1e-5; every
gradient and parameter leaf rtol 1e-4, atol 1e-5·max(1, max|leaf|).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
from repro.models import loss_fn as jloss  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import make_grad_fn  # noqa: E402
from repro_torch.models import loss_fn  # noqa: E402
from test_torch_local_global import FUSED, _pair  # noqa: E402
from test_torch_train import _as_port, _close_trees  # noqa: E402

CASES = [("qwen1.5-4b", {}), ("h2o-danube-1.8b", {}), ("gemma2-27b", {}),
         ("gemma2-27b", FUSED)]


def _train_pair(arch, seed=0, **changes):
    """(reference cfg, port cfg, reference params, port tree), f32."""
    jcfg, cfg, tree, model = _pair(arch, "float32", seed, **changes)
    assert cfg.remat and jcfg.remat
    return jcfg, cfg, tree, model.tree()


@pytest.mark.parametrize("arch, changes", CASES)
def test_loss_and_grads_match_reference(arch, changes):
    """``loss_fn`` and its gradients (remat, chunked CE against
    ``unembed_matrix``: ``lm_head``'s gradient where untied; the
    window's band in the attention backward; gemma2's softcapped logits
    and post-norms) against ``jax.value_and_grad(repro.models.loss_fn)``."""
    jcfg, cfg, tree, params = _train_pair(arch, **changes)
    assert ("lm_head" in params) == (not cfg.tie_embeddings)
    toks = np.random.default_rng(7).integers(0, 512, size=(2, 96)).astype(
        np.int32)
    (jl, _), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(toks)}, jcfg)
    loss, grads = make_grad_fn(cfg, clip_norm=None)(params,
                                                    torch.from_numpy(toks))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _close_trees(grads, _as_port(jg, cfg), "grads")
    with torch.no_grad():
        np.testing.assert_allclose(
            float(loss_fn(params, {"tokens": torch.from_numpy(toks)},
                          cfg)[0]), float(jl), rtol=1e-5)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen1.5-4b",
                                  "gemma2-27b"])
def test_launcher_trains_reduced_model(arch, capsys):
    """``python -m repro_torch.launch.train --reduced --arch …``: three
    PSP ticks on the CPU (96 tokens a sequence, past the window of 64),
    each logged with a finite loss."""
    assert train.main(["--device", "cpu", "--reduced", "--arch", arch,
                       "--d-model", "64", "--barrier", "pbsp", "--steps",
                       "3", "--seq", "96", "--batch", "2", "--log-every",
                       "1"]) == 0
    out = capsys.readouterr().out
    ticks = [line for line in out.splitlines() if line.startswith("tick")]
    assert len(ticks) == 3 and f"arch={arch}" in out
    assert all(np.isfinite(float(line.split()[3])) for line in ticks)
