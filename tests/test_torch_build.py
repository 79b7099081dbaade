"""The port's kernel build and binding, on the CPU (no ``nvcc``, no card).

Every wrapper module imports without compiling anything; each wrapper
checks its inputs before it loads a library, so a CPU tensor raises a
``ValueError`` and no build is attempted; and ``_build._target`` hashes
each ``csrc/*.cu`` on its own, so editing one source rebuilds only it.
"""
import shutil

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.kernels import (_build, flash_attention, ops,  # noqa: E402
                                 psp_tick, rglru_scan, rmsnorm, ssd_scan)

SOURCES = ("flash_attention", "psp_tick", "rglru_scan", "rmsnorm",
           "ssd_scan")
WRAPPERS = (flash_attention, psp_tick, rglru_scan, rmsnorm, ssd_scan)


def test_wrappers_check_before_they_build():
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == list(SOURCES)
    libs = dict(_build._LIBS)
    counts = [m.launch_count() for m in WRAPPERS]
    with pytest.raises(ValueError, match="CUDA tensor"):
        rmsnorm.rmsnorm_cuda(torch.ones(2, 64), torch.ones(64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        q = torch.ones(1, 3, 2, 64)
        flash_attention.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensor"):
        x, bc = torch.ones(1, 4, 2, 16), torch.ones(1, 4, 1, 32)
        ssd_scan.ssd_cuda(x, torch.ones(1, 4, 2), -torch.ones(2), bc, bc)
    with pytest.raises(ValueError, match="CUDA tensor"):
        x = torch.ones(1, 4, 32)
        rglru_scan.rglru_scan_cuda(x, x, x, torch.ones(32))
    assert ops.use_kernel("auto", torch.device("cpu")) is False
    assert _build._LIBS == libs
    assert counts == [m.launch_count() for m in WRAPPERS]


def test_each_source_hashes_on_its_own(tmp_path, monkeypatch):
    for name in SOURCES:
        shutil.copy(_build.CSRC / f"{name}.cu", tmp_path / f"{name}.cu")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build._target(n) for n in SOURCES}
    assert len(set(before.values())) == len(SOURCES)
    with open(tmp_path / "rmsnorm.cu", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build._target(n) for n in SOURCES}
    assert after["rmsnorm"] != before["rmsnorm"]
    assert all(after[n] == before[n] for n in SOURCES if n != "rmsnorm")
    assert all(p.name.startswith(f"lib{n}_") for n, p in after.items())
