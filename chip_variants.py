#!/usr/bin/env python3
"""Time design variants of the port's two backward kernels on the card.

Each variant is the kernel's CUDA source with one of its design
constants changed (the RMSNorm backward's ``BWD_FILL``, busy warps per SM
its launcher aims for, and ``COLS_WARPS``, the warps of its column pass;
the flash backward's ``BWD_STAGES``, streamed tile pairs in its ring).
Every variant is built with the port's own flags (one ``nvcc`` each, all
started together, into ``build/variants/``), held to its plain version on
a few of ``chip_smoke.py``'s phase 5 cases, and timed at the training
shapes of ``chip_smoke.py`` (``FLASH_BWD_TIMED``, ``RMS_BWD_TIMED``) beside
the library call, in one call, with each launch's device time.  The
first variant of each kernel is the source as it stands.

Run on a machine with one card, from the root of the checkout::

    python3 chip_variants.py

It exits with code 2 without a GPU.  It needs the CUDA toolkit's
``nvcc``; it changes no file outside ``build/variants/``.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

#: (kernel source, tag, {old text: new text}); the empty dict is the source
#: as it stands
VARIANTS = (
    ("rmsnorm", "as built", {}),
    ("rmsnorm", "BWD_FILL 8", {"BWD_FILL = 16;": "BWD_FILL = 8;"}),
    ("rmsnorm", "BWD_FILL 4", {"BWD_FILL = 16;": "BWD_FILL = 4;"}),
    ("rmsnorm", "COLS_WARPS 16", {"COLS_WARPS = 32;": "COLS_WARPS = 16;",
                                  "COLS_BATCH = 9;": "COLS_BATCH = 17;"}),
    ("rmsnorm", "COLS_WARPS 8", {"COLS_WARPS = 32;": "COLS_WARPS = 8;",
                                 "COLS_BATCH = 9;": "COLS_BATCH = 33;"}),
    ("flash_attention", "as built", {}),
    ("flash_attention", "BWD_STAGES 3", {"BWD_STAGES = 2;": "BWD_STAGES = 3;"}),
)


def variant_source(name, subs):
    """The text of ``csrc/<name>.cu`` with each substitution made once;
    raises if a constant is not found."""
    from repro_torch.kernels import _build
    text = (_build.CSRC / f"{name}.cu").read_text()
    for old, new in subs.items():
        if text.count(old) != 1:
            raise ValueError(f"{name}.cu: {old!r} found {text.count(old)} "
                             "times")
        text = text.replace(old, new)
    return text


def build(variants):
    """Build every variant in parallel (the sources as they stand with
    ``-Xptxas -v``); returns ({(name, tag): CDLL}, {name: ptxas report of
    the source as it stands})."""
    from repro_torch.kernels import _build
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, tag, subs) in enumerate(variants):
        src = out / f"{name}_{i}.cu"
        src.write_text(variant_source(name, subs))
        procs[(name, tag)] = (not subs, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS,
             *(() if subs else ("-Xptxas", "-v")), "-o",
             str(src.with_suffix(".so")), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            src.with_suffix(".so"))
    libs, reports = {}, {}
    for (name, tag), (as_built, proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} {tag}:\n{log}")
        if as_built:
            reports[name] = log
        lib = ctypes.CDLL(str(so))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        libs[(name, tag)] = lib
    return libs, reports


def backward_registers(log):
    """(kernel, registers, spill-store bytes) of each backward kernel in a
    ``-Xptxas -v`` report, and its "Potential Performance Loss" lines."""
    rows, warns, fn = [], [], None
    for line in log.splitlines():
        head = re.search(r"Compiling entry function '(\S+)'", line)
        if head:
            fn = head.group(1)
        if "Potential Performance Loss" in line:
            warns.append(line.strip())
        used = re.search(r"Used (\d+) registers", line)
        if used and fn and re.search(r"bwd_\w+kernel", fn):
            rows.append((fn, int(used.group(1))))
    spills = {f: int(m.group(1)) for f, m in (
        (f, re.search(rf"Function properties for {re.escape(f)}\s+"
                      r"\d+ bytes stack frame, (\d+) bytes spill stores",
                      log)) for f, _ in rows) if m}
    return [(f, r, spills.get(f, 0)) for f, r in rows], warns


def kernel_name(key):
    """A profiler key's kernel name without its namespace, template
    arguments and parameters (``void (anonymous namespace)::f<64>(...)``
    → ``f``)."""
    key = key.replace("(anonymous namespace)::", "")
    return key.split("(")[0].split("<")[0].split()[-1].split("::")[-1][:48]


def use(lib, name):
    """Point the wrapper module of kernel source ``name`` at ``lib``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa, rmsnorm as rn
    mod = fa if name == "flash_attention" else rn
    _build._LIBS[name] = lib
    mod._lib.cache_clear()
    mod._lib()


def main() -> int:
    """Build, check and time every variant; 0 on success."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa, rmsnorm as rn
    card = cs.smi()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    libs, reports = build(VARIANTS)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    for name, log in reports.items():
        rows, warns = backward_registers(log)
        for fn, regs, spill in rows:
            print(f"[ptxas] {name}: {fn[-72:]} {regs} registers, {spill} "
                  "bytes spilled", flush=True)
        print(f"[ptxas] {name}: {len(warns)} 'Potential Performance Loss' "
              "warnings" + "".join(f"\n  {w}" for w in warns), flush=True)

    for (name, tag), lib in libs.items():
        use(lib, name)
        if name == "flash_attention":
            for case in ((("causal", {}), 7, 1000, 64, "bfloat16"),
                         (("causal", {}), 7, 1000, 128, "bfloat16"),
                         (("window256", {"window": 256}), 1, 37, 64,
                          "bfloat16")):
                cs.check_flash_bwd(np, torch, case, dev, 5)
        else:
            for rows, D, dt in ((1024, 896, "bfloat16"),
                                (4099, 3072, "bfloat16"),
                                (7, 100, "float32")):
                cs.check_rms_bwd(np, torch, rows, D, dt, dev, seed=3)
    print("every variant == its plain version on its spot checks",
          flush=True)

    def report(title, fns):
        ms, clocks = cs.timed_rounds(torch, fns)
        print(f"[{title}] " + cs.rounds_text(ms) + f"; SM clock {clocks} "
              f"[{card}]", flush=True)
        for label, (fn, n) in fns.items():
            split = cs.profile_device(torch, fn, n)
            print(f"  {label}: " + ", ".join(
                f"{kernel_name(k)} {v:.5f}" for k, v in split.items()),
                flush=True)

    B, S = cs.FLASH_BWD_TIMED
    q, k, v = cs.flash_inputs(np, torch, B, S, 14, 2, 64, "bfloat16", dev)
    do = cs.flash_inputs(np, torch, B, S, 14, 2, 64, "bfloat16", dev, 1)[0]
    o, lse = fa.attention_ref(q, k, v, causal=True, return_lse=True)
    nxt, _ = cs.rotating((q, k, v, o, lse, do))
    leaves = [t.transpose(1, 2).detach().requires_grad_(True)
              for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                         enable_gqa=True)
    dout = do.transpose(1, 2)

    def flash(lib):
        def f():
            use(lib, "flash_attention")
            return fa.flash_attention_bwd_cuda(*nxt())
        return f
    fns = {tag: (flash(lib), 20) for (name, tag), lib in libs.items()
           if name == "flash_attention"}
    fns["SDPA backward"] = (lambda: torch.autograd.grad(
        out, leaves, dout, retain_graph=True), 20)
    report(f"flash backward B={B} S={S} H=14 KV=2 hd=64 bf16 causal", fns)

    rows, D = cs.RMS_BWD_TIMED
    x, w = cs.rms_inputs(np, torch, rows, D, "bfloat16", dev, seed=1)
    g, _ = cs.rms_inputs(np, torch, rows, D, "bfloat16", dev, seed=2)
    _, m = rn.rmsnorm_ref(x, w, round_scale=True, return_m=True)
    nxt_r, _ = cs.rotating((x, w, g, m))
    xl = x.detach().requires_grad_(True)
    wl = w.to(torch.bfloat16).requires_grad_(True)
    y = F.rms_norm(xl, (D,), wl, 1e-6)

    def rms(lib):
        def f():
            use(lib, "rmsnorm")
            return rn.rmsnorm_bwd_cuda(*nxt_r())
        return f
    fns = {tag: (rms(lib), 50) for (name, tag), lib in libs.items()
           if name == "rmsnorm"}
    fns["F.rms_norm backward"] = (lambda: torch.autograd.grad(
        y, (xl, wl), g, retain_graph=True), 50)
    report(f"rmsnorm backward ({rows}, {D}) bf16", fns)
    return 0


if __name__ == "__main__":
    sys.exit(main())
