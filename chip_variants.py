#!/usr/bin/env python3
"""Time design variants of the port's three backward kernels and of the
RG-LRU scan on the card.

Each variant is the kernel's CUDA source with one of its design
constants changed (the RMSNorm backward's ``BWD_FILL``, busy warps per SM
its launcher aims for, and ``COLS_WARPS``, the warps of its column pass;
the flash backward's ``BWD_STAGES``, streamed tile pairs in its ring;
the bfloat16 SSD backward's ``BWD_HEADS``, heads per block of its chunk
kernel, and ``BWD_ROWS``, state rows per block of its state-gradient
scan; the RG-LRU scan's prefill block, ``PREFILL_THREADS`` threads of
``PREFILL_L`` steps each, a ring of ``PREFILL_SLOTS`` tiles and
``PREFILL_MINB`` blocks an SM, timed at recurrentgemma-2b's prefill and
at a decode step by queued CUDA events and by the profiler; the RG-LRU
backward's block, ``BWD_THREADS`` threads, ``BWD_GROUPS`` of them
across a tile's row of 4-channel vectors, ``BWD_SLOTS`` slots and
``BWD_MINB`` blocks an SM, under the name ``rglru_bwd``, timed at
recurrentgemma-2b's training shape by queued events and by the profiler,
each launch apart).
Every variant is built with the port's own flags (one ``nvcc`` each, all
started together, into ``build/variants/``), held to its plain version
on a few of ``chip_smoke.py``'s phase 5 cases, and timed at the
training shapes of ``chip_smoke.py`` (``FLASH_BWD_TIMED``,
``RMS_BWD_TIMED``, ``SSD_BWD_TIMED``) beside the library call where there
is one, in one call, with each launch's device time.  The first variant
of each kernel is the source as it stands.

With ``--parent DIR`` (a checkout of an earlier commit, e.g. unpacked by
``git archive`` into a directory ``.gitignore`` lists), that checkout's
RG-LRU scan (and its backward, beside the ``rglru_bwd`` variants) is
checked and timed before and after the variants, on the same inputs and
by the same clocks, through its own wrapper and build (into
``DIR/build/kernels/``), in a child interpreter that imports that
checkout's ``repro_torch``: any checkout whose ``rglru_scan_cuda`` and
``rglru_scan_bwd_cuda`` keep their contracts.

Last, two kernels as built are timed phase by phase from copies of their
sources in which thread 0 of each block stamps ``%globaltimer`` (and
``clock64``), read back after one call: the SSD backward's chunk kernel
at ``SSD_BWD_TIMED`` (the mean and the largest time per phase over the
blocks, and the mean by chunk), and the RG-LRU scan at its prefill (the
first block's start to the last block's end, and each block's cycles
waiting for its tiles' loads, forming and scanning them, carrying h in
and out, and rescanning and storing, summed over its tiles), and the
RG-LRU backward at its training shape likewise (waiting for the loads,
forming and both scans, waiting for the carry, carrying it across the
warps, the gradients and their stores, dΛ's sums and the refill).  The
RG-LRU kernels' SASS instructions per element (``cuobjdump -sass``,
static counts over each kernel, divided by the elements a thread holds
a tile) are printed with their ``ptxas`` registers.

Run on a machine with one card, from the root of the checkout::

    python3 chip_variants.py [--parent DIR] [kernel source ...]

(the sources' names, e.g. ``rglru_scan``, or ``rglru_bwd`` for the
RG-LRU backward's, restrict it to their variants).

It exits with code 2 without a GPU.  It needs the CUDA toolkit's
``nvcc``; it changes no file outside ``build/variants/`` (and, with
``--parent``, the parent's ``build/kernels/``).
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
    ("ssd_scan", "as built", {}),
    ("ssd_scan", "BWD_HEADS 2", {"BWD_HEADS = 3;": "BWD_HEADS = 2;"}),
    ("ssd_scan", "BWD_HEADS 4", {"BWD_HEADS = 3;": "BWD_HEADS = 4;"}),
    ("ssd_scan", "BWD_ROWS 16", {"BWD_ROWS = 64;": "BWD_ROWS = 16;"}),
    ("ssd_scan", "BWD_ROWS 32", {"BWD_ROWS = 64;": "BWD_ROWS = 32;"}),
    ("rglru_scan", "as built", {}),
    *(("rglru_scan", tag, dict(
        (f"PREFILL_{k} = {v};", f"PREFILL_{k} = {n};")
        for k, v, n in zip(("THREADS", "L", "SLOTS", "MINB"), (256, 2, 2, 3),
                           new) if n != v))
      for tag, new in (("SLOTS 3, two blocks an SM", (256, 2, 3, 2)),
                       ("SLOTS 2, two blocks an SM", (256, 2, 2, 2)),
                       ("L 4 (128-step tiles), one block an SM",
                        (256, 4, 2, 1)),
                       ("L 1 (32-step tiles)", (256, 1, 2, 3)),
                       ("128 threads, L 2, six blocks an SM",
                        (128, 2, 2, 6)))),
    ("rglru_bwd", "as built", {}),
    *(("rglru_bwd", tag, dict(
        (f"BWD_{k} = {v};", f"BWD_{k} = {n};")
        for k, v, n in zip(("THREADS", "GROUPS", "SLOTS", "MINB"),
                           (256, 8, 2, 2), new) if n != v))
      for tag, new in (("three slots", (256, 8, 3, 2)),
                       ("three blocks an SM", (256, 8, 2, 3)),
                       ("512 threads (1 step a chunk), one block an SM",
                        (512, 8, 2, 1)),
                       ("16 channels a tile (1 step a chunk), four blocks "
                        "an SM", (256, 4, 2, 4)))),
)
#: the CUDA source of each variant name that is not a source's own
SOURCE = {"rglru_bwd": "rglru_scan"}
#: the SSD backward's spot checks: (B, S, nh, ng, hd, N, chunk, decay,
#: dtype), a last head tile of 2, two groups at hd 16 with N and Q not
#: multiples of 16, and 32 chunks
SSD_CHECKS = ((2, 512, 20, 1, 64, 128, 128, "model", "bfloat16"),
              (2, 240, 6, 2, 16, 36, 48, "slow", "bfloat16"),
              (1, 4096, 8, 2, 64, 128, 128, "slow", "bfloat16"))
#: the RG-LRU scan's spot checks (h0 and the gate given): (B, S, W,
#: dtype), a segment cut short, a decode step, a partial tile on the
#: masked path, the prefill
RGLRU_CHECKS = ((2, 300, 256, "float32"), (4, 1, 2560, "bfloat16"),
                (1, 65, 100, "bfloat16"), (4, 4096, 2560, "bfloat16"))
#: the RG-LRU backward's spot checks (``chip_smoke.rglru_bwd_cases``'
#: form): segments cut short in float32, the masked path, the edge, the
#: training shape
RGLRU_BWD_CHECKS = ((2, 300, 256, True, True, "float32", False),
                    (1, 65, 100, True, True, "bfloat16", False),
                    (2, 300, 256, True, True, "bfloat16", True),
                    (2, 4096, 2560, False, True, "bfloat16", False))


def variant_source(name, subs):
    """The text of ``csrc/<name>.cu`` with each substitution made once;
    raises if a constant is not found."""
    from repro_torch.kernels import _build
    text = (_build.CSRC / f"{SOURCE.get(name, name)}.cu").read_text()
    for old, new in subs.items():
        if text.count(old) != 1:
            raise ValueError(f"{name}.cu: {old!r} found {text.count(old)} "
                             "times")
        text = text.replace(old, new)
    return text


def build(variants):
    """Build every variant in parallel (the sources as they stand, and
    every RG-LRU variant, with ``-Xptxas -v``); returns ({(name, tag):
    CDLL}, {name, or "name tag": its ptxas report})."""
    from repro_torch.kernels import _build
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, tag, subs) in enumerate(variants):
        src = out / f"{name}_{i}.cu"
        src.write_text(variant_source(name, subs))
        verbose = not subs or name in ("rglru_scan", "rglru_bwd")
        procs[(name, tag)] = (verbose, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS,
             *(("-Xptxas", "-v") if verbose else ()), "-o",
             str(src.with_suffix(".so")), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            src.with_suffix(".so"))
    libs, reports = {}, {}
    for (name, tag), (verbose, proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} {tag}:\n{log}")
        if verbose:
            reports[name if tag == "as built" else f"{name} {tag}"] = log
        lib = ctypes.CDLL(str(so))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        libs[(name, tag)] = lib
    return libs, reports


def backward_registers(log):
    """(kernel, registers, spill-store bytes) of each backward kernel (and
    the RG-LRU scan's) in a ``-Xptxas -v`` report, and its "Potential
    Performance Loss" lines."""
    rows, warns, fn = [], [], None
    for line in log.splitlines():
        head = re.search(r"Compiling entry function '(\S+)'", line)
        if head:
            fn = head.group(1)
        if "Potential Performance Loss" in line:
            warns.append(line.strip())
        used = re.search(r"Used (\d+) registers", line)
        if used and fn and re.search(
                r"bwd_\w*kernel|rglru_(prefill|decode)_kernel", fn):
            rows.append((fn, int(used.group(1))))
    spills = {f: int(m.group(1)) for f, m in (
        (f, re.search(rf"Function properties for {re.escape(f)}\s+"
                      r"\d+ bytes stack frame, (\d+) bytes spill stores",
                      log)) for f, _ in rows) if m}
    return [(f, r, spills.get(f, 0)) for f, r in rows], warns


#: bwd_chunk_kernel's phase boundaries: (text in ssd_scan.cu after which
#: thread 0 stamps, stamp index; per head t the index is that plus 6t)
SSD_STAMPS = (
    ("const int r0 = 16 * blk + g4, r1 = r0 + 8;  // this lane's rows\n",
     0, "start"),
    ("                    // lands\n", 1, "C and B in"),
    ("  float accB[NT8][4], accC[NT8][4];  // dB_J, dC_I summed over the "
     "heads\n", 2, "C·Bᵀ"),
    ("    __syncthreads();  // head t's x and G_c have landed\n", 3,
     "wait for x, G_c"),
    ("    __syncthreads();  // dy, H_c, cum, dt are in; G_c in st's order "
     "is read\n", 4, "B·G_cᵀ, wait for the rest"),
    ("    if (c > 0) transpose_state<HD>(Hf, warp, lane);\n"
     "    __syncthreads();\n", 5, "transposes"),
    ("    __syncthreads();  // phase 1 is done: x and G_c are read\n", 6,
     "phase 1"),
    ("                      // and H_c are read\n", 7, "phase 2"),
    ("    __syncthreads();  // cum, dt and the per-head sums are read\n", 8,
     "dcum scan"),
)
STAMP_HELPERS = r"""
__device__ unsigned long long g_stamps[1 << 16];
__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(k) do { if (threadIdx.x == 0) g_stamps[(blockIdx.x + \
    gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) * 32 + (k)] = \
    gtimer(); } while (0)
"""


def stamped_source():
    """``ssd_scan.cu`` with the stamps of ``SSD_STAMPS`` in
    ``bwd_chunk_kernel`` (index 30 at its end) and a ``read_stamps``
    entry point; raises if an anchor is not found once."""
    from repro_torch.kernels import _build
    text = (_build.CSRC / "ssd_scan.cu").read_text()
    text = text.replace("namespace {\n", "namespace {\n" + STAMP_HELPERS, 1)
    k0 = text.index("__global__ void __launch_bounds__(NT, 1) "
                    "bwd_chunk_kernel")
    body = text[k0:]
    marks = [(a, f"STAMP({k}{' + 6 * t' if k > 2 else ''});\n")
             for a, k, _ in SSD_STAMPS]
    marks.append(("  // the tile's dB and dC, rows r0 and r1 of this warp's "
                  "block\n", "  __syncthreads();\n  STAMP(30);\n"))
    for anchor, stamp in marks:
        if body.count(anchor) < 1:
            raise ValueError(f"ssd_scan.cu: stamp anchor {anchor!r} missing")
        i = body.index(anchor) + len(anchor)
        body = body[:i] + stamp + body[i:]
    return text[:k0] + body + """
extern "C" int read_stamps(unsigned long long* out, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_stamps, n * 8));
}
"""


def ssd_phases(np, torch, cs, dev, card):
    """Build the stamped SSD source, run one backward call at
    ``SSD_BWD_TIMED`` through it and print each phase's block times."""
    from repro_torch.kernels import _build, ssd_scan as ss
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "ssd_scan_stamped.cu"
    src.write_text(stamped_source())
    so = src.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    use(lib, "ssd_scan")
    B, S = cs.SSD_BWD_TIMED
    nh, ng, hd, N = 48, 1, 64, 128
    args = cs.ssd_inputs(np, torch, B, S, nh, ng, hd, N, "model",
                         "bfloat16", dev)
    dy = cs.ssd_inputs(np, torch, B, S, nh, ng, hd, N, "model", "bfloat16",
                       dev, 1)[0]
    _, _, cum, st = ss.ssd_cuda(*args, return_states=True)
    for _ in range(3):
        ss.ssd_bwd_cuda(*args, dy, cum, st)
    torch.cuda.synchronize()
    tiles = -(-nh // 3)  # BWD_HEADS as built
    nb, nc = tiles * (S // 128) * B, S // 128
    buf = np.zeros(nb * 32, np.uint64)
    if lib.read_stamps(buf.ctypes.data, nb * 32):
        raise RuntimeError("read_stamps failed")
    st_ = buf.reshape(nb, 32).astype(np.int64)
    chunk = np.arange(nb) // tiles % nc
    rows = [(name, k) for _, k, name in SSD_STAMPS[1:3]]
    rows += [(f"head {t}: {name}", k + 6 * t) for t in range(3)
             for _, k, name in SSD_STAMPS[3:]]
    rows.append(("the tile's dB, dC out", 30))
    print(f"[ssd backward phases] bwd_chunk_kernel at B={B} S={S} nh={nh} "
          f"hd={hd} N={N} bf16, {nb} blocks: µs per phase, mean and max "
          f"over the blocks, then the mean by chunk 0..{nc - 1} [{card}]",
          flush=True)
    prev = st_[:, 0]
    for name, k in rows:
        if k != 30 and not st_[:, k].any():
            continue
        d = (st_[:, k] - prev) / 1e3
        print(f"  {name:34s} {d.mean():7.2f} {d.max():7.2f}   " + " ".join(
            f"{d[chunk == c].mean():6.2f}" for c in range(nc)), flush=True)
        prev = st_[:, k]
    span = (st_[:, 30] - st_[:, 0]) / 1e3
    print(f"  block span mean {span.mean():.2f} µs, max {span.max():.2f}; "
          f"first start to last end "
          f"{(st_[:, 30].max() - st_[:, 0].min()) / 1e3:.2f} µs", flush=True)


#: the stamps of a stamped RG-LRU kernel: thread 0 of each block writes
#: its first and last %globaltimer, then its clock64 cycles in each of
#: up to eight phases summed over its tiles, then its tile count
#: (RGLRU_WIDTH words a block)
RGLRU_PHASES = ("waiting for the tile's loads", "forming a, b and the "
                "chunks' maps, the warp scan", "waiting for the entering h",
                "carrying h across the warps", "rescan and stores, the "
                "slot's refill")
RGLRU_BWD_PHASES = ("waiting for the tile's loads", "forming, the chunks' "
                    "maps and both warp scans", "waiting for the carry",
                    "the carry across the warps, published", "rescan, "
                    "gradients and their stores", "waiting for the block's "
                    "gradients, the slot's refill")
RGLRU_WIDTH = 12
RGLRU_STAMPS = r"""
__device__ unsigned long long g_stamps[1 << 16];
__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define STAMP_BEGIN() \
  const unsigned long long st_t0 = gtimer(); \
  long long st_last = clock64(), st_acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#define STAMP(k) do { if (threadIdx.x == 0) { const long long st_now = \
    clock64(); st_acc[k] += st_now - st_last; st_last = st_now; } } while (0)
#define STAMP_END(tiles) do { if (threadIdx.x == 0) { \
    unsigned long long* st_o = g_stamps + 12 * blockIdx.x; \
    st_o[0] = st_t0; st_o[1] = gtimer(); \
    for (int q = 0; q < 8; ++q) st_o[2 + q] = st_acc[q]; \
    st_o[10] = (tiles); } } while (0)
"""
READ_STAMPS = """
extern "C" int read_stamps(unsigned long long* out, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_stamps, n * 8));
}
extern "C" int clear_stamps() {
  static unsigned long long zeros[1 << 16];
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, zeros, sizeof zeros));
}
"""


def build_lib(src, text, *flags):
    """Write ``text`` to ``src``, build it with the port's flags, load it
    with ``cuda_error_string`` declared (and ``read_stamps`` if it has
    one); returns (library, compiler output)."""
    from repro_torch.kernels import _build
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    so = src.with_suffix(".so")
    run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o",
                          str(so), str(src)], capture_output=True, text=True)
    if run.returncode:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{run.stdout}"
                           f"{run.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    if "read_stamps" in text:
        lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    if "clear_stamps" in text:
        lib.clear_stamps.argtypes = []
    return lib, run.stdout + run.stderr


def sass_per_element(lib_path, pattern, per_thread):
    """(kernel, static SASS instructions, of them MUFU, instructions per
    element) of each kernel in ``lib_path`` whose name matches
    ``pattern``; ``per_thread(name)`` is the elements a thread of it
    holds a tile (``cuobjdump -sass``; a static count: each kernel's
    whole code, its division and sqrt slow paths included)."""
    import shutil
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1) if re.search(pattern, head.group(1)) else None
            if fn:
                counts[fn] = [0, 0]
        elif fn and re.search(r"/\*[0-9a-f]{4,}\*/\s+[A-Z@]", line):
            counts[fn][0] += 1
            counts[fn][1] += "MUFU" in line
    return [(f, n, m, n / per_thread(f)) for f, (n, m) in counts.items()]


def rglru_elements(fn):
    """Elements a thread of the RG-LRU kernel ``fn`` (a mangled name)
    holds a tile: PREFILL_L steps of a 16-byte vector of channels in the
    prefill kernel, DECODE_L steps of one channel in the decode kernel,
    BWD_SEG · BWD_GROUPS / BWD_THREADS steps of 4 channels in the
    backward's."""
    from repro_torch.kernels import _build
    text = (_build.CSRC / "rglru_scan.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);",
                                       text).group(1))
    if "rglru_decode_kernel" in fn:
        return const("DECODE_L")
    if "rglru_bwd_kernel" in fn:
        return 4 * const("BWD_SEG") * const("BWD_GROUPS") // const(
            "BWD_THREADS")
    return const("PREFILL_L") * (8 if "bfloat16" in fn else 4)


def stamp_read(np, lib, n_blocks, width):
    """The first ``n_blocks`` × ``width`` stamps of ``lib``."""
    buf = np.zeros(n_blocks * width, np.uint64)
    if lib.read_stamps(buf.ctypes.data, n_blocks * width):
        raise RuntimeError("read_stamps failed")
    return buf.reshape(n_blocks, width).astype(np.int64)


def rglru_phases(np, torch, cs, dev, card, lam, nxt):
    """Build the stamped scan, run calls on the rotated prefill inputs
    ``nxt`` through it and print its first start to last end and each
    phase's cycles."""
    from repro_torch.kernels import _build, rglru_scan as rg
    text = (_build.CSRC / "rglru_scan.cu").read_text()
    lib, _ = build_lib(ROOT / "build" / "variants" / "rglru_scan_stamped.cu",
                       RGLRU_STAMPS + text + READ_STAMPS)
    use(lib, "rglru_scan")
    B, S, W = cs.RGLRU_TIMED
    mhz = float(re.sub(r"[^0-9.]", "", cs.sm_clock()) or "nan")
    for _ in range(5):  # each call stamps the same blocks; the last stays
        t = nxt()
        rg.rglru_scan_cuda(t[0], t[1], t[2], lam, None, t[3])
    torch.cuda.synchronize()
    stamps_text(np, torch, cs, dev, lib, f"[rglru scan phases] B={B} S={S} "
                f"W={W} bf16, gate fused", RGLRU_PHASES, mhz, card)


def stamps_text(np, torch, cs, dev, lib, title, phases, mhz, card):
    """Print a stamped RG-LRU kernel's blocks: first start to last end,
    a block's span, and each phase's cycles a block and a tile."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    st = stamp_read(np, lib, 4 * sms, RGLRU_WIDTH)
    st = st[st[:, 1] > 0]  # the grid's blocks
    span = (st[:, 1].max() - st[:, 0].min()) / 1e3
    life = (st[:, 1] - st[:, 0]) / 1e3
    starts, ends, tiles = st[:, 0], st[:, 1], st[:, 10]
    print(f"{title}: {len(st)} blocks, tiles a block {tiles.min()}–"
          f"{tiles.max()} ({tiles.sum()} in all); first block's start to last "
          f"block's end {span:.2f} µs; a block's span mean {life.mean():.2f}, "
          f"min {life.min():.2f}, max {life.max():.2f} µs; starts spread over "
          f"{(starts.max() - starts.min()) / 1e3:.2f} µs, ends over "
          f"{(ends.max() - ends.min()) / 1e3:.2f} µs [{card}]", flush=True)
    for k, name in enumerate(phases):
        us = st[:, 2 + k] / mhz
        print(f"  {name:50s} mean {us.mean():8.2f} µs a block (max "
              f"{us.max():8.2f}), {us.sum() / tiles.sum():6.3f} µs a tile "
              f"(thread 0's clock64 at {mhz:.0f} MHz)", flush=True)


def rglru_bwd_phases(np, torch, cs, dev, card):
    """Build the stamped source, run the backward at the training shape
    (RGLRU_BWD_TIMED, bf16, gated) through it and print its blocks'
    phases."""
    from repro_torch.kernels import _build, rglru_scan as rg
    text = (_build.CSRC / "rglru_scan.cu").read_text()
    lib, _ = build_lib(ROOT / "build" / "variants" / "rglru_bwd_stamped.cu",
                       RGLRU_STAMPS + text + READ_STAMPS)
    use(lib, "rglru_scan")
    B, S, W = cs.RGLRU_BWD_TIMED
    x, rp, ip, g, lam, _ = cs.rglru_inputs(torch, B, S, W, "bfloat16", dev)
    dy = cs.rglru_inputs(torch, B, S, W, "bfloat16", dev, 1)[0]
    st = rg.rglru_scan_cuda(x, rp, ip, lam, None, g, return_states=True)[2]
    torch.cuda.synchronize()
    if lib.clear_stamps():
        raise RuntimeError("clear_stamps failed")
    for _ in range(5):  # each call stamps the same blocks; the last stays
        rg.rglru_scan_bwd_cuda(x, rp, ip, lam, dy, st, None, g)
    torch.cuda.synchronize()
    mhz = float(re.sub(r"[^0-9.]", "", cs.sm_clock()) or "nan")
    stamps_text(np, torch, cs, dev, lib, f"[rglru backward phases] B={B} "
                f"S={S} W={W} bf16, gated", RGLRU_BWD_PHASES, mhz, card)


def rglru_check(np, torch, cs, dev, rg, tag):
    """Hold ``rg.rglru_scan_cuda`` (with the library it has) to
    ``rg.rglru_scan_ref`` on RGLRU_CHECKS."""
    for i, (B, S, W, dt) in enumerate(RGLRU_CHECKS):
        x, rp, ip, g, lam, h0 = cs.rglru_inputs(torch, B, S, W, dt, dev, i)
        y, hl = rg.rglru_scan_cuda(x, rp, ip, lam, h0, g)
        yr, hr = rg.rglru_scan_ref(x, rp, ip, lam, h0, g)
        cs.check_close(np, y, yr, dt, f"rglru {tag}", cs.RGLRU_F32)
        cs.check_close(np, hl, hr, "float32", f"rglru {tag} h_last",
                       cs.RGLRU_F32)


def rglru_times(torch, cs, dev, card, rg, libs, nbytes=None):
    """Time ``rg.rglru_scan_cuda`` with each library of ``libs`` (tag →
    CDLL, or None: the one the wrapper builds itself) at
    recurrentgemma-2b's prefill (RGLRU_TIMED, bf16, gate fused) and a
    decode step by queued CUDA events, and at the prefill by the
    profiler, beside the bound of ``nbytes`` if given; returns the
    prefill's rotating inputs and lam."""
    B, S, W = cs.RGLRU_TIMED
    x, rp, ip, g, lam, h0 = cs.rglru_inputs(torch, B, S, W, "bfloat16", dev)
    nxt, n_sets = cs.rotating((x, rp, ip, g))
    step = tuple(t[:, :1].contiguous() for t in (x, rp, ip, g))

    def scan(lib, decode):
        def f():
            if lib is not None:
                use(lib, "rglru_scan")
            t = step if decode else nxt()
            return rg.rglru_scan_cuda(t[0], t[1], t[2], lam,
                                      h0 if decode else None, t[3])
        return f
    for decode, what in ((False, f"S={S}"), (True, "a decode step (S=1)")):
        fns = {tag: (scan(lib, decode), 200 if decode else 20)
               for tag, lib in libs.items()}
        ms, clocks = cs.event_rounds(torch, fns, queued=True)
        print(f"[rglru scan B={B} {what} W={W} bf16, gate fused (no library "
              "call computes it)] " + cs.rounds_text(ms) + f"; SM clock "
              f"{clocks}; inputs rotated over {n_sets} copies [{card}]",
              flush=True)
        if decode:
            continue
        if nbytes is not None:
            print("  bound " + f"{cs.roof().times_ms(0, nbytes)[1]:.4f} ms "
                  f"({nbytes / 1e6:.2f} MB); " + ", ".join(
                      f"{tag} {nbytes / v[0] / 1e6:.1f} GB/s"
                      for tag, v in ms.items()), flush=True)
        prof, clocks = cs.timed_rounds(torch, fns)
        print(f"  by the profiler: " + cs.rounds_text(prof)
              + f"; SM clock {clocks} [{card}]", flush=True)
    return nxt, lam


def parent_times(parent, what="scan"):
    """Check and time the RG-LRU scan (``what`` "scan") or its backward
    ("bwd") of the checkout at ``parent`` (an earlier commit, e.g.
    unpacked by ``git archive``) through its own wrapper, built by its own
    ``_build`` into its own ``build/kernels/``, on this checkout's
    inputs: in a child interpreter whose ``repro_torch`` is that
    checkout's (:func:`scan_child`)."""
    sys.stdout.flush()
    src = Path(parent).resolve() / "src"
    run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--scan-child", str(src), what], cwd=ROOT)
    if run.returncode:
        raise RuntimeError(f"the parent's RG-LRU {what} failed (rc "
                           f"{run.returncode})")


def scan_child(src, what):
    """The child of :func:`parent_times`: ``repro_torch`` from ``src``,
    its RG-LRU scan or backward held to its plain version and timed."""
    sys.path.insert(0, src)
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import rglru_scan as rg
    if Path(src).resolve() not in Path(rg.__file__).resolve().parents:
        raise RuntimeError(f"repro_torch came from {rg.__file__}, not {src}")
    dev = torch.device("cuda", 0)
    if what == "bwd":
        rglru_bwd_check(np, torch, cs, dev, "the parent's kernels")
        rglru_bwd_times(torch, cs, dev, cs.smi(), rg,
                        {"the parent's kernels": None})
        return 0
    rglru_check(np, torch, cs, dev, rg, "the parent's kernel")
    rglru_times(torch, cs, dev, cs.smi(), rg, {"the parent's kernel": None})
    return 0


def rglru_bwd_check(np, torch, cs, dev, tag):
    """Hold the RG-LRU backward (with the library its wrapper has) to its
    plain version on RGLRU_BWD_CHECKS (``chip_smoke.check_rglru_bwd``)."""
    for i, case in enumerate(RGLRU_BWD_CHECKS):
        try:
            cs.check_rglru_bwd(np, torch, case, dev, i)
        except AssertionError as e:
            raise AssertionError(f"{tag}: {e}") from e


def rglru_bwd_times(torch, cs, dev, card, rg, libs, nbytes=None):
    """Time ``rg.rglru_scan_bwd_cuda`` with each library of ``libs`` (tag
    → CDLL, or None: the one the wrapper builds itself) at
    recurrentgemma-2b's training shape (RGLRU_BWD_TIMED, bf16, gated,
    h_last unused) by queued CUDA events and by the profiler, each
    launch apart, beside the bound of ``nbytes`` if given."""
    B, S, W = cs.RGLRU_BWD_TIMED
    x, rp, ip, g, lam, _ = cs.rglru_inputs(torch, B, S, W, "bfloat16", dev)
    dy = cs.rglru_inputs(torch, B, S, W, "bfloat16", dev, 1)[0]
    st = rg.rglru_scan_cuda(x, rp, ip, lam, None, g, return_states=True)[2]
    nxt, n_sets = cs.rotating((x, rp, ip, g, dy, st))

    def bwd(lib):
        def f():
            if lib is not None:
                use(lib, "rglru_scan")
            t = nxt()
            return rg.rglru_scan_bwd_cuda(t[0], t[1], t[2], lam, t[4], t[5],
                                          None, t[3])
        return f
    fns = {tag: (bwd(lib), 20) for tag, lib in libs.items()}
    ms, clocks = cs.event_rounds(torch, fns, queued=True)
    print(f"[rglru backward B={B} S={S} W={W} bf16, gated (no library call "
          "computes it)] " + cs.rounds_text(ms) + f"; SM clock {clocks}; "
          f"inputs rotated over {n_sets} copies [{card}]", flush=True)
    if nbytes is not None:
        print("  bound " + f"{cs.roof().times_ms(0, nbytes)[1]:.4f} ms "
              f"({nbytes / 1e6:.2f} MB); " + ", ".join(
                  f"{tag} {nbytes / v[0] / 1e6:.1f} GB/s"
                  for tag, v in ms.items()), flush=True)
    for tag, (fn, n) in fns.items():
        split = cs.profile_device(torch, fn, n)
        print(f"  {tag} by the profiler: " + ", ".join(
            f"{kernel_name(k)} {v:.5f}" for k, v in split.items()
            if "rglru" in k), flush=True)


def rglru_bwd_section(np, torch, cs, dev, card, libs, parent):
    """The RG-LRU backward's variants timed at the training shape (the
    parent's kernels before and after them, if given), their SASS per
    element, then the stamped phases of the source as it stands."""
    from repro_torch.kernels import rglru_scan as rg
    B, S, W = cs.RGLRU_BWD_TIMED
    if parent is not None:
        parent_times(parent, "bwd")
    rglru_bwd_times(torch, cs, dev, card, rg,
                    {tag: lib for (name, tag), lib in libs.items()
                     if name == "rglru_bwd"},
                    rg.scan_bwd_bytes(B, S, W, 2, gated=True))
    if parent is not None:
        parent_times(parent, "bwd")
    path = Path(libs[("rglru_bwd", "as built")]._name)
    for fn, n, mufu, per in sass_per_element(path, r"rglru_bwd_kernel",
                                             rglru_elements):
        print(f"[rglru bwd sass] {path.stem}: …{fn[-56:]} {n} instructions "
              f"({mufu} MUFU), {per:.1f} per element", flush=True)
    rglru_bwd_phases(np, torch, cs, dev, card)


def rglru_section(np, torch, cs, dev, card, libs, parent):
    """The RG-LRU scan's variants timed at the prefill and a decode step,
    by queued events and by the profiler (the parent's kernel before and
    after them, if given); their SASS per element; then the stamped
    phases."""
    from repro_torch.kernels import rglru_scan as rg
    B, S, W = cs.RGLRU_TIMED
    if parent is not None:
        parent_times(parent)
    nxt, lam = rglru_times(
        torch, cs, dev, card, rg,
        {tag: lib for (name, tag), lib in libs.items()
         if name == "rglru_scan"}, rg.scan_bytes(B, S, W, 2, gated=True))
    if parent is not None:
        parent_times(parent)
    path = Path(libs[("rglru_scan", "as built")]._name)
    for fn, n, mufu, per in sass_per_element(
            path, r"rglru_(prefill|decode)_kernel", rglru_elements):
        print(f"[rglru sass] {path.stem}: …{fn[-56:]} {n} instructions "
              f"({mufu} MUFU), {per:.1f} per element", flush=True)
    rglru_phases(np, torch, cs, dev, card, lam, nxt)


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
    from repro_torch.kernels import rglru_scan as rg, ssd_scan as ss
    name = SOURCE.get(name, name)
    mod = {"flash_attention": fa, "rmsnorm": rn, "ssd_scan": ss,
           "rglru_scan": rg}[name]
    _build._LIBS[name] = lib
    mod._lib.cache_clear()
    mod._lib()


def main() -> int:
    """Build, check and time every variant; 0 on success."""
    if sys.argv[1:2] == ["--scan-child"]:
        return scan_child(sys.argv[2], sys.argv[3])
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa, rmsnorm as rn
    from repro_torch.kernels import rglru_scan as rg, ssd_scan as ss
    card = cs.smi()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    argv = sys.argv[1:]
    parent = None
    if argv[:1] == ["--parent"]:
        parent, argv = argv[1], argv[2:]
    only = set(argv)
    libs, reports = build([v for v in VARIANTS if not only or v[0] in only])
    names = {name for name, _ in libs}
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    for name, log in reports.items():
        rows, warns = backward_registers(log)
        for fn, regs, spill in rows:
            if " " in name and not re.search(
                    "rglru_bwd_kernel" if name.startswith("rglru_bwd")
                    else "rglru_prefill_kernel", fn):
                continue  # of a variant, the kernels it changes
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
        elif name == "ssd_scan":
            for i, case in enumerate(SSD_CHECKS):
                cs.check_ssd_bwd(np, torch, case, dev, i)
        elif name == "rglru_scan":
            rglru_check(np, torch, cs, dev, rg, tag)
        elif name == "rglru_bwd":
            rglru_bwd_check(np, torch, cs, dev, tag)
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

    if "flash_attention" in names:
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

    if "rmsnorm" in names:
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

    if "ssd_scan" in names:
        B, S = cs.SSD_BWD_TIMED
        nh, ng, hd, N = 48, 1, 64, 128
        args = cs.ssd_inputs(np, torch, B, S, nh, ng, hd, N, "model",
                             "bfloat16", dev)
        dy = cs.ssd_inputs(np, torch, B, S, nh, ng, hd, N, "model", "bfloat16",
                           dev, 1)[0]
        use(libs[("ssd_scan", "as built")], "ssd_scan")
        _, _, cum, st = ss.ssd_cuda(*args, return_states=True)
        nxt_s, _ = cs.rotating((*args, dy, cum, st))

        def ssd(lib):
            def f():
                use(lib, "ssd_scan")
                return ss.ssd_bwd_cuda(*nxt_s())
            return f
        fns = {tag: (ssd(lib), 20) for (name, tag), lib in libs.items()
               if name == "ssd_scan"}
        report(f"ssd backward B={B} S={S} nh={nh} hd={hd} N={N} ng={ng} bf16 "
               "(no library call computes it)", fns)
        ssd_phases(np, torch, cs, dev, card)
    if "rglru_scan" in names:
        rglru_section(np, torch, cs, dev, card, libs, parent)
    if "rglru_bwd" in names:
        rglru_bwd_section(np, torch, cs, dev, card, libs, parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
