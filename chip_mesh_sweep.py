#!/usr/bin/env python3
"""Time phase 21 (b)'s node-sharded sweep on the card, for one or more
copies of the port's sources.

For each source directory given (a ``src`` holding ``repro_torch``), in
turn and in a process of its own, two gloo ranks sharing card 0 run
``run_sweep`` of ``chip_smoke``'s 5 s Fig 2 configs (25 rows, P 1000,
d 1000, β 10) on the ``(rows, nodes)`` mesh (1, 2): the gathered CUDA
tick.  A 0.2 s sweep first loads the tick kernel.  Each line printed
gives every rank's seconds for the 5 s sweep, its collective calls and
the total updates (equal across sources when they agree).  To hold two
trees against each other, unpack the older one with ``git archive``
into a directory that ``.gitignore`` lists and alternate them:

    python3 chip_mesh_sweep.py OLD/src src OLD/src src
"""
import subprocess
import sys
import time

#: the mesh phase 21 (b) runs the gathered tick on
MESH = (1, 2)


def configs(duration):
    """``chip_smoke``'s Fig 2 configs at horizon ``duration``."""
    import chip_smoke as cs
    from repro_torch.core import SimConfig, make_barrier
    return [SimConfig(n_nodes=1000, dim=1000, duration=duration, seed=0,
                      straggler_frac=f,
                      barrier=make_barrier(n, staleness=4, sample_size=10))
            for n in cs.FIVE for f in cs.FRACS]


def rank():
    """One rank: (seconds of the 5 s sweep, collective calls, total
    updates)."""
    import torch
    from repro_torch.core import run_sweep
    from repro_torch.parallel import collectives
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    run_sweep(configs(0.2), device=dev, mesh=MESH)
    collectives.reset_call_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_sweep(configs(5.0), device=dev, mesh=MESH)
    secs = time.perf_counter() - t0
    return secs, collectives.call_counts(), int(sum(r.total_updates
                                                    for r in res))


def one(src: str) -> None:
    """The sweep on two ranks with the port's sources at ``src``."""
    from repro_torch.launch.mesh import spawn_host_world
    out = spawn_host_world(2, rank, backend="gloo", wall=600.0)
    print(f"{src}: " + "; ".join(
        f"rank {i} {s:.3f} s, calls {c}, updates {u}"
        for i, (s, c, u) in enumerate(out)), flush=True)


def main(argv) -> int:
    """Each source directory in its own process, in the order given."""
    if len(argv) == 2 and argv[0] == "--one":
        one(argv[1])
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for src in argv:
        rc = subprocess.call([sys.executable, __file__, "--one", src])
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        sys.path[:0] = [sys.argv[2], "."]
    sys.exit(main(sys.argv[1:]))
