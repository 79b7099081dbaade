"""Quickstart: the paper in a minute, on the port.

The port's copy of ``examples/quickstart.py``.  Simulates the paper's
evaluation (distributed SGD on a linear model under five barrier-control
strategies) with the discrete-event engine and prints the headline
comparison — progress, step dispersion, model error, server update
counts — then the Theorem 2 bounds showing why a small sample size β is
enough.  It runs on the host (numpy) and needs no card.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
from repro_torch.core.barriers import make_barrier
from repro_torch.core.bounds import mean_lag_bound, variance_lag_bound
from repro_torch.core.simulator import SimConfig, run_simulation


def main():
    """Print the five barriers' outcomes and the bounds table."""
    n, dur = 200, 20.0
    beta = max(1, n // 100)          # β = 1% of system size (paper §5.1)
    print(f"simulating {n} nodes for {dur:.0f}s, sample size β={beta}\n")
    print(f"{'barrier':8s} {'progress':>9s} {'spread':>7s} "
          f"{'error':>8s} {'updates':>8s}")
    for name in ("bsp", "ssp", "asp", "pbsp", "pssp"):
        bar = make_barrier(name, staleness=4, sample_size=beta)
        r = run_simulation(SimConfig(n_nodes=n, duration=dur, dim=100,
                                     barrier=bar, straggler_frac=0.05,
                                     seed=0))
        print(f"{name:8s} {r.mean_progress:9.1f} "
              f"{int(r.steps.max() - r.steps.min()):7d} "
              f"{r.final_error:8.4f} {r.total_updates:8d}")

    print("\nTheorem-2 bounds (r=4, T=10000, a=F(r)^β=0.5): why small β works")
    print(f"{'beta':>6s} {'mean-lag bound':>15s} {'var-lag bound':>15s}")
    a = 0.5
    for b in (1, 2, 5, 16, 100):
        F = a ** (1.0 / b)
        print(f"{b:6d} {mean_lag_bound(F, b, 4, 10_000):15.3f} "
              f"{variance_lag_bound(F, b, 4, 10_000):15.3f}")
    print("\n→ pBSP/pSSP: near-ASP speed, near-BSP dispersion, lowest error;")
    print("  bounds are already near-optimal at β≈5 — the sampling primitive")
    print("  buys distributed barrier control for O(β) messages per step.")


if __name__ == "__main__":
    main()
