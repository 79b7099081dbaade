"""The port's reproductions of the paper's figures and its sweep benchmark.

* :mod:`repro_torch.bench.figures` — Figs 1a–1e, 1c's β sweep, 2a–2c
  and 3 through :func:`repro_torch.core.run_sweep`
* :mod:`repro_torch.bench.fig45_bounds` — Figs 4–5: the Theorem 2 bounds
  beside an empirical mean lag
* :mod:`repro_torch.bench.sweep_bench` — the Fig 2 matrix through the
  event engine, the numpy grid engine, the plain tick and the kernel,
  plus a 100,000-node pair
* :mod:`repro_torch.bench.run` — the ``name,us_per_call,derived`` CSV
  harness over all of them
"""
