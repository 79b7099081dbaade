"""Runnable examples of the port (``python -m repro_torch.examples.<name>``),
the counterparts of the reference's ``examples/``: ``quickstart`` (on the
host), ``serve_demo``, ``train_e2e``, ``elastic_train``, ``barrier_sweep``
and ``live_serve`` (on the card by default, on the CPU with ``--device
cpu``)."""
