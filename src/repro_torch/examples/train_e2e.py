"""End-to-end example: train a transformer for a few hundred steps with
PSP barrier control.

The port's copy of ``examples/train_e2e.py``.  Default: a ~10M-param
reduced qwen2 for 200 PSP ticks.  ``--large`` selects a ~100M-param
config (the same code path).  Every ``repro_torch.launch.train`` flag
passes through — ``--device cpu`` (the default is the card, and it
raises without a GPU), and the fault-tolerance ones: ``--ckpt-dir`` +
``--save-every`` / ``--save-interval`` cut async full-state
checkpoints, and a killed run restarted with ``--resume`` continues bit
for bit where the latest checkpoint left off.

    PYTHONPATH=src python -m repro_torch.examples.train_e2e
    PYTHONPATH=src python -m repro_torch.examples.train_e2e --device cpu \\
        --steps 20
    PYTHONPATH=src python -m repro_torch.examples.train_e2e --large \\
        --steps 400
    PYTHONPATH=src python -m repro_torch.examples.train_e2e \\
        --ckpt-dir /tmp/e2e --save-every 50   # kill it, rerun with --resume
"""
import argparse
import sys

from repro_torch.launch.train import main as train_main


def train_args(argv=None):
    """The ``repro_torch.launch.train`` argument list of ``argv``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--barrier", default="pbsp")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--large", action="store_true",
                    help="~100M params instead of ~10M")
    a, rest = ap.parse_known_args(argv)
    if a.large:
        dims = ["--d-model", "768", "--n-layers", "12", "--vocab", "8192",
                "--seq", "256", "--batch", "4"]
    else:
        dims = ["--d-model", "256", "--n-layers", "4", "--vocab", "1024",
                "--seq", "128", "--batch", "4"]
    return (["--arch", "qwen2-0.5b", "--reduced", "--steps", str(a.steps),
             "--barrier", a.barrier, "--workers", "4",
             "--straggler-frac", "0.25", "--log-every", "20"]
            + dims + rest)


def main(argv=None):
    """Train through the launcher with the example's arguments."""
    return train_main(train_args(argv))


if __name__ == "__main__":
    sys.exit(main())
