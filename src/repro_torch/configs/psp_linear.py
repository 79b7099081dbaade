"""The paper's own evaluation workload (§5).

1000-node network running SGD on a linear model of 1000 parameters through
the parameter-server engine for 40 simulated seconds, each node sampling 1%
of the system size.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PSPLinearConfig:
    """The paper's §5 workload: system size, model size, horizon, β."""

    n_nodes: int = 1000
    dim: int = 1000
    duration: float = 40.0
    sample_frac: float = 0.01      # β = 1% of system size (paper §5.1)
    ssp_staleness: int = 4         # paper: "SSP allows certain staleness (4)"
    base_compute: float = 0.1
    seed: int = 0

    @property
    def sample_size(self) -> int:
        """β: ``sample_frac`` of the system size, at least 1."""
        return max(1, int(self.n_nodes * self.sample_frac))


CONFIG = PSPLinearConfig()
