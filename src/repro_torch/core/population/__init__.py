from repro_torch.core.population.cohort import CohortScheduler
from repro_torch.core.population.population import (
    ClientPopulation,
    DensePopulation,
)

__all__ = ["CohortScheduler", "ClientPopulation", "DensePopulation"]
