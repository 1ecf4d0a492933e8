"""Population-scale client engine: lazy populations, cohort scheduling,
streaming execution (port of ``repro.core.population``)."""
from repro_torch.core.population.cohort import (
    AvailabilityTrace,
    CohortScheduler,
    CohortSelection,
    cohort_to_spec,
    parse_cohort_spec,
    parse_trace_spec,
)
from repro_torch.core.population.engine import (
    PopulationRunResult,
    as_population,
    estimate_w_ref,
    run_gfl_population,
    uniform_cohort_batch,
    uniform_cohort_indices,
)
from repro_torch.core.population.population import (
    ClientPopulation,
    DensePopulation,
    DirichletPopulation,
    PopulationSpec,
    SyntheticPopulation,
    parse_population_spec,
    population_from_spec,
    population_to_spec,
)

__all__ = [
    "AvailabilityTrace", "CohortScheduler", "CohortSelection",
    "cohort_to_spec", "parse_cohort_spec", "parse_trace_spec",
    "PopulationRunResult", "as_population", "estimate_w_ref",
    "run_gfl_population", "uniform_cohort_batch",
    "uniform_cohort_indices",
    "ClientPopulation", "DensePopulation", "DirichletPopulation",
    "PopulationSpec", "SyntheticPopulation", "parse_population_spec",
    "population_from_spec", "population_to_spec",
]
