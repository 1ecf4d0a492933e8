"""Resilience runtime: fault injection, time-varying topologies, and
dropout-safe execution of the GFL protocol (port of
``repro.core.resilience``).

The paper's stated motivation for the graph-federated architecture is
robustness to communication failures and server overload; this package
makes that regime executable.  ``faults`` and ``process`` are pure numpy,
copied from the reference, so fault realizations are equal bit for bit;
``runtime`` runs the rounds in torch.
"""
from repro_torch.core.resilience.faults import FaultModel, parse_fault_spec
from repro_torch.core.resilience.process import (
    RoundRealization,
    TopologyProcess,
    fold_dropped_links,
)
from repro_torch.core.resilience.runtime import (
    ResilientGFLState,
    ensure_dropout_safe,
    init_resilient_state,
    make_resilient_gfl_step,
)

__all__ = [
    "FaultModel",
    "parse_fault_spec",
    "RoundRealization",
    "TopologyProcess",
    "fold_dropped_links",
    "ResilientGFLState",
    "ensure_dropout_safe",
    "init_resilient_state",
    "make_resilient_gfl_step",
]
