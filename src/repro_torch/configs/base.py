"""GFL protocol configuration: the reference ``repro.configs.base.GFLConfig``
field for field (names and defaults are held equal by the tests).

``ModelConfig`` and the architecture registry belong to a later slice.
Fields this slice does not run (``fault``, non-dense ``population``,
non-uniform ``cohort``, ``async_spec``, ``telemetry``, ``sanitize``) are
kept so a config round-trips, and the engines raise ``NotImplementedError``
when one is set.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GFLConfig:
    """Graph-federated-learning protocol knobs (Rizk & Sayed 2021)."""
    num_servers: int = 10            # P
    clients_per_server: int = 50     # K
    clients_sampled: int = 0         # L; 0 -> full participation
    topology: str = "ring"           # ring | torus | full | erdos |
                                     # hypercube | expander
    topology_seed: int = 0           # seed for randomized graph families
    torus_rows: int = 0              # torus row count; 0 -> near-square auto
    fault: str = "none"              # resilience fault spec (later slice)
    population: str = "dense"        # client-population spec (dense only)
    cohort: str = "uniform"          # cohort-scheduler spec (uniform only)
    async_spec: str = "none"         # event-driven executor (later slice)
    data_seed: int = 0               # seed of the lazy population generator
    privacy: str = "hybrid"          # registry key into
                                     # repro_torch.core.privacy.mechanism
    sigma_g: float = 0.2             # server-level noise std
    grad_bound: float = 10.0         # B in Assumption 3 (clipping threshold)
    mu: float = 0.1                  # step size
    epsilon_target: float = 0.0      # scheduled mechanism: total eps budget
    epsilon_horizon: int = 0         # scheduled mechanism: budget horizon
    secure_agg: bool = True          # pairwise-mask SMC at client level
    combine_impl: str = "dense"      # mesh combine (later slice)
    combine_every: int = 1           # combine every tau steps
    use_kernels: bool = False        # whole-run switch: route the round
                                     # through the CUDA kernels
                                     # (repro_torch.kernels.ops)
    combine_wire: str = "bf16"       # mesh knob (later slice)
    grad_acc_dtype: str = "float32"  # mesh knob (later slice)
    client_parallel: bool = False    # mesh knob (later slice)
    sanitize: bool = False           # runtime sanitizer (later slice)
    telemetry: str = "off"           # telemetry sinks (later slice)

    @property
    def effective_clients(self) -> int:
        return self.clients_sampled or self.clients_per_server
