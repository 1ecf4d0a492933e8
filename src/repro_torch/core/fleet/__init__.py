"""The multi-process server fleet (port of ``repro.core.fleet``).

Only the ``fleet`` spec grammar is ported so far: the workers, the
transports and the coordinator come with the fleet slice (ROADMAP item
18)."""
from repro_torch.core.fleet.spec import FleetSpec, parse_fleet_spec

__all__ = ["FleetSpec", "parse_fleet_spec"]
