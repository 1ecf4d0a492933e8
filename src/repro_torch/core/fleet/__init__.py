"""Multi-process server fleet: the event engine as a real deployment (port
of ``repro.core.fleet``).

Each of the P servers runs as its own worker (OS process, or tier-1-safe
in-process thread) driving its local slice of the buffered event engine;
psi exchanges and cohort dispatches travel over a pluggable
:class:`~repro_torch.core.fleet.transport.Transport` (``inproc`` |
``filelog`` | ``socket``) selected by the ``fleet`` spec grammar.  A
coordinator owns the namebook, dispatches cohorts with timeout + bounded
retry + exponential backoff, SIGKILL-realizes ``outage ... kill=1``
faults (:func:`plan_kills`), and elastically restarts killed workers from
their crash-atomic write-ahead checkpoints.

On a card a worker folds its cohort through K1 ``fold_norms`` + K2
``fold_apply`` (``kernels.ops.round_fold`` at P = 1) on a CUDA stream of
its own — worker threads share the coordinator's card, worker processes
hold a CUDA context each — and the coordinator combines through K3
``graph_combine``.  The namebook, transports, spec grammar, cohort and
kill draws are copies of the reference's; the state is float32 on the
device, so a run matches the reference's float64 one to a tolerance, and
its integer outcomes (flush schedule, q, versions, q-ledgers) exactly.
"""
from repro_torch.core.fleet.chaos import ChaosOutcome, chaos_run, plan_kills
from repro_torch.core.fleet.coordinator import (Coordinator, Fleet,
                                                FleetRunResult,
                                                fleet_cohort,
                                                reference_solution,
                                                run_fleet)
from repro_torch.core.fleet.namebook import (COORDINATOR, Namebook,
                                             WorkerEntry, worker_name)
from repro_torch.core.fleet.spec import TRANSPORTS, FleetSpec, \
    parse_fleet_spec
from repro_torch.core.fleet.transport import (FileLogTransport, InprocHub,
                                              InprocTransport, Message,
                                              SocketTransport, Transport,
                                              TransportError,
                                              make_transport,
                                              send_with_retry)
from repro_torch.core.fleet.worker import (FleetProblem, FleetWorker,
                                           load_worker_checkpoint,
                                           worker_process_main)

__all__ = [
    "ChaosOutcome", "chaos_run", "plan_kills",
    "Coordinator", "Fleet", "FleetRunResult", "fleet_cohort",
    "reference_solution", "run_fleet",
    "COORDINATOR", "Namebook", "WorkerEntry", "worker_name",
    "TRANSPORTS", "FleetSpec", "parse_fleet_spec",
    "FileLogTransport", "InprocHub", "InprocTransport", "Message",
    "SocketTransport", "Transport", "TransportError", "make_transport",
    "send_with_retry",
    "FleetProblem", "FleetWorker", "load_worker_checkpoint",
    "worker_process_main",
]
