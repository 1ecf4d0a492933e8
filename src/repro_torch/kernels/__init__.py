"""Hand-written Hopper kernels of the port and their plain torch versions.

Each wrapper dispatches on the device of its tensors: a CPU tensor goes to
the plain version beside the kernel, a CUDA tensor launches the kernel
(built from ``repro_torch/csrc`` on first use) or raises — there is no
fallback.  ``LAUNCHES`` counts the kernel launches per wrapper, so a run
can show that its main path went through the kernels.  A wrapper called
under CUDA-graph capture counts at the call; the round graph
(``core/population/graphed.py``) takes those counts back after the capture
and adds them at every replay (:func:`count_replay`), so ``LAUNCHES``
counts real launches either way, and ``REPLAYED`` the share of them that
replays made.  Wrappers count through :func:`count`, under a lock, since
the fleet's in-process workers launch from several threads.

K3 and K8 also report each call's modelled bytes and FLOPs (their ``cost``
functions) to the op analyses listening in :data:`LISTENERS`
(:class:`repro_torch.launch.op_analysis.OpCounter`), on real tensors where
they launch and on fake ones, where the wrapper returns the output's shape
and launches nothing (the dry run).  RWKV-6's time loop reports there too
on fake tensors (``models.rwkv.time_loop_cost``), a modelled unit and no
kernel.
"""
from __future__ import annotations

import threading

LAUNCHES = {"fold_norms": 0, "fold_apply": 0, "graph_combine": 0,
            "pair_streams": 0, "swa_decode": 0, "secure_agg_mean": 0,
            "clip_accum": 0, "laplace_transform": 0}
REPLAYED = dict.fromkeys(LAUNCHES, 0)
_COUNT_LOCK = threading.Lock()
#: callables ``(name, cost)`` told of each K3 / K8 call (and of each
#: modelled unit); empty unless an op analysis is running
LISTENERS: list = []


def count(name: str) -> None:
    """Count one launch of kernel ``name`` (a wrapper, where it launches)."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def report(name: str, cost: dict) -> None:
    """Tell the listening op analyses of one call of kernel ``name`` and
    its ``cost`` (``{"bytes", "flops", "dot_flops"}``, and ``"ops"`` for
    a modelled unit that is no kernel)."""
    for listen in LISTENERS:
        listen(name, cost)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = REPLAYED[name] = 0


def count_replay(held: dict) -> None:
    """Count one replay of a graph that holds ``held`` launches a kernel."""
    for name, n in held.items():
        LAUNCHES[name] += n
        REPLAYED[name] += n
