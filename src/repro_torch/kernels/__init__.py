"""Hand-written Hopper kernels of the port and their plain torch versions.

Each wrapper dispatches on the device of its tensors: a CPU tensor goes to
the plain version beside the kernel, a CUDA tensor launches the kernel
(built from ``repro_torch/csrc`` on first use) or raises — there is no
fallback.  ``LAUNCHES`` counts the kernel launches per wrapper, so a run
can show that its main path went through the kernels.
"""
from __future__ import annotations

LAUNCHES = {"fold_norms": 0, "fold_apply": 0, "graph_combine": 0,
            "pair_streams": 0, "swa_decode": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
