#!/usr/bin/env python3
"""How far the profiler's device times sit from the host's, and what the
pad of chip_smoke.py's profiler windows does about it.

    python3 chip_trace_probe.py [SECONDS]

For SECONDS (default 90), traces ``chip_smoke.profile_calls`` over 50
calls of K6 ``clip_accum`` at (8, 2^22) and of K3 ``graph_combine`` at
(10, 2), in turns, each once with no pad and once with
``chip_smoke.TRACE_PAD_S`` (the smoke's pad), after CUDA-event timing of the same calls, and each trace
taken once (no retake of a broken fence).
torch.profiler keeps a device record only if its start and end, moved
onto the host's clock, fall inside the window; a trace whose move is off
by more than the pad loses the records at that edge.

Prints a JSON line for each broken fence (chip_smoke's ``broken_fence``)
and for each whole trace whose count of device ops is not one a call,
then one line a pad: the traces, how many had a broken fence, how many
were off, and the least and the most offset (chip_smoke's ``traced``: a
marker kernel's start, on an idle device, less the start of the host
call that launched it), then the card's name and power limit.
Needs a CUDA card and this checkout's ``chip_smoke.py``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_trace_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import clip_accum as ca
    from repro_torch.kernels import graph_combine as gc
    from repro_torch.launch.kernel_bench import time_ms

    seconds = float(argv[0]) if argv else 90.0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    g = 3 * torch.randn((8, 1 << 22), generator=gen, device="cuda")
    A = torch.rand((10, 10), generator=gen, device="cuda")
    A = A / A.sum(dim=0, keepdim=True)
    psi = torch.randn((10, 2), generator=gen, device="cuda")
    calls = {"clip_accum": lambda: ca.clip_accum(g, 1.0),
             "combine": lambda: gc.graph_combine(A, psi)}
    pads = (0.0, cs.TRACE_PAD_S)
    cs.TRACE_LOST_TRIES = 1
    stats = {pad: {"traces": 0, "broken": 0, "off": 0} for pad in pads}
    offsets = {pad: [] for pad in pads}
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        for kernel, fn in calls.items():
            for pad in pads:
                time_ms(fn, budget_s=0.2)
                cs.TRACE_PAD_S = pad
                st = stats[pad]
                st["traces"] += 1
                try:
                    rec = cs.profile_calls(torch, fn, 50, kernel)
                except cs.SmokeFailure:
                    st["broken"] += 1
                    continue
                finally:
                    offsets[pad].append(cs.TRACE_OFFSETS[-1])
                if round(rec["device_ops_per_call"] * 50) != 50:
                    st["off"] += 1
                    print(json.dumps({"off": kernel, "pad_s": pad, **{
                        k: rec[k] for k in ("markers", "device_records",
                                            "launch_calls",
                                            "device_ops_per_call")}}),
                          flush=True)
    for pad, st in stats.items():
        known = [o for o in offsets[pad] if o is not None]
        print(json.dumps({"pad_s": pad, **st,
                          "offset_unknown": len(offsets[pad]) - len(known),
                          "offset_us_least": min(known, default=None),
                          "offset_us_most": max(known, default=None),
                          "offset_over_1ms": sum(abs(o) > 1e3
                                                 for o in known)}),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
