#!/usr/bin/env python3
"""Probe of gloo on CUDA tensors for ranks that share one card.

    python3 chip_gloo_probe.py

Spawns worlds of 2 and then 4 ranks, every one on cuda:0 with a gloo
process group (NCCL takes no two ranks on one card), and has each rank
run ``all_reduce`` on CUDA tensors in f32, bf16 and int64, a
``broadcast`` and an ``all_gather``, then time a bf16 ``all_reduce`` at
[4, 1, 4096] (a decode step's activation), [4, 1000, 4096] and
[4, 4096, 2048] (prefills), in ms a call on the host clock around
synchronized repeats.  Rank 0's record of each world is printed as
JSON, after the card's name and power limit.  Tensor parallelism on one
card (``serve --mesh 1x4 --backend gloo --device cuda:0``) runs on the
first and the last of these.
"""
import json
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_main(rank, world, port, out):
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    res = {}
    for dt in (torch.float32, torch.bfloat16, torch.int64):
        try:
            x = torch.full((5,), rank + 1.0, device="cuda").to(dt)
            dist.all_reduce(x)
            res[str(dt)] = x.cpu().float().tolist()
        except Exception as e:          # the record says what gloo refused
            res[str(dt)] = repr(e)[:300]
    try:
        x = torch.ones(3, device="cuda")
        dist.broadcast(x, 0)
        res["broadcast"] = "ok"
    except Exception as e:
        res["broadcast"] = repr(e)[:200]
    try:
        parts = [torch.empty(3, device="cuda") for _ in range(world)]
        dist.all_gather(parts, torch.ones(3, device="cuda"))
        res["all_gather"] = "ok"
    except Exception as e:
        res["all_gather"] = repr(e)[:200]
    for shape in ((4, 1, 4096), (4, 1000, 4096), (4, 4096, 2048)):
        try:
            x = torch.randn(shape, device="cuda").to(torch.bfloat16)
            for _ in range(3):
                dist.all_reduce(x)
            torch.cuda.synchronize()
            t = time.perf_counter()
            n = 10 if shape[1] == 1 else 3
            for _ in range(n):
                dist.all_reduce(x)
            torch.cuda.synchronize()
            res[str(shape)] = (time.perf_counter() - t) / n * 1e3
        except Exception as e:
            res[str(shape)] = repr(e)[:200]
    with open(f"{out}/r{rank}.json", "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_gloo_probe: no CUDA device", file=sys.stderr)
        return 2
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout, flush=True)
    ctx = mp.get_context("spawn")
    ok = True
    for world in (2, 4):
        with tempfile.TemporaryDirectory(prefix="gloo_probe_") as out:
            t = time.perf_counter()
            procs = [ctx.Process(target=rank_main,
                                 args=(r, world, 29600 + world, out))
                     for r in range(world)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(300)
                if p.is_alive():
                    p.kill()
                    p.join()
            codes = [p.exitcode for p in procs]
            ok = ok and codes == [0] * world
            print("world", world, "exit", codes, time.perf_counter() - t,
                  flush=True)
            if codes[0] == 0:
                with open(f"{out}/r0.json") as f:
                    print(f.read(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
