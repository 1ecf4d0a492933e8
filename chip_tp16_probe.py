#!/usr/bin/env python3
"""How far a split rwkv6-3b's gradient lies from the whole model's, on
one card, by param dtype and model group size.

    python3 chip_tp16_probe.py [--layers 2] \
        [--runs bfloat16:16,float32:16,bfloat16:4,bfloat16:2]

For each run (dtype, M): rwkv6-3b at full width, cut to ``--layers``
layers, in that dtype; the whole model's gradient of the train step's
gradient function (``launch.steps.client_grads``, on chip_smoke's tp16
batch) in this process, twice (its own run-to-run difference), then M
gloo ranks spawned on cuda:0, each taking its gradient twice from the
same seed's blocks.  Prints one JSON line a run: each leaf's largest
difference from its block of the whole gradient in bf16 ulps of the
leaf's largest |value| (chip_smoke's tp16 gate), the relative norm of the
difference, the losses, gloo's all_reduce of bf16 and f32 CUDA tensors
against the f64 sum, and the gradient's ms, with the card's name and
power limit.  Exits non-zero where a rank fails.
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def cfg_of(dtype, layers):
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(cs.TP16_ARCH), num_layers=layers,
                               param_dtype=dtype)


def rank_main(rank, world, port, root, dtype, layers):
    """One spawned rank: gloo's all_reduce checks, then its gradient
    twice against its blocks of the whole one; writes rank<r>.json."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    from repro_torch import rng
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.models.model import Model
    from repro_torch.models.parallel import ModelGroup
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=600))
    try:
        group = ModelGroup.of(parse_mesh(f"1x{world}", "cuda:0", "gloo"))
        out = {"rank": rank}
        for dt in (torch.bfloat16, torch.float32):
            xs = [torch.randn((3, 4096), generator=torch.Generator()
                              .manual_seed(r)).to(dt) for r in range(world)]
            want = sum(x.double() for x in xs)
            got = xs[rank].cuda().clone()
            group.all_reduce(got)
            out[f"allreduce_{str(dt)[6:]}_max_abs_err"] = float(
                (got.double().cpu() - want).abs().max())
        model = Model.init(cfg_of(dtype, layers), rng(0, "cuda"),
                           group=group)
        loss, grads, ms, n = cs.tp16_grads(torch, model)
        loss2, grads2, ms2, _ = cs.tp16_grads(torch, model)
        want = torch.load(Path(root) / f"grad_{group.index}.pt")
        whole = torch.load(Path(root) / "grad_whole.pt")
        want.update(whole["leaves"])
        leaves = {}
        for k, g in grads.items():
            w, g = want[k].cuda().float(), g.float()
            leaves[k] = {
                "ulps": float((g - w).abs().max())
                / (2 ** -7 * whole["top"][k] or 1.0),
                "rel_norm": float((g - w).norm() / (w.norm() + 1e-30)),
                "rerun_max_abs_diff": float(
                    (grads2[k].float() - g).abs().max())}
        out.update(loss=loss, loss_rerun=loss2, ms=[ms, ms2],
                   collectives=n, leaves=leaves)
    finally:
        dist.destroy_process_group()
    (Path(root) / f"rank{rank}.json").write_text(json.dumps(out))


def probe(torch, dtype, world, layers, smi) -> bool:
    import multiprocessing as mp
    import socket
    import tempfile
    from repro_torch import rng
    from repro_torch.models.model import Model
    t0 = time.perf_counter()
    cfg = cfg_of(dtype, layers)
    cs.TP16_RANKS = world               # tp16_whole_grads' block count
    with tempfile.TemporaryDirectory(prefix="tp16_probe_") as root:
        whole = cs.tp16_whole_grads(torch, cfg, root)
        top = torch.load(Path(root) / "grad_whole.pt")["top"]
        m1 = Model.init(cfg, rng(0, "cuda"))
        _, ga, _, _ = cs.tp16_grads(torch, m1)
        _, gb, _, _ = cs.tp16_grads(torch, m1)
        rerun = max(float((ga[k].float() - gb[k].float()).abs().max())
                    / (2 ** -7 * top[k] or 1.0) for k in ga)
        del m1, ga, gb
        torch.cuda.empty_cache()
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=rank_main,
                             args=(r, world, port, root, dtype, layers))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(900)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        recs = [json.loads((Path(root) / f"rank{r}.json").read_text())
                for r in range(world) if codes[r] == 0]
    worst: dict = {}
    for rk in recs:
        for k, v in rk["leaves"].items():
            if k not in worst or v["ulps"] > worst[k]["ulps"]:
                worst[k] = v
    print(json.dumps({
        "dtype": dtype, "M": world, "layers": layers, "exit_codes": codes,
        "whole_loss": whole["loss"], "whole_rerun_worst_ulps": rerun,
        "rank_losses": sorted({rk["loss"] for rk in recs}),
        "rank_rerun_losses": sorted({rk["loss_rerun"] for rk in recs}),
        "allreduce_max_abs_err": {
            k: max(rk[k] for rk in recs) for k in recs[0]
            if k.startswith("allreduce")} if recs else None,
        "grad_ms_first_rerun": recs[0]["ms"] if recs else None,
        "collectives": recs[0]["collectives"] if recs else None,
        "worst_ulps": max((v["ulps"] for v in worst.values()), default=None),
        "leaves_by_ulps": sorted(worst.items(),
                                 key=lambda kv: -kv[1]["ulps"]),
        "seconds": time.perf_counter() - t0, "power": smi}), flush=True)
    return codes == [0] * world


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--runs",
                    default="bfloat16:16,float32:16,bfloat16:4,bfloat16:2")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_tp16_probe: no CUDA device", file=sys.stderr)
        return 2
    _, smi = cs.phase_device(torch)
    ok = True
    for run in args.runs.split(","):
        dtype, world = run.split(":")
        ok = probe(torch, dtype, int(world), args.layers, smi) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
