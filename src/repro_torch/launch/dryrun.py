"""Multi-pod dry run: trace every (arch x shape x mesh) step of the port on
fake tensors over a fake process group (mirrors ``repro/launch/dryrun.py``).

The reference lowers and compiles each step for the 16x16 and 2x16x16
production meshes without hardware and reads XLA's cost and memory
analyses.  Here one process stands in for one rank of the mesh's world
(256 or 512 ranks, a server block and a model slice each): the world is
torch's ``"fake"`` c10d backend (:func:`repro_torch.launch.mesh.fake_world`),
every tensor a ``FakeTensor``, so nothing is allocated, sent or run, and
:mod:`repro_torch.launch.op_analysis` counts what this rank's step would
do: FLOPs, HBM bytes, collective bytes by op, and its memory, with
whether its peak fits the card.  The steps are the port's own
(``steps.make_train_step`` / ``make_prefill_step`` /
``make_decode_step``) at full width and ``INPUT_SHAPES``; K3 and K8 count
by their cost models where the step reaches them (K3: ``--combine dense
--use-kernels`` on ``train_4k``; K8: every GQA arch's decode).  A
data-dependent host read on the step's path raises under fake tensors and
fails the combo with its reason.

Each combo prints one ``OK <tag>: ...`` line and its record as one JSON
line; nothing is written to disk.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
        --shape decode_32k --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
        --shape train_4k --combine dense --use-kernels [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--device cpu]

Fake tensors lie on ``cuda:0`` by default, which models the card (it
needs torch built for CUDA); ``--device cpu`` traces the same ops on fake
CPU tensors, with the same counts.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import rng
from repro_torch.configs.base import INPUT_SHAPES, GFLConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch import roofline as rl
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import Mesh, fake_world, num_servers
from repro_torch.launch.op_analysis import OpCounter, storage_bytes
from repro_torch.models.model import Model
from repro_torch.models.parallel import ModelGroup

# long_500k requires sub-quadratic attention (the reference's DESIGN.md §4)
LONG_OK = {"zamba2-1.2b", "rwkv6-3b", "mixtral-8x7b",
           "llava-next-mistral-7b", "phi3-mini-3.8b"}
LONG_SKIP_REASON = {
    "yi-6b": "pure full attention (no windowed variant in source model)",
    "smollm-135m": "pure full attention",
    "minicpm3-4b": "MLA full attention",
    "deepseek-v2-lite-16b": "MLA full attention (compressed cache, "
                            "still O(S) full-attn)",
    "whisper-tiny": "enc-dec with 448-token decoder; 500k decode meaningless",
}
# the production meshes (launch/mesh.make_production_mesh)
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def default_gfl(combine: str, **over) -> GFLConfig:
    return GFLConfig(topology="ring", privacy="hybrid", sigma_g=0.2,
                     grad_bound=10.0, mu=0.1, combine_impl=combine, **over)


def mesh_name(multi_pod: bool) -> str:
    return "x".join(map(str, MESHES[multi_pod][0]))


def trace_combo(arch: str, shape_name: str, *, multi_pod: bool,
                combine: str = "sparse", donate: bool = True,
                clients: int = 4, gfl_over: dict | None = None,
                moe_dispatch: str | None = None,
                remat_policy: str | None = None, device="cuda:0",
                rank: int = 0):
    """Trace one combo as rank ``rank`` of its production mesh; returns
    (stats, meta) (:class:`op_analysis.OpStats`)."""
    cfg = get_config(arch)
    if moe_dispatch and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=moe_dispatch))
    dims, axes = MESHES[multi_pod]
    return trace_step(cfg, INPUT_SHAPES[shape_name], dims, axes,
                      combine=combine, donate=donate, clients=clients,
                      gfl_over=gfl_over, remat_policy=remat_policy,
                      device=device, rank=rank)


def _rows(shape, servers: int, block: int) -> slice:
    """The rank's rows of a serving batch of ``shape.global_batch``
    requests over ``servers`` data ranks; every rank serves the whole
    batch where it does not split (long_500k's one request)."""
    B = shape.global_batch
    if B % servers:
        return slice(0, B)
    per = B // servers
    return slice(block * per, (block + 1) * per)


def trace_step(cfg, shape, mesh_shape, axes, *, combine: str = "sparse",
               donate: bool = True, clients: int = 4,
               gfl_over: dict | None = None,
               remat_policy: str | None = None, device="cuda:0",
               rank: int = 0):
    """Trace ``cfg``'s step at ``shape`` as rank ``rank`` of a fake world
    laid out as ``mesh_shape`` over ``axes``; returns (stats, meta).

    ``donate`` is the reference's argument: the port's decode step
    updates its cache in place, and a train step's old state lives until
    the caller drops it after the step, which is what donating them
    means, so only True is taken."""
    if not donate:
        raise ValueError("the port's steps always donate: its decode step "
                         "updates the cache in place")
    world = math.prod(mesh_shape)
    dev = torch.device(device)
    t0 = time.perf_counter()
    with fake_world(world, rank), FakeTensorMode():
        mesh = Mesh(mesh_shape, axes, device=dev, backend="fake")
        lay = mesh.layout()
        gen = rng(0, dev)           # fake draws: the seed reaches nothing
        if shape.kind == "train":
            gfl = default_gfl(combine, **(gfl_over or {}))
            model = Model.init(cfg, gen, group=None if gfl.client_parallel
                               else ModelGroup.of(mesh))
            step = steps_lib.make_train_step(model, gfl, mesh,
                                             clients=clients,
                                             remat_policy=remat_policy)
            state = steps_lib.init_train_state(model, gfl, mesh, key=0)
            batch = {k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
                     for k, s in steps_lib.input_specs(
                         model, shape, mesh, gfl=gfl,
                         clients=clients).items()}
            # every rank is handed the whole batch and reads its servers'
            # rows: those are its argument
            share = lay["per_rank"] / num_servers(mesh)
            params = state.params
            counter = OpCounter(argument_bytes=storage_bytes(params) + int(
                sum(b.numel() * b.element_size() for b in batch.values())
                * share))
            with counter:
                out = step(state, batch)
        else:
            model = Model.init(cfg, gen, group=ModelGroup.of(mesh))
            params = dict(model.named_parameters())
            rows = _rows(shape, lay["server_ranks"], lay["block"])
            specs = steps_lib.input_specs(model, shape, mesh)
            if shape.kind == "prefill":
                batch = {k: torch.zeros(s.shape, dtype=s.dtype,
                                        device=dev)[rows]
                         for k, s in specs.items()}
                counter = OpCounter((params, batch))
                with counter:
                    out = steps_lib.make_prefill_step(model)(None, batch)
            else:
                B = len(range(shape.global_batch)[rows])
                tokens = torch.zeros((B,), dtype=specs["tokens"].dtype,
                                     device=dev)
                cache = model.init_cache(B, shape.seq_len)
                counter = OpCounter((params, tokens, cache))
                with counter:
                    out = steps_lib.make_decode_step(model)(None, tokens,
                                                            cache)
        stats = counter.finish(out)
        param_bytes = storage_bytes(params)
        del out, model
    return stats, {"cfg": cfg, "shape": shape, "chips": world,
                   "mesh": "x".join(map(str, mesh_shape)),
                   "param_bytes": param_bytes,
                   "trace_s": time.perf_counter() - t0}


def n_params_of(cfg) -> int:
    """The whole model's parameter count (the reference's tree)."""
    from repro_torch.convert import tree_shapes
    outer, stacks = tree_shapes(cfg)
    return (sum(math.prod(s) for s in outer.values())
            + sum(n * sum(math.prod(s) for s in layer.values())
                  for n, layer in stacks.values()))


def analyze(stats, meta, *, arch, shape_name, combine) -> dict:
    """The combo's record: the reference's keys where their meaning
    carries over, ``flops`` / ``hbm_bytes`` for its ``hlo_flops`` /
    ``hlo_bytes`` (the x chips totals, each beside its per-card value),
    ``trace_s`` for ``compile_s``, and ``fits_hbm``."""
    cfg, shape, chips = meta["cfg"], meta["shape"], meta["chips"]
    memd = {"argument_bytes": stats.argument_bytes,
            "output_bytes": stats.output_bytes,
            "temp_bytes": stats.temp_bytes,
            "peak_bytes": stats.peak_bytes,
            "param_bytes": meta["param_bytes"]}
    n_params = n_params_of(cfg)
    n_active = rl.active_params(cfg, n_params)
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mflops = rl.model_flops_estimate(
        n_params, n_active, tokens,
        "train" if shape.kind == "train" else "serve")
    roof = rl.Roofline(
        arch=arch, shape=shape_name, flops=stats.flops * chips,
        hbm_bytes=stats.hbm_bytes * chips, model_flops=mflops,
        mesh=meta["mesh"], chips=chips,
        collective_bytes=stats.collective_bytes * chips,
        collective_detail={"counts": dict(stats.collective_counts),
                           "bytes_by_op": dict(stats.collective_bytes_by_op)},
        memory_per_device=memd).finalize()
    out = dataclasses.asdict(roof)
    out.update({
        "flops_per_device": stats.flops,
        "hbm_bytes_per_device": stats.hbm_bytes,
        "collective_bytes_per_device": stats.collective_bytes,
        "dot_flops_per_device": stats.dot_flops,
        "ops_per_device": stats.ops,
        "kernel_launches": dict(stats.kernel_launches),
        "modelled": dict(stats.modelled),
        "n_params": n_params, "n_active_params": n_active,
        "fits_hbm": stats.peak_bytes <= rl.HBM_CAPACITY_BYTES,
        "combine": combine if shape.kind == "train" else None,
        "kind": shape.kind})
    return out


def run_one(arch: str, shape_name: str, *, multi_pod: bool,
            combine: str = "sparse", clients: int = 4,
            gfl_over: dict | None = None, moe_dispatch: str | None = None,
            variant: str = "", remat_policy: str | None = None,
            device="cuda:0", rank: int = 0) -> dict:
    """Trace and analyze one combo; prints its ``OK`` (or ``SKIP``) line
    and its record as a JSON line, and returns the record."""
    mesh = mesh_name(multi_pod)
    tag = f"{arch}_{shape_name}_{mesh}_{combine}"
    if variant:
        tag += f"_{variant}"
    if shape_name == "long_500k" and arch not in LONG_OK:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh,
               "skip": LONG_SKIP_REASON.get(arch, "full attention"),
               "combine": combine}
        print(f"SKIP {tag}: {rec['skip']}")
        print(json.dumps(rec), flush=True)
        return rec
    stats, meta = trace_combo(arch, shape_name, multi_pod=multi_pod,
                              combine=combine, clients=clients,
                              gfl_over=gfl_over, moe_dispatch=moe_dispatch,
                              remat_policy=remat_policy, device=device,
                              rank=rank)
    rec = analyze(stats, meta, arch=arch, shape_name=shape_name,
                  combine=combine)
    rec["trace_s"] = round(meta["trace_s"], 1)
    rec["variant"] = variant
    peak = rec["memory_per_device"]["peak_bytes"]
    print(f"OK {tag}: trace={rec['trace_s']}s "
          f"flops={rec['flops']:.3e} bytes={rec['hbm_bytes']:.3e} "
          f"coll={rec['collective_bytes']:.3e} "
          f"bottleneck={rec['bottleneck']} peak/card={peak / 1e9:.2f}GB "
          f"fits_hbm={rec['fits_hbm']}")
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--combine", default="sparse",
                    choices=["sparse", "rotate", "dense"])
    ap.add_argument("--use-kernels", action="store_true",
                    help="the train step's dense combine through K3")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="cuda:0",
                    help="the fake tensors' device: cuda:0 (default) or cpu")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the mesh's world this process traces")
    args = ap.parse_args(argv)

    archs = [a for a in ARCH_IDS if a != "gfl-logreg"] \
        if args.all or not args.arch else [args.arch]
    shapes = list(INPUT_SHAPES) if args.all or not args.shape \
        else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]
    over = {"use_kernels": True} if args.use_kernels else None

    failures = []
    t0 = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    run_one(arch, shape, multi_pod=mp, combine=args.combine,
                            gfl_over=over, device=args.device,
                            rank=args.rank)
                except Exception as e:
                    failures.append((arch, shape, mp, repr(e)))
                    print(f"FAIL {arch}/{shape}/mp={mp}: {e}")
                    traceback.print_exc()
    print(f"\n{len(archs) * len(shapes) * len(meshes)} combos in "
          f"{time.perf_counter() - t0:.1f} s")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        sys.exit(1)
    print("\nall dry-runs passed")


if __name__ == "__main__":
    main()
