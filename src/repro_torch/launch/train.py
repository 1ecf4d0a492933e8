"""Training launcher: GFL training of any --arch on a mesh (mirrors
``repro/launch/train.py``).

The mesh's servers are blocked over the ranks of a ``torch.distributed``
world (:mod:`repro_torch.launch.mesh`): one process holds them all, or
``torchrun`` starts several (NCCL ranks on cards, gloo ranks with
``--device cpu``).  The whole path runs — client loops, the combine's
permutes (or K3 once a leaf with ``--use-kernels`` and ``--combine
dense``), the fault process, cohorts, the event layer, telemetry,
privacy accounting and the consensus checkpoint.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --mesh 4x1 --steps 3 --combine dense --use-kernels
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --reduced --mesh 2x1 --steps 2 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch smollm-135m --reduced --mesh 4x1 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch smollm-135m --reduced --mesh 2x2 --backend gloo --device cpu

``--mesh`` takes ``production`` (16 x 16), ``production-multipod`` (2 x
16 x 16) or ``DxM`` / ``PODxDxM``; a model axis M above 1 is tensor
parallelism: each rank holds its block of every leaf of its servers, the
model split over the M ranks of its model group (every family).
``--backend gloo`` puts ranks that share one card on gloo (``--device
cuda:0``); NCCL, the cuda default, is for ranks on distinct cards.
``--layers N`` cuts the arch to N layers at its full width (whisper's
decoder layers; a hybrid's shared block still fires every
``hybrid_attn_every``).  The weights and the draws are random, from
``REPRO_SEED`` (0 by default); the token batches, and a vlm's image
embeddings or whisper's frames (the stubbed encoders' outputs, 0.1 N(0,
1) f32 as ``launch.serve`` draws them), are drawn on the host, so every
rank and device trains on the same data.  The
consensus checkpoint holds server 0's whole leaves (gathered over its
model group), the reference's tree.  Runs on ``cuda`` unless ``--device
cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import rng
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs.base import GFLConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.privacy.mechanism import mechanism_for
from repro_torch.data.synthetic import (TokenStream, client_seed,
                                        federated_token_batches)
from repro_torch.draws import Draws
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import init_world, mesh_from_arg, num_servers
from repro_torch.models.model import Model
from repro_torch.models.parallel import ModelGroup

SELECT_SEED = 1234      # the cohort draws, apart from the model's seed
STUB_SEED = 1           # the stub encoders' outputs, apart from the tokens'


def stub_batch(cfg, step: int, P: int, L: int, per_client: int,
               client_ids=None) -> dict:
    """A vlm's ``image_embeds`` or whisper's ``frames`` for a step's batch,
    [P, L, per_client, N, D] f32, 0.1 N(0, 1): each (server, client id)
    from a host generator of its own (``client_seed`` of STUB_SEED), as
    the tokens are drawn; {} for the other families."""
    n = {"vlm": cfg.num_image_tokens,
         "audio": cfg.encoder_seq_len}.get(cfg.family)
    if not n:
        return {}
    gen = torch.Generator()
    rows = []
    for p in range(P):
        for l in range(L):
            cid = l if client_ids is None else int(client_ids[p, l])
            gen.manual_seed(client_seed(STUB_SEED, step, p, cid))
            rows.append(0.1 * torch.randn((per_client, n, cfg.d_model),
                                          generator=gen))
    key = "image_embeds" if cfg.family == "vlm" else "frames"
    return {key: torch.stack(rows).reshape(P, L, per_client, n,
                                           cfg.d_model)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the arch to this many layers at its width "
                         "(0 keeps its depth)")
    ap.add_argument("--mesh", default="production",
                    help="'production', 'production-multipod' or e.g. '4x1'")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--per-client", type=int, default=2)
    ap.add_argument("--privacy", default="hybrid",
                    help="registered mechanism spec (see "
                         "repro_torch.core.privacy.mechanism), e.g. hybrid, "
                         "gaussian_dp, scheduled:iid_dp")
    ap.add_argument("--sigma", type=float, default=0.01)
    ap.add_argument("--mu", type=float, default=0.1)
    ap.add_argument("--combine", default="sparse",
                    choices=["sparse", "rotate", "dense"])
    ap.add_argument("--fault", default="none",
                    help="resilience fault spec, e.g. links:0.1+dropout:0.2")
    ap.add_argument("--virtual-clients", type=int, default=0,
                    help="virtual population size K per server; 0 keeps the "
                         "positional --clients cohort.  With K > 0 a "
                         "CohortScheduler samples --clients ids per round "
                         "and the accountant reports subsampling-amplified "
                         "epsilon")
    ap.add_argument("--cohort", default="uniform",
                    help="cohort-scheduler spec, e.g. "
                         "uniform+trace:diurnal,period=24,min=0.2")
    ap.add_argument("--async", dest="async_spec", default="none",
                    help="event-driven executor spec, e.g. "
                         "async:buffer=8,latency=lognorm:0.5,max_stale=4 — "
                         "drives staleness-weighted cohort weights and "
                         "per-server release accounting")
    ap.add_argument("--use-kernels", action="store_true",
                    help="the dense combine runs K3 (graph_combine) once a "
                         "leaf (its plain version on the CPU)")
    ap.add_argument("--telemetry", default="off",
                    help="telemetry sink spec: 'off' (default), or a "
                         "'+'-joined jsonl[:path]|csv[:base]|memory|"
                         "console[:every] spec")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="the process group's backend: nccl (default on "
                         "cuda) for ranks on distinct cards, gloo (default "
                         "on cpu) for ranks sharing one card")
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)

    dev = init_world(args.device, args.backend)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    mesh = mesh_from_arg(args.mesh, dev, args.backend)
    Pn = num_servers(mesh)
    log = print if mesh.rank == 0 else (lambda *a, **k: None)
    log(f"mesh {mesh.shape} -> {Pn} GFL servers over {mesh.world} rank(s); "
        f"arch {cfg.name}")

    gfl_cfg = GFLConfig(topology="ring", privacy=args.privacy,
                        sigma_g=args.sigma, mu=args.mu, grad_bound=10.0,
                        combine_impl=args.combine, fault=args.fault,
                        cohort=args.cohort, async_spec=args.async_spec,
                        use_kernels=args.use_kernels,
                        telemetry=args.telemetry)
    # mechanism-aware: the noise profile picks the curve (eps is inf for
    # a zero-noise config — the honest Theorem-2 answer)
    acc = mechanism_for(gfl_cfg).accountant()
    stream = TokenStream(vocab=cfg.vocab_size, seed=0)

    scheduler = None
    if args.virtual_clients <= 0 and args.cohort != "uniform":
        raise SystemExit(
            "--cohort only takes effect with --virtual-clients > 0 (the "
            "scheduler samples cohort ids from the virtual population); "
            "pass --virtual-clients or drop --cohort")
    from repro_torch.core.population import (CohortScheduler,
                                             parse_cohort_spec)
    if args.virtual_clients > 0:
        sampler, floor, trace = parse_cohort_spec(args.cohort)
        if sampler == "importance":
            raise SystemExit(
                "--cohort importance needs per-client gradient-norm "
                "feedback, which the mesh step does not report; use the "
                "simulator engine (run_gfl_population) or a uniform "
                "sampler with a trace")
        # dropout realizations stay with the topology process below
        scheduler = CohortScheduler(
            args.virtual_clients, args.clients, Pn, sampler=sampler,
            floor=floor, trace=trace, seed=0)
        acc.sampling_rate = args.clients / args.virtual_clients
        log(f"virtual population: K={args.virtual_clients} per server, "
            f"cohort L={args.clients} ({args.cohort})")

    async_drv = async_acc = None
    from repro_torch.core.events import AsyncCohortDriver, parse_async_spec
    async_spec = parse_async_spec(args.async_spec)
    if async_spec is not None:
        k_pop = args.virtual_clients or args.clients
        # the event layer drives the step's cohort-weight path; the
        # availability trace is applied once: by the scheduler when there
        # is one, else here
        trace = ("always" if scheduler is not None
                 else parse_cohort_spec(args.cohort)[2])
        async_drv = AsyncCohortDriver(async_spec, Pn, args.clients, k_pop,
                                      trace=trace, seed=0, device=dev)
        async_acc = mechanism_for(gfl_cfg).async_accountant(Pn)
        log(f"async event layer: {async_spec.to_spec()} (per-server "
            f"buffered releases, staleness alpha={async_spec.alpha:g})")

    process = (steps_lib.make_topology_process(mesh, gfl_cfg)
               if gfl_cfg.fault != "none" else None)
    from repro_torch.telemetry import (emit, session_from_config,
                                       telemetry_active, trace_span)
    with session_from_config(gfl_cfg):
        with trace_span("train_setup", arch=cfg.name, servers=Pn):
            model = Model.init(cfg, rng(None, dev),
                               group=ModelGroup.of(mesh))
            step = steps_lib.make_train_step(model, gfl_cfg, mesh)
            state = steps_lib.init_train_state(model, gfl_cfg, mesh,
                                               Draws(None, dev))
        t0 = time.time()
        # the cohort draws stay apart from the model's seed
        sel_draws = Draws(SELECT_SEED, dev)
        history = []
        for i in range(args.steps):
            ids = weights = None
            q_round = None
            if scheduler is not None:
                sel = scheduler.select(sel_draws, i, N=1, batch_size=1)
                ids, weights = sel.client_idx.cpu().numpy(), sel.weights
                q_round = float(sel.q)
                scheduler.q_history.append(q_round)
            if async_drv is not None:
                aw, flushed, q_srv = async_drv.step(i, ids)
                weights = aw if weights is None else weights * aw
            batch = federated_token_batches(
                stream, 0, i, Pn, args.clients, args.per_client, args.seq,
                client_ids=ids)
            batch.update(stub_batch(cfg, i, Pn, args.clients,
                                    args.per_client, client_ids=ids))
            if process is not None:
                real = process.realize(i)
                alive = (process.client_alive(i, args.clients)
                         if process.fault.client_dropout > 0 else None)
                state, metrics = step(state, batch, real.A, alive,
                                      cohort_weights=weights)
                if real.gap != 0.0 and i % max(args.steps // 10, 1) == 0:
                    log(f"  round {i}: spectral gap {real.gap:.3f}")
            else:
                state, metrics = step(state, batch, cohort_weights=weights)
            # one ledger release a protocol round, charged at THIS round's
            # realized rate; under --async a server releases only when its
            # buffer fills, its own ledger on its own cadence
            if async_acc is not None:
                async_acc.record_round(flushed, q_srv)
                eps = async_acc.epsilon()
            else:
                eps = acc.advance(1, q=q_round)
            loss = float(metrics["loss"])
            history.append({"step": i, "loss": loss, "eps": eps})
            if telemetry_active():
                rec = {"step": i, "loss": loss,
                       "seconds": time.time() - t0}
                if process is not None:
                    rec["gap"] = process.realize(i).gap
                emit("mesh", rec)
                if "update_norm" in metrics:
                    emit("step", {
                        "step": i + 1,
                        "update_norm": float(metrics["update_norm"]),
                        "param_norm": float(metrics["param_norm"])})
            if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
                amp = (f" eps_amp {acc.amplified_epsilon():.2f} "
                       f"(q~{scheduler.realized_q:.3g})"
                       if scheduler is not None and async_acc is None
                       else "")
                if async_acc is not None:
                    rel = async_acc.releases
                    amp = (f" eps_amp {async_acc.amplified_epsilon():.2f} "
                           f"rel {min(rel)}-{max(rel)}")
                log(f"step {i:4d} loss {loss:.4f} eps {eps:.1f}{amp} "
                    f"({time.time() - t0:.0f}s)")
    if args.checkpoint and 0 in mesh.local_servers:
        # server 0's whole leaves, by the "/"-joined keys of the
        # reference tree's checkpoint paths, written by its model group's
        # first rank
        tree = steps_lib.whole_leaves(
            {k: v[0] for k, v in state.params.items()}, cfg, model.group)
        if model.group is None or model.group.index == 0:
            save_checkpoint(args.checkpoint, tree, step=args.steps)
            log(f"saved consensus checkpoint to {args.checkpoint}")
    return {"history": history, "state": state, "mesh": mesh}


if __name__ == "__main__":
    main()
