#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. device  — the card's name and power limit (nvidia-smi); no CUDA device
             or no port beside this script exits non-zero with no result.
2. build   — compiles every kernel of the main path from
             src/repro_torch/csrc (one nvcc per source, in parallel) and
             prints ptxas' registers and spills.
3. kernels — holds each kernel against its plain torch version on the card
             at the main-path shape (P=10, L=50, D=2), the BENCH shape
             (P=10, L=8, D=2048), a ragged one (P=10, L=13, D=509) and one
             past L2 (P=10, L=8, D=2^22): every fold mode, w as [P, D] and
             [P, L, D], f32 and bf16, graph_combine with g / None / gate;
             hash streams bit-exact; every kernel run twice, bitwise equal.
             Times each (CUDA events), its HBM bound, its plain version and,
             where one torch call computes the same thing, that call.
4. main    — run_gfl on the gfl-logreg problem at full size (P=10, K=50,
             N=100, M=2, L=50, B=10, 500 rounds) for every mechanism, with
             use_kernels on (launch counts read) and off (same seeds);
             checks finite MSD, on/off agreement, hybrid below iid_dp.
5. profile — torch.profiler over 50 hybrid rounds, kernels on and off:
             wall and device-busy time per round, idle share, device ops.
6. swa     — K8 swa_decode against its plain version at the serving shapes
             (B, H, KV, C, Dh) = (4, 32, 32, 2047, 96) bf16,
             (4, 32, 32, 1064, 96) bf16, (4, 9, 3, 1064, 64) bf16 and f32,
             (2, 8, 4, 1000, 64) f32 and (32, 32, 32, 2047, 96) bf16 (805 MB
             of K/V), each with nvalid = C and a partial nvalid; run twice,
             bitwise equal; kernel, plain and scaled_dot_product_attention
             times with the HBM bound, cycling through copies of K/V that
             exceed the 50 MB L2, as decode finds them cold.
7. serve   — phi3-mini-3.8b at full width (32 layers, d 3072, bf16, random
             weights from seed 0) through repro_torch.launch.serve.generate:
             request A, 4 x 4096-token prompts + 32 greedy tokens (ring of
             2047 slots, wrapped); request B, 4 x 1000 + 32 (1064 slots,
             nvalid partial).  Gates finite logits, 32 x 32 K8 launches per
             request, and K8 against its plain version on the live q, cache
             and nvalid of layers 0 and 31 at decode steps 0 and 31;
             prints prefill ms, decode ms per step and tok/s against the
             step's byte bound, peak memory, and a torch.profiler view of
             decode steps (device busy and idle share, K8's share; no
             softmax or scaled_dot_product_attention may run there).

Tolerances: f32 outputs within atol 1e-5 of the plain version (the
reference's parity contract, docs/kernels.md); fold_norms' f32 sums within
rtol 1e-5 (a sum over up to 2^22 squares, taken in another order); bf16
outputs, compared in f32, within atol = rtol = 3e-2 (about two bf16 ulps at
|psi| < 4, as tests/test_round_fold.py); hash streams exactly equal.  K8
in f32 within atol 1e-5; K8 in bf16, whose outputs are attention averages
far smaller than psi, within rtol 1e-2 and atol 2^-8 max|plain| (one bf16
ulp of each value, half an ulp at the top of the range: the kernel and the
plain version differ only in the f32 summation order before the one cast).
The swa phase shows that limit is tight enough: the plain version with one
64-slot tile, or the ragged tail tile, left out (what a kernel that skipped
it would return) must fall outside it at every shape.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Any failed check exits non-zero.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (data sheet)
F32_OPS_PER_S = 67e12            # H100 SXM non-tensor fp32 (data sheet)
ATOL_F32 = 1e-5
RTOL_NORMS = 1e-5
TOL_BF16 = 3e-2
SWA_RTOL_BF16 = 1e-2
SWA_TILE = 64                    # slots per tile in csrc/swa_decode.cu
MAIN_SHAPE = (10, 50, 2)
SHAPES = [MAIN_SHAPE, (10, 8, 2048), (10, 13, 509), (10, 8, 1 << 22)]
ITERS = 500
# kernels on vs off after 500 rounds: the two client levels draw different
# masks (hash vs Gaussian) that cancel only to f32 rounding, each round
PARAMS_ATOL = 1e-4
MSD_RTOL, MSD_ATOL = 1e-3, 1e-6
SWA_SERVE_SHAPE = (4, 32, 32, 2047, 96)
SWA_SHAPES = [(SWA_SERVE_SHAPE, "bfloat16"), ((4, 32, 32, 1064, 96), "bfloat16"),
              ((4, 9, 3, 1064, 64), "bfloat16"), ((4, 9, 3, 1064, 64), "float32"),
              ((2, 8, 4, 1000, 64), "float32"),
              ((32, 32, 32, 2047, 96), "bfloat16")]
L2_BYTES = 50 * 2 ** 20          # H100 L2 (data sheet)
SERVE_ARCH = "phi3-mini-3.8b"
SERVE_REQUESTS = (("A", 4, 4096), ("B", 4, 1000))   # name, batch, prompt
SERVE_NEW_TOKENS = 32
SERVE_PROFILE_STEPS = 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# --------------------------------------------------------------- device


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(line, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": line, "kind": kind,
          "count": torch.cuda.device_count(),
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return kind, line


# ---------------------------------------------------------------- build


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build()
    secs = time.perf_counter() - t0
    for name in _build.SOURCES:
        lines = [ln.strip() for ln in
                 _build.report_path(name).read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
        emit({"phase": "build", "source": f"csrc/{name}.cu",
              "library": paths[name].name, "ptxas": lines})
    emit({"phase": "build", "seconds": secs})


# -------------------------------------------------------------- kernels


def time_ms(torch, fn, *, budget_s=0.2, max_reps=200):
    """Mean ms per call over many launches, CUDA events, after warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = max(time.perf_counter() - t0, 1e-6)
    reps = int(max(3, min(max_reps, budget_s / once)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def swa_tol(torch, want):
    """(atol, rtol) for K8's output against its plain version."""
    if want.dtype != torch.bfloat16:
        return ATOL_F32, 0.0
    return float(want.float().abs().max()) * 2.0 ** -8, SWA_RTOL_BF16


def check_close(torch, name, got, want, dtype, *, norms=False, tol=None):
    err = max_err(torch, got, want)
    if tol is not None:
        ok = torch.allclose(got.float(), want.float(), atol=tol[0],
                            rtol=tol[1])
    elif dtype == torch.bfloat16:
        ok = torch.allclose(got.float(), want.float(), atol=TOL_BF16,
                            rtol=TOL_BF16)
    elif norms:
        ok = torch.allclose(got, want, atol=0.0, rtol=RTOL_NORMS)
    else:
        ok = torch.allclose(got.float(), want.float(), atol=ATOL_F32, rtol=0)
    require(bool(ok), f"{name}: max abs err {err} beyond tolerance")
    return err


def twice_equal(torch, name, fn):
    a, b = fn(), fn()
    torch.cuda.synchronize()
    require(torch.equal(a, b), f"{name}: two runs differ")
    return a


def fold_inputs(torch, P, L, D, dtype, per_client, gen):
    dev = "cuda"
    w_shape = (P, L, D) if per_client else (P, D)
    w = torch.randn(w_shape, generator=gen, device=dev).to(dtype)
    g = (3 * torch.randn((P, L, D), generator=gen, device=dev)).to(dtype)
    noise = (0.3 * torch.randn((P, L, D), generator=gen,
                               device=dev)).to(dtype)
    ss = 0.1 * torch.rand((P, L), generator=gen, device=dev) + 0.01
    fw = torch.rand((P, L), generator=gen, device=dev)
    fw = fw / fw.sum(dim=1, keepdim=True)
    # non-uniform noise weights (staleness-weighted, as the event engine
    # folds) with one dead client per server: uniform weights would make
    # every alive pair's mask term cancel exactly and leave the hash path
    # unchecked
    nw = torch.rand((P, L), generator=gen, device=dev) + 0.1
    nw[:, L // 2] = 0.0
    nw = nw / nw.sum(dim=1, keepdim=True)
    seeds = torch.arange(P, device=dev, dtype=torch.int64) * 2654435761 + 7
    return w, g, noise, ss, fw, nw, seeds


def phase_kernels(torch):
    from repro_torch.kernels import round_fold as rf
    from repro_torch.kernels import secure_agg as sa
    from repro_torch.kernels import graph_combine as gc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    errs = {"fold_norms": 0.0, "fold_apply": 0.0, "graph_combine": 0.0}
    timings = {}

    # hash streams: bit for bit
    for L, D, seed in ((50, 509, 7), (13, 2048, 0xFFFFFFFF), (8, 1 << 16, 0)):
        got = sa.pair_streams(seed, L, D, 0.5, "cuda")
        want = sa.pair_streams_plain(seed, L, D, 0.5, "cuda")
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"pair streams L={L} D={D} seed={seed}: not bit-exact")
        emit({"phase": "kernels", "check": "pair_streams", "L": L, "D": D,
              "seed": seed, "bit_exact": True})

    for (P, L, D) in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            # K1
            _, g, _, _, _, _, _ = fold_inputs(torch, P, L, D, dtype, False,
                                              gen)
            got = twice_equal(torch, "fold_norms", lambda: rf.fold_norms(g))
            e = check_close(torch, f"fold_norms {P,L,D} {dname}", got,
                            rf.fold_norms_plain(g), torch.float32, norms=True)
            emit({"phase": "kernels", "kernel": "fold_norms",
                  "shape": [P, L, D], "dtype": dname, "max_abs_err": e})
            del g
            # K2: every mode, shared and per-client bases
            for per_client in (False, True):
                w, g, noise, ss, fw, nw, seeds = fold_inputs(
                    torch, P, L, D, dtype, per_client, gen)
                for mode in ("none", "laplace", "mask"):
                    kw = dict(mode=mode, sigma=0.5,
                              seeds=seeds if mode == "mask" else None,
                              noise=noise if mode == "laplace" else None)
                    got = twice_equal(torch, "fold_apply",
                                      lambda: rf.fold_apply(w, g, ss, fw, nw,
                                                            **kw))
                    want = rf.fold_apply_plain(w, g, ss, fw, nw, **kw)
                    e = check_close(torch, f"fold_apply {mode} {P,L,D} "
                                    f"{dname} per_client={per_client}",
                                    got, want, dtype)
                    if dtype == torch.float32 and (P, L, D) == MAIN_SHAPE:
                        errs["fold_apply"] = max(errs["fold_apply"], e)
                    emit({"phase": "kernels", "kernel": "fold_apply",
                          "mode": mode, "per_client_base": per_client,
                          "shape": [P, L, D], "dtype": dname,
                          "max_abs_err": e})
                del w, g, noise
            # K3: g / None / gate
            psi = torch.randn((P, D), generator=gen, device="cuda").to(dtype)
            gn = (0.2 * torch.randn((P, D), generator=gen,
                                    device="cuda")).to(dtype)
            cache = torch.randn((P, D), generator=gen,
                                device="cuda").to(dtype)
            gate = (torch.arange(P, device="cuda") % 3 != 0).float()
            A = torch.rand((P, P), generator=gen, device="cuda")
            a_t = (A / A.sum(dim=0, keepdim=True)).T.contiguous()
            for variant, args in (("g", (gn, None, None)),
                                  ("none", (None, None, None)),
                                  ("gate", (gn, cache, gate))):
                g_, c_, gt_ = args
                got = twice_equal(torch, "graph_combine",
                                  lambda: gc.graph_combine(a_t, psi, g_,
                                                           cache=c_,
                                                           gate=gt_))
                want = gc.graph_combine_plain(a_t, psi, g_, cache=c_,
                                              gate=gt_)
                e = check_close(torch, f"graph_combine {variant} {P,D} "
                                f"{dname}", got, want, dtype)
                if dtype == torch.float32 and (P, L, D) == MAIN_SHAPE:
                    errs["graph_combine"] = max(errs["graph_combine"], e)
                emit({"phase": "kernels", "kernel": "graph_combine",
                      "variant": variant, "shape": [P, D], "dtype": dname,
                      "max_abs_err": e})
            if dtype == torch.float32 and (P, L, D) == MAIN_SHAPE:
                _, g, _, _, _, _, _ = fold_inputs(torch, P, L, D, dtype,
                                                  False, gen)
                errs["fold_norms"] = max_err(torch, rf.fold_norms(g),
                                             rf.fold_norms_plain(g))
        timings[(P, L, D)] = time_shape(torch, P, L, D, gen)
        emit({"phase": "kernels", "timing": timings[(P, L, D)],
              "shape": [P, L, D], "dtype": "float32"})
    return errs, timings


def time_shape(torch, P, L, D, gen):
    """f32 kernel, plain and library times at one shape, with the bounds."""
    from repro_torch.kernels import round_fold as rf
    from repro_torch.kernels import graph_combine as gc

    f32 = torch.float32
    w, g, noise, ss, fw, _, seeds = fold_inputs(torch, P, L, D, f32, False,
                                                gen)
    nw = torch.full((P, L), 1.0 / L, device="cuda")     # all alive
    out = {}
    # K1: reads g once, writes [P, L]
    bytes_k1 = P * L * D * 4 + P * L * 4
    out["fold_norms"] = {
        "ms": time_ms(torch, lambda: rf.fold_norms(g)),
        "plain_ms": time_ms(torch, lambda: rf.fold_norms_plain(g)),
        "library_ms": time_ms(
            torch, lambda: torch.linalg.vector_norm(g, dim=-1) ** 2),
        "bytes": bytes_k1, "ops": 2 * P * L * D}
    # K2 per mode: reads w, g (+ noise), weights; writes psi
    base = P * D * 4 + P * L * D * 4 + 3 * P * L * 4 + P * D * 4
    npairs = L * (L - 1) // 2
    for mode in ("none", "laplace", "mask"):
        kw = dict(mode=mode, sigma=0.2,
                  seeds=seeds if mode == "mask" else None,
                  noise=noise if mode == "laplace" else None)
        nbytes = base + (P * L * D * 4 if mode == "laplace" else 0) + \
            (P * 4 if mode == "mask" else 0)
        # 3 flops per client (sub, mul, fma); laplace adds an fma per
        # client; mask ~14 integer/float ops per alive pair and feature
        ops = P * D * (3 * L + (2 * L if mode == "laplace" else 0)
                       + (14 * npairs if mode == "mask" else 0))
        out[f"fold_apply[{mode}]"] = {
            "ms": time_ms(torch, lambda: rf.fold_apply(w, g, ss, fw, nw,
                                                       **kw)),
            "plain_ms": time_ms(torch, lambda: rf.fold_apply_plain(
                w, g, ss, fw, nw, **kw), budget_s=0.5, max_reps=50),
            "library_ms": None, "bytes": nbytes, "ops": ops}
    del noise, g, w
    # K3: reads a_t, psi, g; writes out
    psi = torch.randn((P, D), generator=gen, device="cuda")
    gn = 0.2 * torch.randn((P, D), generator=gen, device="cuda")
    A = torch.rand((P, P), generator=gen, device="cuda")
    a_t = (A / A.sum(dim=0, keepdim=True)).T.contiguous()
    x, neg_g = psi + gn, -gn
    for variant, g_ in (("g", gn), ("none", None)):
        nbytes = P * P * 4 + (3 if g_ is not None else 2) * P * D * 4
        lib = ((lambda: torch.addmm(neg_g, a_t, x)) if g_ is not None
               else (lambda: torch.mm(a_t, psi)))
        out[f"graph_combine[{variant}]"] = {
            "ms": time_ms(torch, lambda: gc.graph_combine(a_t, psi, g_)),
            "plain_ms": time_ms(torch, lambda: gc.graph_combine_plain(
                a_t, psi, g_)),
            "library_ms": time_ms(torch, lib), "bytes": nbytes,
            "ops": 2 * P * P * D + (2 * P * D if g_ is not None else 0)}
    for rec in out.values():
        rec["bound_ms"] = max(rec["bytes"] / HBM_BYTES_PER_S,
                              rec["ops"] / F32_OPS_PER_S) * 1e3
        rec["bound_by"] = ("bytes" if rec["bytes"] / HBM_BYTES_PER_S
                           >= rec["ops"] / F32_OPS_PER_S else "operations")
    return out


# ------------------------------------------------------------ main path


def phase_main(torch):
    import numpy as np
    from repro_torch import kernels as K, rng
    from repro_torch.configs import gfl_logreg
    from repro_torch.core.privacy.accountant import epsilon_at
    from repro_torch.core.privacy.mechanism import (list_mechanisms,
                                                    mechanism_for)
    from repro_torch.core.simulate import generate_problem, run_gfl
    from dataclasses import replace

    t0 = time.perf_counter()
    base = gfl_logreg.GFL
    prob = generate_problem(rng(0, "cuda"), P=base.num_servers,
                            K=base.clients_per_server,
                            N=gfl_logreg.SAMPLES_PER_CLIENT,
                            M=gfl_logreg.DIM, rho=gfl_logreg.RHO)
    torch.cuda.synchronize()
    emit({"phase": "main", "problem_seconds": time.perf_counter() - t0,
          "w_opt": prob.w_opt.cpu().tolist()})
    eps_budget = epsilon_at(ITERS, base.mu, base.grad_bound, base.sigma_g)
    expect = {"none": {"fold_norms", "fold_apply", "graph_combine"},
              "iid_dp": {"fold_norms", "fold_apply"},
              "hybrid": {"fold_norms", "fold_apply", "graph_combine"},
              "gaussian_dp": {"fold_norms", "fold_apply", "graph_combine"},
              "scheduled": {"graph_combine"}}
    totals = {name: 0 for name in K.LAUNCHES}
    tails = {}
    for scheme in list_mechanisms():
        cfg = replace(base, privacy=scheme, epsilon_target=eps_budget,
                      epsilon_horizon=ITERS, use_kernels=True)
        K.reset_launches()
        t0 = time.perf_counter()
        msd_on, p_on = run_gfl(prob, cfg, iters=ITERS, batch_size=10, seed=1)
        torch.cuda.synchronize()
        wall_on = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        for name, n in launches.items():
            totals[name] += n
        t0 = time.perf_counter()
        msd_off, p_off = run_gfl(prob, replace(cfg, use_kernels=False),
                                 iters=ITERS, batch_size=10, seed=1)
        torch.cuda.synchronize()
        wall_off = time.perf_counter() - t0
        tail = float(np.mean(msd_on[-50:]))
        tails[scheme] = tail
        acc = mechanism_for(cfg).accountant()
        acc.advance(ITERS)
        p_err = float((p_on - p_off).abs().max())
        msd_err = float(np.max(np.abs(msd_on - msd_off)))
        emit({"phase": "main", "scheme": scheme, "msd_tail": tail,
              "msd_tail_kernels_off": float(np.mean(msd_off[-50:])),
              "epsilon": acc.epsilon(), "wall_s": wall_on,
              "wall_s_kernels_off": wall_off, "launches": launches,
              "params_max_abs_diff": p_err, "msd_max_abs_diff": msd_err})
        require(bool(np.all(np.isfinite(msd_on)))
                and bool(np.all(np.isfinite(msd_off))),
                f"{scheme}: non-finite MSD")
        for name in expect[scheme]:
            require(launches[name] > 0,
                    f"{scheme}: kernel {name} was never launched")
        require(p_err <= PARAMS_ATOL
                and bool(np.allclose(msd_on, msd_off, rtol=MSD_RTOL,
                                     atol=MSD_ATOL)),
                f"{scheme}: kernels on/off differ (params {p_err}, "
                f"msd {msd_err})")
    require(tails["hybrid"] < tails["iid_dp"],
            f"hybrid MSD tail {tails['hybrid']} not below iid_dp "
            f"{tails['iid_dp']}")
    return totals, prob


# -------------------------------------------------------------- profile


def phase_profile(torch, prob, rounds=50):
    """Where an M=2 hybrid round's time goes: torch.profiler over a short
    run (after the main phase warmed everything up), kernels on and off."""
    from dataclasses import replace
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import gfl_logreg
    from repro_torch.core.simulate import run_gfl

    for use_kernels in (True, False):
        cfg = replace(gfl_logreg.GFL, privacy="hybrid",
                      use_kernels=use_kernels)
        run_gfl(prob, cfg, iters=5, batch_size=10, seed=2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_gfl(prob, cfg, iters=rounds, batch_size=10, seed=2)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy, count, by_name = 0.0, 0, {}
        for evt in prof.events():
            if str(getattr(evt, "device_type", "")).endswith("CUDA"):
                us = evt.time_range.elapsed_us()
                busy += us
                count += 1
                tot = by_name.setdefault(evt.name[:60], [0.0, 0])
                tot[0] += us
                tot[1] += 1
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
        host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        host = [{"name": e.key[:60], "ms_per_round":
                 e.self_cpu_time_total / 1e3 / rounds,
                 "per_round": e.count / rounds} for e in host[:8]]
        emit({"phase": "profile", "scheme": "hybrid",
              "use_kernels": use_kernels, "rounds": rounds,
              "wall_ms_per_round": wall * 1e3 / rounds,
              "device_busy_ms_per_round": (busy / 1e3 / rounds
                                           if count else None),
              "device_idle_share": (1.0 - busy / 1e6 / wall
                                    if count else None),
              "device_ops_per_round": count / rounds if count else None,
              "top_device_ops": [{"name": n, "ms_per_round": v[0] / 1e3 /
                                  rounds, "per_round": v[1] / rounds}
                                 for n, v in top],
              "top_host_ops": host})


# ------------------------------------------------------------ K8 (swa)


def cycling(fns):
    """One callable that runs fns[0], fns[1], ... in turn."""
    state = {"i": 0}

    def run():
        out = fns[state["i"] % len(fns)]()
        state["i"] += 1
        return out
    return run


def swa_bound(B, H, KV, n_live, Dh, esize):
    """Least time of one K8 call: each live K/V row, q and out moved once
    (bytes), or 4 B H n Dh flops on the CUDA cores (f32 FMAs)."""
    nbytes = 2 * B * n_live * KV * Dh * esize + 2 * B * H * Dh * esize + 4
    ops = 4 * B * H * n_live * Dh
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations"), \
        nbytes


def planted_faults(torch, swa, q, k, v, nv, want, tol):
    """Max abs error of what a kernel that left slots out would return: the
    plain version over the live slots less a middle tile, the ragged tail
    tile, or one slot.  A tile left out must fall outside ``tol``."""
    n = min(nv, k.shape[1])
    mid = (n // SWA_TILE) // 2 * SWA_TILE
    tail = n - (n % SWA_TILE or SWA_TILE)
    out = {}
    for label, lo, hi in (("tile", mid, mid + SWA_TILE),
                          ("tail", tail, n), ("slot", n // 2, n // 2 + 1)):
        keep = torch.cat([torch.arange(lo, device=k.device),
                          torch.arange(hi, n, device=k.device)])
        fault = swa.swa_decode_attention_plain(
            q, k[:, keep], v[:, keep],
            torch.tensor([keep.numel()], dtype=torch.int32, device=k.device))
        caught = not torch.allclose(fault.float(), want.float(), atol=tol[0],
                                    rtol=tol[1])
        require(caught or label == "slot", f"swa_decode tolerance {tol} "
                f"misses a kernel that leaves out the {label} [{lo}, {hi})")
        out[label] = {"slots": hi - lo, "max_abs_err": max_err(
            torch, fault, want), "caught": caught}
    return out


def phase_swa(torch):
    import torch.nn.functional as F
    from repro_torch.kernels import swa_decode as swa

    gen = torch.Generator(device="cuda")
    gen.manual_seed(812)
    serve_row = None
    for (B, H, KV, C, Dh), dname in SWA_SHAPES:
        dtype = getattr(torch, dname)
        esize = torch.tensor([], dtype=dtype).element_size()
        kv_bytes = 2 * B * C * KV * Dh * esize
        copies = max(1, min(64, -(-2 * L2_BYTES // kv_bytes)))
        q = torch.randn((B, H, Dh), generator=gen, device="cuda").to(dtype)
        kvs = [(torch.randn((B, C, KV, Dh), generator=gen,
                            device="cuda").to(dtype),
                torch.randn((B, C, KV, Dh), generator=gen,
                            device="cuda").to(dtype))
               for _ in range(copies)]
        k, v = kvs[0]
        for nv in (C, (2 * C) // 3):
            nvalid = torch.tensor([nv], dtype=torch.int32, device="cuda")
            got = twice_equal(torch, "swa_decode",
                              lambda: swa.swa_decode(q, k, v, nvalid))
            want = swa.swa_decode_attention_plain(q, k, v, nvalid)
            tol = swa_tol(torch, want)
            err = check_close(torch, f"swa_decode {(B, H, KV, C, Dh)} "
                              f"{dname} nvalid={nv}", got, want, dtype,
                              tol=tol)
            faults = planted_faults(torch, swa, q, k, v, nv, want, tol)
            mask = (torch.arange(C, device="cuda") < nv)[None, None, None]

            def library(k_, v_):
                return F.scaled_dot_product_attention(
                    q[:, :, None], k_.transpose(1, 2), v_.transpose(1, 2),
                    attn_mask=mask, enable_gqa=KV != H)[:, :, 0]
            lib_err = max_err(torch, library(k, v), want)
            rec = {
                "ms": time_ms(torch, cycling(
                    [lambda k_=k_, v_=v_: swa.swa_decode(q, k_, v_, nvalid)
                     for k_, v_ in kvs])),
                "plain_ms": time_ms(torch, cycling(
                    [lambda k_=k_, v_=v_: swa.swa_decode_attention_plain(
                        q, k_, v_, nvalid) for k_, v_ in kvs]),
                    budget_s=0.5, max_reps=50),
                "library_ms": time_ms(torch, cycling(
                    [lambda k_=k_, v_=v_: library(k_, v_)
                     for k_, v_ in kvs]), budget_s=0.5, max_reps=100)}
            rec["bound_ms"], rec["bound_by"], nbytes = swa_bound(
                B, H, KV, min(nv, C), Dh, esize)
            emit({"phase": "swa", "kernel": "swa_decode",
                  "shape": [B, H, KV, C, Dh], "dtype": dname, "nvalid": nv,
                  "max_abs_err": err, "atol": tol[0], "rtol": tol[1],
                  "planted_faults": faults, "library_max_abs_err": lib_err,
                  "kv_copies_cycled": copies, "bytes": nbytes,
                  "hbm_share": rec["bound_ms"] / rec["ms"], **rec})
            if ((B, H, KV, C, Dh) == SWA_SERVE_SHAPE and nv == C
                    and serve_row is None):
                serve_row = dict(rec, max_abs_err=err)
        del kvs, k, v
        torch.cuda.empty_cache()
    return serve_row


# ---------------------------------------------------------------- serve


class DecodeTap:
    """Stands in for ops.swa_decode_attention during a request: passes
    every call through and keeps copies of the inputs and output of the
    (layer, step) calls it is asked for."""

    def __init__(self, ops, n_layers, keep):
        self.ops, self.n_layers, self.keep = ops, n_layers, set(keep)
        self.orig = ops.swa_decode_attention
        self.calls, self.captured, self.nvalid = 0, {}, []

    def __enter__(self):
        self.ops.swa_decode_attention = self
        return self

    def __exit__(self, *exc):
        self.ops.swa_decode_attention = self.orig

    def __call__(self, q, k, v, nvalid):
        step, layer = divmod(self.calls, self.n_layers)
        self.calls += 1
        out = self.orig(q, k, v, nvalid)
        if layer == 0:
            self.nvalid.append(nvalid)
        if (layer, step) in self.keep:
            self.captured[(layer, step)] = tuple(
                t.clone() for t in (q, k, v, nvalid.reshape(1), out))
        return out


def decode_profile(torch, model, toks, cache, steps):
    """torch.profiler over ``steps`` decode steps (already warm)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = model.decode_step(toks, cache)
            toks = logits.argmax(-1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, k8, k8_n, count, by_name = 0.0, 0.0, 0, 0, {}
    for evt in prof.events():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            us = evt.time_range.elapsed_us()
            busy += us
            count += 1
            tot = by_name.setdefault(evt.name[:60], [0.0, 0])
            tot[0] += us
            tot[1] += 1
            if "swa_decode" in evt.name:
                k8 += us
                k8_n += 1
    host_ops = {e.key for e in prof.key_averages()}
    banned = sorted(n for n in host_ops | set(by_name)
                    if "softmax" in n.lower() or "scaled_dot_product" in n)
    require(not banned, f"decode step runs {banned}: the attention core "
            "must go through K8 alone")
    require(k8_n == steps * model.cfg.num_layers,
            f"profiled {steps} decode steps saw {k8_n} K8 launches")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {"steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
            "device_busy_ms_per_step": busy / 1e3 / steps,
            "device_idle_share": 1.0 - busy / 1e6 / wall,
            "device_ops_per_step": count / steps,
            "k8_ms_per_step": k8 / 1e3 / steps,
            "k8_share_of_device_time": k8 / busy if busy else None,
            "k8_launches": k8_n,
            "top_device_ops": [{"name": n, "ms_per_step": t / 1e3 / steps,
                                "per_step": c / steps}
                               for n, (t, c) in top],
            "top_host_ops": [{"name": e.key[:60], "ms_per_step":
                              e.self_cpu_time_total / 1e3 / steps,
                              "per_step": e.count / steps}
                             for e in host[:8]]}


def phase_serve(torch):
    from repro_torch import kernels as K, rng
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import swa_decode_attention_plain
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import Model

    cfg = get_config(SERVE_ARCH)
    gen = rng(0, "cuda")
    t0 = time.perf_counter()
    model = Model.init(cfg, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    table_bytes = model.embed["table"].numel() * 2
    L, Dh = cfg.num_layers, cfg.resolved_head_dim
    require(L == 32 and cfg.d_model == 3072 and cfg.param_dtype == "bfloat16"
            and model.embed["table"].dtype == torch.bfloat16,
            f"{SERVE_ARCH} is not at full width")
    emit({"phase": "serve", "arch": SERVE_ARCH, "params": n_params,
          "weight_bytes": weight_bytes, "init_s": init_s})
    keep = [(layer, step) for layer in (0, L - 1)
            for step in (0, SERVE_NEW_TOKENS - 1)]
    launches = 0
    for name, B, S in SERVE_REQUESTS:
        prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                               device="cuda")
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        with DecodeTap(ops, L, keep) as tap:
            out = generate(model, prompt, SERVE_NEW_TOKENS)
        counts = dict(K.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        cache = out["cache"]
        C = cache["k"].shape[2]
        nvalid = [int(n) for n in tap.nvalid]
        launches += counts["swa_decode"]
        require(bool(torch.isfinite(out["logits"].float()).all()),
                f"request {name}: non-finite logits")
        require(counts["swa_decode"] == L * SERVE_NEW_TOKENS,
                f"request {name}: {counts['swa_decode']} K8 launches, "
                f"expected {L * SERVE_NEW_TOKENS}")
        require(nvalid == [min(S + 1 + t, C) for t in range(SERVE_NEW_TOKENS)],
                f"request {name}: nvalid {nvalid[:3]}...")
        live = {}
        for (layer, step), (q, k, v, nv, got) in sorted(tap.captured.items()):
            want = swa_decode_attention_plain(q, k, v, nv)
            err = check_close(torch, f"serve {name} layer {layer} step "
                              f"{step}", got, want, torch.bfloat16,
                              tol=swa_tol(torch, want))
            require(torch.equal(got, ops.swa_decode_attention(q, k, v, nv)),
                    f"serve {name} layer {layer} step {step}: rerun differs")
            live[f"layer{layer}_step{step}"] = {"nvalid": int(nv),
                                                "max_abs_err": err}
        del tap
        mean_nv = sum(nvalid) / len(nvalid)
        kv_step = 2 * L * B * mean_nv * cfg.num_kv_heads * Dh * 2
        step_bytes = weight_bytes - table_bytes + kv_step
        decode_ms = out["decode_s"] * 1e3 / SERVE_NEW_TOKENS
        toks = out["tokens"][:, -1]
        prof = decode_profile(torch, model, toks, cache, SERVE_PROFILE_STEPS)
        emit({"phase": "serve", "request": name, "batch": B, "prompt": S,
              "new_tokens": SERVE_NEW_TOKENS, "cache_slots": C,
              "nvalid_first_last": [nvalid[0], nvalid[-1]],
              "ring_wrapped": S > C, "launches": counts,
              "prefill_ms": out["prefill_s"] * 1e3,
              "decode_ms_per_step": decode_ms,
              "decode_tok_per_s": B * SERVE_NEW_TOKENS / out["decode_s"],
              "step_bytes": step_bytes, "step_kv_bytes": kv_step,
              "step_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
              "k8_bound_ms_per_step": kv_step / HBM_BYTES_PER_S * 1e3,
              "peak_memory_bytes": peak, "live_checks": live,
              "profile": prof})
        del out, cache, prompt
        torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------- main


KERNELS = {
    "fold_norms": ("src/repro_torch/csrc/fold_norms.cu",
                   "src/repro/kernels/round_fold.py:61", "fold_norms"),
    "fold_apply": ("src/repro_torch/csrc/fold_apply.cu",
                   "src/repro/kernels/round_fold.py:118", "fold_apply[mask]"),
    "graph_combine": ("src/repro_torch/csrc/graph_combine.cu",
                      "src/repro/kernels/graph_combine.py:63",
                      "graph_combine[g]"),
    "swa_decode": ("src/repro_torch/csrc/swa_decode.cu",
                   "src/repro/kernels/swa_decode.py:57", None),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: the port (src/repro_torch) is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    try:
        kind, smi = phase_device(torch)
        phase_build()
        errs, timings = phase_kernels(torch)
        launches, prob = phase_main(torch)
        phase_profile(torch, prob)
        del prob
        swa_row = phase_swa(torch)
        launches["swa_decode"] = phase_serve(torch)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    table = []
    main_t = timings[MAIN_SHAPE]
    for name, (source, replaces, key) in KERNELS.items():
        rec = main_t[key] if key is not None else swa_row
        err = errs[name] if key is not None else swa_row["max_abs_err"]
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": launches[name],
                      "max_abs_err": err, "ms": rec["ms"],
                      "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                      "bound_by": rec["bound_by"],
                      "library_ms": rec["library_ms"]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "power": smi})
    print(smi, flush=True)          # card name and power limit, nvidia-smi
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
