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

Tolerances: f32 outputs within atol 1e-5 of the plain version (the
reference's parity contract, docs/kernels.md); fold_norms' f32 sums within
rtol 1e-5 (a sum over up to 2^22 squares, taken in another order); bf16
outputs, compared in f32, within atol = rtol = 3e-2 (about two bf16 ulps at
|psi| < 4, as tests/test_round_fold.py); hash streams exactly equal.

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
MAIN_SHAPE = (10, 50, 2)
SHAPES = [MAIN_SHAPE, (10, 8, 2048), (10, 13, 509), (10, 8, 1 << 22)]
ITERS = 500
# kernels on vs off after 500 rounds: the two client levels draw different
# masks (hash vs Gaussian) that cancel only to f32 rounding, each round
PARAMS_ATOL = 1e-4
MSD_RTOL, MSD_ATOL = 1e-3, 1e-6


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


def check_close(torch, name, got, want, dtype, *, norms=False):
    err = max_err(torch, got, want)
    if dtype == torch.bfloat16:
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


# ----------------------------------------------------------------- main


KERNELS = {
    "fold_norms": ("src/repro_torch/csrc/fold_norms.cu",
                   "src/repro/kernels/round_fold.py:61", "fold_norms"),
    "fold_apply": ("src/repro_torch/csrc/fold_apply.cu",
                   "src/repro/kernels/round_fold.py:118", "fold_apply[mask]"),
    "graph_combine": ("src/repro_torch/csrc/graph_combine.cu",
                      "src/repro/kernels/graph_combine.py:63",
                      "graph_combine[g]"),
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
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    table = []
    main_t = timings[MAIN_SHAPE]
    for name, (source, replaces, key) in KERNELS.items():
        rec = main_t[key]
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": launches[name],
                      "max_abs_err": errs[name], "ms": rec["ms"],
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
