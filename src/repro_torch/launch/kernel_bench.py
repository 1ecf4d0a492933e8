"""Kernel bench: per-kernel µs a call, and the round pipeline fused and
unfused (mirrors ``benchmarks/kernel_bench.py``).

    PYTHONPATH=src python -m repro_torch.launch.kernel_bench [--reduced]
    PYTHONPATH=src python -m repro_torch.launch.kernel_bench --reduced --device cpu

Runs on ``cuda`` unless ``--device cpu`` is given, and prints CSV rows
``name,value`` after a ``# device`` line naming the device.  On the card
the kernels are the hand-written CUDA ones and times are CUDA-event means;
on the CPU the wrappers run their plain versions and times are host-clock
means, which say nothing about the card.  Nothing is written to a file.

Micro rows time each single-server kernel beside its plain version at the
reference's shapes (P = 16, L = 8, D = 8192; 2048 reduced): K3
``graph_combine``, K5 ``secure_agg_mean``, K7 ``laplace_transform`` and K6
``clip_accum`` through ``kernels.ops``.

Round rows compare two realizations of one GFL round (clip -> update ->
privatize -> fold -> combine) over [P, L, D] = [10, 8, 16384] (2048
reduced, or any ``D``), in the noise modes "mask" and "laplace":

  unfused_chain  the reference op chain as separate eager ops, each
                 reading its operands from device memory and writing its
                 result back; the privatize stage draws Gaussian pair masks
                 (``pairwise_masks_vec``) or Laplace noise
                 (``sample_laplace``) from a Generator, as the mechanisms do
                 with kernels off;
  fused_kernels  ``ops.round_fold`` + ``ops.graph_combine``: K1, K2 and K3,
                 with the in-round seed or noise draws.

The reference's third row, ``fused_ref``, has no counterpart: it times XLA
fusing the jnp backend into one program, eager torch fuses nothing, and
``torch.compile`` of the plain chain is not a port of the kernels.  Each
mode also carries the analytic HBM byte ratio and round-trip ratio of
:func:`~repro_torch.launch.roofline.round_pipeline_traffic`, the measured
``speedup = unfused_chain / fused_kernels``, and the fused pipeline's
achieved GB/s and share of the card's 3.35 TB/s.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device, rng
from repro_torch.core.privacy.noise import sample_laplace
from repro_torch.core.privacy.secure_agg import num_pairs, pairwise_masks_vec
from repro_torch.core.topology import combination_matrix
from repro_torch.kernels import ops, ref
from repro_torch.kernels.clip_accum import clip_accum_plain
from repro_torch.launch.roofline import HBM_BYTES_PER_S, round_pipeline_traffic

MICRO_SHAPE = (16, 8, 8192)        # P, L, D (reference micro_rows)
ROUND_SHAPE = (10, 8, 16384)       # P, L, D (reference round_rows)
REDUCED_D = 2048


def time_ms(fn, *, device="cuda", budget_s: float = 0.2,
            max_reps: int = 200) -> float:
    """Mean ms a call of ``fn`` over many calls after one warm-up call:
    CUDA events around back-to-back calls on a card, the host clock on the
    CPU.  The repetitions fill about ``budget_s`` seconds."""
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    fn()
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    once = max(time.perf_counter() - t0, 1e-6)
    reps = int(max(3, min(max_reps, budget_s / once)))
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _ring(P: int, dev) -> torch.Tensor:
    return torch.as_tensor(combination_matrix("ring", P), dtype=torch.float32,
                           device=dev)


def micro_rows(reduced: bool = False, device=None) -> list:
    """[(name, µs a call)] for K3, K5, K7 and K6 and their plain versions."""
    dev = resolve_device(device)
    P, L, D = MICRO_SHAPE
    if reduced:
        D = REDUCED_D
    gen = rng(0, dev)                    # fixed bench seed
    A = _ring(P, dev)
    psi = torch.randn((P, D), generator=gen, device=dev)
    g = torch.randn((P, D), generator=gen, device=dev)
    upd = torch.randn((L, D), generator=gen, device=dev)
    u = torch.rand((P, D), generator=gen, device=dev) * 0.998 - 0.499
    seed = torch.tensor([7], dtype=torch.int32, device=dev)
    at = A.T.contiguous()

    def us(fn):
        return time_ms(fn, device=dev) * 1e3

    return [
        ("kernel/graph_combine_us", us(lambda: ops.graph_combine(A, psi, g))),
        ("oracle/graph_combine_us",
         us(lambda: ref.graph_combine_ref(at, psi, g))),
        ("kernel/secure_agg_us", us(lambda: ops.secure_agg_mean(upd, seed))),
        ("kernel/laplace_us", us(lambda: ops.laplace_transform(u, 0.5))),
        ("oracle/laplace_us",
         us(lambda: ref.laplace_transform_plain(u, 0.5))),
        ("kernel/clip_accum_us", us(lambda: ops.clip_accum(upd, 1.0))),
        ("oracle/clip_accum_us", us(lambda: clip_accum_plain(upd, 1.0))),
    ]


def _unfused_chain(A, mode, P, L, D, gen):
    """The reference chain, one eager op per stage, so every intermediate
    goes through device memory; the privatize stage draws as the
    mechanisms do with kernels off."""
    dev = A.device

    def run(w, grads, gn, bound=10.0, mu=0.1):
        n = torch.sqrt(torch.sum(grads * grads, dim=-1))
        c = torch.clamp(bound / torch.clamp(n, min=1e-12), max=1.0)
        upd = w[:, None] - mu * c[..., None] * grads
        if mode == "mask":
            normals = torch.randn((P, num_pairs(L), D), generator=gen,
                                  device=dev)
            upd = upd + pairwise_masks_vec(L, D, 0.3, normals=normals)  # bench-only release site (timing, no data)  # gflint: disable=GFL002
        elif mode == "laplace":
            upd = upd + sample_laplace((P, L, D), 0.3, generator=gen)
        psi = upd.mean(dim=1)
        return ref.graph_combine_ref(A.T, psi, gn)

    return run


def _fused(A, mode, P, L, D, gen):
    """K1 + K2 + K3 through the dispatch layer, with the mechanism's
    in-round draws (per-server seeds, or the pre-drawn Laplace noise)."""
    dev = A.device
    sigma = 0.3

    def run(w, grads, gn):
        seeds = noise = None
        if mode == "mask":
            seeds = torch.randint(0, 2 ** 31 - 1, (P,), generator=gen,
                                  device=dev)
        elif mode == "laplace":
            noise = sample_laplace((P, L, D), sigma, generator=gen)
        psi, _ = ops.round_fold(  # bench-only release site (timing, no data)  # gflint: disable=GFL002
            w, grads, mu=0.1, bound=10.0, mode=mode, sigma=sigma,
            seeds=seeds, noise=noise)
        return ops.graph_combine(A, psi, gn)

    return run


def round_rows(reduced: bool = False, device=None, D: int | None = None):
    """(rows [(name, value)], report [dict per mode]) of the round
    pipeline, unfused chain vs fused kernels, for modes mask and laplace."""
    dev = resolve_device(device)
    P, L, D0 = ROUND_SHAPE
    D = D if D is not None else (REDUCED_D if reduced else D0)
    gen = rng(0, dev)                    # fixed bench seed
    A = _ring(P, dev)
    w = torch.randn((P, D), generator=gen, device=dev)
    grads = torch.randn((P, L, D), generator=gen, device=dev)
    gn = torch.randn((P, D), generator=gen, device=dev) * 0.3

    rows, report = [], []
    for mode in ("mask", "laplace"):
        chain = _unfused_chain(A, mode, P, L, D, gen)
        fused = _fused(A, mode, P, L, D, gen)
        t_chain = time_ms(lambda: chain(w, grads, gn), device=dev,
                          budget_s=0.5, max_reps=50) * 1e3
        t_fused = time_ms(lambda: fused(w, grads, gn), device=dev,
                          budget_s=0.5, max_reps=50) * 1e3
        ref_b = round_pipeline_traffic(P, L, D, mode=mode, fused=False)
        fus_b = round_pipeline_traffic(P, L, D, mode=mode, fused=True)
        ratio = fus_b["total"] / ref_b["total"]
        trips = fus_b["pld_passes"] / ref_b["pld_passes"]
        speedup = t_chain / t_fused
        gbps = fus_b["total"] / (t_fused * 1e-6) / 1e9
        frac = gbps / (HBM_BYTES_PER_S / 1e9)
        rows += [
            (f"round/{mode}/unfused_chain_us", t_chain),
            (f"round/{mode}/fused_kernels_us", t_fused),
            (f"round/{mode}/hbm_ratio", ratio),
            (f"round/{mode}/roundtrip_ratio", trips),
            (f"round/{mode}/speedup", speedup),
            (f"round/{mode}/achieved_gbps_kernels", gbps),
            (f"round/{mode}/roofline_frac_kernels", frac),
        ]
        report.append({
            "name": "round_pipeline", "mode": mode, "P": P, "L": L, "D": D,
            "ref_hbm_bytes": ref_b["total"],
            "fused_hbm_bytes": fus_b["total"], "hbm_ratio": ratio,
            "ref_pld_passes": ref_b["pld_passes"],
            "fused_pld_passes": fus_b["pld_passes"],
            "roundtrip_ratio": trips, "unfused_chain_us": t_chain,
            "fused_kernels_us": t_fused, "round_speedup": speedup,
            "achieved_gbps_kernels": gbps, "roofline_frac_kernels": frac,
            "roof_gbps": HBM_BYTES_PER_S / 1e9})
    return rows, report


def device_name(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reduced", action="store_true",
                    help="D = 2048 in both row sets")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"# device: {device_name(dev)}", flush=True)
    micro = micro_rows(args.reduced, dev)
    for name, val in micro:
        print(f"{name},{val:.1f}", flush=True)
    rows, report = round_rows(args.reduced, dev)
    for name, val in rows:
        print(f"{name},{val:.4g}", flush=True)
    return {"device": device_name(dev), "micro": micro, "round": rows,
            "report": report}


if __name__ == "__main__":
    main()
