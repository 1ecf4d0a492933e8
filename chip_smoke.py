#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. device  — the card's name and power limit (nvidia-smi); no CUDA device
             or no port beside this script exits non-zero with no result.
2. build   — compiles every kernel of the main path from
             src/repro_torch/csrc (one nvcc per source, in parallel) and
             prints ptxas' registers and spills, and the SASS of K5's pair
             loop (cuobjdump) counted per stream.
3. kernels — holds each kernel against its plain torch version on the card
             at the main-path shape (P=10, L=50, D=2), the BENCH shape
             (P=10, L=8, D=2048), the kernel bench's micro rows (P=16, L=8,
             D=8192), a ragged one (P=10, L=13, D=509) and one past L2
             (P=10, L=8, D=2^22): every fold mode, w as [P, D] and
             [P, L, D], f32 and bf16, graph_combine with g / None / gate,
             each with A as stored and with psi off a 16-byte boundary;
             hash streams bit-exact; K1 also on rows that start off a
             16-byte boundary; every kernel run twice, bitwise equal.
             Times each (CUDA events), its bound, its plain version and,
             where one torch call computes the same thing, that call (K1
             against vector_norm^2 and K3 against its call in turns), with
             device-only times of K1, K2 (every mode) and K3 from the
             profiler, which must see one device op a call of K1 and K2,
             the kernel, and K3's host split at (10, 2).
4. kernel_bench — K5 secure_agg_mean, K6 clip_accum and K7
             laplace_transform against their plain versions, f32 and bf16,
             run twice and bitwise equal: K5 at (L, D) = (8, 8192), (5,
             1000), (64, 256), (8, 2^22); K6 at (8, 8192), (6, 509),
             either side of its resident limit (8, 811008) and (8, 811009),
             and (8, 2^22); K7 at (P, D) = (16, 8192), (10, 1000), (1,
             4096), (16, 2^22).  Planted checks: K5 at scale 2^20 must differ from
             the plain mean (masks applied) yet hold its limit; K6's limit
             must catch the plain version with the clip left out.  One
             round as the bench's fused side runs it (K1 + K2 + K3, mask
             and laplace) against the plain chain on the same inputs, at
             D = 16384 and 2^20.  Times each of K5-K7 at the micro shape
             and the wide one (K6 also at its resident limit) beside its
             bound, its plain version and the library call (K5: the
             unmasked mean), with K5's and K6's device-only times from the
             profiler, which must see one device op a call, the kernel's;
             K6's record also carries the bytes its plan must move.  Then drives `python -m repro_torch.launch.kernel_bench` (micro
             rows, round rows at D = 16384) and the round rows at D = 2^20,
             with the launch counts read.
5. main    — run_gfl on the gfl-logreg problem at full size (P=10, K=50,
             N=100, M=2, L=50, B=10, 500 rounds) for every mechanism, with
             use_kernels on (launch counts read) and off (same seeds);
             checks finite MSD, on/off agreement, hybrid below iid_dp.
6. profile — torch.profiler over 50 hybrid rounds, kernels on and off:
             wall and device-busy time per round, idle share, device ops.
7. swa     — K8 swa_decode against its plain version at the serving shapes
             (B, H, KV, C, Dh) = (4, 32, 32, 2047, 96) bf16,
             (4, 32, 32, 1064, 96) bf16, (4, 9, 3, 1064, 64) bf16 and f32,
             (2, 8, 4, 1000, 64) f32 and (32, 32, 32, 2047, 96) bf16 (805 MB
             of K/V), each with its launch plan (tile, splits, blocks) and
             nvalid = C, 2C/3 (timed), 0, 1 and either side of a split
             boundary; run twice, bitwise equal; kernel, plain and
             scaled_dot_product_attention times with the HBM bound, cycling
             through copies of K/V that exceed the 50 MB L2, as decode
             finds them cold; a CUDA graph captured at nvalid = C/3 and
             replayed at C; and a stall probe at the phi3 shapes (the
             kernel beside its loads-only build, built here).
8. serve   — phi3-mini-3.8b at full width (32 layers, d 3072, bf16, random
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
             A profiler trace whose launch count is off (K8 a layer and
             step here, one op a call of K1 and K2 above) is taken again,
             up to three traces: the profiler has been seen to lose one
             kernel record in a trace.  Every profiled window is fenced
             by marker kernels, and only the ops between them count.

Tolerances: f32 outputs within atol 1e-5 of the plain version (the
reference's parity contract, docs/kernels.md); fold_norms' f32 sums within
rtol 1e-5 (a sum over up to 2^22 squares, taken in another order); bf16
outputs, compared in f32, within atol = rtol = 3e-2 (about two bf16 ulps at
|psi| < 4, as tests/test_round_fold.py); hash streams exactly equal.  K8
in f32 within atol 1e-5; K5-K8 in bf16, whose outputs (attention averages,
masked and clipped means) can lie far below 1, within rtol 1e-2 and atol
2^-8 max|plain| (one bf16 ulp of each value, half an ulp at the top of the
range: kernel and plain version differ only in the f32 summation order
before the one cast), so a zero or misplaced result fails at every shape.
The swa phase shows that limit is tight enough: the plain version with one
tile of the kernel's, or the ragged tail tile, left out, and the split
model with one split left out (what a kernel that skipped them would
return) must fall outside it at every shape.  K5 in f32 within
atol max(1e-5, L scale 2^-22) (the masks cancel in another order than the
plain version's add-and-take-away; each f32 add rounds by at most 2^-24 of
its magnitude, which is below L scale); K6 in f32 within atol = rtol =
1e-5 and K7 within atol 1e-6, the reference's own limits
(tests/test_kernels.py).
Bounds: bytes over 3.35 TB/s, fp32 operations over 67 TFLOP/s, and the
hash's integer and conversion instructions over the INT32 rate derived in
src/repro_torch/launch/roofline.py, the largest of the three.

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
# the card's roofs (HBM, fp32, INT32 rates, L2 size) live in
# src/repro_torch/launch/roofline.py and are imported where used
ATOL_F32 = 1e-5
RTOL_NORMS = 1e-5
TOL_BF16 = 3e-2
RTOL_BF16_SCALED = 1e-2
MAIN_SHAPE = (10, 50, 2)
# the main path's, the reference's BENCH shape, the kernel bench's micro
# rows (K3 at P = 16), a ragged one, one past the 50 MB L2
SHAPES = [MAIN_SHAPE, (10, 8, 2048), (16, 8, 8192), (10, 13, 509),
          (10, 8, 1 << 22)]
ITERS = 500
# kernels on vs off after 500 rounds: the two client levels draw different
# masks (hash vs Gaussian) that cancel only to f32 rounding, each round
PARAMS_ATOL = 1e-4
MSD_RTOL, MSD_ATOL = 1e-3, 1e-6
SWA_SERVE_SHAPE = (4, 32, 32, 2047, 96)
SWA_PROBE_SHAPES = [(SWA_SERVE_SHAPE, "bfloat16"),
                    ((32, 32, 32, 2047, 96), "bfloat16")]
SWA_SHAPES = [(SWA_SERVE_SHAPE, "bfloat16"), ((4, 32, 32, 1064, 96), "bfloat16"),
              ((4, 9, 3, 1064, 64), "bfloat16"), ((4, 9, 3, 1064, 64), "float32"),
              ((2, 8, 4, 1000, 64), "float32"),
              ((32, 32, 32, 2047, 96), "bfloat16")]
SERVE_ARCH = "phi3-mini-3.8b"
SERVE_REQUESTS = (("A", 4, 4096), ("B", 4, 1000))   # name, batch, prompt
SERVE_NEW_TOKENS = 32
SERVE_PROFILE_STEPS = 3
TRACE_TRIES = 3       # traces of a launch count before it fails


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
    sass = k5_stream_sass(paths["secure_agg_mean"])
    emit({"phase": "build", "k5_sass": sass})
    # the bound counts HASH_INT_OPS a stream: the kernel must need as many
    require("error" not in sass, f"K5 SASS: {sass.get('error')}")
    require(sass["int_per_stream"] >= HASH_INT_OPS,
            f"K5 SASS: {sass['int_per_stream']} integer and conversion "
            f"instructions a stream, below the bound's {HASH_INT_OPS}")


# K5's instantiation at eight f32 features a thread in 16-byte vectors:
# its pair loop is the hot loop at every wide f32 shape
K5_SASS_FUNCTION = "secure_agg_mean_kernelIfLi8ELb1E"
K5_SASS_FPT = 8
# the opcodes (before their first '.') that issue on the INT32 lanes or
# convert: the ones HASH_INT_OPS counts
K5_SASS_INT = {"LOP3", "LOP", "SHF", "SHL", "SHR", "IMAD", "IMUL", "IADD3",
               "LEA", "PRMT", "I2F", "I2FP"}


def k5_stream_sass(lib):
    """The SASS of one K5 stream: ``cuobjdump -sass`` of the library,
    K5's f32 16-byte instantiation, its loop that reads pair keys from
    shared memory (the pair loop: the loop with the most key loads, a
    backward branch to its head).  Returns the loop's instruction counts
    by opcode and per stream (each key serves ``K5_SASS_FPT`` features),
    among them the integer and conversion instructions a stream
    (``K5_SASS_INT``), or why none was read."""
    import collections
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=120).stdout
    except OSError as exc:
        return {"error": f"cuobjdump: {exc}"}
    body, inside = [], False
    for line in text.splitlines():
        if "Function :" in line:
            inside = K5_SASS_FUNCTION in line
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if inside and m:
            body.append((int(m.group(1), 16), m.group(2).strip()))
    if not body:
        return {"error": f"no SASS for {K5_SASS_FUNCTION}"}

    def opcode(ins):
        ins = re.sub(r"^@!?U?P\w+\s+", "", ins)
        return ins.split()[0]

    def keys(ins):
        op = opcode(ins)
        if not op.startswith("LDS"):
            return 0
        width = re.search(r"\.(64|128)", op)
        return int(width.group(1)) // 32 if width else 1

    best = None
    for addr, ins in body:
        m = re.search(r"BRA\s+(?:`\()?[^0-9]*0x([0-9a-f]+)", ins)
        if not m or int(m.group(1), 16) >= addr:
            continue
        loop = [i for a, i in body if int(m.group(1), 16) <= a <= addr]
        n_keys = sum(keys(i) for i in loop)
        if n_keys and (best is None or n_keys > best[0]):
            best = (n_keys, loop)
    if best is None:
        return {"error": "no loop reads keys from shared memory"}
    n_keys, loop = best
    counts = collections.Counter(opcode(i) for i in loop)
    streams = n_keys * K5_SASS_FPT
    n_int = sum(n for op, n in counts.items()
                if op.split(".")[0] in K5_SASS_INT)
    return {"function": K5_SASS_FUNCTION, "loop_instructions": len(loop),
            "keys": n_keys, "streams": streams,
            "per_stream": len(loop) / streams,
            "int_per_stream": n_int / streams,
            "by_opcode": dict(sorted(counts.items()))}


# -------------------------------------------------------------- kernels


# Instructions of one counter-hash stream value (csrc/hash.cuh), counted
# from the least sequence.  The Murmur3 finalizer's first shift-xor
# distributes over idx ^ key (hash.cuh premix), so with the keys and the
# feature indices premixed once a stream is left the xor, two multiplies,
# two shift-xor pairs, the >> 8 and the int-to-float conversion: 9 integer
# and conversion instructions (K5's SASS: 3 LOP3, 3 SHF, 2 IMAD and one
# I2FP a stream; the build phase requires at least this many), on the
# INT32 lanes; and one fma for (2u - 1) scale (hash.cuh stream_value) on
# the fp32 lanes.  K2's mask mode runs the sequence without the premix,
# 11, against the same bound.
HASH_INT_OPS = 9
HASH_FLOPS = 2


def bound(rec) -> dict:
    """Adds the least time of a timed record (its "bytes", "flops" and
    "int_ops") and what bounds it."""
    from repro_torch.launch.roofline import kernel_bound_ms
    rec["bound_ms"], rec["bound_by"] = kernel_bound_ms(
        rec["bytes"], rec.get("flops", 0), rec.get("int_ops", 0))
    return rec


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def bf16_tol(torch, want):
    """(atol, rtol) of a K5-K8 output against its plain version: f32's
    atol 1e-5, or in bf16 one ulp of each value (rtol 1e-2) and half an
    ulp at the top of the data's range (atol 2^-8 max|plain|)."""
    if want.dtype != torch.bfloat16:
        return ATOL_F32, 0.0
    return float(want.float().abs().max()) * 2.0 ** -8, RTOL_BF16_SCALED


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

    # K1 on rows off a 16-byte boundary: g[1:] of [rows + 1, D], D odd
    for dtype in (torch.float32, torch.bfloat16):
        base = torch.randn((81, 40001), generator=gen, device="cuda")
        g = base.to(dtype)[1:].view(10, 8, 40001)
        got = twice_equal(torch, "fold_norms", lambda: rf.fold_norms(g))
        e = check_close(torch, f"fold_norms unaligned {dtype}", got,
                        rf.fold_norms_plain(g), torch.float32, norms=True)
        emit({"phase": "kernels", "kernel": "fold_norms", "layout": "g[1:]",
              "shape": [10, 8, 40001], "dtype": str(dtype), "max_abs_err": e})
        del base, g

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
            A = A / A.sum(dim=0, keepdim=True)
            # psi one element off a 16-byte boundary: the element-wise path
            psi_off = torch.empty(P * D + 1, device="cuda",
                                  dtype=dtype)[1:].view(P, D)
            psi_off.copy_(psi)
            for variant, args in (("g", (gn, None, None)),
                                  ("none", (None, None, None)),
                                  ("gate", (gn, cache, gate))):
                g_, c_, gt_ = args
                want = gc.graph_combine_plain(A, psi, g_, cache=c_,
                                              gate=gt_)
                for layout, psi_ in (("A", psi), ("psi+1", psi_off)):
                    got = twice_equal(torch, "graph_combine",
                                      lambda: gc.graph_combine(
                                          A, psi_, g_, cache=c_, gate=gt_))
                    e = check_close(torch, f"graph_combine {variant} {layout} "
                                    f"{P,D} {dname}", got, want, dtype)
                    if dtype == torch.float32 and (P, L, D) == MAIN_SHAPE:
                        errs["graph_combine"] = max(errs["graph_combine"], e)
                    emit({"phase": "kernels", "kernel": "graph_combine",
                          "variant": variant, "layout": layout,
                          "shape": [P, D], "dtype": dname, "max_abs_err": e})
            del psi_off
            if dtype == torch.float32 and (P, L, D) == MAIN_SHAPE:
                _, g, _, _, _, _, _ = fold_inputs(torch, P, L, D, dtype,
                                                  False, gen)
                errs["fold_norms"] = max_err(torch, rf.fold_norms(g),
                                             rf.fold_norms_plain(g))
        timings[(P, L, D)] = time_shape(torch, P, L, D, gen)
        emit({"phase": "kernels", "timing": timings[(P, L, D)],
              "shape": [P, L, D], "dtype": "float32"})
    k3_host_split(torch, gen)
    return errs, timings


def time_shape(torch, P, L, D, gen):
    """f32 kernel, plain and library times at one shape, with the bounds."""
    from repro_torch.kernels import round_fold as rf
    from repro_torch.kernels import graph_combine as gc
    from repro_torch.launch.kernel_bench import time_ms

    f32 = torch.float32
    w, g, noise, ss, fw, _, seeds = fold_inputs(torch, P, L, D, f32, False,
                                                gen)
    nw = torch.full((P, L), 1.0 / L, device="cuda")     # all alive
    out = {}
    # K1: reads g once, writes [P, L]; against the library call in turns
    # (both host-bound at the main path's shape)
    bytes_k1 = P * L * D * 4 + P * L * 4
    ms, lib_ms = paired_ms(torch, lambda: rf.fold_norms(g),
                           lambda: torch.linalg.vector_norm(g, dim=-1) ** 2)
    out["fold_norms"] = {
        "ms": ms, **one_op(torch, lambda: rf.fold_norms(g), "norms",
                           f"fold_norms {P, L, D}"),
        "plain_ms": time_ms(lambda: rf.fold_norms_plain(g)),
        "library_ms": lib_ms, "bytes": bytes_k1, "flops": 2 * P * L * D}
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
        # client; mask hashes each alive pair once per feature (one stream)
        # and folds it with an fma
        flops = P * D * (3 * L + (2 * L if mode == "laplace" else 0)
                         + ((HASH_FLOPS + 2) * npairs if mode == "mask"
                            else 0))
        int_ops = P * D * npairs * HASH_INT_OPS if mode == "mask" else 0
        call = (lambda: rf.fold_apply(w, g, ss, fw, nw, **kw))
        out[f"fold_apply[{mode}]"] = {
            "ms": time_ms(call),
            **one_op(torch, call, "fold_apply",
                     f"fold_apply {mode} {P, L, D}"),
            "plain_ms": time_ms(lambda: rf.fold_apply_plain(
                w, g, ss, fw, nw, **kw), budget_s=0.5, max_reps=50),
            "library_ms": None, "bytes": nbytes, "flops": flops,
            "int_ops": int_ops}
    del noise, g, w
    # K3: reads A (as stored, as the round passes it), psi, g; writes out.
    # The library call reads A^T as a view: cuBLAS copies nothing either
    psi = torch.randn((P, D), generator=gen, device="cuda")
    gn = 0.2 * torch.randn((P, D), generator=gen, device="cuda")
    A = torch.rand((P, P), generator=gen, device="cuda")
    A = A / A.sum(dim=0, keepdim=True)
    x, neg_g = psi + gn, -gn
    for variant, g_ in (("g", gn), ("none", None)):
        nbytes = P * P * 4 + (3 if g_ is not None else 2) * P * D * 4
        lib = ((lambda: torch.addmm(neg_g, A.T, x)) if g_ is not None
               else (lambda: torch.mm(A.T, psi)))
        ms, lib_ms = paired_ms(
            torch, lambda: gc.graph_combine(A, psi, g_), lib)
        out[f"graph_combine[{variant}]"] = {
            "ms": ms,
            # the kernel alone on the device, from the profiler: what of
            # "ms" is not host time
            "device_ms": profile_calls(
                torch, lambda: gc.graph_combine(A, psi, g_), 50,
                "combine")["device_ms"],
            "plain_ms": time_ms(lambda: gc.graph_combine_plain(
                A, psi, g_)),
            "library_ms": lib_ms, "bytes": nbytes,
            "flops": 2 * P * P * D + (2 * P * D if g_ is not None else 0)}
    for rec in out.values():
        bound(rec)
    return out


def paired_ms(torch, fn, lib, rounds=11):
    """Medians of ``rounds`` back-to-back timings of ``fn`` and ``lib``
    taken in turns (fn, lib, lib, fn, ...): at tiny shapes both are
    host-bound and move with the host's load, so they are compared in
    alternation rather than one after the other."""
    import statistics
    from repro_torch.launch.kernel_bench import time_ms

    mine, theirs = [], []
    for r in range(rounds):
        pair = [(mine, fn), (theirs, lib)]
        for acc, f in (pair if r % 2 == 0 else pair[::-1]):
            acc.append(time_ms(f, budget_s=0.05))
    return statistics.median(mine), statistics.median(theirs)


def one_op(torch, fn, kernel, name, calls=50, tries=TRACE_TRIES):
    """The device-only time a call of ``fn`` from the profiler, requiring
    that each call enqueue exactly one device op, the kernel's.  A trace
    that disagrees is taken again, up to ``tries`` traces (the profiler
    has been seen to lose one kernel record in a trace)."""
    for attempt in range(tries):
        rec = profile_calls(torch, fn, calls, kernel)
        n = round(rec["device_ops_per_call"] * calls)
        if n == calls and len(rec["device_ops"]) == 1 and \
                kernel in rec["device_ops"][0]:
            return {"device_ms": rec["device_ms"],
                    "device_ops_per_call": rec["device_ops_per_call"]}
        emit({"phase": "kernels", "retrace": attempt + 1, "of": name,
              "device_ops": n, "calls": calls, "names": rec["device_ops"]})
    require(False, f"{name}: {n} device ops in {calls} calls "
            f"({rec['device_ops']}) in each of {tries} traces, expected "
            "the kernel alone, once a call")


def profile_calls(torch, fn, calls, kernel):
    """torch.profiler over ``calls`` back-to-back calls of ``fn`` (after a
    warm-up): the host's wall time per call (the enqueue, no synchronise
    inside), the device time per call of the kernels whose name holds
    ``kernel`` and of every device op, and host self time by op.

    The calls are fenced on the device by marker kernels
    (``torch.cuda._sleep``'s ``spin_kernel``), two before and three after,
    and only the device ops between the first and the last marker are
    read: the profiler has been seen to drop one kernel record at the edge
    of a window, and a dropped marker costs nothing."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            torch.cuda._sleep(1)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host = time.perf_counter() - t0
        for _ in range(3):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    marks = [e.time_range.start for e in device if "spin_kernel" in e.name]
    lo, hi = (min(marks), max(marks)) if len(marks) >= 2 else (0, -1)
    dev = dev_all = 0.0
    names = set()
    n_ops = 0
    for evt in device:
        if "spin_kernel" in evt.name or not lo < evt.time_range.start < hi:
            continue
        us = evt.time_range.elapsed_us()
        dev_all += us
        n_ops += 1
        names.add(evt.name[:60])
        if kernel in evt.name:
            dev += us
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {"calls": calls, "host_ms_per_call": host * 1e3 / calls,
            "device_ms": dev / 1e3 / calls,
            "device_ms_all_ops": dev_all / 1e3 / calls,
            "device_ops_per_call": n_ops / calls,
            "device_ops": sorted(names),
            "host_self_us_by_op": [
                {"name": e.key[:60], "us_per_call": e.self_cpu_time_total /
                 calls, "per_call": e.count / calls} for e in ops[:8]]}


def k3_host_split(torch, gen, calls=200):
    """K3 at the main path's (P, D) = (10, 2), as the round calls it
    (``ops.graph_combine``) and through its wrapper: the profile of
    ``profile_calls`` for each, and the plain ``time.perf_counter``
    enqueue cost without the profiler."""
    from repro_torch.kernels import graph_combine as gc
    from repro_torch.kernels import ops

    P, _, D = MAIN_SHAPE
    A = torch.rand((P, P), generator=gen, device="cuda")
    A = A / A.sum(dim=0, keepdim=True)
    psi = torch.randn((P, D), generator=gen, device="cuda")
    gn = 0.2 * torch.randn((P, D), generator=gen, device="cuda")
    out = {}
    for label, fn in (
            ("ops.graph_combine[g]", lambda: ops.graph_combine(A, psi, gn)),
            ("graph_combine[g]", lambda: gc.graph_combine(A, psi, gn)),
            ("graph_combine[none]", lambda: gc.graph_combine(A, psi))):
        rec = profile_calls(torch, fn, calls, "combine")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        rec["host_ms_per_call_unprofiled"] = (time.perf_counter() - t0) * \
            1e3 / calls
        torch.cuda.synchronize()
        out[label] = rec
        emit({"phase": "kernels", "k3_host_split": label, "shape": [P, D],
              **rec})
    return out


# --------------------------------------------------------- kernel bench


# (L, D) for K5 and K6, (P, D) for K7: the micro rows' shape first, ragged
# shapes, then one past the 50 MB L2 (K5, K6: 134 MB; K7: 268 MB in, out).
# K6 also either side of its plan's resident limit on 132 SMs: 264 blocks
# keep 3 tiles of 1024 f32 of each of 8 rows (26 MB of g), and one element
# more is read twice
K5_SHAPES = [(8, 8192), (5, 1000), (64, 256), (8, 1 << 22)]
K6_RESIDENT_D = 264 * 3 * 1024
K6_SHAPES = [(8, 8192), (6, 509), (8, K6_RESIDENT_D), (8, K6_RESIDENT_D + 1),
             (8, 1 << 22)]
K6_TIMED = (0, 2, 3, -1)          # the shapes timed beside K5's and K7's
K7_SHAPES = [(16, 8192), (10, 1000), (1, 4096), (16, 1 << 22)]
K5_SCALES = (1.0, 0.7)            # the micro row's scale, the tests'
K5_PLANT_SCALE = 2.0 ** 20
K6_BOUNDS = (1.0, 0.5, 100.0)     # the micro row's bound, then the tests'
K7_SIGMAS = (0.5, 1.0)            # the micro row's sigma, then the tests'
ATOL_LAPLACE = 1e-6               # tests/test_kernels.py's laplace limit
TOL_CLIP = 1e-5                   # tests/test_kernels.py's clip_accum limit
ROUND_DS = (16384, 1 << 20)       # round rows: the reference's D, 335 MB
NO_LIBRARY = {
    "clip_accum": "no single torch call clips each row to a norm and "
                  "averages",
    "laplace_transform": "no single torch call computes the Laplace "
                         "inverse CDF"}


def k5_atol(L, scale):
    """K5's f32 limit against its plain version.  Kernel and plain version
    add and take away each pair's stream in the same order, but their
    client sums before the masks may differ in summation order, and each
    add and subtraction of a stream (magnitude < scale) then rounds by at
    most 2^-24 of the running sum's magnitude (< L * scale); the two
    differ by less than L * scale * 2^-22 after the division by L.  The
    Pallas kernel, which adds each client's net mask instead, stays within
    the same limit (tests/test_torch_single_server_plans.py).  Never below
    1e-5, the reference's parity limit."""
    return max(ATOL_F32, L * scale * 2.0 ** -22)


def k5_plant(torch, sa, ref, upd, seed):
    """K5's planted check at scale 2^20.  Exact arithmetic cancels the
    masks, so a kernel that skipped them would return the plain mean and
    pass every tolerance.  At 2^20 the cancelled masks leave f32 rounding
    of about 2^-4 an add: require the kernel to differ from the mean by far
    more than summation order alone can (L max|upd| 2^-24), and to stay
    within the plain version's limit at that scale."""
    L = upd.shape[0]
    got = sa.secure_agg_mean(upd, seed, K5_PLANT_SCALE)
    mean_diff = max_err(torch, got, upd.mean(dim=0))
    order_noise = L * float(upd.abs().max()) * 2.0 ** -24
    require(mean_diff > 10 * order_noise,
            f"secure_agg_mean {tuple(upd.shape)}: at scale 2^20 the output "
            f"is the plain mean (max diff {mean_diff}): masks not applied")
    want = ref.secure_agg_mean_plain(upd, seed, K5_PLANT_SCALE)
    err = check_close(torch, f"secure_agg_mean planted {tuple(upd.shape)}",
                      got, want, torch.float32,
                      tol=(k5_atol(L, K5_PLANT_SCALE), 0.0))
    return {"scale": K5_PLANT_SCALE, "max_diff_from_mean": mean_diff,
            "summation_order_noise": order_noise, "max_abs_err": err,
            "atol": k5_atol(L, K5_PLANT_SCALE)}


def single_server_checks(torch, gen):
    """K5, K6 and K7 against their plain versions at every shape, f32 and
    bf16, each kernel run twice and bitwise equal, with the planted checks.
    Returns the largest f32 error of each at the micro rows' shape."""
    from repro_torch.kernels import clip_accum as ca
    from repro_torch.kernels import laplace as lp
    from repro_torch.kernels import ref
    from repro_torch.kernels import secure_agg as sa

    errs = {}
    seed = torch.tensor([0x9E3779B9 - 2 ** 32], dtype=torch.int32,
                        device="cuda")             # a seed past 2^31
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        bf16 = dtype == torch.bfloat16
        for (L, D) in K5_SHAPES:
            upd = torch.randn((L, D), generator=gen, device="cuda").to(dtype)
            for scale in K5_SCALES:
                got = twice_equal(torch, "secure_agg_mean",
                                  lambda: sa.secure_agg_mean(upd, seed,
                                                             scale))
                want = ref.secure_agg_mean_plain(upd, seed, scale)
                tol = bf16_tol(torch, want) if bf16 else \
                    (k5_atol(L, scale), 0.0)
                e = check_close(torch, f"secure_agg_mean {L, D} {dname} "
                                f"scale={scale}", got, want, dtype, tol=tol)
                if not bf16 and (L, D) == K5_SHAPES[0]:
                    errs["secure_agg_mean"] = max(
                        errs.get("secure_agg_mean", 0.0), e)
                emit({"phase": "kernel_bench", "kernel": "secure_agg_mean",
                      "shape": [L, D], "dtype": dname, "scale": scale,
                      "max_abs_err": e, "atol": tol[0], "rtol": tol[1]})
            if not bf16:
                emit({"phase": "kernel_bench", "kernel": "secure_agg_mean",
                      "shape": [L, D], "planted": k5_plant(torch, sa, ref,
                                                           upd, seed)})
            del upd
        for (L, D) in K6_SHAPES:
            g = (3 * torch.randn((L, D), generator=gen,
                                 device="cuda")).to(dtype)
            for b in K6_BOUNDS:
                got = twice_equal(torch, "clip_accum",
                                  lambda: ca.clip_accum(g, b))
                want = ref.clip_accum_plain(g, b)
                tol = bf16_tol(torch, want) if bf16 else (TOL_CLIP, TOL_CLIP)
                e = check_close(torch, f"clip_accum {L, D} {dname} "
                                f"bound={b}", got, want, dtype, tol=tol)
                if not bf16 and (L, D) == K6_SHAPES[0]:
                    errs["clip_accum"] = max(errs.get("clip_accum", 0.0), e)
                rec = {"phase": "kernel_bench", "kernel": "clip_accum",
                       "shape": [L, D], "dtype": dname, "bound": b,
                       "max_abs_err": e, "atol": tol[0], "rtol": tol[1]}
                if b == 0.5:
                    # planted: the plain version with the clip left out
                    unclipped = g.float().mean(dim=0)
                    caught = not torch.allclose(
                        unclipped, want.float(), atol=tol[0], rtol=tol[1])
                    require(caught, f"clip_accum {L, D} {dname}: the limit "
                            "misses a kernel that leaves out the clip")
                    rec["planted_unclipped_max_abs_err"] = max_err(
                        torch, unclipped, want)
                emit(rec)
            del g
        for (P, D) in K7_SHAPES:
            u = (torch.rand((P, D), generator=gen, device="cuda") * 0.998
                 - 0.499).to(dtype)
            for sigma in K7_SIGMAS:
                got = twice_equal(torch, "laplace_transform",
                                  lambda: lp.laplace_transform(u, sigma))
                want = ref.laplace_transform_plain(u, sigma)
                tol = bf16_tol(torch, want) if bf16 else (ATOL_LAPLACE, 0.0)
                e = check_close(torch, f"laplace_transform {P, D} {dname} "
                                f"sigma={sigma}", got, want, dtype, tol=tol)
                if not bf16 and (P, D) == K7_SHAPES[0]:
                    errs["laplace_transform"] = max(
                        errs.get("laplace_transform", 0.0), e)
                emit({"phase": "kernel_bench", "kernel": "laplace_transform",
                      "shape": [P, D], "dtype": dname, "sigma": sigma,
                      "max_abs_err": e, "atol": tol[0], "rtol": tol[1]})
            del u
        torch.cuda.empty_cache()
    return errs


def single_server_timings(torch, gen):
    """f32 kernel, plain and library times of K5-K7 at the micro rows'
    shape and the wide one (K6 also at its resident boundary), with their
    bounds and, for K5 and K6, the kernel's device-only time from the
    profiler, which must see one device op a call."""
    from repro_torch.kernels import clip_accum as ca
    from repro_torch.kernels import laplace as lp
    from repro_torch.kernels import ref
    from repro_torch.kernels import secure_agg as sa
    from repro_torch.launch.kernel_bench import time_ms
    from repro_torch.launch.roofline import HBM_BYTES_PER_S

    out = {}
    seed = torch.tensor([7], dtype=torch.int32, device="cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for which in (0, -1):
        L, D = K5_SHAPES[which]
        upd = torch.randn((L, D), generator=gen, device="cuda")
        # each pair's stream once per feature, as the kernel and the plain
        # version's acc + s - s hash it
        streams = L * (L - 1) // 2 * D
        call = (lambda: sa.secure_agg_mean(upd, seed))
        out[("secure_agg_mean", which)] = bound({
            "shape": [L, D], "ms": time_ms(call),
            **one_op(torch, call, "secure_agg_mean",
                     f"secure_agg_mean {L, D}"),
            "plan": sa.plan(L, D, 4, n_sm),
            "plain_ms": time_ms(lambda: ref.secure_agg_mean_plain(
                upd, seed, 1.0), budget_s=0.5, max_reps=50),
            # the unmasked floor: the client mean without masks
            "library_ms": time_ms(lambda: upd.mean(dim=0)),
            "library": "torch.mean(dim=0), the unmasked floor",
            "bytes": L * D * 4 + D * 4 + 4,
            "flops": streams * (HASH_FLOPS + 2) + L * D + D,
            "int_ops": streams * HASH_INT_OPS})
        del upd
        P, D = K7_SHAPES[which]
        u = torch.rand((P, D), generator=gen, device="cuda") * 0.998 - 0.499
        out[("laplace_transform", which)] = bound({
            "shape": [P, D],
            "ms": time_ms(lambda: lp.laplace_transform(u, 0.5)),
            "plain_ms": time_ms(lambda: ref.laplace_transform_plain(
                u, 0.5)),
            "library_ms": None, "library": NO_LIBRARY["laplace_transform"],
            # abs, -2x, log1p (counted as one), sign * -b, the product
            "bytes": 2 * P * D * 4, "flops": 5 * P * D})
        del u
    for which in K6_TIMED:
        L, D = K6_SHAPES[which]
        g = 3 * torch.randn((L, D), generator=gen, device="cuda")
        p = ca.plan(L, D, 4, n_sm)
        design = ca.hbm_bytes(p, L, D, 4)
        call = (lambda: ca.clip_accum(g, 1.0))
        out[("clip_accum", which)] = bound({
            "shape": [L, D], "ms": time_ms(call),
            **one_op(torch, call, "clip_accum", f"clip_accum {L, D}"),
            "plain_ms": time_ms(lambda: ref.clip_accum_plain(g, 1.0)),
            "library_ms": None, "library": NO_LIBRARY["clip_accum"],
            # g read once, out written once; an fma per element in each
            # pass.  Beside it, the bytes the design must move: the tiles
            # not resident in shared memory are read twice
            "bytes": L * D * 4 + D * 4, "flops": 4 * L * D + D,
            "plan": p, "design_bytes": design,
            "design_bound_ms": design / HBM_BYTES_PER_S * 1e3})
        del g
    for (name, _), rec in out.items():
        rec["roof_share"] = rec["bound_ms"] / rec["ms"]
        emit({"phase": "kernel_bench", "kernel": name, "timing": rec,
              "dtype": "float32"})
    return out


def round_check(torch, D, gen):
    """One round as the round rows' fused side runs it (``ops.round_fold``
    + ``ops.graph_combine``: K1, K2, K3) held against the plain chain
    (``round_fold_ref`` + ``graph_combine_ref``) on the same inputs, seeds
    and noise, in both noise modes, at [P, L] of the round rows and width
    D: psi and the combined output within atol 1e-5, the squared norms
    within rtol 1e-5."""
    from repro_torch.core.privacy.noise import sample_laplace
    from repro_torch.core.topology import combination_matrix
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.kernel_bench import ROUND_SHAPE

    P, L, _ = ROUND_SHAPE
    sigma, mu, clip = 0.3, 0.1, 10.0             # the round rows' values
    A = torch.as_tensor(combination_matrix("ring", P), dtype=torch.float32,
                        device="cuda")
    w = torch.randn((P, D), generator=gen, device="cuda")
    grads = torch.randn((P, L, D), generator=gen, device="cuda")
    gn = 0.3 * torch.randn((P, D), generator=gen, device="cuda")
    ones = torch.ones((P, L), device="cuda")
    for mode in ("mask", "laplace"):
        seeds = noise = None
        if mode == "mask":
            seeds = torch.randint(0, 2 ** 31 - 1, (P,), generator=gen,
                                  device="cuda")
        else:
            noise = sample_laplace((P, L, D), sigma, generator=gen)
        kw = dict(mu=mu, bound=clip, mode=mode, sigma=sigma, seeds=seeds,
                  noise=noise)
        psi, sq = ops.round_fold(w, grads, **kw)
        out = ops.graph_combine(A, psi, gn)
        psi_p, sq_p = ref.round_fold_ref(w, grads, pre_w=ones, fold_w=ones,
                                         noise_w=ones / L, **kw)
        out_p = ref.graph_combine_ref(A.T, psi_p, gn)
        name = f"round {mode} {P, L, D}"
        emit({"phase": "kernel_bench", "round_check": mode,
              "shape": [P, L, D],
              "sq_max_abs_err": check_close(torch, f"{name} sq", sq, sq_p,
                                            torch.float32, norms=True),
              "psi_max_abs_err": check_close(torch, f"{name} psi", psi,
                                             psi_p, torch.float32),
              "out_max_abs_err": check_close(torch, f"{name} combine", out,
                                             out_p, torch.float32)})
        del noise
    del grads
    torch.cuda.empty_cache()


def phase_kernel_bench(torch):
    """K5-K7 checked and timed, one fused round held against the plain
    chain at each round-row width, then the kernel-bench entry point driven
    with the launch counts read: its micro rows and round rows (D = 16384),
    and the round rows again at D = 2^20."""
    from repro_torch import kernels as K
    from repro_torch.launch import kernel_bench as kb

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1313)
    errs = single_server_checks(torch, gen)
    for D in ROUND_DS:
        round_check(torch, D, gen)
    timings = single_server_timings(torch, gen)

    K.reset_launches()
    res = kb.main([])
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    for name in ("secure_agg_mean", "clip_accum", "laplace_transform",
                 "graph_combine", "fold_norms", "fold_apply"):
        require(launches[name] > 0,
                f"kernel_bench: kernel {name} was never launched")
    rows = dict(res["micro"] + res["round"])
    require(all(v == v and abs(v) != float("inf") for v in rows.values()),
            "kernel_bench: a non-finite row")
    emit({"phase": "kernel_bench", "entry": "python -m "
          "repro_torch.launch.kernel_bench", "device": res["device"],
          "rows": rows, "round_report": res["report"], "launches": launches})
    for D in ROUND_DS[1:]:
        K.reset_launches()
        round_rows, report = kb.round_rows(device="cuda", D=D)
        torch.cuda.synchronize()
        wide = dict(K.LAUNCHES)
        for name in ("graph_combine", "fold_norms", "fold_apply"):
            require(wide[name] > 0, f"round rows D={D}: kernel {name} was "
                    "never launched")
        require(all(v == v and abs(v) != float("inf")
                    for _, v in round_rows),
                f"round rows D={D}: a non-finite row")
        emit({"phase": "kernel_bench", "round_rows_D": D,
              "rows": dict(round_rows), "round_report": report,
              "launches": wide})
    return errs, timings, launches


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
    from repro_torch.launch.roofline import kernel_bound_ms
    nbytes = 2 * B * n_live * KV * Dh * esize + 2 * B * H * Dh * esize + 4
    ms, by = kernel_bound_ms(nbytes, 4 * B * H * n_live * Dh)
    return ms, by, nbytes


def planted_faults(torch, swa, ref, q, k, v, nv, want, tol, plan):
    """Max abs error of what a kernel that left slots out would return: the
    plain version over the live slots less a middle tile (the kernel's
    tile), the ragged tail tile or one slot, and the split model with its
    middle live split left out.  Each but the slot must fall outside
    ``tol``."""
    n = min(nv, k.shape[1]) if nv >= 1 else k.shape[1]
    tile, chunk, splits = plan["tile"], plan["chunk"], plan["splits"]
    mid = (n // tile) // 2 * tile
    tail = n - (n % tile or tile)
    faults = {}
    for label, lo, hi in (("tile", mid, mid + tile), ("tail", tail, n),
                          ("slot", n // 2, n // 2 + 1)):
        keep = torch.cat([torch.arange(lo, device=k.device),
                          torch.arange(hi, n, device=k.device)])
        faults[label] = (hi - lo, swa.swa_decode_attention_plain(
            q, k[:, keep], v[:, keep],
            torch.tensor([keep.numel()], dtype=torch.int32, device=k.device)))
    drop = (-(-n // chunk)) // 2
    nvalid = torch.tensor([nv], dtype=torch.int32, device=k.device)
    faults["split"] = (min(chunk, n - drop * chunk),
                       ref.swa_decode_splits_plain(q, k, v, nvalid, splits,
                                                   tile=tile, leave_out=drop))
    out = {}
    for label, (slots, fault) in faults.items():
        caught = not torch.allclose(fault.float(), want.float(), atol=tol[0],
                                    rtol=tol[1])
        require(caught or label == "slot", f"swa_decode tolerance {tol} "
                f"misses a kernel that leaves out the {label} ({slots} "
                "slots)")
        out[label] = {"slots": slots, "max_abs_err": max_err(torch, fault,
                                                             want),
                      "caught": caught}
    return out


def swa_nvalids(C, plan):
    """nvalid values checked at a shape: all, two thirds (both timed), then
    none, one slot, and one short of and exactly at the first split
    boundary (the last split's start when there is one split only)."""
    edge = plan["chunk"] if plan["splits"] > 1 else C - 1
    return [C, (2 * C) // 3, 0, 1, edge - 1, edge]


def graph_replay(torch, swa, q, k, v, C):
    """K8 captured in a CUDA graph at nvalid = C/3, nvalid then set in place
    to C and the graph replayed: the output must match the plain version
    at C (the split plan reads the shape only)."""
    nvalid = torch.tensor([C // 3], dtype=torch.int32, device="cuda")
    swa.swa_decode(q, k, v, nvalid)              # warm: scratch allocated
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = swa.swa_decode(q, k, v, nvalid)
    graph.replay()
    torch.cuda.synchronize()
    first = out.clone()
    want_third = swa.swa_decode_attention_plain(q, k, v, nvalid)
    nvalid.fill_(C)
    graph.replay()
    torch.cuda.synchronize()
    want = swa.swa_decode_attention_plain(q, k, v, nvalid)
    tol = bf16_tol(torch, want)
    return {"nvalid_captured": C // 3, "nvalid_replayed": C,
            "max_abs_err_captured": check_close(
                torch, "swa_decode graph at C/3", first, want_third,
                q.dtype, tol=bf16_tol(torch, want_third)),
            "max_abs_err_replayed": check_close(
                torch, "swa_decode graph replayed at C", out, want, q.dtype,
                tol=tol)}


def stall_probe(torch, swa, q, kvs, C):
    """K8 against its loads-only build (the same copies, no scores, softmax
    or V sum) at nvalid = C, timed in turns: how much of the kernel's time
    the copies alone take, and so what is left to the math.  Both go
    through ``swa.launch``, which counts no launch; the probe's build
    (``csrc/swa_decode.cu`` with ``SWA_PROBE_LOADS_ONLY``) is compiled on
    its first call here."""
    from repro_torch.kernels import _build

    nvalid = torch.tensor([C], dtype=torch.int32, device="cuda")
    kernel = _build.function("swa_decode")
    probe = _build.function("swa_decode", ("SWA_PROBE_LOADS_ONLY",))

    def run(fn):
        return cycling([lambda k_=k_, v_=v_: swa.launch(fn, q, k_, v_, nvalid)
                        for k_, v_ in kvs])
    ms, loads_ms = paired_ms(torch, run(kernel), run(probe))
    return {"kernel_ms": ms, "loads_only_ms": loads_ms,
            "loads_share": loads_ms / ms}


def phase_swa(torch):
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_decode as swa
    from repro_torch.launch.kernel_bench import time_ms
    from repro_torch.launch.roofline import L2_BYTES

    gen = torch.Generator(device="cuda")
    gen.manual_seed(812)
    rows = {}
    for (B, H, KV, C, Dh), dname in SWA_SHAPES:
        dtype = getattr(torch, dname)
        esize = torch.tensor([], dtype=dtype).element_size()
        plan = swa.plan(B, KV, C, Dh, esize, torch.cuda.get_device_properties(
            0).multi_processor_count)
        emit({"phase": "swa", "shape": [B, H, KV, C, Dh], "dtype": dname,
              "plan": plan})
        kv_bytes = 2 * B * C * KV * Dh * esize
        copies = max(1, min(64, -(-2 * L2_BYTES // kv_bytes)))
        q = torch.randn((B, H, Dh), generator=gen, device="cuda").to(dtype)
        kvs = [(torch.randn((B, C, KV, Dh), generator=gen,
                            device="cuda").to(dtype),
                torch.randn((B, C, KV, Dh), generator=gen,
                            device="cuda").to(dtype))
               for _ in range(copies)]
        k, v = kvs[0]
        for i, nv in enumerate(swa_nvalids(C, plan)):
            nvalid = torch.tensor([nv], dtype=torch.int32, device="cuda")
            got = twice_equal(torch, "swa_decode",
                              lambda: swa.swa_decode(q, k, v, nvalid))
            want = swa.swa_decode_attention_plain(q, k, v, nvalid)
            tol = bf16_tol(torch, want)
            err = check_close(torch, f"swa_decode {(B, H, KV, C, Dh)} "
                              f"{dname} nvalid={nv}", got, want, dtype,
                              tol=tol)
            split_model = ref.swa_decode_splits_plain(
                q, k, v, nvalid, plan["splits"], tile=plan["tile"])
            require(bool(torch.isfinite(split_model.float()).all()),
                    f"split model {(B, H, KV, C, Dh)} nvalid={nv}: non-finite")
            rec = {"phase": "swa", "kernel": "swa_decode",
                   "shape": [B, H, KV, C, Dh], "dtype": dname, "nvalid": nv,
                   "max_abs_err": err, "atol": tol[0], "rtol": tol[1],
                   "split_model_max_abs_err": max_err(torch, split_model,
                                                      want)}
            if i >= 2:                  # edge cases: checked, not timed
                emit(rec)
                continue
            rec["planted_faults"] = planted_faults(torch, swa, ref, q, k, v,
                                                   nv, want, tol, plan)
            mask = (torch.arange(C, device="cuda") < nv)[None, None, None]

            def library(k_, v_):
                return F.scaled_dot_product_attention(
                    q[:, :, None], k_.transpose(1, 2), v_.transpose(1, 2),
                    attn_mask=mask, enable_gqa=KV != H)[:, :, 0]
            rec["library_max_abs_err"] = max_err(torch, library(k, v), want)
            rec.update({
                "ms": time_ms(cycling(
                    [lambda k_=k_, v_=v_: swa.swa_decode(q, k_, v_, nvalid)
                     for k_, v_ in kvs])),
                "plain_ms": time_ms(cycling(
                    [lambda k_=k_, v_=v_: swa.swa_decode_attention_plain(
                        q, k_, v_, nvalid) for k_, v_ in kvs]),
                    budget_s=0.5, max_reps=50),
                "library_ms": time_ms(cycling(
                    [lambda k_=k_, v_=v_: library(k_, v_)
                     for k_, v_ in kvs]), budget_s=0.5, max_reps=100)})
            rec["bound_ms"], rec["bound_by"], rec["bytes"] = swa_bound(
                B, H, KV, min(nv, C), Dh, esize)
            rec["kv_copies_cycled"] = copies
            rec["hbm_share"] = rec["bound_ms"] / rec["ms"]
            emit(rec)
            rows.setdefault(((B, H, KV, C, Dh), dname, nv), rec)
        if ((B, H, KV, C, Dh), dname) in SWA_PROBE_SHAPES:
            emit({"phase": "swa", "stall_probe": [B, H, KV, C, Dh],
                  "dtype": dname, **stall_probe(torch, swa, q, kvs, C)})
        if (B, H, KV, C, Dh) in (SWA_SERVE_SHAPE, (2, 8, 4, 1000, 64)):
            emit({"phase": "swa", "cuda_graph": [B, H, KV, C, Dh],
                  "dtype": dname, **graph_replay(torch, swa, q, k, v, C)})
        del kvs, k, v
        torch.cuda.empty_cache()
    return rows[(SWA_SERVE_SHAPE, "bfloat16", SWA_SERVE_SHAPE[3])]


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


def decode_profile(torch, model, toks, cache, steps, tries=TRACE_TRIES):
    """torch.profiler over ``steps`` decode steps (already warm).  A trace
    whose K8 count is not one a layer and step is taken again, up to
    ``tries`` traces (the profiler has been seen to lose one kernel
    record of thousands); every trace must be free of softmax and SDPA."""
    from torch.profiler import ProfilerActivity, profile

    want = steps * model.cfg.num_layers
    for attempt in range(tries):
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
        if k8_n == want:
            break
        emit({"phase": "serve", "retrace": attempt + 1, "k8_launches": k8_n,
              "expected": want})
    require(k8_n == want,
            f"profiled {steps} decode steps saw {k8_n} K8 launches in each "
            f"of {tries} traces")
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
    from repro_torch.launch.roofline import HBM_BYTES_PER_S
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
                              tol=bf16_tol(torch, want))
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
    "secure_agg_mean": ("src/repro_torch/csrc/secure_agg_mean.cu",
                        "src/repro/kernels/secure_agg.py:106", None),
    "clip_accum": ("src/repro_torch/csrc/clip_accum.cu",
                   "src/repro/kernels/clip_accum.py:42", None),
    "laplace_transform": ("src/repro_torch/csrc/laplace.cu",
                          "src/repro/kernels/laplace.py:23", None),
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
        kb_errs, kb_timings, kb_launches = phase_kernel_bench(torch)
        launches, prob = phase_main(torch)
        phase_profile(torch, prob)
        del prob
        swa_row = phase_swa(torch)
        launches["swa_decode"] = phase_serve(torch)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    for name in kb_errs:
        launches[name] = kb_launches[name]
        errs[name] = kb_errs[name]
    table = []
    main_t = timings[MAIN_SHAPE]
    for name, (source, replaces, key) in KERNELS.items():
        if name == "swa_decode":
            rec, err = swa_row, swa_row["max_abs_err"]
        elif key is None:                 # K5-K7: the micro rows' shape
            rec, err = kb_timings[(name, 0)], errs[name]
        else:
            rec, err = main_t[key], errs[name]
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
