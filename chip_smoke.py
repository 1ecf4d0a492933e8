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
             use_kernels on (launch counts read) and off (same seeds),
             through the default executor, the round graph (one round
             captured as a CUDA graph, replayed every round); checks
             finite MSD, on/off agreement, hybrid below iid_dp.  Each run
             again through the eager executor on the same seed: params and
             MSD bitwise equal, the same launch counts, and the wrappers
             launched K1-K3 only in the graph's warm-up round (every later
             launch a replay); the same for hybrid and iid_dp at
             combine_every=2 (two graphs).  Then 20 runs, each capturing
             and freeing its graph, must leave the allocated memory as
             they found it.
6. fig2    — the paper's Fig. 2 experiment at full size with the kernels
             on, through the round graph, on the reference's own problem (data/fig2_problem0.npz,
             written by fig2_reference.py), every config as run_schemes
             builds it: every mechanism at sigma 0.2 and 1.0, P=10, K=50,
             L=10, mu 0.1, full topology, 400 rounds, 16 repeats (seeds
             1000-1015).  The Fig. 2 tail (repeats 0 and 1, as
             run_schemes runs it) must be finite and lie within its band
             of the reference's, the mean log tail of the 16 repeats
             within 4 standard errors of the reference's over 96, and
             hybrid's tail below iid_dp's at sigma 1.0; prints each tail,
             its ratio to none's and the launch counts.  Then runs
             `python -m repro_torch.launch.fig2_convergence --problem
             data/fig2_problem0.npz` as a user does and requires its
             printed tails to be the phase's (rel 1e-5).
7. resilience — gfl-logreg at full size (as main) under the resilience
             runtime, topology seed 7: the six regimes of
             launch/resilience_demo.py under hybrid, and "everything at
             once" under every mechanism, kernels on and off on the same
             seeds: finite MSD, on/off within main's limits, the kernels
             of each mechanism launched, every realized A_i symmetric,
             doubly stochastic, nonnegative and connected; the host ms a
             round that realizing A_i takes and its share of the faulted
             round.  A null fault spec (links:0.0+dropout:0.0) must be
             bitwise equal to the static path, kernels on and off.
             Planted: K2 in mask mode with a third of each server's
             clients dead at mask scale 2^20, at (10, 50, 2) and (10, 48,
             4096), must come within 1e-5 of the plain survivor mean, and
             the plain fold that keeps the orphaned alive-dead streams
             must fall outside it.  "Everything at once" under every
             mechanism and the null spec, kernels on and off, again through
             the eager executor: bitwise equal to the round graph's runs.
             Then launch/fault_sweep.py at its defaults: wall ms a round of
             the static and faulted runs, the host share of a faulted
             round, launch counts.
8. profile — hybrid rounds under the round graph and the eager executor,
             at the main path's shape (kernels on and off) and the Fig. 2
             shape (L=10): steady wall ms a round (the difference of a
             250- and a 50-round run), and from torch.profiler over 50
             rounds (for the graph, from its first replay on) device busy
             ms, the traced window's idle share (the tracer's host cost
             stretches it), busy over the untraced wall, device ops and
             host launch calls a round by name (cudaLaunchKernel,
             cudaGraphLaunch), and the K1-K3 kernels by the call that
             launched them.  The graph must be
             launched at most once a round, no K1-K3 kernel after its
             capture may come from a cudaLaunchKernel, and the wrappers
             may launch K1-K3 only in the warm-up round.
9. population — the population engine's weighted path at the demo's full
             size (examples/population_demo.py: P=8, K=10^5 virtual
             clients a server, L=20, N=100, M=2, 120 rounds, hypercube,
             hybrid, a lazy synthetic:hetero population).  First one
             weighted fold (K1 + K2 through ops.round_fold) at (8, 20, 2)
             and (8, 20, 4096) in every mode, importance weights spread
             over 1e-3 .. 1e3 before the clip and a third of the clients
             dropped, against round_fold_ref (atol 1e-5, sq rtol 1e-5),
             twice bitwise equal.  Then `launch/population_demo.py`'s run
             as a user calls it, its launch counts set to 0 just before:
             K1-K3 launched, from replays.  Then each of its three cohort
             specs (uniform; uniform + diurnal trace; importance + the
             trace), kernels on and off, under the round graph and the
             eager executor: params, MSD, q, the IS state bitwise equal,
             the same launch counts (K1-K3 > 0 with kernels on, the
             wrappers launching only in the warm-up round), q in (0, 1],
             finite MSD, and the run's amplified epsilon equal to the one
             recomputed from its q trace.  The same for "everything on"
             (synthetic:mixture, importance + diurnal trace,
             links:0.2+dropout:0.3) under hybrid and iid_dp, 60 rounds,
             every realized A_i mixing; a dirichlet:0.3 population built
             from the config (K=1000) under both trace specs, with and
             without that fault, and simulate.run_gfl_importance on the
             gfl-logreg problem, each graph against eager.  Then a
             weighted round's time
             (importance + trace, kernels on): steady wall ms a round (the
             difference of a 130- and a 30-round run) and the profiler's
             busy, ops and launch calls, under both executors, and the
             host stage's ms a round with the availability realization's
             apart.  Last `python -m repro_torch.launch.population_scale`
             at its defaults (P=8, L=10, 100 rounds, K = 50, 10^3, 10^5,
             scan=True under the round graph) in its own process:
             client-steps/s and peak bytes, each below the dense [P, K, N,
             M] f32 bytes (or 8 MiB where those are smaller).
10. events — the event engine (run_gfl_async) at the reference docs'
             configuration (docs/async.md) at the population demo's size:
             P=8, K=10^5 virtual synthetic:hetero clients a server, N=100,
             M=2, hypercube, hybrid,
             async:buffer=8,latency=lognorm:0.5,max_stale=4 (8 events a
             server a tick), 500 ticks.  First the event fold: K1 + K2
             through ops.round_fold with per-event bases [P, E, D],
             staleness fold weights, a third of the events invalid and
             importance weights over 1e-3 .. 1e3, at (P, E, D) = (8, 8, 2),
             (8, 6, 509) and (8, 8, 4096) in every mode against
             round_fold_ref (atol 1e-5), then K3's gate/cache variant at
             the all-zero, a mixed and the all-one gate against
             graph_combine_ref of the selected psi; each twice bitwise
             equal.  Then the sync limit on the gfl-logreg problem
             (async:buffer=10, L=10, 500 ticks): bitwise
             run_gfl_population under the round graph.  Then the full-size
             run under uniform + diurnal trace (the docs' run), importance
             + the trace, and uniform + the trace under links:0.2: the
             tick graph bitwise the eager executor and the loop bitwise
             scan=True (params, MSD, flush, q, staleness, event and drop
             schedules, gaps), kernels on against off (the first 10 ticks'
             MSD within rtol 1e-4, final params within atol 1e-4), K1-K3
             launched once a tick and after the warm-up tick only from
             replays, a tick that flushes a strict subset of the servers,
             and the amplified epsilon equal to the one recomputed from
             (flushed, q).  Then the tick's time (the docs' run, kernels
             on): steady wall ms a tick under both executors (the
             difference of a 600- and a 100-tick run) and the profiler's
             busy, ops, launch calls and host share between replays;
             events a second.  Last `python -m
             repro_torch.launch.async_throughput` at its defaults (P=8,
             K=400, rate 8, 150 ticks, buffers 4/8/16 x max_stale 2/4 and
             the sync row) in its own process.
11. observe — the cross-cutting layer on the card, at the main path's
             full size (gfl-logreg, P=10, K=50, N=100, M=2, L=50,
             hybrid, kernels on), under the round graph.  Telemetry on (a
             memory session) against off, bitwise in params and MSD: the
             pure path's loop and scan, 500 rounds; the weighted path at
             population_demo's (8, 10^5, 20), 20 rounds; the event engine
             at the docs' run, 100 ticks, loop and scan.  The streams
             complete: step rows (where the engine taps them) and round
             rows one a round, no NaN, privacy records one a release,
             one kernel record per K1-K3 op a wrapper launched; a
             profile_phase around a first and a second run of one shape
             reads retraces >= 1 and then 0, with peak_bytes.  The off
             graph unchanged: the main hybrid round's device ops a replay
             through profile_run within PR 18's band (72.5-77.5; PERF.md
             section 5: 73-77) and within half an op of the profile
             phase's reading, and the on graph's beside it.  Sanitize
             mode: the ledger cross-check on the three engines, each run
             bitwise its run without it; a NaN w_ref raises SanitizerError after
             a run whose rounds were replayed; a ledger one release short
             raises.  Checkpoints: the final device params, the weighted
             run's ISState and a bf16 tensor saved and loaded back,
             bitwise and on the card.  Prints the steady wall a round
             with telemetry off and on under the graph as name,value
             lines with the card's name and power limit.
12. fleet  — the multi-process server fleet (repro_torch.core.fleet) on
             the card: workers fold through K1 + K2 (ops.round_fold at
             P = 1, L = E), the coordinator combines through K3.  First
             launch/fleet_demo.py's drill (P=4, K=16, n=12, dim 2,
             buffer 6, 4 events a tick, sigma_g 0.2, seed 3, 10 ticks;
             worker 2 SIGKILLed at tick 2, mid-buffer, and restarted
             from its write-ahead checkpoint) on inproc (worker threads,
             a stream each), filelog and socket (spawned worker
             processes, a CUDA context each): the killed run bitwise its
             clean twin (params, MSD, q, flush schedule, q-ledgers), one
             kill and one restart; for the spawned transports every
             worker process (its pid from /proc) seen on the card while
             it ran: sampled every 0.1 s, in a sample where the card
             lists one process more than before the drill for each live
             worker (torch.cuda.list_gpu_processes; the machine's NVML
             reports every process as pid 1, so processes are counted,
             not named), and after the drills no child process left and
             the card listing as many processes as before.  Prints ticks_per_s and
             recovery_s per transport.  Then three inproc runs on the card
             each against the same run on the CPU (flush schedule, q,
             versions, q-ledgers exact; params within atol 1e-5, MSD
             within rtol 1e-5), with K1 and K2 launched once a worker
             tick and K3 once a flushing tick, exactly, counted from 0
             just before: the demo's problem, the Section V size as a
             fleet (P=10, K=50, n=100, dim 2, events = buffer = 50, 30
             ticks) and the demo's problem at dim 2048 (K1's wide
             layout).  Last one worker alone on the card: host ms of a
             tick's fold and of its checkpoint.
13. train  — the federated LM (repro_torch.launch.federated_lm, the port
             of examples/federated_lm.py) at smollm-135m's full width and
             depth in f32: D = 134,515,008, P = 4 servers on a ring, L = 2
             clients a round, 2 sequences of 64 tokens a client, hybrid at
             sigma 0.01, mu 0.5, B 5, the fold through K1 + K2 and the
             combine through K3.  From one state and one set of client
             gradients: a none round, kernels on against off (params atol
             1e-5); a hybrid kernel round launching K1-K3 once each and
             rerun bitwise; the hybrid round's centroid, kernels on and
             off, against the none round's within centroid_atol (the
             masks and the eq.-24 noise cancel in exact arithmetic), the
             servers' params away from none's, and iid_dp's centroid
             away from it by over 100 times that limit.  The round's
             split: the gradients (8 forward and backward passes), K1 +
             K2 and K3 (CUDA events), and one whole round under the
             profiler (busy, idle share, device ops).  Then
             federated_lm.run as a user calls it, 40 rounds, K1-K3
             counted from 0 just before and launched once a round, the
             centroid eval loss and eps(i) every 10 rounds, finite and
             falling.  Last K1-K3 at (4, 2, 134,515,008) against their
             plain versions and library calls, with their bounds.
14. mesh   — the mesh trainer (repro_torch.launch.train, the port of
             launch/train.py) at smollm-135m's full width in bf16, as the
             reference trainer builds it, on mesh 4x1 in one process: 4
             servers, L = 2 clients of 2 x 64 tokens, hybrid at sigma
             0.01, mu 0.1, B 10.  First `python -m repro_torch.launch.train
             --mesh 4x1 --steps 3 --combine dense --use-kernels` as a user
             calls it, K3 counted from 0 just before: 11 launches a step
             (one a leaf of the reference's tree), K1 and K2 none, the loss
             finite.  Then 2 steps each of dense through K3, dense plain,
             rotate and sparse from one init, each run twice: reruns
             bitwise, K3 launched 11 times a dense kernel step and never in
             the others, the embedding centroid of each within 5e-3 of
             dense's (the reference's own bound, tests/test_dryrun.py).  K3
             against its plain version on every leaf of the final state,
             with a hybrid noise tree and without: within one bf16 ulp of
             the leaf's largest |value| (both sum in f32 and round once).
             The step's split: the 8 clients' gradients, the noise tree
             and each variant's combine (CUDA events), each variant's
             step; rotate and sparse on that psi and g against the f32
             einsum, every leaf within 4 bf16 ulps of its largest |value|
             (the centroid cannot see a wrong mix: A is doubly
             stochastic).  K3 in bf16 at the table's [4, 28,311,552] and
             blocks/mlp/w_up's [4, 26,542,080], with g and without,
             against its plain version, `addmm` / `mm` in bf16 and its
             bound (3 x 4 x N x 2 bytes with g; a step's 11 leaves
             0.963 ms).  Last `serve --mesh 1x1` of reduced phi3 against
             serve.generate (the same tokens), and private_serving runs,
             each with K8 counted from 0 just before it: one launch an
             attention layer and decode step.
15. swa    — K8 swa_decode against its plain version at the serving shapes
             (B, H, KV, C, Dh) = (4, 32, 32, 2047, 96) bf16,
             (4, 32, 32, 1064, 96) bf16, mixtral's and llava's (4, 32, 8,
             4096, 128) and (4, 32, 8, 1064, 128) bf16 (Dh 128, G 4),
             zamba2's (4, 32, 32, 4160, 64) and (4, 32, 32, 1064, 64),
             whisper's (4, 6, 6, 480, 64) and (4, 6, 6, 192, 64) bf16,
             (4, 9, 3, 1064, 64) bf16 and f32,
             (2, 8, 4, 1000, 64) f32 and (32, 32, 32, 2047, 96) bf16 (805 MB
             of K/V), each with its launch plan (tile, splits, blocks) and
             nvalid = C, 2C/3 (timed), 0, 1 and either side of a split
             boundary; run twice, bitwise equal; kernel, plain and
             scaled_dot_product_attention times with the HBM bound, cycling
             through copies of K/V that exceed the 50 MB L2, as decode
             finds them cold; a CUDA graph captured at nvalid = C/3 and
             replayed at C; and a stall probe at the phi3 shapes and
             mixtral's 4 x 4096 (the kernel beside its loads-only build,
             built here).
16. serve  — eight archs at full width, bf16, random weights from seed 0,
             each freed before the next, through
             repro_torch.launch.serve.generate: phi3-mini-3.8b (32 layers,
             d 3072), request A, 4 x 4096-token prompts + 32 greedy tokens
             (ring of 2047 slots, wrapped), and B, 4 x 1000 + 32 (1064
             slots, nvalid partial); mixtral-8x7b at 16 of its 32 layers
             (the cut printed: 32 do not fit the card), A (ring of 4096,
             wrapped) and B; deepseek-v2-lite-16b (27 layers, MLA, a dense
             first layer, 2 shared + 64 routed experts top-6), 4 x 4096 +
             32; minicpm3-4b (62 layers, MLA with a compressed query), 4 x
             1000 + 32; zamba2-1.2b and rwkv6-3b at full depth, A and B;
             llava-next-mistral-7b (32 layers, the Mistral-7B backbone,
             SWA 4096), A and B with 2880 image embeddings ahead of each
             prompt (A: 6976 tokens into a ring of 4096, wrapped);
             whisper-tiny (4 + 4 layers) with 1500 encoder frames (the
             stub inputs 0.1 N(0, 1), as the serve entry draws them)
             within its 448-token decoder context: A, 4 x 416 + 32, fills
             it; B is 4 x 128 + 32.  Gates finite logits; K8 launches a layer and step
             for the GQA archs and none for MLA; K8 against its plain
             version on the live q, cache and nvalid of the first and last
             layers at decode steps 0 and 31; the first MoE layer of step
             0, on its live input, against a token-by-token plain version
             (bf16 tolerance), with no routed entry dropped at decode; the
             last request generated again, tokens and logits bitwise
             equal.  Prints prefill ms, decode ms per step and tok/s
             against the step's byte bound (every expert's weights: the
             capacity dispatch reads them all) and the active parameters'
             bytes, the prefill's dropped-entry share, peak memory, and a
             torch.profiler view of decode steps (device busy and idle
             share, K8's share; no scaled_dot_product_attention, and
             softmax only the router's, MLA's and whisper's
             cross-attention's, one a layer and step).
             A profiler trace whose launch count is off (K8 a layer and
             step here, one op a call of K1 and K2 above) is taken again,
             up to three traces: the profiler has been seen to lose one
             kernel record in a trace.  Every profiler window is fenced
             on the device by three marker kernels at each end, each
             launched on an idle device, and the host idles 50 ms at
             each end: the profiler moves device records onto the host's
             clock with an offset, one for a whole trace, that has been
             seen milliseconds off, and drops a record that then falls
             outside the window.  A one-op trace (K1, K2, K5, K6) reads
             only the ops between the markers, and is taken again, up to
             eight traces, while it kept no marker at one end (each
             printed as a `broken_fence` line).  Longer traces (profile,
             events, serve) hold their own counts instead.  Windows are
             measured on one clock each (device records against device
             records).  A `profiler` line at the end reports the offsets
             (a marker's start less its launch call's) over the run's
             traces.

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
The fig2 gates, both on the reference's problem: the reference's tails
(FIG2_REF_TAILS) come from benchmarks/fig2_convergence.py at its defaults
on the CPU, and the spread of its repeats on that problem from
fig2_reference.py (96 repeats, JAX on the CPU).  The port's draws come
from torch generators, so a tail can match only in distribution.  The band:
a Fig. 2 tail must satisfy |log(port / reference)| <= 4 sqrt(2) s, where s
(FIG2_LOG_SD2) is the standard deviation of the log of a two-repeat tail
over the reference's 48 disjoint repeat pairs; the difference of two
independent two-repeat tails has standard deviation sqrt(2) s, so the
band is four of them (a factor 2.08 for none, 4.9-8.4 for the hybrid
family at sigma 0.2 and 1.26-1.35 at 1.0, 41 and 68 for iid_dp, whose
single repeats spread by a factor e^0.92 each way).  The mean log tail:
over the port's 16 repeats against the reference's 96 (FIG2_REF_LOG), it
must lie within 4 standard errors of the difference, sqrt(s_port^2 / 16
+ s_ref^2 / 96): the CPU test's statistic (tests/test_torch_fig2.py) at
full size, a factor of about 1.06-1.8, iid_dp's 2.7.  For normal log
tails each is a false alarm at under 1e-4.
Bounds: bytes over 3.35 TB/s, fp32 operations over 67 TFLOP/s, and the
hash's integer and conversion instructions over the INT32 rate derived in
src/repro_torch/launch/roofline.py, the largest of the three.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Any failed check exits non-zero.
"""
from __future__ import annotations

import contextlib
import json
import math
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
PARAMS_ATOL_TRAIN = 1e-5   # the LM round, kernels on against off (none)
MSD_RTOL, MSD_ATOL = 1e-3, 1e-6
# which kernels each mechanism's rounds must launch with use_kernels on:
# iid_dp's per-edge combine noise keeps the einsum, and scheduled's traced
# sigma has no fold spec, so its client level takes the protect hooks
ROUND_KERNELS = ("fold_norms", "fold_apply", "graph_combine")
GRAPH_CYCLES = 20     # capture-and-free cycles the memory gate runs
EXPECT = {"none": {"fold_norms", "fold_apply", "graph_combine"},
          "iid_dp": {"fold_norms", "fold_apply"},
          "hybrid": {"fold_norms", "fold_apply", "graph_combine"},
          "gaussian_dp": {"fold_norms", "fold_apply", "graph_combine"},
          "scheduled": {"graph_combine"}}
# the Fig. 2 experiment (benchmarks/fig2_convergence.py's defaults), on
# the reference's problem of key 0, the benchmark's, as plain arrays:
# `python3 fig2_reference.py --save-problem data/fig2_problem0.npz`
FIG2_PROBLEM = "data/fig2_problem0.npz"
FIG2_SIGMAS = (0.2, 1.0)
FIG2_ITERS, FIG2_REPEATS = 400, 2
FIG2_STAT_REPEATS = 16
# the reference's tails: `PYTHONPATH=src python benchmarks/fig2_convergence.py`
# at its defaults, JAX 0.9.0 on the CPU (problem key 0, seeds 1000, 1001)
FIG2_REF_TAILS = {
    (0.2, "gaussian_dp"): 0.000529049, (0.2, "hybrid"): 0.000515278,
    (0.2, "iid_dp"): 0.182732, (0.2, "none"): 0.00257179,
    (0.2, "scheduled"): 0.000249682,
    (1.0, "gaussian_dp"): 0.358767, (1.0, "hybrid"): 0.364971,
    (1.0, "iid_dp"): 6.35843, (1.0, "none"): 0.00257179,
    (1.0, "scheduled"): 1.09095}
# on that problem, over the reference's seeds 1000-1095 (`python3
# fig2_reference.py`, JAX 0.9.0 on the CPU): the standard deviation of the
# log of a two-repeat tail over the 48 disjoint pairs of repeats ...
FIG2_LOG_SD2 = {
    (0.2, "gaussian_dp"): 0.2793, (0.2, "hybrid"): 0.2907,
    (0.2, "iid_dp"): 0.6554, (0.2, "none"): 0.1294,
    (0.2, "scheduled"): 0.3758, (1.0, "gaussian_dp"): 0.0406,
    (1.0, "hybrid"): 0.0536, (1.0, "iid_dp"): 0.7454, (1.0, "none"): 0.1294,
    (1.0, "scheduled"): 0.0476}
# ... and the mean and standard deviation of the log of one repeat's tail
FIG2_REF_REPEATS = 96
FIG2_REF_LOG = {
    (0.2, "gaussian_dp"): (-7.3959, 0.4758),
    (0.2, "hybrid"): (-7.4240, 0.4845),
    (0.2, "iid_dp"): (-2.9022, 0.9095),
    (0.2, "none"): (-5.8488, 0.2148),
    (0.2, "scheduled"): (-8.5965, 0.5585),
    (1.0, "gaussian_dp"): (-1.0329, 0.0563),
    (1.0, "hybrid"): (-1.0203, 0.0732),
    (1.0, "iid_dp"): (0.4956, 0.9322),
    (1.0, "none"): (-5.8488, 0.2148),
    (1.0, "scheduled"): (0.1081, 0.0626)}
FIG2_BAND_SDS = 4.0
RES_TOPOLOGY_SEED = 7          # examples/resilience_demo.py's
RES_NULL_SPEC = "links:0.0+dropout:0.0"
DROPOUT_PLANT_SCALE = float(1 << 20)
DROPOUT_PLANT_SHAPES = [MAIN_SHAPE, (10, 48, 4096)]
SWA_SERVE_SHAPE = (4, 32, 32, 2047, 96)
SWA_MIXTRAL_SHAPE = (4, 32, 8, 4096, 128)    # Dh 128, G 4, ring of 4096
SWA_ZAMBA2_SHAPE = (4, 32, 32, 4160, 64)     # Dh 64, G 1, S + 64, no ring
SWA_WHISPER_SHAPE = (4, 6, 6, 480, 64)       # whisper's decoder, request A
SWA_PROBE_SHAPES = [(SWA_SERVE_SHAPE, "bfloat16"),
                    ((32, 32, 32, 2047, 96), "bfloat16"),
                    (SWA_MIXTRAL_SHAPE, "bfloat16"),
                    (SWA_ZAMBA2_SHAPE, "bfloat16")]
SWA_SHAPES = [(SWA_SERVE_SHAPE, "bfloat16"), ((4, 32, 32, 1064, 96), "bfloat16"),
              (SWA_MIXTRAL_SHAPE, "bfloat16"),
              ((4, 32, 8, 1064, 128), "bfloat16"),
              (SWA_ZAMBA2_SHAPE, "bfloat16"),
              ((4, 32, 32, 1064, 64), "bfloat16"),
              (SWA_WHISPER_SHAPE, "bfloat16"),
              ((4, 6, 6, 192, 64), "bfloat16"),
              ((4, 9, 3, 1064, 64), "bfloat16"), ((4, 9, 3, 1064, 64), "float32"),
              ((2, 8, 4, 1000, 64), "float32"),
              ((32, 32, 32, 2047, 96), "bfloat16")]
# each arch's requests: name, batch, prompt (+ SERVE_NEW_TOKENS greedy)
SERVE_MODELS = (
    ("phi3-mini-3.8b", (("A", 4, 4096), ("B", 4, 1000))),
    ("mixtral-8x7b", (("A", 4, 4096), ("B", 4, 1000))),
    ("deepseek-v2-lite-16b", (("A", 4, 4096),)),
    ("minicpm3-4b", (("B", 4, 1000),)),
    ("zamba2-1.2b", (("A", 4, 4096), ("B", 4, 1000))),
    ("rwkv6-3b", (("A", 4, 4096), ("B", 4, 1000))),
    ("llava-next-mistral-7b", (("A", 4, 4096), ("B", 4, 1000))),
    # whisper's decoder context is 448 positions (arXiv:2212.04356): A
    # fills it, B is a short transcript
    ("whisper-tiny", (("A", 4, 416), ("B", 4, 128))),
)
# the leaves the reference keeps in f32 in a bf16 model, (part, leaf):
# Mamba2's A_log, RWKV-6's w0 and u; every other parameter is bf16
SERVE_F32_LEAVES = {("ssm", "A_log"), ("att", "w0"), ("att", "u")}
# archs served at fewer layers than their config's, and why
SERVE_DEPTH_CUTS = {
    "mixtral-8x7b": (16, "32 layers are about 46.7e9 parameters, 93.4 GB "
                         "in bf16, more than the card's 80 GB; 16 are "
                         "about 23.5e9, 47.0 GB")}
# the step's bytes reckoned by hand (every expert read: capacity dispatch)
SERVE_RECKONED_STEP_GB = {"mixtral-8x7b": 46.7, "deepseek-v2-lite-16b": 31.0,
                          "minicpm3-4b": 8.15, "zamba2-1.2b": 3.7,
                          "rwkv6-3b": 6.0, "llava-next-mistral-7b": 16.4,
                          "whisper-tiny": 0.14}
SERVE_NEW_TOKENS = 32
SERVE_PROFILE_STEPS = 3
TRACE_TRIES = 3       # traces of a launch count before it fails
# Profiler windows.  torch.profiler keeps a device record only if its
# times, moved onto the host's clock, fall inside the window, and that
# move is off by an offset, one for a whole trace, that has been seen
# milliseconds off (chip_trace_probe.py).  So the host idles TRACE_PAD_S
# at each edge of a window, the device idle
TRACE_PAD_S = 0.05
TRACE_MARKERS = 3       # marker kernels at each end of a traced window
TRACE_LEAD_PAD = 256    # marker kernels ahead of the decode profile's steps
TRACE_LOST_TRIES = 8    # traces taken while the profiler breaks the fence
TRACE_OFFSETS: list = []   # each trace's offset, µs (None: not measured)
# over the run: traces, fenced ones taken again, unfenced ones kept broken
TRACE_COUNTS = {"traces": 0, "broken_fences": 0, "unfenced_broken": 0}


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


def time_shape(torch, P, L, D, gen, profile=True):
    """f32 kernel, plain and library times at one shape, with the bounds,
    each kernel's output held against its plain version's (``max_abs_err``;
    K1 at rtol 1e-5, K2 and K3 at atol 1e-5); with ``profile``, K1's, K2's
    and K3's device-only times from the profiler too (at the federated
    LM's width its one-op traces lost their leading markers in 8 of 8
    takes: the train phase times without it)."""
    from repro_torch.kernels import round_fold as rf
    from repro_torch.kernels import graph_combine as gc
    from repro_torch.launch.kernel_bench import time_ms

    f32 = torch.float32
    w, g, noise, ss, fw, _, seeds = fold_inputs(torch, P, L, D, f32, False,
                                                gen)
    # every client alive, at weights that differ: at equal weights each
    # pair's mask terms cancel and mask mode's hash path goes unchecked
    nw = torch.rand((P, L), generator=gen, device="cuda") + 0.1
    nw = nw / nw.sum(dim=1, keepdim=True)
    out = {}
    # K1: reads g once, writes [P, L]; against the library call in turns
    # (both host-bound at the main path's shape)
    bytes_k1 = P * L * D * 4 + P * L * 4
    ms, lib_ms = paired_ms(torch, lambda: rf.fold_norms(g),
                           lambda: torch.linalg.vector_norm(g, dim=-1) ** 2)
    out["fold_norms"] = {
        "ms": ms, **(one_op(torch, lambda: rf.fold_norms(g), "norms",
                            f"fold_norms {P, L, D}") if profile else {}),
        "plain_ms": time_ms(lambda: rf.fold_norms_plain(g)),
        "max_abs_err": check_close(torch, f"fold_norms {P, L, D} timed",
                                   rf.fold_norms(g), rf.fold_norms_plain(g),
                                   f32, norms=True),
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
            **(one_op(torch, call, "fold_apply",
                      f"fold_apply {mode} {P, L, D}") if profile else {}),
            "plain_ms": time_ms(lambda: rf.fold_apply_plain(
                w, g, ss, fw, nw, **kw), budget_s=0.5, max_reps=50),
            "max_abs_err": check_close(
                torch, f"fold_apply {mode} {P, L, D} timed", call(),
                rf.fold_apply_plain(w, g, ss, fw, nw, **kw), f32),
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
            **({"device_ms": profile_calls(
                torch, lambda: gc.graph_combine(A, psi, g_), 50,
                "combine")["device_ms"]} if profile else {}),
            "plain_ms": time_ms(lambda: gc.graph_combine_plain(
                A, psi, g_)),
            "max_abs_err": check_close(
                torch, f"graph_combine {variant} {P, D} timed",
                gc.graph_combine(A, psi, g_),
                gc.graph_combine_plain(A, psi, g_), f32),
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
              "device_ops": n, "calls": calls, "names": rec["device_ops"],
              **{k: rec[k] for k in ("markers", "device_records",
                                     "launch_calls")}})
    require(False, f"{name}: {n} device ops in {calls} calls "
            f"({rec['device_ops']}) in each of {tries} traces, expected "
            "the kernel alone, once a call")


@contextlib.contextmanager
def device_trace(torch):
    """torch.profiler (host and CUDA) over the block, fenced on the device
    by ``TRACE_MARKERS`` marker kernels (``torch.cuda._sleep``'s
    ``spin_kernel``) at each end, each launched on an idle device: the
    host idles ``TRACE_PAD_S`` seconds after the window opens, and after the
    block it synchronises, launches the trailing markers, synchronises and
    idles again before the window closes.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    pad_s = TRACE_PAD_S
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        for _ in range(TRACE_MARKERS):
            torch.cuda._sleep(1)
        yield prof
        torch.cuda.synchronize()
        for _ in range(TRACE_MARKERS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(pad_s)


def is_device(evt) -> bool:
    return str(getattr(evt, "device_type", "")).endswith("CUDA")


def traced(torch, block, what, fenced=True):
    """``block()`` under ``device_trace``.  The fence's markers are the
    trace's first and last ``TRACE_MARKERS`` host ``cudaLaunch*`` calls
    (host records are all kept); it is whole when a device record of a
    leading marker and one of a trailing marker came back.  The offset
    that moves device records onto the host's clock is one for a whole
    trace, so a whole fence holds every device record launched between
    its ends; a broken one says the profiler dropped records at that
    edge, and with ``fenced`` the trace is taken again, at most
    ``TRACE_LOST_TRIES`` traces.  Traces of thousands of device records,
    after earlier profiling in the process, have been seen to lose their
    leading markers in every take, with the offset near zero and any pad:
    their callers hold their own counts (``fenced=False``).  A marker
    starts on an idle device within microseconds of its launch, so the
    least of the markers' starts less their launch calls' is the offset
    (``TRACE_OFFSETS``).  Returns ``{"prof", "events", "device"`` (the
    device records but the markers), ``"lo", "hi"`` (the first leading
    marker record's start and the last trailing one's, on the device
    clock; None where none came back), ``"marker_ids", "markers"`` (how
    many marker records came back), ``"value"`` (the block's)}."""
    for attempt in range(TRACE_LOST_TRIES):
        with device_trace(torch) as prof:
            value = block()
        events = list(prof.events())
        TRACE_COUNTS["traces"] += 1
        launches = sorted((e for e in events
                           if e.name.startswith("cudaLaunch")),
                          key=lambda e: e.time_range.start)
        at = {e.id: e.time_range.start for e in launches}
        lead = {e.id for e in launches[:TRACE_MARKERS]}
        trail = {e.id for e in launches[-TRACE_MARKERS:]}
        marks = [e for e in events if is_device(e)
                 and "spin_kernel" in e.name and e.id in lead | trail]
        lo = [e.time_range.start for e in marks if e.id in lead]
        hi = [e.time_range.start for e in marks if e.id in trail]
        offset = min((e.time_range.start - at[e.id] for e in marks),
                     default=None)
        TRACE_OFFSETS.append(offset)
        if (lo and hi) or not fenced:
            TRACE_COUNTS["unfenced_broken"] += not (lo and hi)
            return {"prof": prof, "events": events,
                    "device": [e for e in events if is_device(e)
                               and "spin_kernel" not in e.name],
                    "lo": min(lo, default=None), "hi": max(hi, default=None),
                    "marker_ids": lead | trail, "markers": len(marks),
                    "value": value}
        TRACE_COUNTS["broken_fences"] += 1
        emit({"phase": "profiler", "broken_fence": attempt + 1, "of": what,
              "leading_markers": len(lo), "trailing_markers": len(hi),
              "device_records": sum(map(is_device, events)),
              "launch_calls": len(launches), "offset_us": offset})
        time.sleep(0.5)
    require(False, f"{what}: the profiler dropped every marker record at "
            f"one end of each of {TRACE_LOST_TRIES} traces")


def profile_calls(torch, fn, calls, kernel):
    """torch.profiler over ``calls`` back-to-back calls of ``fn`` (after a
    warm-up): the host's wall time per call (the enqueue, no synchronise
    inside), the device time per call of the kernels whose name holds
    ``kernel`` and of every device op, and host self time by op.

    The trace is ``traced``'s: only the device ops between its fence's
    first and last marker records are read.  ``markers`` counts the marker
    records found, ``device_records`` every device record and
    ``launch_calls`` the host's ``cudaLaunch*`` calls."""
    def block():
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return time.perf_counter() - t0

    fn()
    tr = traced(torch, block, f"{kernel}: {calls} calls")
    events, host, lo, hi = tr["events"], tr["value"], tr["lo"], tr["hi"]
    dev = dev_all = 0.0
    names = set()
    n_ops = 0
    for evt in tr["device"]:
        if not lo < evt.time_range.start < hi:
            continue
        us = evt.time_range.elapsed_us()
        dev_all += us
        n_ops += 1
        names.add(evt.name[:60])
        if kernel in evt.name:
            dev += us
    ops = sorted(tr["prof"].key_averages(),
                 key=lambda e: -e.self_cpu_time_total)
    return {"calls": calls, "markers": tr["markers"],
            "device_records": sum(map(is_device, events)),
            "launch_calls": sum(e.name.startswith("cudaLaunch")
                                for e in events),
            "host_ms_per_call": host * 1e3 / calls,
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


def timed_run(torch, prob, cfg, iters, seed, executor=None, **kw):
    """(msd, params, wall s, launches, replayed[, gaps]) of one
    ``run_gfl``."""
    from repro_torch import kernels as K
    from repro_torch.core.simulate import run_gfl

    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_gfl(prob, cfg, iters=iters, batch_size=10, seed=seed,
                  executor=executor, **kw)
    torch.cuda.synchronize()
    return (out[0], out[1], time.perf_counter() - t0, dict(K.LAUNCHES),
            dict(K.REPLAYED), *out[2:])


def require_graph_is_eager(torch, what, graph, eager, warmups=1) -> None:
    """The round graph's run against the eager executor's on the same
    seed: params and MSD trace bitwise equal, the same launch counts, and
    the wrappers launched K1-K3 only in the graph run's warm-up rounds,
    one a graph (every later launch a replay)."""
    msd_g, p_g, _, launches_g, replayed = graph[:5]
    msd_e, p_e, _, launches_e, _ = eager[:5]
    require(bool(torch.equal(p_g, p_e)) and msd_g.tolist() == msd_e.tolist(),
            f"{what}: the round graph differs from the eager executor")
    require(launches_g == launches_e,
            f"{what}: launches {launches_g} under the graph, {launches_e} "
            "eagerly")
    for name in ROUND_KERNELS:
        calls = launches_g[name] - replayed[name]
        require(calls <= warmups and (calls > 0) == (launches_g[name] > 0),
                f"{what}: {name} launched by its wrapper {calls} times under "
                f"the graph, expected at most {warmups} (the warm-up rounds)")


def phase_main(torch):
    import numpy as np
    from repro_torch import kernels as K, rng
    from repro_torch.configs import gfl_logreg
    from repro_torch.core.privacy.accountant import epsilon_at
    from repro_torch.core.privacy.mechanism import (list_mechanisms,
                                                    mechanism_for)
    from repro_torch.core.simulate import generate_problem
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
    totals = {name: 0 for name in K.LAUNCHES}
    tails = {}
    for scheme in list_mechanisms():
        cfg = replace(base, privacy=scheme, epsilon_target=eps_budget,
                      epsilon_horizon=ITERS, use_kernels=True)
        off = replace(cfg, use_kernels=False)
        on_g = timed_run(torch, prob, cfg, ITERS, 1)
        msd_on, p_on, wall_on, launches = on_g[:4]
        for name, n in launches.items():
            totals[name] += n
        on_e = timed_run(torch, prob, cfg, ITERS, 1, "eager")
        off_g = timed_run(torch, prob, off, ITERS, 1)
        off_e = timed_run(torch, prob, off, ITERS, 1, "eager")
        msd_off, p_off, wall_off = off_g[:3]
        tail = float(np.mean(msd_on[-50:]))
        tails[scheme] = tail
        acc = mechanism_for(cfg).accountant()
        acc.advance(ITERS)
        p_err = float((p_on - p_off).abs().max())
        msd_err = float(np.max(np.abs(msd_on - msd_off)))
        emit({"phase": "main", "scheme": scheme, "msd_tail": tail,
              "msd_tail_kernels_off": float(np.mean(msd_off[-50:])),
              "epsilon": acc.epsilon(), "wall_s": wall_on,
              "wall_s_kernels_off": wall_off, "wall_s_eager": on_e[2],
              "wall_s_eager_kernels_off": off_e[2],
              "wall_ms_per_round": wall_on * 1e3 / ITERS,
              "wall_ms_per_round_eager": on_e[2] * 1e3 / ITERS,
              "launches": launches, "replayed": on_g[4],
              "params_max_abs_diff": p_err, "msd_max_abs_diff": msd_err})
        require(bool(np.all(np.isfinite(msd_on)))
                and bool(np.all(np.isfinite(msd_off))),
                f"{scheme}: non-finite MSD")
        for name in EXPECT[scheme]:
            require(launches[name] > 0,
                    f"{scheme}: kernel {name} was never launched")
        require_graph_is_eager(torch, f"{scheme}, kernels on", on_g, on_e)
        require_graph_is_eager(torch, f"{scheme}, kernels off", off_g, off_e)
        require(p_err <= PARAMS_ATOL
                and bool(np.allclose(msd_on, msd_off, rtol=MSD_RTOL,
                                     atol=MSD_ATOL)),
                f"{scheme}: kernels on/off differ (params {p_err}, "
                f"msd {msd_err})")
    require(tails["hybrid"] < tails["iid_dp"],
            f"hybrid MSD tail {tails['hybrid']} not below iid_dp "
            f"{tails['iid_dp']}")
    for scheme in ("hybrid", "iid_dp"):   # two graphs: combine or not
        for use_kernels in (True, False):
            cfg = replace(base, privacy=scheme, combine_every=2,
                          use_kernels=use_kernels)
            what = f"{scheme}, combine_every 2, use_kernels {use_kernels}"
            graph = timed_run(torch, prob, cfg, ITERS, 1)
            require_graph_is_eager(torch, what, graph,
                                   timed_run(torch, prob, cfg, ITERS, 1,
                                             "eager"), warmups=2)
            emit({"phase": "main", "scheme": scheme, "combine_every": 2,
                  "use_kernels": use_kernels, "graph_is_eager": True,
                  "launches": graph[3]})
    for use_kernels in (True, False):
        graph_memory(torch, prob, replace(base, privacy="hybrid",
                                          use_kernels=use_kernels))
    return totals, prob


def graph_memory(torch, prob, cfg, runs=GRAPH_CYCLES):
    """``runs`` runs, each capturing its round graph and freeing it at the
    end, must leave the allocated memory where the first left it."""
    timed_run(torch, prob, cfg, 20, 0)
    base = torch.cuda.memory_allocated()
    for seed in range(runs):
        timed_run(torch, prob, cfg, 20, seed)
    after = torch.cuda.memory_allocated()
    emit({"phase": "main", "graph_cycles": runs,
          "use_kernels": cfg.use_kernels,
          "memory_allocated_before": base, "memory_allocated_after": after})
    require(after == base, f"{runs} round-graph runs left {after - base} "
            "bytes allocated")


# ----------------------------------------------------------------- fig2


def fig2_band(sigma, scheme) -> float:
    """The largest |log(port tail / reference tail)| the fig2 phase takes."""
    return FIG2_BAND_SDS * 2 ** 0.5 * FIG2_LOG_SD2[(sigma, scheme)]


def fig2_config(sigma, scheme):
    """The config ``run_schemes`` builds for ``scheme`` at ``sigma`` (the
    fig2 entry's tails, from ``run_schemes``, must equal the phase's)."""
    from repro_torch.configs.base import GFLConfig
    from repro_torch.core.privacy.accountant import epsilon_at

    return GFLConfig(num_servers=10, clients_per_server=50,
                     clients_sampled=10, topology="full", privacy=scheme,
                     sigma_g=sigma, mu=0.1, grad_bound=10.0,
                     epsilon_target=epsilon_at(FIG2_ITERS, 0.1, 10.0, sigma),
                     epsilon_horizon=FIG2_ITERS, use_kernels=True)


def phase_fig2(torch):
    """The paper's Fig. 2 at full size with the kernels on, on the
    reference's own problem (FIG2_PROBLEM): every mechanism at sigma 0.2
    and 1.0, FIG2_STAT_REPEATS repeats (seeds 1000, ...).  The Fig. 2 tail
    (repeats 0 and 1, as ``run_schemes`` runs it) must be finite and lie
    within its band of the reference's; the mean log tail of all repeats
    within FIG2_BAND_SDS standard errors of the reference's; hybrid's
    tail below iid_dp's at sigma 1.0.  Then ``python -m
    repro_torch.launch.fig2_convergence --problem``, whose rows must
    carry the same Fig. 2 tails."""
    import math
    import os
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.core.privacy.mechanism import list_mechanisms
    from repro_torch.core.simulate import msd_tail, run_gfl
    from repro_torch.launch.fig2_convergence import load_problem

    prob = load_problem(ROOT / FIG2_PROBLEM, "cuda")
    tails, totals = {}, {name: 0 for name in K.LAUNCHES}
    for sigma in FIG2_SIGMAS:
        K.reset_launches()
        t0 = time.perf_counter()
        reps = {}
        for scheme in list_mechanisms():
            cfg = fig2_config(sigma, scheme)
            msds = [run_gfl(prob, cfg, iters=FIG2_ITERS, batch_size=10,
                            seed=1000 + r)[0]
                    for r in range(FIG2_STAT_REPEATS)]
            require(all(bool(np.isfinite(m).all()) for m in msds),
                    f"fig2 sigma {sigma} {scheme}: non-finite MSD")
            reps[scheme] = np.array([msd_tail(m, FIG2_ITERS) for m in msds])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        for name, n in launches.items():
            totals[name] += n
        for name in {"fold_norms", "fold_apply", "graph_combine"}:
            require(launches[name] > 0,
                    f"fig2 sigma {sigma}: kernel {name} was never launched")
        for scheme, rep in reps.items():
            tail = float(rep[:FIG2_REPEATS].mean())
            tails[(sigma, scheme)] = tail
            ref = FIG2_REF_TAILS[(sigma, scheme)]
            dev = abs(math.log(tail / ref)) if tail > 0 else math.inf
            logs = np.log(rep)
            ref_mean, ref_sd = FIG2_REF_LOG[(sigma, scheme)]
            se = math.sqrt(logs.var(ddof=1) / len(logs)
                           + ref_sd ** 2 / FIG2_REF_REPEATS)
            z = abs(float(logs.mean()) - ref_mean) / se
            emit({"phase": "fig2", "sigma": sigma, "scheme": scheme,
                  "msd_tail": tail, "ref_tail": ref, "log_ratio_to_ref": dev,
                  "band": fig2_band(sigma, scheme),
                  "mean_log_tail": float(logs.mean()),
                  "ref_mean_log_tail": ref_mean,
                  "log_sd": float(logs.std(ddof=1)), "ref_log_sd": ref_sd,
                  "standard_errors": z, "repeats": len(logs)})
            require(dev <= fig2_band(sigma, scheme),
                    f"fig2 sigma {sigma} {scheme}: tail {tail} outside the "
                    f"band of the reference's {ref}")
            require(z <= FIG2_BAND_SDS,
                    f"fig2 sigma {sigma} {scheme}: mean log tail "
                    f"{float(logs.mean())} is {z} standard errors from the "
                    f"reference's {ref_mean}")
        emit({"phase": "fig2", "sigma": sigma, "wall_s": wall,
              "runs": len(reps) * FIG2_STAT_REPEATS, "launches": launches,
              "ratio_to_none": {s: tails[(sigma, s)] / tails[(sigma, "none")]
                                for s in reps}})
    require(tails[(1.0, "hybrid")] < tails[(1.0, "iid_dp")],
            f"fig2: hybrid tail {tails[(1.0, 'hybrid')]} not below iid_dp "
            f"{tails[(1.0, 'iid_dp')]} at sigma 1.0")
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fig2_convergence",
         "--problem", FIG2_PROBLEM],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    require(res.returncode == 0,
            f"fig2_convergence exited {res.returncode}: {res.stderr[-2000:]}")
    rows = dict(ln.split(",") for ln in res.stdout.splitlines()
                if ln.startswith("fig2_msd_tail/"))
    for (sigma, scheme), tail in tails.items():
        got = float(rows[f"fig2_msd_tail/sigma={sigma}/{scheme}"])
        require(math.isclose(got, tail, rel_tol=1e-5),
                f"fig2_convergence: {sigma} {scheme} printed {got}, the "
                f"phase's run {tail}")
    emit({"phase": "fig2", "entry": "repro_torch.launch.fig2_convergence",
          "rows": len(rows), "wall_s": time.perf_counter() - t0,
          "launches_in_process": totals})


# ----------------------------------------------------------- resilience


def dropout_plant(torch, gen):
    """K2 in mask mode with a third of each server's clients dead, at mask
    scale 2^20: survivors fold with weight 1/n_alive and K2 hashes only
    alive pairs, so their streams cancel and K2 must come within ATOL_F32
    of the plain survivor mean (no masks); the plain fold that keeps the
    orphaned alive-dead streams must fall outside it."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.secure_agg import net_mask_stream

    for P, L, D in DROPOUT_PLANT_SHAPES:
        w = torch.randn((P, D), generator=gen, device="cuda")
        grads = torch.randn((P, L, D), generator=gen, device="cuda")
        dead = torch.argsort(torch.rand((P, L), generator=gen,
                                        device="cuda"), dim=1)[:, :L // 3]
        alive = torch.ones((P, L), dtype=torch.bool, device="cuda")
        alive.scatter_(1, dead, False)
        af = alive.to(torch.float32)
        nw = af / af.sum(dim=1, keepdim=True)
        seeds = torch.randint(0, 2 ** 31 - 1, (P,), generator=gen,
                              device="cuda")
        kw = dict(mu=0.1, bound=10.0, fold_w=af, noise_w=nw)
        psi, _ = ops.round_fold(w, grads, mode="mask",
                                sigma=DROPOUT_PLANT_SCALE, seeds=seeds, **kw)
        plain, _ = ref.round_fold_ref(w, grads, pre_w=torch.ones_like(af),
                                      mode="none", **kw)
        idx = torch.arange(D, device="cuda")
        leak = torch.stack([sum(nw[p, k] * net_mask_stream(
            k, idx, seeds[p], DROPOUT_PLANT_SCALE, L)
            for k in range(L) if alive[p, k]) for p in range(P)])
        err = max_err(torch, psi, plain)
        leak_err = max_err(torch, plain + leak, plain)
        emit({"phase": "resilience", "dropout_plant": [P, L, D],
              "dead_per_server": L // 3, "mask_scale": DROPOUT_PLANT_SCALE,
              "max_abs_err": err, "orphaned_streams_err": leak_err,
              "limit": ATOL_F32})
        require(err <= ATOL_F32,
                f"K2 dropout plant {P, L, D}: {err} from the survivor mean")
        require(leak_err > ATOL_F32,
                f"K2 dropout plant {P, L, D}: orphaned streams within the "
                "limit, the check sees nothing")


def check_realizations(cfg, spec, P) -> None:
    """Every realized A_i of ``spec`` over the run is symmetric, doubly
    stochastic, nonnegative and connected."""
    import numpy as np
    from repro_torch.core.resilience import TopologyProcess
    from repro_torch.core.simulate import base_combination_matrix
    from repro_torch.core.topology import spectral_gap

    proc = TopologyProcess(base_combination_matrix(cfg, P), spec,
                           seed=cfg.topology_seed)
    for i in range(ITERS):
        A = proc.realize(i).A
        require(bool(np.allclose(A, A.T, atol=1e-12))
                and bool(np.allclose(A.sum(0), 1.0, atol=1e-12))
                and bool(np.allclose(A.sum(1), 1.0, atol=1e-12))
                and bool((A >= 0).all()) and spectral_gap(A) < 1.0,
                f"{spec}: A_{i} breaks Assumption 1")


def phase_resilience(torch, prob):
    """gfl-logreg at full size under the resilience runtime: the six
    regimes of ``launch/resilience_demo.py`` under hybrid and the last one
    under every mechanism, kernels on and off on the same seeds; a null
    fault spec bitwise equal to the static path; K2's dropout plant; then
    ``launch/fault_sweep.py`` at its defaults."""
    from dataclasses import replace
    import numpy as np
    from repro_torch import kernels as K, rng
    from repro_torch.configs import gfl_logreg
    from repro_torch.core.privacy.accountant import epsilon_at
    from repro_torch.core.privacy.mechanism import list_mechanisms
    from repro_torch.core.simulate import run_gfl
    from repro_torch.launch import fault_sweep
    from repro_torch.launch.resilience_demo import REGIMES

    base = gfl_logreg.GFL
    P = base.num_servers
    eps_budget = epsilon_at(ITERS, base.mu, base.grad_bound, base.sigma_g)
    everything = REGIMES[-1]
    runs = [(name, spec, "hybrid") for name, spec in REGIMES] + [
        (everything[0], everything[1], s) for s in list_mechanisms()
        if s != "hybrid"]
    totals = {name: 0 for name in K.LAUNCHES}
    walls = {}
    for name, spec, scheme in runs:
        cfg = replace(base, privacy=scheme, epsilon_target=eps_budget,
                      epsilon_horizon=ITERS, fault=spec,
                      topology_seed=RES_TOPOLOGY_SEED, use_kernels=True)
        on_g = timed_run(torch, prob, cfg, ITERS, 1, record_gaps=True)
        msd_on, p_on, wall_on, launches = on_g[:4]
        gaps = on_g[5]
        for k, n in launches.items():
            totals[k] += n
        off = replace(cfg, use_kernels=False)
        off_g = timed_run(torch, prob, off, ITERS, 1)
        msd_off, p_off, wall_off = off_g[:3]
        walls[(spec, scheme)] = wall_on
        wall_eager = None
        if spec == everything[1]:
            on_e = timed_run(torch, prob, cfg, ITERS, 1, "eager")
            wall_eager = on_e[2]
            require_graph_is_eager(torch, f"{name} / {scheme}, kernels on",
                                   on_g, on_e)
            require_graph_is_eager(torch, f"{name} / {scheme}, kernels off",
                                   off_g, timed_run(torch, prob, off, ITERS,
                                                    1, "eager"))
        p_err = float((p_on - p_off).abs().max())
        msd_err = float(np.max(np.abs(msd_on - msd_off)))
        realize_ms = None
        if spec != "none":
            check_realizations(cfg, spec, P)
            realize_ms = fault_sweep.realize_ms(cfg, P, spec, ITERS)
        emit({"phase": "resilience", "regime": name, "fault": spec,
              "scheme": scheme, "msd_tail": float(np.mean(msd_on[-50:])),
              "gap_mean": float(gaps.mean()), "gap_worst": float(gaps.max()),
              "wall_ms_per_round": wall_on * 1e3 / ITERS,
              "wall_ms_per_round_kernels_off": wall_off * 1e3 / ITERS,
              "wall_ms_per_round_eager": (None if wall_eager is None
                                          else wall_eager * 1e3 / ITERS),
              "graph_is_eager": wall_eager is not None or None,
              "host_realize_ms_per_round": realize_ms,
              "host_realize_share": (realize_ms / (wall_on * 1e3 / ITERS)
                                     if realize_ms is not None else None),
              "launches": launches, "params_max_abs_diff": p_err,
              "msd_max_abs_diff": msd_err})
        require(bool(np.all(np.isfinite(msd_on)))
                and bool(np.all(np.isfinite(msd_off))),
                f"{name} / {scheme}: non-finite MSD")
        for k in EXPECT[scheme]:
            require(launches[k] > 0,
                    f"{name} / {scheme}: kernel {k} was never launched")
        require(p_err <= PARAMS_ATOL
                and bool(np.allclose(msd_on, msd_off, rtol=MSD_RTOL,
                                     atol=MSD_ATOL)),
                f"{name} / {scheme}: kernels on/off differ (params {p_err}, "
                f"msd {msd_err})")
    for use_kernels in (True, False):
        cfg = replace(base, use_kernels=use_kernels)
        msd_s, p_s = run_gfl(prob, cfg, iters=ITERS, batch_size=10, seed=1)
        null = replace(cfg, fault=RES_NULL_SPEC)
        null_g = timed_run(torch, prob, null, ITERS, 1)
        msd_n, p_n = null_g[:2]
        same = bool(torch.equal(p_s, p_n)) and msd_s.tolist() == msd_n.tolist()
        emit({"phase": "resilience", "null_fault": RES_NULL_SPEC,
              "use_kernels": use_kernels, "bitwise_equal_to_static": same})
        require(same, f"fault {RES_NULL_SPEC} differs from the static path "
                f"(use_kernels={use_kernels})")
        require_graph_is_eager(
            torch, f"{RES_NULL_SPEC}, use_kernels {use_kernels}", null_g,
            timed_run(torch, prob, null, ITERS, 1, "eager"))
    dropout_plant(torch, rng(3, "cuda"))
    K.reset_launches()
    t0 = time.perf_counter()
    rows, summary = fault_sweep.run(device="cuda")
    torch.cuda.synchronize()
    sweep_launches = dict(K.LAUNCHES)
    for row in rows:
        emit({"phase": "resilience", "fault_sweep": list(row)})
        require(bool(np.isfinite(row[3])), f"fault_sweep {row}: non-finite")
    for k in ("fold_norms", "fold_apply", "graph_combine"):
        require(sweep_launches[k] > 0, f"fault_sweep: {k} never launched")
    emit({"phase": "resilience", "fault_sweep_summary": dict(summary),
          "wall_s": time.perf_counter() - t0, "launches": sweep_launches,
          "launches_regimes": totals,
          "wall_ms_per_round_static": walls[("none", "hybrid")] * 1e3 / ITERS,
          "wall_ms_per_round_everything": walls[(everything[1], "hybrid")]
          * 1e3 / ITERS})


# -------------------------------------------------------------- profile


LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                "cudaGraphLaunch")
# K1-K3's device kernels, by the names csrc/ gives them
ROUND_KERNEL_SYMBOLS = {"fold_norms": ("norms_rows", "norms_split"),
                        "fold_apply": ("fold_apply_kernel",),
                        "graph_combine": ("combine_kernel",)}
PROFILE_ROUNDS = 50
TOP_KERNELS = 8       # device kernels a profile names, by time
STEADY_ROUNDS = (100, 600)  # wall a round: the difference of two runs
STEADY_REPEATS = 3


def steady_ms(torch, run, executor, rounds=STEADY_ROUNDS) -> float:
    """Wall ms a round in steady state, without the profiler: the median
    over STEADY_REPEATS of the difference of a long and a short run
    (``run(iters, executor)``) over their difference in rounds, so the
    round graph's warm-up and capture (and the eager run's first round)
    cancel."""
    import statistics

    short, long_ = rounds
    diffs = []
    for _ in range(STEADY_REPEATS):
        walls = []
        for n in (short, long_):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(n, executor)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        diffs.append((walls[1] - walls[0]) * 1e3 / (long_ - short))
    return statistics.median(diffs)


def gfl_runner(prob, cfg):
    """``run(iters, executor)`` of ``run_gfl`` on ``prob`` (seed 2)."""
    from repro_torch.core.simulate import run_gfl

    def run(iters, executor):
        return run_gfl(prob, cfg, iters=iters, batch_size=10, seed=2,
                       executor=executor)
    return run


def profile_run(torch, run, executor, rounds=PROFILE_ROUNDS) -> dict:
    """torch.profiler over one ``rounds``-round ``run(iters, executor)``.  For the round graph
    the window opens at the first ``cudaGraphLaunch`` (after the warm-up
    round and the capture) and a round is a replay; eagerly it opens at
    the run's first device op.  It closes at the last device op's end.
    Per round: the window's length, device busy ms and ops, host launch
    calls by name, the TOP_KERNELS device kernels that take the most time
    (name, µs and ops a round), and the K1-K3 device kernels by the host
    call that launched them (CUPTI's correlation id: ``cudaLaunchKernel`` or
    ``cudaGraphLaunch``); the idle share is the window's.  Under the graph,
    the host's share: its time from the end of one ``cudaGraphLaunch`` to
    the start of the next (the round's stage), over the span from the
    first replay's start to the last's.  The tracer
    lengthens small kernels, so busy time here can exceed a round's
    wall time measured without it (``steady_ms``).  Device records and
    host calls are each compared on their own clock (the profiler moves
    the device's onto the host's with an offset that can be milliseconds
    off, see ``traced``): the device window opens at the first device
    op of the first replay (or of the run), and host calls are counted
    from the first ``cudaGraphLaunch`` (eagerly, all of them: the trace
    holds the run alone).  The trace is ``traced``'s, unfenced (the
    K1-K3 counts a replay are the phases' gates); its markers are left
    out of every count."""
    from repro_torch import kernels as K

    def block():
        K.reset_launches()
        run(rounds, executor)

    run(5, executor)
    tr = traced(torch, block, f"profile: {rounds} {executor} rounds",
                fenced=False)
    wrapper_calls = {k: K.LAUNCHES[k] - K.REPLAYED[k] for k in ROUND_KERNELS}
    events, device = tr["events"], tr["device"]
    require(bool(device), f"profile: no device op in the trace of {rounds} "
            f"{executor} rounds")
    calls = [e for e in events if e.name in LAUNCH_CALLS
             and e.id not in tr["marker_ids"]]
    graph_launches = [e.time_range.start for e in calls
                      if e.name == "cudaGraphLaunch"]
    by_call = {e.id: e.name for e in calls}
    # the device window on the device's clock, host calls on the host's
    first = min(e.time_range.start for e in device)
    if executor == "graph" and graph_launches:
        lo = min((e.time_range.start for e in device
                  if by_call.get(e.id) == "cudaGraphLaunch"), default=first)
        host_lo = min(graph_launches)
    else:
        lo, host_lo = first, float("-inf")    # the trace holds the run alone
    hi = max(e.time_range.end for e in device)
    n = len(graph_launches) if executor == "graph" else rounds
    # the host between replays: from the end of one cudaGraphLaunch to the
    # start of the next (the round's host stage), over those replays' span
    replays = sorted((e.time_range.start, e.time_range.end) for e in calls
                     if e.name == "cudaGraphLaunch")
    host_share = (sum(b[0] - a[1] for a, b in zip(replays, replays[1:]))
                  / (replays[-1][0] - replays[0][0])
                  if len(replays) > 1 else None)
    launch_calls = {name: 0 for name in LAUNCH_CALLS}
    for e in calls:
        if e.time_range.start >= host_lo:
            launch_calls[e.name] += 1
    busy, ops, k13, by_name = 0.0, 0, {}, {}
    for e in device:
        if e.time_range.start < lo:
            continue
        busy += e.time_range.elapsed_us()
        ops += 1
        t_ops = by_name.setdefault(e.name[:80], [0.0, 0])
        t_ops[0] += e.time_range.elapsed_us()
        t_ops[1] += 1
        for k, symbols in ROUND_KERNEL_SYMBOLS.items():
            if any(sym in e.name for sym in symbols):
                via = by_call.get(e.id, "unlinked")
                k13[f"{k}/{via}"] = k13.get(f"{k}/{via}", 0) + 1
    return {"rounds_in_window": n, "graph_launches": len(graph_launches),
            "window_ms_per_round": (hi - lo) / 1e3 / n if n else None,
            "device_idle_share": 1.0 - busy / (hi - lo) if n else None,
            "device_busy_ms_per_round": busy / 1e3 / n if n else None,
            "device_ops_per_round": ops / n if n else None,
            "launch_calls_per_round": {k: v / n for k, v in
                                       launch_calls.items()} if n else None,
            "round_kernels_by_launch_call": k13,
            "host_share_between_replays": host_share,
            "wrapper_launches": wrapper_calls,
            # the device kernels that take the most time: (name, us and
            # ops a round)
            "top_device_kernels": [
                (name, t / n, c / n) for name, (t, c) in sorted(
                    by_name.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]]
            if n else None}


def phase_profile(torch, prob):
    """Where a hybrid round's time goes under each executor, at the main
    path's shape (L = 50) and the Fig. 2 shape (L = 10): steady wall ms a
    round, and from torch.profiler the device busy time, idle share,
    device ops and host launch calls a round.  The round graph must be
    replayed at most once a round, and after its capture no K1-K3 kernel
    may come from a wrapper's launch (the wrappers run only in the warm-up
    round)."""
    from dataclasses import replace
    from repro_torch.configs import gfl_logreg

    shapes = [("main", replace(gfl_logreg.GFL, privacy="hybrid",
                               use_kernels=True)),
              ("main, kernels off", replace(gfl_logreg.GFL,
                                            privacy="hybrid")),
              ("fig2", fig2_config(0.2, "hybrid"))]
    for shape, cfg in shapes:
        for executor in ("graph", "eager"):
            rec = profile_run(torch, gfl_runner(prob, cfg), executor)
            wall = steady_ms(torch, gfl_runner(prob, cfg), executor)
            emit({"phase": "profile", "scheme": "hybrid", "shape": shape,
                  "clients_sampled": cfg.clients_sampled,
                  "use_kernels": cfg.use_kernels, "executor": executor,
                  "wall_ms_per_round": wall,
                  "busy_over_wall": rec["device_busy_ms_per_round"] / wall,
                  **rec})
            if executor != "graph":
                continue
            if shape == "main":
                PROFILED["main"] = rec["device_ops_per_round"]
            require(0 < rec["graph_launches"] <= PROFILE_ROUNDS,
                    f"profile {shape}: {rec['graph_launches']} graph "
                    f"launches in {PROFILE_ROUNDS} rounds")
            by_call = rec["round_kernels_by_launch_call"]
            require(not any(k.endswith("/cudaLaunchKernel") for k in by_call),
                    f"profile {shape}: K1-K3 launched by cudaLaunchKernel "
                    f"after the capture: {by_call}")
            if cfg.use_kernels:
                require(all(v == 1 for v in rec["wrapper_launches"].values()),
                        f"profile {shape}: wrapper launches "
                        f"{rec['wrapper_launches']}, expected one each (the "
                        "warm-up round)")
                require(all(by_call.get(f"{k}/cudaGraphLaunch")
                            == rec["rounds_in_window"] for k in ROUND_KERNELS),
                        f"profile {shape}: K1-K3 kernels {by_call} in "
                        f"{rec['rounds_in_window']} replays, expected one "
                        "each a replay")


# ------------------------------------------------------------ population

POP_ITERS = 120                 # examples/population_demo.py's rounds
POP_EVERYTHING = ("synthetic:mixture",
                  "importance,floor=0.2+trace:diurnal,period=24,min=0.2",
                  "links:0.2+dropout:0.3")
POP_EVERYTHING_ITERS = 60
POP_DIRICHLET = ("dirichlet:0.3", 1000)    # spec, K: the pool is P K 20
POP_STEADY_ROUNDS = (30, 130)
POP_STAGE_ROUNDS = 100
# (P, L, D, topology): the demo's weighted rounds (hypercube, L = 20), a
# wide row at the demo's P and L, and the bench's rounds (ring, L = 10)
POP_FOLD_SHAPES = [(8, 20, 2, "hypercube"), (8, 20, 4096, "hypercube"),
                   (8, 10, 2, "ring")]
POP_ONOFF_ROUNDS = 10       # rounds whose MSD kernels on and off must share
POP_FOLD_SIGMA = 0.2


def pop_run(torch, pop, cfg, iters, w_ref, executor=None, seed=1):
    """(result, wall s, launches, replayed) of one ``run_gfl_population``,
    its launch counts set to 0 just before (``pop`` None: built from
    ``cfg.population``)."""
    from repro_torch import kernels as K
    from repro_torch.core.population import run_gfl_population

    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_gfl_population(pop, cfg, iters=iters, batch_size=10,
                             seed=seed, w_ref=w_ref, executor=executor,
                             device="cuda")
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dict(K.LAUNCHES), dict(K.REPLAYED)


def require_pop_graph_is_eager(torch, what, graph, eager, cfg) -> dict:
    """A population run under the round graph against the eager executor on
    the same seed: params, MSD, q, the IS state and the gaps bitwise
    equal, the same launch counts, the wrappers launching K1-K3 only in the
    warm-up round; q in (0, 1], finite MSD, and the run's amplified epsilon
    equal to the one recomputed from its q trace."""
    import numpy as np
    from repro_torch.core.privacy.mechanism import mechanism_for

    res_g, wall_g, launches_g, replayed = graph
    res_e, wall_e, launches_e, _ = eager
    same = (bool(torch.equal(res_g.params, res_e.params))
            and res_g.msd.tolist() == res_e.msd.tolist()
            and res_g.q.tolist() == res_e.q.tolist())
    if res_g.scheduler.is_state is not None:
        same = same and all(bool(torch.equal(a, b)) for a, b in zip(
            res_g.scheduler.is_state, res_e.scheduler.is_state))
    if res_g.gaps is not None:
        same = same and bool(np.array_equal(res_g.gaps, res_e.gaps))
    require(same, f"population {what}: the round graph differs from the "
            "eager executor")
    require(launches_g == launches_e,
            f"population {what}: launches {launches_g} under the graph, "
            f"{launches_e} eagerly")
    for name in ROUND_KERNELS:
        calls = launches_g[name] - replayed[name]
        require(calls <= 1 and (calls > 0) == (launches_g[name] > 0),
                f"population {what}: {name} launched by its wrapper {calls} "
                "times under the graph, expected once (the warm-up round)")
    require(bool(np.all(np.isfinite(res_g.msd))),
            f"population {what}: non-finite MSD")
    require(bool(np.all((res_g.q > 0) & (res_g.q <= 1))),
            f"population {what}: q outside (0, 1]")
    acc = mechanism_for(cfg).accountant()
    for qi in res_g.q:
        acc.advance(1, q=float(qi))
    eps_amp = res_g.accountant.amplified_epsilon()
    require(eps_amp == acc.amplified_epsilon(),
            f"population {what}: amplified epsilon {eps_amp} against "
            f"{acc.amplified_epsilon()} from the q trace")
    return {"wall_s": wall_g, "wall_s_eager": wall_e,
            "msd_tail": float(np.mean(res_g.msd[-max(len(res_g.msd) // 10,
                                                      1):])),
            "q_mean": float(res_g.q.mean()), "q_max": float(res_g.q.max()),
            "epsilon": res_g.accountant.epsilon(),
            "epsilon_amplified": eps_amp, "launches": launches_g,
            "replayed": replayed}


def require_pop_kernels_are_plain(torch, cohort, on, off) -> dict:
    """The same seed's run with the kernels (K1-K3) and without them (the
    reference's ops): the MSD of the first POP_ONOFF_ROUNDS rounds within
    rtol 1e-4.  Where the draws do not read the sampler's feedback (no
    importance sampler), the final params within atol 1e-4 too; under
    importance sampling norms that differ in the last bits may, rarely,
    tip a later draw across a CDF step, after which the runs part."""
    import numpy as np

    n = POP_ONOFF_ROUNDS
    msd_rel = float(np.max(np.abs(on.msd[:n] / off.msd[:n] - 1)))
    require(msd_rel <= 1e-4, f"population {cohort}: the MSD of the first "
            f"{n} rounds with the kernels and without differ by {msd_rel} "
            "(relative)")
    rec = {"kernels_against_plain": {"msd_rel_err_first_rounds": msd_rel,
                                     "rounds": n}}
    if off.scheduler.is_state is None:
        err = float((on.params - off.params).abs().max())
        require(err <= 1e-4, f"population {cohort}: final params with the "
                f"kernels and without differ by {err}")
        rec["kernels_against_plain"]["params_max_abs_err"] = err
    return rec


def importance_check(torch) -> None:
    """``simulate.run_gfl_importance`` on the gfl-logreg problem (P=10,
    K=50, N=100, L=50, kernels on) under both executors: bitwise equal,
    finite, K1-K3 launched."""
    import numpy as np
    from dataclasses import replace
    from repro_torch import kernels as K, rng
    from repro_torch.configs import gfl_logreg
    from repro_torch.core.simulate import generate_problem, run_gfl_importance

    prob = generate_problem(rng(0, "cuda"), P=10, K=50, N=100, M=2)
    cfg = replace(gfl_logreg.GFL, use_kernels=True)
    out = {}
    for executor in ("graph", "eager"):
        K.reset_launches()
        out[executor] = (*run_gfl_importance(prob, cfg, iters=200,
                                             seed=1, executor=executor),
                         dict(K.LAUNCHES))
    (msd_g, p_g, l_g), (msd_e, p_e, l_e) = out["graph"], out["eager"]
    require(bool(torch.equal(p_g, p_e)) and msd_g.tolist() == msd_e.tolist()
            and l_g == l_e, "run_gfl_importance: the round graph differs "
            "from the eager executor")
    require(bool(np.all(np.isfinite(msd_g)))
            and all(l_g[k] > 0 for k in ROUND_KERNELS),
            f"run_gfl_importance: MSD finite {np.isfinite(msd_g).all()}, "
            f"launches {l_g}")
    emit({"phase": "population", "entry": "run_gfl_importance",
          "msd_tail": float(np.mean(msd_g[-20:])), "launches": l_g,
          "graph_is_eager": True})


def pop_scale_rows(torch):
    """``python -m repro_torch.launch.population_scale`` at its defaults,
    as a user runs it (its own process: its peak bytes are its run's):
    every K's row, its peak below the dense budget (the entry asserts it
    too and exits non-zero)."""
    import csv
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m",
                          "repro_torch.launch.population_scale"],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=600)
    require(out.returncode == 0, "population_scale exited "
            f"{out.returncode}: {out.stderr[-2000:]}")
    lines = [ln for ln in out.stdout.splitlines() if not ln.startswith("#")]
    header, *rows = csv.reader(lines[:4])
    rows = [dict(zip(header, r)) for r in rows]
    for r in rows:
        require(int(r["peak_bytes"]) < int(r["budget_bytes"]),
                f"population_scale K={r['virtual_K']}: peak "
                f"{r['peak_bytes']} bytes, budget {r['budget_bytes']}")
        emit({"phase": "population", "bench": "population_scale", **r})
    emit({"phase": "population", "bench": "population_scale",
           "seconds": time.perf_counter() - t0, "tail": lines[4:]})
    return rows


def pop_fold_check(torch, gen) -> float:
    """K1 + K2 through ``ops.round_fold`` on the weighted path's inputs:
    importance weights spread over 1e-3 .. 1e3 before the clip, about a
    third of the clients dropped (survivor fold and noise weights), in
    every mode, against ``round_fold_ref`` on the same inputs (psi atol
    1e-5, sq rtol 1e-5); launched once a call, twice bitwise equal.  Then
    K3 (``ops.graph_combine``) on that psi with the path's combination
    matrix and a homomorphic noise term, against ``graph_combine_ref``
    (atol 1e-5)."""
    from dataclasses import replace

    from repro_torch import kernels as K
    from repro_torch.configs import gfl_logreg
    from repro_torch.core import gfl
    from repro_torch.core.simulate import base_combination_matrix
    from repro_torch.kernels import ops, ref

    worst = 0.0
    for P, L, D, topology in POP_FOLD_SHAPES:
        A = torch.as_tensor(base_combination_matrix(
            replace(gfl_logreg.GFL, num_servers=P, topology=topology), P),
            dtype=torch.float32, device="cuda")
        w = torch.randn((P, D), generator=gen, device="cuda")
        g = 3 * torch.randn((P, L, D), generator=gen, device="cuda")
        pre_w = 10.0 ** (6 * torch.rand((P, L), generator=gen,
                                        device="cuda") - 3)
        alive = torch.rand((P, L), generator=gen, device="cuda") > 0.3
        alive[:, 0] = True
        fold_w, noise_w = gfl._survivor_weights(alive)
        noise = 0.3 * torch.randn((P, L, D), generator=gen, device="cuda")
        gn = POP_FOLD_SIGMA * torch.randn((P, D), generator=gen,
                                          device="cuda")
        seeds = torch.arange(P, device="cuda", dtype=torch.int64) * 7919 + 3
        for mode in ("none", "laplace", "mask"):
            kw = dict(mu=0.1, bound=10.0, pre_w=pre_w, fold_w=fold_w,
                      noise_w=noise_w, mode=mode, sigma=POP_FOLD_SIGMA,
                      seeds=seeds if mode == "mask" else None,
                      noise=noise if mode == "laplace" else None)
            before = dict(K.LAUNCHES)
            (psi, sq), again = (ops.round_fold(w, g, **kw)
                                for _ in range(2))
            out = ops.graph_combine(A, psi, gn)
            torch.cuda.synchronize()
            require(bool(torch.equal(psi, again[0]))
                    and bool(torch.equal(sq, again[1])),
                    f"weighted fold {mode}: two runs differ")
            require(all(K.LAUNCHES[k] - before[k] == n for k, n in
                        (("fold_norms", 2), ("fold_apply", 2),
                         ("graph_combine", 1))),
                    f"weighted fold {mode}: K1/K2/K3 not launched once a "
                    "call")
            want_psi, want_sq = ref.round_fold_ref(w, g, **kw)
            name = f"weighted fold {mode} ({P}, {L}, {D})"
            err = check_close(torch, name, psi, want_psi, torch.float32)
            check_close(torch, f"{name} sq", sq, want_sq, torch.float32,
                        norms=True)
            err_k3 = check_close(torch, f"{name} combine ({topology})", out,
                                 ref.graph_combine_ref(A.T, psi, gn),
                                 torch.float32)
            worst = max(worst, err, err_k3)
            emit({"phase": "population", "check": "weighted_fold",
                  "shape": [P, L, D], "topology": topology, "mode": mode,
                  "max_abs_err": err, "combine_max_abs_err": err_k3,
                  "pre_w_range": [float(pre_w.min()), float(pre_w.max())],
                  "alive": int(alive.sum())})
    return worst


def pop_host_stage(torch, pop, cfg) -> dict:
    """Host ms a round of the weighted round's host stage
    (``StagedWeightedStep.stage``: availability [P, K] and the dropout mask
    realized in numpy and staged through pinned slots, A_i, the draws
    reseeded) and of the availability realization alone."""
    from repro_torch.core.population import CohortScheduler
    from repro_torch.core.population.engine import StagedWeightedStep
    from repro_torch.core.resilience import TopologyProcess
    from repro_torch.core.simulate import base_combination_matrix, make_grad_fn
    from repro_torch.draws import Draws

    A = base_combination_matrix(cfg, pop.P)
    proc = (None if cfg.fault == "none" else
            TopologyProcess(A, cfg.fault, seed=cfg.topology_seed))
    sched = CohortScheduler.from_config(cfg)
    sched.place("cuda")
    step = StagedWeightedStep(pop, cfg, sched, proc, A,
                              make_grad_fn(pop.rho), 10, POP_STAGE_ROUNDS,
                              torch.device("cuda"))
    draws = Draws(3, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(POP_STAGE_ROUNDS):
        step.stage(i, draws)
    torch.cuda.synchronize()
    stage_ms = (time.perf_counter() - t0) * 1e3 / POP_STAGE_ROUNDS
    t0 = time.perf_counter()
    for i in range(POP_STAGE_ROUNDS):
        sched.availability(i)
    avail_ms = (time.perf_counter() - t0) * 1e3 / POP_STAGE_ROUNDS
    return {"host_stage_ms_per_round": stage_ms,
            "availability_ms_per_round": avail_ms}


def phase_population(torch):
    """The population engine's weighted path at the demo's full size (P=8,
    K=10^5, L=20, N=100, 120 rounds, hypercube, hybrid): the demo entry as
    a user runs it, its three cohort specs under both executors with
    kernels on and off, "everything on", a weighted round's time and host
    stage, the weighted fold, and the bench's K sweep."""
    from dataclasses import replace

    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.core.population import (estimate_w_ref,
                                             population_from_spec)
    from repro_torch.launch import population_demo as demo

    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    fold_err = pop_fold_check(torch, gen)
    # the entry, counts from 0 just before
    K.reset_launches()
    t0 = time.perf_counter()
    rows, eps = demo.run(device="cuda")
    torch.cuda.synchronize()
    launches, replayed = dict(K.LAUNCHES), dict(K.REPLAYED)
    emit({"phase": "population", "entry": "population_demo",
          "seconds": time.perf_counter() - t0,
          "rows": [(c, t, q) for c, t, q, _ in rows], **eps,
          "launches": launches, "replayed": replayed})
    for name in ROUND_KERNELS:
        require(launches[name] > 0 and replayed[name] > 0,
                f"population_demo: {name} launched {launches[name]} times, "
                f"{replayed[name]} from replays")
    for cohort, tail, q_mean, _ in rows:
        require(bool(np.isfinite(tail)) and 0 < q_mean <= 1,
                f"population_demo {cohort}: tail {tail}, q {q_mean}")
    base = demo.base_config()
    pop = population_from_spec(base, device="cuda")
    w_ref = estimate_w_ref(pop, sample_clients=64, iters=1500)
    for cohort in demo.COHORTS:
        runs = {}
        for use_kernels in (True, False):
            cfg = replace(base, cohort=cohort, use_kernels=use_kernels)
            what = f"{cohort}, use_kernels {use_kernels}"
            graph = pop_run(torch, pop, cfg, POP_ITERS, w_ref)
            rec = require_pop_graph_is_eager(
                torch, what, graph,
                pop_run(torch, pop, cfg, POP_ITERS, w_ref, "eager"), cfg)
            if use_kernels:
                for name in ROUND_KERNELS:
                    require(rec["launches"][name] > 0,
                            f"population {what}: {name} never launched")
            runs[use_kernels] = graph[0]
            emit({"phase": "population", "cohort": cohort,
                  "use_kernels": use_kernels, "iters": POP_ITERS,
                  "graph_is_eager": True, **rec})
        emit({"phase": "population", "cohort": cohort,
              **require_pop_kernels_are_plain(torch, cohort, runs[True],
                                              runs[False])})
    population, cohort, fault = POP_EVERYTHING
    pop_mix = population_from_spec(replace(base, population=population),
                                   device="cuda")
    w_mix = estimate_w_ref(pop_mix, sample_clients=64, iters=1500)
    for scheme in ("hybrid", "iid_dp"):
        for use_kernels in (True, False):
            cfg = replace(base, population=population, cohort=cohort,
                          fault=fault, privacy=scheme,
                          use_kernels=use_kernels, topology_seed=7)
            what = f"everything on, {scheme}, use_kernels {use_kernels}"
            graph = pop_run(torch, pop_mix, cfg, POP_EVERYTHING_ITERS, w_mix)
            rec = require_pop_graph_is_eager(
                torch, what, graph,
                pop_run(torch, pop_mix, cfg, POP_EVERYTHING_ITERS, w_mix,
                        "eager"), cfg)
            require(bool(np.all(graph[0].gaps < 1.0)),
                    f"population {what}: a realized A_i does not mix")
            emit({"phase": "population", "everything_on": True,
                  "scheme": scheme, "use_kernels": use_kernels,
                  "spec": POP_EVERYTHING, "iters": POP_EVERYTHING_ITERS,
                  "graph_is_eager": True, **rec})
    # the other ways in: a Dirichlet population built from the config,
    # and run_gfl_importance on the gfl-logreg problem
    population, K_d = POP_DIRICHLET
    for cohort in demo.COHORTS[1:]:
        for fault_d in ("none", fault):
            cfg = replace(base, clients_per_server=K_d,
                          population=population, cohort=cohort,
                          fault=fault_d)
            what = f"{population} K={K_d}, {cohort}, fault {fault_d}"
            rec = require_pop_graph_is_eager(
                torch, what,
                pop_run(torch, None, cfg, POP_EVERYTHING_ITERS, None),
                pop_run(torch, None, cfg, POP_EVERYTHING_ITERS, None,
                        "eager"), cfg)
            emit({"phase": "population", "population": population,
                  "clients_per_server": K_d, "cohort": cohort,
                  "fault": fault_d, "graph_is_eager": True, **rec})
    importance_check(torch)
    # a weighted round's time: the demo's importance + trace spec
    cfg = replace(base, cohort=demo.COHORTS[2])

    def run(iters, executor):
        return pop_run(torch, pop, cfg, iters, w_ref, executor, seed=2)

    timing = {}
    for executor in ("graph", "eager"):
        rec = profile_run(torch, run, executor)
        wall = steady_ms(torch, run, executor, POP_STEADY_ROUNDS)
        timing[executor] = (wall, rec)
        emit({"phase": "population", "timing": cfg.cohort,
              "executor": executor, "wall_ms_per_round": wall,
              "busy_over_wall": rec["device_busy_ms_per_round"] / wall,
              **rec})
    stage = pop_host_stage(torch, pop, cfg)
    traced = timing["graph"][1]
    require(traced["host_share_between_replays"] is not None,
            "population timing: no two replays in the traced graph run")
    emit({"phase": "population", "timing": cfg.cohort, **stage,
          "host_share_of_traced_graph_round":
              traced["host_share_between_replays"],
          "stage_alone_over_graph_round_wall":
              stage["host_stage_ms_per_round"] / timing["graph"][0],
          "graph_ms_per_round": timing["graph"][0],
          "eager_ms_per_round": timing["eager"][0]})
    scale = pop_scale_rows(torch)
    return {"launches": launches, "fold_err": fold_err,
            "client_steps_per_sec_K1e5":
                float(scale[-1]["client_steps_per_sec"])}


# ---------------------------------------------------------------- events

# the reference docs' configuration (docs/async.md) at the population
# demo's scale: P=8, K=10^5, N=100, M=2, hypercube, hybrid
EV_P, EV_K = 8, 100_000
EV_TICKS = 500
EV_SPEC = "async:buffer=8,latency=lognorm:0.5,max_stale=4"
EV_DIURNAL = "trace:diurnal,period=24,min=0.2"
# (name, cohort, fault): the docs' run, importance sampling, link faults
EV_CASES = (("uniform+trace", "uniform+" + EV_DIURNAL, "none"),
            ("importance+trace", "importance,floor=0.2+" + EV_DIURNAL,
             "none"),
            ("uniform+trace, links", "uniform+" + EV_DIURNAL, "links:0.2"))
EV_FOLD_SHAPES = [(8, 8, 2), (8, 6, 509), (8, 8, 4096)]   # (P, E, D)
EV_FOLD_SIGMA = 0.2
EV_ONOFF_TICKS = 10     # ticks whose MSD kernels on and off must share
EV_SYNC = ("async:buffer=10", 10, 500)   # spec, clients_sampled, ticks
EV_STEADY_TICKS = (100, 600)


def events_config(cohort, fault="none", use_kernels=True):
    from repro_torch.configs.base import GFLConfig
    return GFLConfig(num_servers=EV_P, clients_per_server=EV_K,
                     topology="hypercube", privacy="hybrid", sigma_g=0.2,
                     mu=0.1, grad_bound=10.0, population="synthetic:hetero",
                     cohort=cohort, fault=fault, async_spec=EV_SPEC,
                     use_kernels=use_kernels, topology_seed=7)


def event_fold_check(torch, gen) -> float:
    """The event tick's fold, K1 + K2 through ``ops.round_fold``, on its
    inputs: per-event bases [P, E, D] (the stale snapshots), staleness
    weights 1/(1 + age)^0.5 as ``fold_w``, about a third of the events
    invalid (fold weight 0, ``noise_w`` = valid / n_valid), importance
    weights spread over 1e-3 .. 1e3 as ``pre_w``, in every mode against
    ``round_fold_ref`` (psi atol 1e-5, sq rtol 1e-5), launched once a
    call, twice bitwise equal.  Then K3's gate/cache variant on that psi
    with the hypercube's matrix and a homomorphic noise term, at the
    all-zero, a mixed and the all-one gate, against ``graph_combine_ref``
    of the selected psi (the kernels-off order: select, then combine),
    twice bitwise equal."""
    from dataclasses import replace

    from repro_torch import kernels as K
    from repro_torch.core.events import staleness_weights
    from repro_torch.core.simulate import base_combination_matrix
    from repro_torch.kernels import ops, ref

    worst = 0.0
    for P, E, D in EV_FOLD_SHAPES:
        A = torch.as_tensor(base_combination_matrix(
            replace(events_config("uniform"), num_servers=P), P),
            dtype=torch.float32, device="cuda")
        w = torch.randn((P, E, D), generator=gen, device="cuda")
        g = 3 * torch.randn((P, E, D), generator=gen, device="cuda")
        pre_w = 10.0 ** (6 * torch.rand((P, E), generator=gen,
                                        device="cuda") - 3)
        valid = torch.rand((P, E), generator=gen, device="cuda") > 1 / 3
        valid[:, 0] = True
        ages = torch.randint(0, 5, (P, E), generator=gen, device="cuda")
        fold_w = staleness_weights(ages, 0.5) * valid
        noise_w = valid.float() / valid.sum(dim=1, keepdim=True)
        noise = 0.3 * torch.randn((P, E, D), generator=gen, device="cuda")
        seeds = torch.arange(P, device="cuda", dtype=torch.int64) * 7919 + 5
        for mode in ("none", "laplace", "mask"):
            kw = dict(mu=0.1, bound=10.0, pre_w=pre_w, fold_w=fold_w,
                      noise_w=noise_w, mode=mode, sigma=EV_FOLD_SIGMA,
                      seeds=seeds if mode == "mask" else None,
                      noise=noise if mode == "laplace" else None)
            before = dict(K.LAUNCHES)
            (psi, sq), again = (ops.round_fold(w, g, **kw) for _ in range(2))
            torch.cuda.synchronize()
            require(bool(torch.equal(psi, again[0]))
                    and bool(torch.equal(sq, again[1])),
                    f"event fold {mode}: two runs differ")
            require(all(K.LAUNCHES[k] - before[k] == 2
                        for k in ("fold_norms", "fold_apply")),
                    f"event fold {mode}: K1/K2 not launched once a call")
            want_psi, want_sq = ref.round_fold_ref(w, g, **kw)
            name = f"event fold {mode} ({P}, {E}, {D})"
            err = check_close(torch, name, psi, want_psi, torch.float32)
            check_close(torch, f"{name} sq", sq, want_sq, torch.float32,
                        norms=True)
            worst = max(worst, err)
            emit({"phase": "events", "check": "event_fold",
                  "shape": [P, E, D], "mode": mode, "max_abs_err": err,
                  "pre_w_range": [float(pre_w.min()), float(pre_w.max())],
                  "valid": int(valid.sum())})
        cache = torch.randn((P, D), generator=gen, device="cuda")
        gn = EV_FOLD_SIGMA * torch.randn((P, D), generator=gen,
                                         device="cuda")
        mixed = (torch.arange(P, device="cuda") % 3 == 0).float()
        for label, gate in (("zero", torch.zeros(P, device="cuda")),
                            ("mixed", mixed),
                            ("one", torch.ones(P, device="cuda"))):
            before = K.LAUNCHES["graph_combine"]
            out = twice_equal(torch, f"event combine gate {label}",
                              lambda: ops.graph_combine(A, psi, gn,
                                                        cache=cache,
                                                        gate=gate))
            require(K.LAUNCHES["graph_combine"] - before == 2,
                    f"event combine gate {label}: K3 not launched once a "
                    "call")
            want = ref.graph_combine_ref(A.T, ops.apply_gate(psi, gate,
                                                             cache), gn)
            err = check_close(torch, f"event combine gate {label} "
                              f"({P}, {D})", out, want, torch.float32)
            worst = max(worst, err)
            emit({"phase": "events", "check": "event_combine_gate",
                  "shape": [P, D], "gate": label, "max_abs_err": err})
    return worst


def ev_run(torch, pop, cfg, ticks, w_ref, executor=None, scan=False,
           seed=1):
    """(result, wall s, launches, replayed) of one ``run_gfl_async``, its
    launch counts set to 0 just before."""
    from repro_torch import kernels as K
    from repro_torch.core.events import run_gfl_async

    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_gfl_async(pop, cfg, ticks=ticks, batch_size=10, seed=seed,
                        w_ref=w_ref, executor=executor, scan=scan,
                        device="cuda")
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dict(K.LAUNCHES), dict(K.REPLAYED)


EV_FIELDS = ("flushed", "q", "staleness", "events", "dropped_stale")


def require_event_runs_equal(torch, what, a, b) -> None:
    """Two event runs bitwise equal: params, MSD, the schedules, gaps."""
    import numpy as np

    same = (bool(torch.equal(a.params, b.params))
            and a.msd.tolist() == b.msd.tolist()
            and all(np.array_equal(getattr(a, f), getattr(b, f))
                    for f in EV_FIELDS)
            and (a.gaps is None) == (b.gaps is None)
            and (a.gaps is None or np.array_equal(a.gaps, b.gaps)))
    require(same, f"events {what}: the runs differ")


def check_event_run(torch, what, run, cfg) -> dict:
    """One kernels-on graph run's own gates: K1-K3 launched, after the
    warm-up tick only from replays; finite MSD; a tick that flushes a
    strict subset of the servers; q only on flushes and in (0, 1]; the
    amplified epsilon equal to the one recomputed from (flushed, q)."""
    import numpy as np
    from repro_torch.core.privacy.mechanism import mechanism_for

    res, wall, launches, replayed = run
    for name in ROUND_KERNELS:
        require(launches[name] == EV_TICKS
                and launches[name] - replayed[name] == 1,
                f"events {what}: {name} launched {launches[name]} times, "
                f"{replayed[name]} from replays, in {EV_TICKS} ticks")
    require(bool(np.all(np.isfinite(res.msd))),
            f"events {what}: non-finite MSD")
    per_tick = res.flushed.sum(axis=1)
    subset = int(((per_tick > 0) & (per_tick < EV_P)).sum())
    require(subset > 0, f"events {what}: no tick flushes a strict subset "
            "of the servers")
    q = res.q
    require(bool(np.all((q[res.flushed] > 0) & (q[res.flushed] <= 1)))
            and bool(np.all(q[~res.flushed] == 0)),
            f"events {what}: q outside (0, 1] on a flush or set without one")
    acc = mechanism_for(cfg).async_accountant(EV_P)
    acc.record_schedule(res.flushed, res.q)
    eps = res.accountant.amplified_epsilon()
    require(eps == acc.amplified_epsilon(),
            f"events {what}: amplified epsilon {eps} against "
            f"{acc.amplified_epsilon()} from (flushed, q)")
    events = int(res.events.sum())
    return {"wall_s": wall, "events_folded": events,
            "events_per_sec_run": events / wall,
            "ticks_flushing_a_strict_subset": subset,
            "releases_per_server": res.flushed.sum(axis=0).tolist(),
            "mean_staleness": float(res.staleness.mean()),
            "dropped_stale": int(res.dropped_stale.sum()),
            "msd_tail": float(np.mean(res.msd[-50:])),
            "epsilon": res.accountant.epsilon(),
            "epsilon_amplified": eps, "launches": launches,
            "replayed": replayed}


def event_sync_limit(torch) -> None:
    """The sync limit on the gfl-logreg problem (``async:buffer=10``,
    ``clients_sampled=10``, 500 ticks, kernels on): ``run_gfl_async`` is
    bitwise ``run_gfl_population``, both under the round graph."""
    from dataclasses import replace

    from repro_torch import rng
    from repro_torch.configs import gfl_logreg
    from repro_torch.core.events import run_gfl_async
    from repro_torch.core.population import run_gfl_population
    from repro_torch.core.simulate import generate_problem

    spec, L, ticks = EV_SYNC
    base = gfl_logreg.GFL
    prob = generate_problem(rng(0, "cuda"), P=base.num_servers,
                            K=base.clients_per_server,
                            N=gfl_logreg.SAMPLES_PER_CLIENT,
                            M=gfl_logreg.DIM, rho=gfl_logreg.RHO)
    cfg = replace(base, async_spec=spec, clients_sampled=L,
                  use_kernels=True)
    a = run_gfl_async(prob, cfg, ticks=ticks, batch_size=10, seed=1)
    p = run_gfl_population(prob, cfg, iters=ticks, batch_size=10, seed=1)
    require(bool(torch.equal(a.params, p.params))
            and a.msd.tolist() == p.msd.tolist() and bool(a.flushed.all()),
            "events sync limit: run_gfl_async differs from "
            "run_gfl_population")
    emit({"phase": "events", "sync_limit": spec, "clients_sampled": L,
          "ticks": ticks, "bitwise_run_gfl_population": True,
          "msd_tail": float(a.msd[-50:].mean())})


def event_host_stage(torch, pop, cfg, ticks=POP_STAGE_ROUNDS) -> dict:
    """Host ms a tick of the event tick's host stage
    (``StagedEventTick.stage``: the draws reseeded, the tick's arrivals
    realized in numpy and copied pageable) and of its parts alone."""
    from repro_torch.core.events import engine, parse_async_spec
    from repro_torch.core.population.cohort import parse_trace_spec
    from repro_torch.core.simulate import base_combination_matrix, make_grad_fn
    from repro_torch.draws import Draws

    spec = parse_async_spec(cfg.async_spec)
    step = engine.StagedEventTick(
        pop, cfg, spec, parse_trace_spec(cfg.cohort.partition("trace:")[2]),
        None, None, base_combination_matrix(cfg, pop.P),
        make_grad_fn(pop.rho), 10, ticks, torch.device("cuda"),
        seed=cfg.topology_seed)
    draws = Draws(3, "cuda")
    u, ages = step.queue.realize(0)

    def ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(ticks):
            fn(i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / ticks

    return {"host_stage_ms_per_tick": ms(lambda i: step.stage(i, draws)),
            "reseed_ms": ms(draws.stage),
            "realize_ms": ms(step.queue.realize),
            "two_copies_ms": ms(lambda i: (
                step.u.copy_(torch.from_numpy(u)),
                step.ages.copy_(torch.from_numpy(ages))))}


def async_throughput_rows(torch):
    """``python -m repro_torch.launch.async_throughput`` at its defaults,
    as a user runs it, in its own process: every row's events a second."""
    import csv
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m",
                          "repro_torch.launch.async_throughput"],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=600)
    require(out.returncode == 0, "async_throughput exited "
            f"{out.returncode}: {out.stderr[-2000:]}")
    lines = [ln for ln in out.stdout.splitlines() if not ln.startswith("#")]
    header, *rows = csv.reader(lines)
    rows = [dict(zip(header, r)) for r in rows]
    require(len(rows) == 7 and rows[0]["config"] == "sync",
            f"async_throughput: rows {[r['config'] for r in rows]}")
    for r in rows:
        require(float(r["events_per_sec"]) > 0
                and float(r["msd_final"]) == float(r["msd_final"]),
                f"async_throughput {r['config']}: {r}")
        emit({"phase": "events", "bench": "async_throughput", **r})
    emit({"phase": "events", "bench": "async_throughput",
          "seconds": time.perf_counter() - t0})
    return rows


def phase_events(torch) -> dict:
    """The event engine at full size (module docstring, phase 10).  The
    K1-K3 launches it returns are those of its kernels-on runs of the three
    cases (graph, eager and scan), each counted from 0 just before."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.core.population import (estimate_w_ref,
                                             population_from_spec)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    fold_err = event_fold_check(torch, gen)
    event_sync_limit(torch)
    pop = population_from_spec(events_config("uniform"), device="cuda")
    w_ref = estimate_w_ref(pop, sample_clients=64, iters=1500)
    totals = dict.fromkeys(ROUND_KERNELS, 0)
    for name, cohort, fault in EV_CASES:
        cfg = events_config(cohort, fault)
        graph = ev_run(torch, pop, cfg, EV_TICKS, w_ref)
        rec = check_event_run(torch, name, graph, cfg)
        for k in ROUND_KERNELS:
            totals[k] += graph[2][k]
        eager = ev_run(torch, pop, cfg, EV_TICKS, w_ref, "eager")
        require_event_runs_equal(torch, f"{name}: graph against eager",
                                 graph[0], eager[0])
        require(graph[2] == eager[2], f"events {name}: launches "
                f"{graph[2]} under the graph, {eager[2]} eagerly")
        scan = ev_run(torch, pop, cfg, EV_TICKS, w_ref, scan=True)
        require_event_runs_equal(torch, f"{name}: loop against scan",
                                 graph[0], scan[0])
        for k in ROUND_KERNELS:
            totals[k] += eager[2][k] + scan[2][k]
        off = ev_run(torch, pop, events_config(cohort, fault, False),
                     EV_TICKS, w_ref)[0]
        on = graph[0]
        if name == EV_CASES[0][0]:
            events_a_tick = float(on.events.sum()) / EV_TICKS
        n = EV_ONOFF_TICKS
        msd_rel = float(np.max(np.abs(on.msd[:n] / off.msd[:n] - 1)))
        p_err = float((on.params - off.params).abs().max())
        require(msd_rel <= 1e-4 and p_err <= PARAMS_ATOL,
                f"events {name}: kernels on against off: MSD of the first "
                f"{n} ticks {msd_rel} (relative), final params {p_err}")
        emit({"phase": "events", "case": name, "cohort": cohort,
              "fault": fault, "spec": EV_SPEC, "ticks": EV_TICKS,
              "graph_is_eager": True, "loop_is_scan": True,
              "wall_s_eager": eager[1], "wall_s_scan": scan[1],
              "kernels_against_plain": {"msd_rel_err_first_ticks": msd_rel,
                                        "params_max_abs_err": p_err},
              **rec})
    # the tick's time: the docs' run (uniform + diurnal), kernels on
    cfg = events_config(EV_CASES[0][1])

    def run(ticks, executor):
        return ev_run(torch, pop, cfg, ticks, w_ref, executor)

    timing = {}
    for executor in ("graph", "eager"):
        rec = profile_run(torch, run, executor)
        wall = steady_ms(torch, run, executor, EV_STEADY_TICKS)
        timing[executor] = wall
        emit({"phase": "events", "timing": cfg.cohort, "executor": executor,
              "wall_ms_per_tick": wall,
              "busy_over_wall": rec["device_busy_ms_per_round"] / wall,
              "events_per_tick": events_a_tick,
              "events_per_sec_steady": events_a_tick / wall * 1e3, **rec})
    emit({"phase": "events", "timing": cfg.cohort,
          **event_host_stage(torch, pop, cfg),
          "graph_ms_per_tick": timing["graph"],
          "eager_ms_per_tick": timing["eager"]})
    rows = async_throughput_rows(torch)
    K.reset_launches()
    return {"launches": totals, "fold_err": fold_err,
            "graph_ms_per_tick": timing["graph"],
            "eager_ms_per_tick": timing["eager"],
            "bench_rows": len(rows)}


# ------------------------------------------------------------ observe

OBS_ITERS = 500          # the main path's rounds
OBS_PROFILE_ITERS = 300  # a shape no earlier run captured: the retrace check
OBS_POP_ITERS = 20
OBS_EV_TICKS = 100
OBS_OFF_OPS = (72.5, 77.5)   # PR 18's 73-77 device ops a replay, rounded
OBS_OPS_TOL = 0.5        # ops a replay: the off graph against the profile's
PROFILED: dict = {}      # the profile phase's main hybrid graph reading


def observed(torch, fn, profile=False):
    """(result, records by stream) of ``fn()`` under a memory session that
    writes no file."""
    from repro_torch.telemetry import MemorySink, session
    with session([MemorySink()], trace_path="", profile=profile) as sess:
        out = fn()
    torch.cuda.synchronize()
    by = {}
    for r in sess.memory_records():
        by.setdefault(r["stream"], []).append(r)
    return out, by


def require_streams(what, recs, rounds, releases, step_rows, wrapper) -> dict:
    """The streams of one observed run are complete."""
    import math

    def finite(rows):
        return all(not (isinstance(v, float) and math.isnan(v))
                   for r in rows for v in r.values())

    require(len(recs.get("round", [])) == rounds and finite(recs["round"]),
            f"observe {what}: {len(recs.get('round', []))} round records "
            f"for {rounds} rounds, or a NaN")
    require(len(recs.get("step", [])) == (rounds if step_rows else 0)
            and finite(recs.get("step", [])),
            f"observe {what}: {len(recs.get('step', []))} step records")
    require(len(recs.get("privacy", [])) == releases,
            f"observe {what}: {len(recs.get('privacy', []))} privacy "
            f"records for {releases} releases")
    ops = [r["op"] for r in recs.get("kernel", [])]
    for name in ROUND_KERNELS:
        require(ops.count(name) == (1 if wrapper[name] else 0),
                f"observe {what}: {ops.count(name)} kernel records of "
                f"{name}, launched {wrapper[name]} times by its wrapper")
    return {k: len(v) for k, v in recs.items()}


def observe_pair(torch, what, run, cfg, equal, step_rows, releases) -> dict:
    """``run(cfg)`` with telemetry off, then on: bitwise ``equal``, and
    the streams of the on run complete."""
    from dataclasses import replace
    from repro_torch import kernels as K

    off = run(cfg)
    K.reset_launches()
    on, recs = observed(torch, lambda: run(replace(cfg, telemetry="memory")))
    wrapper = {k: K.LAUNCHES[k] - K.REPLAYED[k] for k in ROUND_KERNELS}
    require(equal(off, on), f"observe {what}: telemetry on is not bitwise "
            "the run with it off")
    rounds = len(on.msd)
    counts = require_streams(what, recs, rounds, releases(on), step_rows,
                             wrapper)
    return {"case": what, "rounds": rounds, "bitwise": True,
            "records": counts, "wrapper_launches": wrapper,
            "replayed": dict(K.REPLAYED)}


def phase_observe(torch, smi) -> dict:
    """Telemetry, sanitize mode and checkpoints on the card, under the round
    graph (module docstring, phase 11)."""
    import tempfile
    from dataclasses import replace

    import numpy as np
    from repro_torch import kernels as K, rng
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import gfl_logreg
    from repro_torch.core.events import run_gfl_async
    from repro_torch.core.population import (estimate_w_ref,
                                             population_from_spec,
                                             run_gfl_population)
    from repro_torch.core.simulate import generate_problem
    from repro_torch.launch import population_demo as demo
    from repro_torch.sanitize import ReleaseLedger, SanitizerError
    from repro_torch.telemetry import profile_phase

    t0 = time.perf_counter()
    base = replace(gfl_logreg.GFL, privacy="hybrid", use_kernels=True)
    prob = generate_problem(rng(0, "cuda"), P=base.num_servers,
                            K=base.clients_per_server,
                            N=gfl_logreg.SAMPLES_PER_CLIENT,
                            M=gfl_logreg.DIM, rho=gfl_logreg.RHO)

    def same(a, b):
        return bool(torch.equal(a.params, b.params)) and \
            a.msd.tolist() == b.msd.tolist()

    def same_events(a, b):
        return same(a, b) and all(np.array_equal(getattr(a, f),
                                                 getattr(b, f))
                                  for f in EV_FIELDS)

    cases = []
    for scan in (False, True):
        def pure(cfg, scan=scan):
            return run_gfl_population(prob, cfg, iters=OBS_ITERS,
                                      batch_size=10, seed=5, scan=scan)
        cases.append(observe_pair(
            torch, f"pure, scan={scan}", pure, base, same, True,
            lambda r: r.accountant.step))
    pure_res = pure(base)
    # the weighted path at population_demo's size
    wbase = replace(demo.base_config(), cohort=demo.COHORTS[2])
    pop = population_from_spec(wbase, device="cuda")
    w_ref = estimate_w_ref(pop, sample_clients=64, iters=1500)

    def weighted(cfg):
        return run_gfl_population(pop, cfg, iters=OBS_POP_ITERS,
                                  batch_size=10, seed=5, w_ref=w_ref)
    cases.append(observe_pair(torch, "weighted", weighted, wbase, same,
                              False, lambda r: r.accountant.step))
    w_res = weighted(wbase)
    # the event engine at the docs' run, loop and scan
    ebase = events_config(EV_CASES[0][1])
    epop = population_from_spec(events_config("uniform"), device="cuda")
    e_ref = estimate_w_ref(epop, sample_clients=64, iters=1500)
    for scan in (False, True):
        def events(cfg, scan=scan):
            return run_gfl_async(epop, cfg, ticks=OBS_EV_TICKS,
                                 batch_size=10, seed=5, w_ref=e_ref,
                                 scan=scan)
        cases.append(observe_pair(
            torch, f"events, scan={scan}", events, ebase, same_events, scan,
            lambda r: int(r.flushed.sum())))
    for case in cases:
        emit({"phase": "observe", **case})

    # a first and a second run of one shape under the phase profiler
    def twice():
        for name in ("first", "second"):
            with profile_phase(name):
                run_gfl_population(prob, base, iters=OBS_PROFILE_ITERS,
                                   batch_size=10, seed=6)
    _, recs = observed(torch, twice, profile=True)
    prof = {r["phase"]: r for r in recs.get("profile", [])
            if r["phase"] in ("first", "second")}
    require(len(prof) == 2
            and prof["first"]["retraces"] >= 1
            and prof["second"]["retraces"] == 0
            and all("peak_bytes" in r for r in prof.values()),
            f"observe: profile records {prof}")
    emit({"phase": "observe", "profile": {
        k: {f: r[f] for f in ("wall_s", "compile_s", "execute_s",
                              "callback_s", "retraces", "compiles",
                              "peak_bytes")} for k, r in prof.items()}})

    # the off graph is today's; the on graph beside it
    from repro_torch.core.simulate import run_gfl

    def runner(cfg, on):
        def run(iters, executor):
            if not on:
                return run_gfl(prob, cfg, iters=iters, batch_size=10,
                               seed=2, executor=executor)
            return observed(torch, lambda: run_gfl(
                prob, replace(cfg, telemetry="memory"), iters=iters,
                batch_size=10, seed=2, executor=executor))[0]
        return run

    rec_off = profile_run(torch, runner(base, False), "graph")
    rec_on = profile_run(torch, runner(base, True), "graph")
    ops_off = rec_off["device_ops_per_round"]
    lo, hi = OBS_OFF_OPS             # the graph before telemetry
    require(lo <= ops_off <= hi, f"observe: the telemetry-off main round "
            f"has {ops_off} device ops a replay, not {lo}-{hi}")
    if "main" in PROFILED:           # the profile phase ran: its reading
        near = abs(ops_off - PROFILED["main"]) <= OBS_OPS_TOL
        require(near, f"observe: the telemetry-off main round has {ops_off} "
                f"device ops a replay, the profile phase {PROFILED['main']}")
    wall_off = steady_ms(torch, runner(base, False), "graph")
    wall_on = steady_ms(torch, runner(base, True), "graph")
    emit({"phase": "observe", "graph_ops_per_replay_off": ops_off,
          "graph_ops_per_replay_profile_phase": PROFILED.get("main"),
          "graph_ops_per_replay_on": rec_on["device_ops_per_round"],
          "busy_ms_per_round_off": rec_off["device_busy_ms_per_round"],
          "busy_ms_per_round_on": rec_on["device_busy_ms_per_round"],
          "wall_ms_per_round_off": wall_off,
          "wall_ms_per_round_on": wall_on})
    print(f"observe/card,{smi}", flush=True)
    print(f"observe/graph_round_ms_telemetry_off,{wall_off}", flush=True)
    print(f"observe/graph_round_ms_telemetry_on,{wall_on}", flush=True)

    # sanitize mode on the three engines, and its plants
    sane = [pure(replace(base, sanitize=True)),
            weighted(replace(wbase, sanitize=True)),
            events(replace(ebase, sanitize=True))]
    e_res = events(ebase)
    require(same(sane[0], pure_res) and same(sane[1], w_res)
            and same_events(sane[2], e_res),
            "observe: sanitize mode changed a run")
    K.reset_launches()
    try:
        run_gfl_population(prob, replace(base, sanitize=True),
                           iters=OBS_ITERS, batch_size=10, seed=5,
                           w_ref=torch.full((gfl_logreg.DIM,), float("nan"),
                                            device="cuda"))
        raised = False
    except SanitizerError:
        raised = True
    require(raised and K.REPLAYED["fold_apply"] >= OBS_ITERS - 1,
            f"observe: a NaN w_ref did not raise SanitizerError after "
            f"{K.REPLAYED['fold_apply']} replayed rounds")
    short = ReleaseLedger()
    short.record_release(sane[0].accountant.step)
    short.charge_from(sane[0].accountant)
    short.cross_check()
    short.record_release()
    try:
        short.cross_check()
        raised = False
    except SanitizerError:
        raised = True
    require(raised, "observe: a ledger one release short did not raise")

    # checkpoints round-trip on the card
    bf16 = torch.randn(64, 96, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(3)
                       ).to(torch.bfloat16)
    tree = {"params": sane[0].params, "is_state": w_res.scheduler.is_state,
            "bf16": bf16}
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp + "/ck", tree, step=OBS_ITERS)
        like = {"params": torch.zeros_like(tree["params"]),
                "is_state": type(tree["is_state"])(
                    *(torch.zeros_like(t) for t in tree["is_state"])),
                "bf16": torch.zeros_like(bf16)}
        back, step = load_checkpoint(tmp + "/ck", like)

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    pairs = [(back["params"], tree["params"]), (back["bf16"], bf16)]
    pairs += list(zip(back["is_state"], tree["is_state"]))
    require(step == OBS_ITERS and all(
        a.device == b.device and a.dtype == b.dtype
        and bool(torch.equal(bits(a), bits(b))) for a, b in pairs),
        "observe: a checkpoint did not round-trip bitwise on the card")
    emit({"phase": "observe", "sanitize_engines": 3,
          "nan_w_ref_raised_after_run": True, "short_ledger_raised": True,
          "checkpoint_leaves": len(pairs), "checkpoint_bitwise": True,
          "seconds": time.perf_counter() - t0})
    return {"wall_ms_per_round_off": wall_off, "wall_ms_per_round_on": wall_on}


# ------------------------------------------------------------------ fleet

FLEET_TRANSPORTS = ("inproc", "filelog", "socket")
# the Section V problem as a fleet: P=10, K=50 clients of N=100 samples,
# M=2; every client arrives every tick (events = buffer = K), 30 ticks
FLEET_SECTION_V = {"P": 10, "K": 50, "n": 100, "dim": 2, "buffer": 50,
                   "events": 50, "sigma_g": 0.2, "seed": 3}
FLEET_SECTION_V_TICKS = 30
FLEET_WIDE_DIM = 2048           # K1's split-row layout under a worker
FLEET_SAMPLE_S = 0.1            # card-process sampling period, seconds
FLEET_TICK_SAMPLES = 20         # worker ticks timed alone


def child_pids() -> set:
    """Pids of this process's live children started by multiprocessing's
    spawn (its resource tracker, a helper that holds no device, left
    out), from /proc."""
    import os
    me, out = os.getpid(), set()
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as fh:
                stat = fh.read()
            with open(f"/proc/{entry}/cmdline", "rb") as fh:
                cmd = fh.read()
        except OSError:
            continue
        # the fields after the command's closing parenthesis: state, ppid
        fields = stat[stat.rfind(")") + 2:].split()
        if len(fields) > 1 and fields[0] != "Z" and int(fields[1]) == me \
                and b"spawn_main" in cmd:
            out.add(int(entry))
    return out


def card_processes(torch) -> int:
    """Processes holding a context on card 0, as NVML lists them
    (torch.cuda.list_gpu_processes).  The card's machine reports every
    process as pid 1 (``/process_api``), so they are counted, not named."""
    import re
    return len(re.findall(r"process\s+\d+ uses",
                          torch.cuda.list_gpu_processes(0)))


class CardWatch:
    """Samples, on a thread, this process's spawned children (from /proc)
    and the processes on the card (NVML) while a block runs.  A child is
    seen on the card in a sample where every live child holds a context:
    the card lists the processes it listed before the block plus exactly
    one a live child."""

    def __init__(self, torch, base: int):
        import threading
        self.torch = torch
        self.base = base
        self.children: set = set()
        self.on_card: set = set()
        self.most_on_card = 0
        self.most_bytes = 0
        self._free0 = torch.cuda.mem_get_info(0)[0]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        while not self._stop.wait(FLEET_SAMPLE_S):
            kids = child_pids()
            extra = card_processes(self.torch) - self.base
            self.children |= kids
            self.most_on_card = max(self.most_on_card, extra)
            self.most_bytes = max(self.most_bytes, self._free0
                                  - self.torch.cuda.mem_get_info(0)[0])
            if kids and extra == len(kids) and kids <= child_pids():
                self.on_card |= kids

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def fleet_twin(torch, prob, ticks, root, what) -> dict:
    """One inproc run on the card, its launches counted from 0 just before,
    and the same run on the CPU: integer outcomes exact, params within
    atol 1e-5, MSD within rtol 1e-5; K1 and K2 once a worker tick, K3 once
    a flushing tick, exactly."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.core.fleet import run_fleet
    K.reset_launches()
    on = run_fleet(prob, "fleet", ticks, ckpt_root=f"{root}/{what}-cuda",
                   device="cuda")
    launches = {k: K.LAUNCHES[k] for k in ROUND_KERNELS}
    off = run_fleet(prob, "fleet", ticks, ckpt_root=f"{root}/{what}-cpu",
                    device="cpu")
    p_err = float((on.params.cpu() - off.params).abs().max())
    msd_rel = float(np.max(np.abs(on.msd / off.msd - 1)))
    exact = (np.array_equal(on.flushed, off.flushed)
             and np.array_equal(on.q, off.q)
             and np.array_equal(on.versions, off.versions)
             and on.q_ledgers == off.q_ledgers)
    require(exact, f"fleet {what}: cuda against the CPU: flush schedule, "
            f"q, versions or q-ledgers differ")
    require(p_err <= ATOL_F32 and msd_rel <= RTOL_NORMS,
            f"fleet {what}: cuda against the CPU: params {p_err} (atol "
            f"{ATOL_F32}), MSD {msd_rel} (rtol {RTOL_NORMS})")
    flushing = int(on.flushed.any(axis=1).sum())
    want = {"fold_norms": prob.P * ticks, "fold_apply": prob.P * ticks,
            "graph_combine": flushing}
    require(launches == want, f"fleet {what}: launches {launches}, "
            f"expected {want} (K1, K2 a worker tick; K3 a flushing tick)")
    rec = {"phase": "fleet", "run": what, "P": prob.P, "K": prob.K,
           "n": prob.n, "dim": prob.dim, "events": prob.events,
           "buffer": prob.buffer, "ticks": ticks, "launches": launches,
           "flushing_ticks": flushing, "integer_outcomes_exact": True,
           "params_max_abs_err_vs_cpu": p_err, "msd_rel_err_vs_cpu": msd_rel,
           "ticks_per_s": on.ticks_per_s, "ticks_per_s_cpu": off.ticks_per_s,
           "msd_last": float(on.msd[-1])}
    emit(rec)
    return launches


def fleet_tick_split(torch, prob, root) -> dict:
    """One worker alone on the card at ``prob``: host ms of a tick's fold
    (ending in the reply's copy to the host) and of its write-ahead
    checkpoint, medians over FLEET_TICK_SAMPLES ticks."""
    import statistics

    import numpy as np
    from repro_torch.core.fleet import (FleetWorker, InprocHub,
                                        parse_fleet_spec)
    from repro_torch.core.fleet.coordinator import fleet_cohort
    w = FleetWorker(0, prob, parse_fleet_spec("fleet"),
                    InprocHub().register("w"), f"{root}/split",
                    device="cuda")
    fold, ckpt = [], []
    params = np.zeros(prob.dim)
    with w.on_stream():
        for t in range(FLEET_TICK_SAMPLES + 2):
            cohort = [int(k) for k in fleet_cohort(prob, t)[0]]
            t0 = time.perf_counter()
            w.last_reply = w.compute_tick(t, params, cohort)
            t1 = time.perf_counter()
            w.checkpoint()
            t2 = time.perf_counter()
            if t >= 2:                      # past the first calls' set-up
                fold.append((t1 - t0) * 1e3)
                ckpt.append((t2 - t1) * 1e3)
    return {"fold_ms": statistics.median(fold),
            "checkpoint_ms": statistics.median(ckpt)}


def phase_fleet(torch) -> dict:
    """The fleet on the card (module docstring, phase 12).  Returns the
    K1-K3 launches of its clean inproc runs, each counted from 0 just
    before."""
    import os
    import tempfile
    from dataclasses import replace

    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.core.fleet import FleetProblem
    from repro_torch.launch import fleet_demo as demo

    t_phase = time.perf_counter()
    prob = demo.build_problem()
    base = card_processes(torch)          # this process's own context
    for transport in FLEET_TRANSPORTS:
        t0 = time.perf_counter()
        with CardWatch(torch, base) as watch:
            res = demo.run(transport, demo.TICKS, "cuda")
        out = res["out"]
        clean, faulted = out.clean, out.faulted
        bitwise = (bool(torch.equal(faulted.params, clean.params))
                   and np.array_equal(faulted.msd, clean.msd)
                   and np.array_equal(faulted.q, clean.q))
        require(bitwise and out.msd_gap == 0.0,
                f"fleet {transport}: the killed run is not bitwise its "
                f"clean twin (msd gap {out.msd_gap})")
        require(faulted.kills == 1 and faulted.restarts == 1,
                f"fleet {transport}: kills {faulted.kills}, restarts "
                f"{faulted.restarts}")
        rec = {"phase": "fleet", "transport": transport,
               "drill": f"SIGKILL worker{demo.KILL_SERVER} at tick "
                        f"{demo.KILL_TICK}", "ticks": demo.TICKS,
               "bitwise_clean_twin": True, "msd_gap": out.msd_gap,
               "kills": faulted.kills, "restarts": faulted.restarts,
               "retries": faulted.retries,
               "recovery_s": faulted.recovery_s,
               "ticks_per_s": clean.ticks_per_s,
               "ticks_per_s_faulted": faulted.ticks_per_s,
               "ticks_per_s_inproc": res["inproc"].ticks_per_s,
               "seconds": time.perf_counter() - t0}
        if transport != "inproc":
            # 4 workers, then 4 again for the twin, and the restart
            spawned = 2 * prob.P + faulted.restarts
            rec.update({"worker_pids": sorted(watch.children),
                        "worker_pids_on_card": sorted(watch.on_card),
                        "most_worker_processes_on_card": watch.most_on_card,
                        "most_card_bytes_beyond_own": watch.most_bytes})
            require(len(watch.children) == spawned,
                    f"fleet {transport}: {len(watch.children)} worker "
                    f"processes seen, {spawned} started")
            require(watch.on_card == watch.children,
                    f"fleet {transport}: worker processes "
                    f"{sorted(watch.children - watch.on_card)} never seen "
                    f"holding a context on the card")
        emit(rec)
    # a SIGKILLed context is torn down by the driver: give it a moment
    deadline = time.perf_counter() + 10.0
    while card_processes(torch) != base and time.perf_counter() < deadline:
        time.sleep(0.1)
    after = card_processes(torch)
    require(not child_pids() and after == base,
            f"fleet: processes left after the drills: children "
            f"{sorted(child_pids())}, {after} on the card against {base} "
            f"before")
    emit({"phase": "fleet", "card_processes_before": base,
          "card_processes_after": after, "own_pid": os.getpid()})
    totals = dict.fromkeys(ROUND_KERNELS, 0)
    with tempfile.TemporaryDirectory(prefix="fleet_smoke_") as root:
        for what, p, ticks in (
                ("demo", prob, demo.TICKS),
                ("section_v", FleetProblem(**FLEET_SECTION_V),
                 FLEET_SECTION_V_TICKS),
                (f"dim{FLEET_WIDE_DIM}", replace(prob, dim=FLEET_WIDE_DIM),
                 demo.TICKS)):
            for k, n in fleet_twin(torch, p, ticks, root, what).items():
                totals[k] += n
        split = {what: fleet_tick_split(torch, p, root) for what, p in (
            ("demo", prob), ("section_v", FleetProblem(**FLEET_SECTION_V)))}
    emit({"phase": "fleet", "worker_tick_alone": split})
    K.reset_launches()
    emit({"phase": "fleet", "launches": totals,
          "seconds": time.perf_counter() - t_phase})
    return {"launches": totals}



# ------------------------------------------------------------------ train


TRAIN_ARCH = "smollm-135m"
TRAIN_D = 134_515_008           # embed 49152 x 576 + 30 x 3,540,096 + 576
TRAIN_P, TRAIN_L = 4, 2         # servers on a ring, clients a round
TRAIN_SEQ = 64
TRAIN_ROUNDS = 40
TRAIN_LOG_EVERY = 10
TRAIN_PRIVACY, TRAIN_SIGMA = "hybrid", 0.01     # the example's defaults
TRAIN_SEED = 7                  # the gate rounds' draws


def train_config():
    """smollm-135m at full width and depth in f32, the dtype the
    reference's federated LM trains in (``ModelConfig.reduced()`` sets it;
    only the widths differ here)."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(TRAIN_ARCH), param_dtype="float32")


def centroid_atol(w_max: float) -> float:
    """The hybrid round's centroid against the none round's.  The masks
    cancel in each server's fold and the eq.-24 noise in the centroid (the
    ring's A is doubly stochastic) exactly in real arithmetic; in f32 each
    of the at most P + L additions where a mask or noise term meets a
    parameter rounds by at most 2^-24 of a magnitude below 2 max|w| (the
    masks and noise are sigma-sized, the norm scales 1), and the fold's
    and combine's sums are taken in another order with them than without:
    a factor 16 over that bound."""
    return 16 * (TRAIN_P + TRAIN_L) * 2.0 ** -24 * 2 * max(w_max, 1.0)


def phase_train(torch) -> dict:
    """The federated LM at smollm-135m's full width through K1-K3 (module
    docstring, phase 13).  Returns the K1-K3 launches of its run, counted
    from 0 just before it."""
    from repro_torch import kernels as K
    from repro_torch.core import gfl
    from repro_torch.draws import Draws
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import federated_lm as flm
    from repro_torch.launch.kernel_bench import time_ms

    t_phase = time.perf_counter()
    cfg = train_config()
    require(cfg.num_layers == 30 and cfg.d_model == 576
            and (cfg.num_heads, cfg.num_kv_heads) == (9, 3)
            and cfg.d_ff == 1536 and cfg.vocab_size == 49152
            and cfg.tie_embeddings, f"{cfg.name} is not at full width")

    def gcfg(privacy, kernels):
        return flm.gfl_config(TRAIN_P, TRAIN_L, privacy, TRAIN_SIGMA,
                              kernels)

    tr = flm.Trainer.build(cfg, gcfg(TRAIN_PRIVACY, True), seq=TRAIN_SEQ,
                           device="cuda")
    D = tr.view.size
    require(D == TRAIN_D and tr.flat0.dtype == torch.float32,
            f"train: D = {D} ({tr.flat0.dtype}), expected {TRAIN_D} f32")
    state0, batch0 = tr.init_state(), tr.batch(0)
    # the clients' gradients, once: every gate round reads these
    grads_s = []
    for _ in range(2):              # the first call warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = tr.grad_fn(state0.params, batch0)
        torch.cuda.synchronize()
        grads_s.append(time.perf_counter() - t0)
        if len(grads_s) == 1:
            grads = again
    grads_rerun_max_diff = float((again - grads).abs().max())
    del again
    require(bool(torch.isfinite(grads).all()), "train: non-finite gradients")

    def fixed(params, batch):
        return grads

    def round_of(privacy, kernels, seed=TRAIN_SEED):
        step = tr.step_fn(gcfg(privacy, kernels), fixed)
        return step(state0, batch0, Draws(seed, "cuda")).params

    none_on, none_off = round_of("none", True), round_of("none", False)
    err_none = max_err(torch, none_on, none_off)
    require(err_none <= PARAMS_ATOL_TRAIN, f"train: none round, kernels on "
            f"against off, max abs err {err_none} > {PARAMS_ATOL_TRAIN}")
    K.reset_launches()
    hyb_on = round_of(TRAIN_PRIVACY, True)
    counts = {k: K.LAUNCHES[k] for k in ROUND_KERNELS}
    require(counts == dict.fromkeys(ROUND_KERNELS, 1),
            f"train: a kernel round launched {counts}, expected K1-K3 once "
            "each")
    require(torch.equal(hyb_on, round_of(TRAIN_PRIVACY, True)),
            "train: a rerun of the hybrid kernel round differs")
    hyb_off = round_of(TRAIN_PRIVACY, False)
    iid_on = round_of("iid_dp", True)
    tol = centroid_atol(float(state0.params.abs().max()))
    c = {name: gfl.centroid(w) for name, w in (
        ("none_on", none_on), ("none_off", none_off), ("hybrid_on", hyb_on),
        ("hybrid_off", hyb_off), ("iid_dp_on", iid_on))}
    cerr = {"hybrid_on-none_on": max_err(torch, c["hybrid_on"],
                                         c["none_on"]),
            "hybrid_off-none_off": max_err(torch, c["hybrid_off"],
                                           c["none_off"]),
            "hybrid_on-hybrid_off": max_err(torch, c["hybrid_on"],
                                            c["hybrid_off"]),
            "iid_dp_on-none_on": max_err(torch, c["iid_dp_on"],
                                         c["none_on"])}
    for pair in ("hybrid_on-none_on", "hybrid_off-none_off",
                 "hybrid_on-hybrid_off"):
        require(cerr[pair] <= tol, f"train: centroid {pair} max abs err "
                f"{cerr[pair]} > {tol}")
    require(cerr["iid_dp_on-none_on"] > 100 * tol,
            f"train: iid_dp's centroid within {cerr['iid_dp_on-none_on']} "
            "of none's: its noise does not reach the centroid")
    # the masks and noise are there in each server's params
    server_err = max_err(torch, hyb_on, none_on)
    require(server_err > 100 * tol, f"train: hybrid's servers within "
            f"{server_err} of none's: no masks or noise applied")
    emit({"phase": "train", "arch": cfg.name, "D": D,
          "P": TRAIN_P, "L": TRAIN_L, "per_client": tr.per_client,
          "seq": TRAIN_SEQ, "param_dtype": cfg.param_dtype,
          "grads_s": grads_s, "grads_rerun_max_abs_diff":
          grads_rerun_max_diff, "none_on_off_max_abs_err": err_none,
          "round_launches": counts, "rerun_bitwise": True,
          "centroid_atol": tol, "centroid_max_abs_err": cerr,
          "hybrid_server_max_abs_diff_from_none": server_err})
    del none_on, none_off, hyb_off, iid_on, c
    # the round's split: the gradients, K1 + K2 (the fold), K3 (combine)
    hyb = gcfg(TRAIN_PRIVACY, True)
    seeds = Draws(TRAIN_SEED, "cuda").mask_seeds(0, TRAIN_P)
    A = torch.as_tensor(tr.A, dtype=torch.float32, device="cuda")

    def fold():
        return kops.round_fold(state0.params, grads, mu=hyb.mu,
                               bound=hyb.grad_bound, mode="mask",
                               sigma=TRAIN_SIGMA, seeds=seeds)
    psi = fold()[0]
    noise = TRAIN_SIGMA * torch.randn_like(psi)
    split = {"grads_ms": grads_s[-1] * 1e3,
             "fold_k1_k2_ms": time_ms(fold, budget_s=0.5),
             "combine_k3_ms": time_ms(lambda: kops.graph_combine(A, psi,
                                                                 noise),
                                      budget_s=0.5)}
    # one whole round (gradients included) under the profiler: busy, idle
    step = tr.step_fn()

    def one_round():
        t0 = time.perf_counter()
        step(state0, batch0, Draws(TRAIN_SEED, "cuda"))
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    one_round()
    t = traced(torch, one_round, "train: one round", fenced=False)
    busy = sum(e.time_range.elapsed_us() for e in t["device"]) / 1e3
    split.update(round_ms=t["value"] * 1e3, device_busy_ms=busy,
                 device_idle_share=1.0 - busy / (t["value"] * 1e3),
                 device_ops=len(t["device"]))
    emit({"phase": "train", "round_split": split})
    del psi, noise, grads, tr, state0, batch0
    torch.cuda.empty_cache()
    # the main path: the entry a user calls, K1-K3 counted from 0
    lines = []
    K.reset_launches()
    t0 = time.perf_counter()
    out = flm.run(cfg, steps=TRAIN_ROUNDS, servers=TRAIN_P,
                  clients=TRAIN_L, seq=TRAIN_SEQ, privacy=TRAIN_PRIVACY,
                  sigma=TRAIN_SIGMA, use_kernels=True, device="cuda",
                  log_every=TRAIN_LOG_EVERY, log=lines.append)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: K.LAUNCHES[k] for k in ROUND_KERNELS}
    require(launches == dict.fromkeys(ROUND_KERNELS, TRAIN_ROUNDS),
            f"train: {TRAIN_ROUNDS} rounds launched {launches}, expected "
            "K1-K3 once a round")
    hist = out["history"]
    loss = [h["loss"] for h in hist]
    require(all(map(math.isfinite, loss)) and loss[-1] < loss[0],
            f"train: centroid eval loss {loss} is not finite or did not "
            "fall")
    require(bool(torch.isfinite(out["state"].params).all()),
            "train: non-finite params after the run")
    for line in lines:
        emit({"phase": "train", "log": line})
    emit({"phase": "train", "rounds": TRAIN_ROUNDS, "history": hist,
          "launches": launches, "run_s": run_s,
          "s_per_round": run_s / TRAIN_ROUNDS,
          "spectral_gap": out["spectral_gap"]})
    del out
    torch.cuda.empty_cache()
    # K1-K3 at the federated LM's shape against their plain versions and
    # library calls, with their bounds
    gen = torch.Generator(device="cuda")
    gen.manual_seed(25)
    rows = time_shape(torch, TRAIN_P, TRAIN_L, TRAIN_D, gen, profile=False)
    torch.cuda.empty_cache()
    emit({"phase": "train", "kernel_rows": [TRAIN_P, TRAIN_L, TRAIN_D],
          **{name: {k: rec[k] for k in ("ms", "device_ms", "plain_ms",
                                        "library_ms", "bound_ms",
                                        "bound_by", "max_abs_err")
                    if k in rec}
             for name, rec in rows.items()}})
    K.reset_launches()
    emit({"phase": "train", "seconds": time.perf_counter() - t_phase})
    return {"launches": launches}


# ------------------------------------------------------------------- mesh


MESH_ARCH, MESH_SPEC = "smollm-135m", "4x1"
MESH_P, MESH_L, MESH_PER_CLIENT, MESH_SEQ = 4, 2, 2, 64
MESH_STEPS = 3                  # the main path's steps (launch.train)
# each variant's steps, run twice: cut from 3 when the whole smoke took
# 953.8 s on one call's host (PERF.md, the mesh finding)
MESH_VARIANT_STEPS = 2
MESH_PRIVACY, MESH_SIGMA, MESH_MU, MESH_BOUND = "hybrid", 0.01, 0.1, 10.0
MESH_SEED = 7
MESH_LEAVES = 11                # the reference's stacked tree of smollm-135m
MESH_VARIANTS = {"dense_k": ("dense", True), "dense": ("dense", False),
                 "rotate": ("rotate", False), "sparse": ("sparse", False)}
MESH_CENTROID_ATOL = 5e-3       # the reference's own, tests/test_dryrun.py
# rotate and sparse against the f32 einsum on one step's psi and g, in
# bf16 ulps (2^-7) of each leaf's largest |value|: psi + g rounds once,
# the bf16 wire rounds after each of the 3 products and 3 sums, and the
# result once more (A's weights in bf16 add a quarter)
MESH_COMBINE_ULPS = 4
MESH_K3_LEAVES = {"embed/table": 28_311_552, "blocks/mlp/w_up": 26_542_080}


def mesh_gfl(variant):
    from repro_torch.configs.base import GFLConfig
    combine, kernels = MESH_VARIANTS[variant]
    return GFLConfig(topology="ring", privacy=MESH_PRIVACY,
                     sigma_g=MESH_SIGMA, mu=MESH_MU, grad_bound=MESH_BOUND,
                     combine_impl=combine, use_kernels=kernels)


def mesh_run(torch, model, variant, batches, counts=False):
    """One variant's steps on ``batches`` from the model's weights and
    fresh draws of MESH_SEED: (state, losses, host seconds a step, K1-K3
    launches of each step)."""
    from repro_torch import kernels as K
    from repro_torch.draws import Draws
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import parse_mesh

    gcfg = mesh_gfl(variant)
    mesh = parse_mesh(MESH_SPEC, "cuda")
    step = S.make_train_step(model, gcfg, mesh)
    state = S.init_train_state(model, gcfg, mesh, Draws(MESH_SEED, "cuda"))
    losses, secs, launches = [], [], []
    for batch in batches:
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches.append({k: K.LAUNCHES[k] for k in ROUND_KERNELS})
        losses.append(float(m["loss"]))
    K.reset_launches()
    return state, losses, secs, launches


def mesh_combine_fn(torch, variant, A, psi, g):
    """What the step does after its noise is drawn, for one variant."""
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import parse_mesh
    combine, kernels = MESH_VARIANTS[variant]
    if combine == "dense":
        return ((lambda: S._kernel_dense_combine(A, psi, g)) if kernels
                else (lambda: S._dense_combine(A, psi, g)))
    fn = S._rotate_combine if combine == "rotate" else S._sparse_combine
    mesh, gcfg = parse_mesh(MESH_SPEC, "cuda"), mesh_gfl(variant)

    def run():
        mixed = fn(mesh, gcfg, {k: x + g[k] for k, x in psi.items()}, A)
        return {k: (m.float() - g[k].float()).to(m.dtype)
                for k, m in mixed.items()}
    return run


def k3_bf16_rows(torch, A, gen) -> dict:
    """K3 in bf16 at the mesh's two largest leaves, [4, N], with g and
    without, beside its plain version, the library call (addmm / mm in
    bf16, A^T as a view) and its bound: 3 (or 2) x 4 x N x 2 bytes."""
    from repro_torch.kernels import graph_combine as gc
    from repro_torch.launch.kernel_bench import time_ms

    bf = torch.bfloat16
    a_bf = A.to(bf)
    rows = {}
    for leaf, N in MESH_K3_LEAVES.items():
        psi = torch.randn((MESH_P, N), generator=gen, device="cuda").to(bf)
        gn = (MESH_SIGMA * torch.randn((MESH_P, N), generator=gen,
                                       device="cuda")).to(bf)
        x, neg_g = psi + gn, -gn
        for variant, g_ in (("g", gn), ("none", None)):
            lib = ((lambda: torch.addmm(neg_g, a_bf.T, x)) if g_ is not None
                   else (lambda: torch.mm(a_bf.T, psi)))
            ms, lib_ms = paired_ms(
                torch, lambda: gc.graph_combine(A, psi, g_), lib)
            plain = gc.graph_combine_plain(A, psi, g_)
            got = gc.graph_combine(A, psi, g_)
            ulp = 2.0 ** -7 * float(plain.float().abs().max())
            err = max_err(torch, got, plain)
            require(err <= ulp, f"mesh: K3 bf16 {leaf} [{variant}] max abs "
                    f"err {err} > one bf16 ulp {ulp}")
            rows[f"{leaf}[{variant}]"] = bound({
                "shape": [MESH_P, N], "ms": ms, "library_ms": lib_ms,
                "plain_ms": time_ms(lambda: gc.graph_combine_plain(
                    A, psi, g_), budget_s=0.3, max_reps=20),
                "max_abs_err": err, "ulp": ulp,
                "bytes": MESH_P * MESH_P * 4
                + (3 if g_ is not None else 2) * MESH_P * N * 2,
                "flops": 2 * MESH_P * MESH_P * N
                + (2 * MESH_P * N if g_ is not None else 0)})
            del plain, got
        del psi, gn, x, neg_g
        torch.cuda.empty_cache()
    return rows


def phase_mesh(torch) -> dict:
    """The mesh trainer (repro_torch.launch.train) at smollm-135m's full
    width in bf16 on mesh 4x1 in one process (module docstring, phase
    14).  Returns K3's launches of its main path, counted from 0 just
    before it."""
    import io
    import statistics
    from repro_torch import kernels as K
    from repro_torch import rng
    from repro_torch.configs.registry import get_config
    from repro_torch.core.privacy.mechanism import (RoundContext,
                                                    mechanism_for)
    from repro_torch.data.synthetic import TokenStream, federated_token_batches
    from repro_torch.draws import DrawKey, Draws
    from repro_torch.kernels import graph_combine as gc
    from repro_torch.launch import private_serving, serve
    from repro_torch.launch import steps as S
    from repro_torch.launch import train
    from repro_torch.launch.kernel_bench import time_ms
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.models.flat import FlatView
    from repro_torch.models.model import Model

    t_phase = time.perf_counter()
    cfg = get_config(MESH_ARCH)
    require(cfg.num_layers == 30 and cfg.d_model == 576
            and (cfg.num_heads, cfg.num_kv_heads) == (9, 3)
            and cfg.d_ff == 1536 and cfg.vocab_size == 49152
            and cfg.tie_embeddings and cfg.param_dtype == "bfloat16",
            f"{cfg.name} is not at full width in bf16")
    # the main path: the entry a user calls, K3 counted from 0 just before
    out_lines = io.StringIO()
    K.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out_lines):
        run = train.main([
            "--arch", MESH_ARCH, "--mesh", MESH_SPEC, "--steps",
            str(MESH_STEPS), "--seq", str(MESH_SEQ), "--clients",
            str(MESH_L), "--per-client", str(MESH_PER_CLIENT), "--privacy",
            MESH_PRIVACY, "--sigma", str(MESH_SIGMA), "--mu", str(MESH_MU),
            "--combine", "dense", "--use-kernels"])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {k: K.LAUNCHES[k] for k in ROUND_KERNELS}
    want = {"fold_norms": 0, "fold_apply": 0,
            "graph_combine": MESH_LEAVES * MESH_STEPS}
    require(launches == want, f"mesh: {MESH_STEPS} dense kernel steps "
            f"launched {launches}, expected {want}")
    losses = [h["loss"] for h in run["history"]]
    require(all(map(math.isfinite, losses)), f"mesh: loss {losses}")
    tree = run["state"].params
    require(len(tree) == MESH_LEAVES
            and all(v.dtype == torch.bfloat16 for v in tree.values())
            and sum(v[0].numel() for v in tree.values()) == TRAIN_D,
            "mesh: the state is not the bf16 tree of smollm-135m")
    for line in out_lines.getvalue().splitlines():
        emit({"phase": "mesh", "log": line})
    emit({"phase": "mesh", "main": "python -m repro_torch.launch.train",
          "mesh": MESH_SPEC, "steps": MESH_STEPS, "loss": losses,
          "launches": launches, "run_s": main_s,
          "leaves": {k: list(v.shape) for k, v in tree.items()}})
    del run, tree
    torch.cuda.empty_cache()

    # the four variants from one init, each twice: bitwise reruns
    model = Model.init(cfg, rng(MESH_SEED, "cuda"))
    stream = TokenStream(vocab=cfg.vocab_size, seed=0)
    batches = [federated_token_batches(stream, 0, i, MESH_P, MESH_L,
                                       MESH_PER_CLIENT, MESH_SEQ)
               for i in range(MESH_VARIANT_STEPS)]
    finals, records = {}, {}
    for variant in MESH_VARIANTS:
        state, loss, secs, counts = mesh_run(torch, model, variant, batches)
        again = mesh_run(torch, model, variant, batches)
        require(all(torch.equal(v, again[0].params[k])
                    for k, v in state.params.items())
                and again[1] == loss, f"mesh: a rerun of {variant} differs")
        require(all(map(math.isfinite, loss)), f"mesh: {variant} loss {loss}")
        k3 = MESH_LEAVES if variant == "dense_k" else 0
        require(all(c == {"fold_norms": 0, "fold_apply": 0,
                          "graph_combine": k3} for c in counts),
                f"mesh: {variant} launched {counts} a step, expected K3 "
                f"{k3} times")
        finals[variant] = state.params
        records[variant] = {"loss": loss, "step_s": secs,
                            "rerun_step_s": again[2],
                            "k3_launches_a_step": k3}
        del again
    cent = {v: p["embed/table"].float().mean(dim=0)
            for v, p in finals.items()}
    cerr = {v: max_err(torch, cent[v], cent["dense"])
            for v in ("dense_k", "rotate", "sparse")}
    for v, e in cerr.items():
        require(e <= MESH_CENTROID_ATOL, f"mesh: {v}'s embedding centroid "
                f"{e} from dense's, over {MESH_CENTROID_ATOL}")
    emit({"phase": "mesh", "variants": records,
          "centroid_max_abs_err_from_dense": cerr,
          "centroid_atol": MESH_CENTROID_ATOL, "rerun_bitwise": True})

    # K3 against its plain version on every leaf, bf16: one ulp of the
    # leaf's largest |value| (both sum in f32 and round once)
    psi = finals["dense_k"]
    del finals, cent
    torch.cuda.empty_cache()
    mech = mechanism_for(mesh_gfl("dense_k"))
    shapes = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
              for k, v in psi.items()}

    def noise(seed):
        return mech.combine_noise_tree(DrawKey(Draws(seed, "cuda"), 0),
                                       shapes, RoundContext(step=0))
    g = noise(MESH_SEED + 1)
    A = torch.as_tensor(S.make_combination_matrix(
        parse_mesh(MESH_SPEC, "cuda"), mesh_gfl("dense_k")),
        dtype=torch.float32, device="cuda")
    leaf_err = {}
    for tag, g_ in (("g", g), ("none", None)):
        got = S._kernel_dense_combine(A, psi, g_)
        for k, x in psi.items():
            plain = gc.graph_combine_plain(
                A, x.reshape(MESH_P, -1),
                None if g_ is None else g_[k].reshape(MESH_P, -1))
            ulp = 2.0 ** -7 * float(plain.float().abs().max())
            err = max_err(torch, got[k].reshape(MESH_P, -1), plain)
            require(err <= ulp, f"mesh: K3 on {k} [{tag}] max abs err "
                    f"{err} > one bf16 ulp {ulp}")
            leaf_err[f"{k}[{tag}]"] = [err, ulp]
            del plain
        del got
    emit({"phase": "mesh", "k3_leaf_max_abs_err_and_ulp": leaf_err})

    # a step's split: the clients' gradients, the noise tree, the combine
    view = FlatView(model)
    w = {k: v[0] for k, v in psi.items()}

    # the 8 clients' gradients of one step, once (warm: the steps above
    # ran them), on the host clock ending in a synchronize
    b = batches[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in range(MESH_P):
        for l in range(MESH_L):
            view.tree_grad(model, w, lambda: model.loss(
                tokens=b["tokens"][p, l].cuda(),
                labels=b["labels"][p, l].cuda())[0])
    torch.cuda.synchronize()
    seeds = iter(range(1000, 10 ** 6))
    split = {"grads_ms": (time.perf_counter() - t0) * 1e3,
             "noise_ms": time_ms(lambda: noise(next(seeds)), budget_s=0.5,
                                 max_reps=10)}
    # rotate and sparse on the same psi and g against the f32 einsum,
    # every leaf (the centroid above cannot see a wrong mix: A is doubly
    # stochastic, so any combine keeps the mean over servers)
    einsum = S._dense_combine(A, psi, g)
    comb_err = {}
    for variant in MESH_VARIANTS:
        fn = mesh_combine_fn(torch, variant, A, psi, g)
        split[f"combine_ms[{variant}]"] = time_ms(fn, budget_s=0.5,
                                                  max_reps=20)
        if variant not in ("rotate", "sparse"):
            continue
        got = fn()
        for k, x in got.items():
            ulp = 2.0 ** -7 * float(einsum[k].float().abs().max())
            err = max_err(torch, x, einsum[k])
            require(err <= MESH_COMBINE_ULPS * ulp, f"mesh: {variant} on "
                    f"{k} max abs err {err} from the f32 einsum > "
                    f"{MESH_COMBINE_ULPS} bf16 ulps {MESH_COMBINE_ULPS * ulp}")
            comb_err[f"{variant}:{k}"] = [err, ulp]
        del got
    del einsum
    emit({"phase": "mesh", "combine_max_abs_err_and_ulp_from_einsum": comb_err,
          "ulps_allowed": MESH_COMBINE_ULPS})
    for variant, rec in records.items():
        split[f"step_ms[{variant}]"] = statistics.median(
            rec["step_s"] + rec["rerun_step_s"]) * 1e3
    # K3's 11 leaves a step: psi and g read, out written, in bf16
    split["k3_leaves_bound_ms"] = bound({
        "bytes": 3 * MESH_P * TRAIN_D * 2
        + MESH_LEAVES * MESH_P * MESH_P * 4, "flops": 0})["bound_ms"]
    emit({"phase": "mesh", "split": split})
    del psi, g, w, view, model
    torch.cuda.empty_cache()

    # K3 in bf16 at the two largest leaves
    gen = torch.Generator(device="cuda")
    gen.manual_seed(26)
    rows = k3_bf16_rows(torch, A, gen)
    emit({"phase": "mesh", "k3_bf16": rows})

    # serve --mesh 1x1 is the one-process path; private_serving runs;
    # each decodes through K8, counted from 0 just before it: one launch
    # an attention application and decode step
    pcfg = get_config("phi3-mini-3.8b").reduced()
    args = ["--reduced", "--mesh", "1x1", "--seed", "0", "--batch", "4",
            "--prompt-len", "64", "--new-tokens", "16"]
    k8 = {}
    with contextlib.redirect_stdout(io.StringIO()):
        K.reset_launches()
        got = serve.main(args)["tokens"]
        k8["serve_mesh_1x1"] = (K.LAUNCHES["swa_decode"],
                                (got.shape[1] - 1) * attn_per_step(pcfg))
        gen = rng(0, "cuda")
        pm = Model.init(pcfg, gen)
        prompt = torch.randint(0, pcfg.vocab_size, (4, 64), generator=gen,
                               device="cuda")
        want = serve.generate(pm, prompt, 16)["tokens"]
        ps = io.StringIO()
        with contextlib.redirect_stdout(ps):
            K.reset_launches()
            ptoks = private_serving.main([])["tokens"]
            k8["private_serving"] = (K.LAUNCHES["swa_decode"],
                                     (ptoks.shape[1] - 1)
                                     * attn_per_step(pcfg))
        K.reset_launches()
    for what, (n, n_want) in k8.items():
        require(n == n_want > 0, f"mesh: {what} launched K8 {n} times, "
                f"expected {n_want}")
    require(torch.equal(got, want), "mesh: serve --mesh 1x1 tokens differ "
            "from serve.generate's")
    require("OK" in ps.getvalue(), "mesh: private_serving did not finish")
    emit({"phase": "mesh", "serve_mesh_1x1_tokens_equal": True,
          "k8_launches_and_expected": k8,
          "private_serving": ps.getvalue().splitlines()[-3:]})
    del pm, prompt
    torch.cuda.empty_cache()
    emit({"phase": "mesh", "seconds": time.perf_counter() - t_phase})
    return {"launches": launches}


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
        if (B, H, KV, C, Dh) in (SWA_SERVE_SHAPE, SWA_ZAMBA2_SHAPE,
                                 (2, 8, 4, 1000, 64)):
            emit({"phase": "swa", "cuda_graph": [B, H, KV, C, Dh],
                  "dtype": dname, **graph_replay(torch, swa, q, k, v, C)})
        del kvs, k, v
        torch.cuda.empty_cache()
    return rows[(SWA_SERVE_SHAPE, "bfloat16", SWA_SERVE_SHAPE[3])]


# ---------------------------------------------------------------- serve


class DecodeTap:
    """Stands in for ops.swa_decode_attention during a request: passes
    every call through and keeps copies of the inputs and output of the
    (application, step) calls it is asked for; ``n_attn`` is the attention
    applications a step (``attn_per_step``)."""

    def __init__(self, ops, n_attn, keep):
        self.ops, self.n_attn, self.keep = ops, max(n_attn, 1), set(keep)
        self.orig = ops.swa_decode_attention
        self.calls, self.captured, self.nvalid = 0, {}, []

    def __enter__(self):
        self.ops.swa_decode_attention = self
        return self

    def __exit__(self, *exc):
        self.ops.swa_decode_attention = self.orig

    def __call__(self, q, k, v, nvalid):
        step, layer = divmod(self.calls, self.n_attn)
        self.calls += 1
        out = self.orig(q, k, v, nvalid)
        if layer == 0:
            self.nvalid.append(nvalid)
        if (layer, step) in self.keep:
            self.captured[(layer, step)] = tuple(
                t.clone() for t in (q, k, v, nvalid.reshape(1), out))
        return out


class MoETap:
    """Stands in for ``models.moe.moe_forward`` during a request: passes
    every call through with a stats dict, sums routed and dropped entries
    for the prefill and the decode steps apart, and keeps the params, input
    and output of the first MoE layer of decode step 0."""

    def __init__(self, moe, n_moe):
        self.moe, self.n_moe = moe, n_moe
        self.orig = moe.moe_forward
        self.calls, self.captured = 0, None
        self.stats = {"prefill": {}, "decode": {}}

    def __enter__(self):
        self.moe.moe_forward = self
        return self

    def __exit__(self, *exc):
        self.moe.moe_forward = self.orig

    def __call__(self, params, x, cfg, stats=None):
        i = self.calls
        self.calls += 1
        st = self.stats["prefill" if i < self.n_moe else "decode"]
        out, aux = self.orig(params, x, cfg, st)
        if i == self.n_moe:
            self.captured = (params, x.clone(), out.clone())
        return out, aux

    def counts(self) -> dict:
        return {phase: {"entries": st.get("entries", 0),
                        "dropped": int(st.get("dropped", 0))}
                for phase, st in self.stats.items()}


def moe_plain(torch, params, x, cfg):
    """The MoE layer token by token: the router in f32, the token's top-k
    experts' SwiGLU (each product in the weights' dtype, as the layer runs
    it), their gate-weighted sum in f32, plus the shared experts."""
    import torch.nn.functional as F
    m = cfg.moe
    xf = x.reshape(-1, x.shape[-1])
    rows = []
    for t in range(xf.shape[0]):
        xt = xf[t:t + 1]
        probs = torch.softmax((xt @ params["router"]).float(), dim=-1)[0]
        vals, idx = torch.topk(probs, m.top_k)
        vals = vals / vals.sum().clamp(min=1e-9)
        acc = torch.zeros(xf.shape[1], dtype=torch.float32, device=x.device)
        for j in range(m.top_k):
            e = int(idx[j])
            h = F.silu(xt @ params["w_gate"][e]) * (xt @ params["w_up"][e])
            acc += vals[j] * (h @ params["w_down"][e])[0].float()
        if m.num_shared_experts:
            sh = params["shared"]
            h = F.silu(xt @ sh["w_gate"]) * (xt @ sh["w_up"])
            acc += (h @ sh["w_down"])[0].float()
        rows.append(acc)
    return torch.stack(rows).reshape(x.shape)


def attn_per_step(cfg) -> int:
    """GQA attention applications a decode step, each one K8 launch: every
    layer of a GQA dense or MoE model, the hybrid family's shared block
    once every ``hybrid_attn_every`` layers, none for MLA and RWKV-6."""
    if cfg.attention != "gqa":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.hybrid_attn_every
    return cfg.num_layers


def decode_profile(torch, model, toks, cache, steps, tries=TRACE_TRIES):
    """torch.profiler over ``steps`` decode steps (already warm).  A trace
    whose K8 count is not one a GQA attention application and step (none
    for MLA and RWKV-6) is taken again, up to ``tries`` traces (the
    profiler has been seen to lose one kernel record of thousands).  No
    trace may run SDPA, and its softmax calls must be the router's (one a
    MoE layer and step) and MLA's (one a layer and step) alone: GQA
    attention goes through K8, and Mamba2 and RWKV-6 run no softmax.  The
    trace is ``traced``'s, unfenced (the K8 count is the gate); its markers
    are not counted.  Whisper's cross-attention is plain f32 (the
    reference's), one softmax a layer and step."""
    cfg = model.cfg
    n_moe = sum("moe" in bp for bp in model.blocks)
    want = steps * attn_per_step(cfg)
    # the router's, MLA's and whisper's cross-attention's: one a layer
    want_softmax = steps * (n_moe + (cfg.num_layers
                                     if cfg.attention == "mla"
                                     or cfg.family == "audio" else 0))
    state = {"toks": toks, "cache": cache}

    def block():
        # marker kernels ahead of the steps, not counted: after earlier
        # profiling a trace has lost about 30 leading records (whisper's
        # first K8 of a step among them), and these are lost instead
        for _ in range(TRACE_LEAD_PAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, state["cache"] = model.decode_step(state["toks"],
                                                       state["cache"])
            state["toks"] = logits.argmax(-1)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for attempt in range(tries):
        tr = traced(torch, block, f"serve: {steps} decode steps",
                    fenced=False)
        prof, wall = tr["prof"], tr["value"]
        busy, k8, k8_n, count, by_name = 0.0, 0.0, 0, 0, {}
        for evt in tr["device"]:
            us = evt.time_range.elapsed_us()
            busy += us
            count += 1
            tot = by_name.setdefault(evt.name[:60], [0.0, 0])
            tot[0] += us
            tot[1] += 1
            if "swa_decode" in evt.name:
                k8 += us
                k8_n += 1
        host = {e.key: e.count for e in prof.key_averages()}
        banned = sorted(n for n in set(host) | set(by_name)
                        if "scaled_dot_product" in n
                        or (not want_softmax and "softmax" in n.lower()))
        require(not banned, f"decode step runs {banned}: the attention core "
                "must go through K8 alone")
        softmax = host.get("aten::softmax", 0)
        require(softmax == want_softmax, f"decode steps ran {softmax} "
                f"softmax calls, expected {want_softmax} (router and MLA)")
        if k8_n == want:
            break
        emit({"phase": "serve", "retrace": attempt + 1, "k8_launches": k8_n,
              "expected": want})
    require(k8_n == want,
            f"profiled {steps} decode steps saw {k8_n} K8 launches in each "
            f"of {tries} traces, expected {want}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {"steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
            "device_busy_ms_per_step": busy / 1e3 / steps,
            "device_idle_share": 1.0 - busy / 1e6 / wall,
            "device_ops_per_step": count / steps,
            "softmax_calls_per_step": softmax / steps,
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


def serve_config(arch):
    """The arch's registry config at full width, with its depth cut (and
    the cut's record) where the card cannot hold every layer."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    cut = SERVE_DEPTH_CUTS.get(arch)
    if cut is None:
        return cfg, None
    layers, why = cut
    return (dataclasses.replace(cfg, num_layers=layers),
            {"num_layers": f"{cfg.num_layers} -> {layers}", "why": why})


def cache_step_bytes(cfg, B, mean_live):
    """Bytes of the cache one decode step must move, as (all, the KV
    part): the KV part is K and V of every KV head (bf16), or MLA's latent
    and roped key, at ``mean_live`` slots, over every attention
    application; the recurrent state is read and written once a step:
    Mamba2's f32 ``h`` and its bf16 conv window of K - 1 rows, RWKV-6's
    f32 ``wkv`` and its bf16 ``att_x`` and ``ffn_x``; whisper's decoder
    reads its cross K and V (f32, the encoder's Se rows) every step, a
    part the KV part (K8's) leaves out."""
    L = cfg.num_layers
    if cfg.family == "ssm":
        H, hs = cfg.d_model // cfg.rwkv.head_size, cfg.rwkv.head_size
        return 2 * L * B * (H * hs * hs * 4 + 2 * cfg.d_model * 2), 0
    if cfg.attention == "mla":
        row = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    else:
        row = 2 * cfg.num_kv_heads * cfg.resolved_head_dim
    kv = attn_per_step(cfg) * B * mean_live * row * 2
    if cfg.family == "audio":
        return kv + L * B * cfg.encoder_seq_len * row * 4, kv
    if cfg.family != "hybrid":
        return kv, kv
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.headdim
    conv_ch = d_inner + 2 * s.ngroups * s.state_dim
    state = H * s.headdim * s.state_dim * 4 + (s.conv_dim - 1) * conv_ch * 2
    return kv + 2 * L * B * state, kv


def serve_request(torch, model, name, B, S, gen, moe_mod, ops):
    """One request through ``launch.serve.generate`` with its gates (a
    vlm's image embeddings and whisper's frames drawn as the serve entry
    draws them); the record to print, and the prompt, stub inputs and
    output for the rerun."""
    from repro_torch import kernels as K
    from repro_torch.kernels.ref import swa_decode_attention_plain
    from repro_torch.launch.serve import generate, stub_inputs

    cfg = model.cfg
    L = cfg.num_layers
    n_attn = attn_per_step(cfg)
    n_moe = sum("moe" in bp for bp in model.blocks)
    keep = [(a, step) for a in sorted({0, n_attn - 1}) if n_attn
            for step in (0, SERVE_NEW_TOKENS - 1)]
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    inputs = stub_inputs(cfg, B, gen)
    # the tokens the cache holds after the prefill: a vlm's image ones too
    S_all = S + (cfg.num_image_tokens if cfg.family == "vlm" else 0)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    with contextlib.ExitStack() as stack:
        tap = stack.enter_context(DecodeTap(ops, n_attn, keep))
        mtap = stack.enter_context(MoETap(moe_mod, n_moe)) if n_moe else None
        out = generate(model, prompt, SERVE_NEW_TOKENS, **inputs)
    counts = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    cache = out["cache"]
    kv_name = next((n for n in ("attn_k", "k", "c_kv") if n in cache), None)
    C = cache[kv_name].shape[2] if kv_name else None     # RWKV-6: no KV
    require(bool(torch.isfinite(out["logits"].float()).all()),
            f"{cfg.name} request {name}: non-finite logits")
    want_k8 = n_attn * SERVE_NEW_TOKENS
    require(counts["swa_decode"] == want_k8,
            f"{cfg.name} request {name}: {counts['swa_decode']} K8 "
            f"launches, expected {want_k8}")
    rec = {"phase": "serve", "arch": cfg.name, "request": name, "batch": B,
           "prompt": S, "prefill_tokens": S_all,
           "stub_inputs": {k: list(v.shape) for k, v in inputs.items()},
           "new_tokens": SERVE_NEW_TOKENS, "cache_slots": C,
           "launches": counts}
    live = {}
    if n_attn:
        nvalid = [int(n) for n in tap.nvalid]
        require(nvalid == [min(S_all + 1 + t, C)
                           for t in range(SERVE_NEW_TOKENS)],
                f"{cfg.name} request {name}: nvalid {nvalid[:3]}...")
        require(sorted(tap.captured) == sorted(keep),
                f"{cfg.name} request {name}: live K8 checks "
                f"{sorted(tap.captured)}, expected {sorted(keep)}")
        for (layer, step), (q, k, v, nv, got) in sorted(tap.captured.items()):
            want = swa_decode_attention_plain(q, k, v, nv)
            err = check_close(torch, f"serve {cfg.name} {name} attention "
                              f"{layer} step {step}", got, want,
                              torch.bfloat16, tol=bf16_tol(torch, want))
            require(torch.equal(got, ops.swa_decode_attention(q, k, v, nv)),
                    f"serve {cfg.name} {name} attention {layer} step {step}: "
                    "rerun differs")
            live[f"layer{layer}_step{step}"] = {"nvalid": int(nv),
                                                "max_abs_err": err}
        mean_live = sum(nvalid) / len(nvalid)
        rec.update(nvalid_first_last=[nvalid[0], nvalid[-1]],
                   ring_wrapped=S_all > C)
    else:
        require(not tap.calls, f"{cfg.name}: decode reached K8, which runs "
                "no attention of an MLA or RWKV-6 model")
        mean_live = S_all + (SERVE_NEW_TOKENS + 1) / 2
    if mtap is not None:
        moe_counts = mtap.counts()
        params, x, got = mtap.captured
        want = moe_plain(torch, params, x, cfg)
        tol = bf16_tol(torch, want.to(torch.bfloat16))
        err = check_close(torch, f"serve {cfg.name} {name} MoE layer of "
                          "decode step 0", got, want, torch.bfloat16,
                          tol=tol)
        require(moe_counts["decode"]["dropped"] == 0,
                f"{cfg.name} request {name}: decode dropped "
                f"{moe_counts['decode']['dropped']} routed entries")
        pre = moe_counts["prefill"]
        used = ((got.float() - want).abs()
                / (tol[0] + tol[1] * want.abs())).max()
        live["moe_step0"] = {"layer": L - n_moe, "tokens": x.shape[0],
                             "max_abs_err": err, "atol": tol[0],
                             "rtol": tol[1],
                             "share_of_tolerance": float(used)}
        rec.update(moe_entries=moe_counts,
                   prefill_dropped_share=pre["dropped"] / pre["entries"])
        del mtap, params, x, got
    rec["live_checks"] = live
    del tap
    step_cache, step_kv = cache_step_bytes(cfg, B, mean_live)
    rec.update(prefill_ms=out["prefill_s"] * 1e3,
               decode_ms_per_step=out["decode_s"] * 1e3 / SERVE_NEW_TOKENS,
               decode_tok_per_s=B * SERVE_NEW_TOKENS / out["decode_s"],
               peak_memory_bytes=peak, mean_live_slots=mean_live,
               step_cache_bytes=step_cache, step_kv_bytes=step_kv)
    return rec, prompt, inputs, out


def phase_serve(torch):
    """Each of SERVE_MODELS at full width (mixtral's depth cut), in bf16
    (but SERVE_F32_LEAVES), random weights from seed 0, its requests
    through ``launch.serve.generate``, each model freed before the next.
    Returns the K8 launches of the requests."""
    import dataclasses
    from repro_torch import rng
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.roofline import HBM_BYTES_PER_S, active_params
    from repro_torch.launch.serve import generate
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import Model

    launches = 0
    for arch, requests in SERVE_MODELS:
        t_arch = time.perf_counter()
        cfg, cut = serve_config(arch)
        gen = rng(0, "cuda")
        t0 = time.perf_counter()
        model = Model.init(cfg, gen)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        weight_bytes = sum(p.numel() * p.element_size()
                           for p in model.parameters())
        # decode reads B rows of the table, unless it is tied (unembed);
        # whisper's encoder runs in the prefill alone, and a step reads
        # one row of its position table
        table_bytes = (0 if cfg.tie_embeddings else
                       model.embed["table"].numel() * 2)
        if cfg.family == "audio":
            table_bytes += sum(
                p.numel() * p.element_size() for n, p
                in model.named_parameters()
                if n.startswith(("enc_blocks.", "enc_norm.", "dec_pos")))
        n_active = active_params(cfg, n_params)
        # the hybrid family's shared block is read once an application:
        # at 134 MB (zamba2) it does not stay in the 50 MB L2
        shared_bytes = (0 if model.shared_attn is None else
                        sum(p.numel() * p.element_size()
                            for p in model.shared_attn.parameters()))
        reread_bytes = shared_bytes * (attn_per_step(cfg) - 1) \
            if shared_bytes else 0
        full = get_config(arch)
        require(dataclasses.replace(cfg, num_layers=full.num_layers) == full
                and len(model.blocks) == cfg.num_layers
                and model.embed["table"].shape[1] == full.d_model,
                f"{arch} is not at full width")
        f32 = sorted(n for n, p in model.named_parameters()
                     if tuple(n.split(".")[-2:]) in SERVE_F32_LEAVES)
        require(cfg.param_dtype == "bfloat16"
                and all(p.dtype == (torch.float32 if n in f32
                                    else torch.bfloat16)
                        for n, p in model.named_parameters()),
                f"{arch} is not in bf16 (but {sorted(SERVE_F32_LEAVES)} "
                "in f32)")
        emit({"phase": "serve", "arch": arch, "params": n_params,
              "active_params": n_active, "weight_bytes": weight_bytes,
              "f32_params": len(f32), "shared_block_bytes": shared_bytes,
              "attention_per_step": attn_per_step(cfg),
              "layers": cfg.num_layers, "d_model": cfg.d_model,
              "reduced": cut, "init_s": init_s})
        for name, B, S in requests:
            rec, prompt, inputs, out = serve_request(
                torch, model, name, B, S, gen, moe_mod, ops)
            launches += rec["launches"]["swa_decode"]
            cache_b = rec["step_cache_bytes"]
            step_bytes = weight_bytes - table_bytes + reread_bytes + cache_b
            # the active parameters' bytes (the routed experts a token
            # uses), without the table, beside every expert's
            active_bytes = 2 * n_active - table_bytes + reread_bytes + cache_b
            rec.update(step_bytes=step_bytes,
                       step_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3,
                       reckoned_step_gb=SERVE_RECKONED_STEP_GB.get(arch),
                       active_step_bytes=active_bytes,
                       active_bound_ms=active_bytes / HBM_BYTES_PER_S * 1e3)
            if attn_per_step(cfg):
                rec["k8_bound_ms_per_step"] = (rec["step_kv_bytes"]
                                               / HBM_BYTES_PER_S * 1e3)
            rec["profile"] = decode_profile(torch, model,
                                            out["tokens"][:, -1],
                                            out["cache"],
                                            SERVE_PROFILE_STEPS)
            emit(rec)
            if name == requests[-1][0]:
                # the last request again: the same tokens and logits, bit
                # for bit
                again = generate(model, prompt, SERVE_NEW_TOKENS, **inputs)
                require(torch.equal(again["tokens"], out["tokens"])
                        and torch.equal(again["logits"], out["logits"]),
                        f"{arch} request {name}: a second generate differs")
                emit({"phase": "serve", "arch": arch, "request": name,
                      "rerun_bitwise_equal": True})
                del again
            del out, prompt, inputs
            torch.cuda.empty_cache()
        del model
        torch.cuda.empty_cache()
        emit({"phase": "serve", "arch": arch,
              "freed_to_bytes": torch.cuda.memory_allocated(),
              "seconds": time.perf_counter() - t_arch})
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
    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        emit({"phase": name, "phase_seconds": time.perf_counter() - t0})
        return out

    try:
        kind, smi = timed("device", phase_device, torch)
        timed("build", phase_build)
        errs, timings = timed("kernels", phase_kernels, torch)
        kb_errs, kb_timings, kb_launches = timed(
            "kernel_bench", phase_kernel_bench, torch)
        launches, prob = timed("main", phase_main, torch)
        timed("fig2", phase_fig2, torch)
        timed("resilience", phase_resilience, torch, prob)
        timed("profile", phase_profile, torch, prob)
        del prob
        timed("population", phase_population, torch)
        ev = timed("events", phase_events, torch)
        timed("observe", phase_observe, torch, smi)
        fl = timed("fleet", phase_fleet, torch)
        train = timed("train", phase_train, torch)
        mesh = timed("mesh", phase_mesh, torch)
        swa_row = timed("swa", phase_swa, torch)
        launches["swa_decode"] = timed("serve", phase_serve, torch)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    for name in kb_errs:
        launches[name] = kb_launches[name]
        errs[name] = kb_errs[name]
    for name, n in ev["launches"].items():     # the event phase's K1-K3
        launches[name] += n
    for name, n in fl["launches"].items():     # the fleet phase's K1-K3
        launches[name] += n
    for name, n in train["launches"].items():  # the federated LM's K1-K3
        launches[name] += n
    for name, n in mesh["launches"].items():   # the mesh trainer's K3
        launches[name] += n
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
    known = [o for o in TRACE_OFFSETS if o is not None]
    emit({"phase": "profiler", **TRACE_COUNTS,
          "offset_us_least": min(known, default=None),
          "offset_us_most": max(known, default=None),
          "traces_off_by_over_1ms": sum(abs(o) > 1e3 for o in known)})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "power": smi})
    print(smi, flush=True)          # card name and power limit, nvidia-smi
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
