"""Back-to-back runs of the paper's experiment: a seed sweep.

Set-up draws the Section V problem from the seed
(:mod:`gflbench.traffic.section5`) and makes the warm-up runs.  A unit is
one ``repro_torch.core.simulate.run_gfl`` run of ``rounds`` rounds from
zero parameters, each with its own noise seed drawn from the run's seed,
its final parameters read back to the host: what a user's sweep pays a
run, its warm-up round and graph capture included.

The check replays a sample of the window's runs, drawn from the seed, with
the plain round (:func:`gflbench.reference.gfl.logistic_run`) in float64
and compares each run's final parameters and MSD trace with the
program's.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from gflbench.reference import gfl as ref
from gflbench.traffic import section5


def unit_seed(seed: int, purpose: int, index: int) -> int:
    return int(np.random.SeedSequence([seed, purpose, index]).generate_state(
        1, np.uint32)[0])


class Driver:
    def __init__(self, config: dict, workload: dict, seed: int, device,
                 spans):
        self.cfg, self.wl, self.seed = config, workload, seed
        self.device, self.spans = device, spans
        self.proto = {"P": config["P"], "K": config["K"], "N": config["N"],
                      "L": workload["clients_sampled"] or config["K"],
                      "B": config["batch_size"], "mu": config["mu"],
                      "rho": config["rho"], "bound": config["grad_bound"],
                      "sigma": config["sigma_g"],
                      "topology": config["topology"]}
        self.rounds = workload["rounds"]
        self.runs: list = []           # every unit: (seed, wall s, params,
                                       # msd, capture s)

    def setup(self) -> None:
        from repro_torch.configs.base import GFLConfig
        from repro_torch.core import simulate
        c = self.cfg
        feats, labels, w_opt = section5.make_problem(self.seed, c,
                                                     self.device)
        self.problem = (feats, labels, w_opt)
        self.prob = simulate.LogisticProblem(feats, labels, c["rho"], w_opt)
        self.gcfg = GFLConfig(
            num_servers=c["P"], clients_per_server=c["K"],
            clients_sampled=self.wl["clients_sampled"],
            topology=c["topology"], privacy=self.wl["privacy"],
            sigma_g=c["sigma_g"], mu=c["mu"], grad_bound=c["grad_bound"],
            use_kernels=self.wl["use_kernels"])
        for k in range(self.wl["warmup_runs"]):
            self._run(unit_seed(self.seed, 5, k))

    def _run(self, run_seed: int):
        from repro_torch.core import simulate
        from repro_torch.telemetry.profile import compile_counters
        before = compile_counters()["compile_s"]
        t0 = time.perf_counter()
        with self.spans("run_gfl"):
            msd, params = simulate.run_gfl(
                self.prob, self.gcfg, iters=self.rounds,
                batch_size=self.proto["B"], seed=run_seed,
                executor=self.wl["executor"])
        with self.spans("read_back"):
            params = params.cpu()
        wall = time.perf_counter() - t0
        return (run_seed, wall, params, np.asarray(msd),
                compile_counters()["compile_s"] - before)

    def units(self, *, seconds: float = 0.0, count: int = 0) -> dict:
        """Runs until ``seconds`` have passed (the last run finished) or
        ``count`` runs are done; returns the window's record."""
        first = len(self.runs)
        t0 = time.perf_counter()
        while True:
            self.runs.append(self._run(unit_seed(self.seed, 4,
                                                 len(self.runs))))
            elapsed = time.perf_counter() - t0
            n = len(self.runs) - first
            if (count and n >= count) or (not count and elapsed >= seconds):
                break
        runs = self.runs[first:]
        return {"units": n, "seconds": elapsed,
                "rounds": n * self.rounds,
                "unit_s": [r[1] for r in runs],
                "capture_s": [r[4] for r in runs],
                "first": first}

    def free(self) -> None:
        self.prob = self.gcfg = None

    # ------------------------------------------------------------ check

    def sample(self, window: dict) -> list:
        """The window's runs the check replays, drawn from the seed."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 6]))
        n = window["units"]
        pick = rng.choice(n, size=min(self.wl["check_runs"], n),
                          replace=False)
        return [window["first"] + int(i) for i in sorted(pick)]

    def reference(self, index: int, dtype=torch.float64):
        feats, labels, w_opt = self.problem
        return ref.logistic_run(feats, labels, w_opt, self.proto,
                                self.runs[index][0], self.rounds, dtype)

    def check(self, window: dict, stand_in=None) -> dict:
        """The numbers compared: the widest gap, over the sampled runs, of
        the final parameters (as a share of the run's largest reference
        parameter) and of the MSD trace (each round's as a share of that
        round's reference MSD, or of the run's median one where larger).
        ``stand_in(index)`` replaces the program's (params, msd) of a run,
        for a control."""
        params_gap, msd_gap = [], []
        for i in self.sample(window):
            if stand_in is None:
                params, msd = self.runs[i][2], self.runs[i][3]
            else:
                params, msd = stand_in(i)
            w_ref, msd_ref = self.reference(i)
            params = torch.as_tensor(params, dtype=torch.float64)
            msd = torch.as_tensor(np.asarray(msd), dtype=torch.float64)
            params_gap.append(float((params - w_ref).abs().max()
                                    / w_ref.abs().max()))
            floor = torch.clamp(msd_ref, min=float(msd_ref.median()))
            msd_gap.append(float(((msd - msd_ref).abs() / floor).max()))
        # np.max, not max: a NaN anywhere is the answer
        return {"params_gap": float(np.max(params_gap)),
                "msd_gap": float(np.max(msd_gap))}
