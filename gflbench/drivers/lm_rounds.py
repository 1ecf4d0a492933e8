"""Rounds of federated language-model training under the GFL protocol.

Set-up builds the port's trainer (``repro_torch.launch.federated_lm.
Trainer``) for the configured model, hands its step the weights drawn from
the seed (:mod:`gflbench.traffic.weights`) as the flat [P, D] state, and
drives that step through its first ``check_steps`` rounds, which the check
replays.  A unit is one round: the host draws the round's token batches
(:mod:`gflbench.traffic.tokens`), then the step
(``Trainer.step_fn``, ``core.gfl.make_gfl_step``) runs every client's
forward and backward, the fold and the combine.  The step's client
gradients are timed with CUDA events around the ``grad_fn`` it is given.

The check follows the first rounds with the plain model
(:mod:`gflbench.reference.smollm`) and the plain round
(:mod:`gflbench.reference.gfl`), and compares, leaf by leaf, the norms of
every client's gradient as the step received it, of the first update as
the servers' mean parameters show it, and of the change of the mean
parameters over the checked rounds.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from gflbench.reference import gfl as ref
from gflbench.reference import smollm
from gflbench.traffic import weights
from gflbench.traffic.tokens import TokenStream

#: a leaf whose reference gradient norm is under this share of the median
#: leaf's moves by round-off alone and is not compared
NEGLIGIBLE = 1e-3


def model_config(cfg: dict):
    """The port's ModelConfig of a Llama config with Hugging Face keys."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=cfg["name"], family="dense",
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        tie_embeddings=cfg["tie_word_embeddings"],
        rope_theta=cfg["rope_theta"], norm_eps=cfg["rms_norm_eps"],
        param_dtype=cfg["trained_in"], source=cfg["source"])


def gap(prog: torch.Tensor, refn: torch.Tensor) -> float:
    """The widest gap of norms over the leaves that count: |prog - ref| as
    a share of the reference's norm of that leaf or of the median leaf,
    whichever is larger.  ``prog`` and ``ref`` are [..., leaves]."""
    med = refn.median(dim=-1, keepdim=True).values
    keep = ~(refn < NEGLIGIBLE * med)        # a NaN is kept, and fails
    share = (prog - refn).abs() / torch.maximum(refn, med)
    return float(torch.where(keep, share, torch.zeros_like(share)).max())


class Driver:
    def __init__(self, config: dict, workload: dict, seed: int, device,
                 spans):
        self.cfg, self.wl, self.seed = config, workload, seed
        self.device, self.spans = device, spans
        self.P, self.L = workload["servers"], workload["clients"]
        self.per_client, self.seq = workload["per_client"], workload["seq"]
        self.leaves = smollm.layout(config)
        self.stream = TokenStream(config["vocab_size"], seed,
                                  workload["bigram_frac"])
        self.noise_seed = int(np.random.SeedSequence([seed, 7])
                              .generate_state(1, np.uint32)[0])
        self.events: list = []       # (grad start, grad end, step start,
                                     # step end) CUDA events a round
        self.recorded: dict = {"client": []}   # the check's program side
        self.round = 0
        self._record, self._pending = False, None

    @property
    def tokens_per_round(self) -> int:
        return self.P * self.L * self.per_client * self.seq

    def setup(self) -> None:
        from repro_torch.configs.base import GFLConfig
        from repro_torch.core import gfl
        from repro_torch.draws import Draws
        from repro_torch.launch import federated_lm
        wl = self.wl
        mcfg = model_config(self.cfg)
        gcfg = GFLConfig(num_servers=self.P, clients_per_server=self.L,
                         privacy=wl["privacy"], sigma_g=wl["sigma"],
                         mu=wl["mu"], topology=wl["topology"],
                         grad_bound=wl["grad_bound"],
                         use_kernels=wl["use_kernels"])
        with self.spans("trainer_build"):
            tr = federated_lm.Trainer.build(
                mcfg, gcfg, seq=self.seq, per_client=self.per_client,
                seed=self.seed, device=self.device)
        self._check_layout(tr.view)
        self.flat0 = weights.flat_weights(self.cfg, self.seed, self.device)
        self.state = gfl.GFLState(self.flat0.expand(self.P, -1).clone(), 0)
        self.step = tr.step_fn(grad_fn=self._timed(tr.grad_fn))
        self.draws = Draws(self.noise_seed, self.device)
        mu = wl["mu"]
        for i in range(wl["check_steps"]):
            self._round(record=True)
            c = self.state.params.mean(0)
            if i == 0:
                self.recorded["update1"] = smollm.leaf_norms(
                    (self.flat0 - c) / mu, self.leaves).cpu()
        self.recorded["change"] = smollm.leaf_norms(
            c - self.flat0, self.leaves).cpu()

    def _check_layout(self, view) -> None:
        """The step's flat vector has the stated layout (the weights are
        handed over in it), else the run cannot start."""
        theirs = [(view.key(lf), lf.offset, lf.numel * len(lf.names))
                  for lf in view.leaves]
        ours = [(lf.key, lf.offset, lf.numel) for lf in self.leaves]
        if theirs != ours:
            raise RuntimeError(f"the program's flat layout {theirs} is not "
                               f"the stated one {ours}")

    def _timed(self, grad_fn):
        def timed(params, batch):
            ev = self._event()
            with self.spans("grads"):
                out = grad_fn(params, batch)
            self._pending = (ev, self._event())
            if self._record:
                P, L, _ = out.shape
                self.recorded["client"].append(torch.stack([
                    smollm.leaf_norms(out[p, l], self.leaves)
                    for p in range(P) for l in range(L)]).view(P, L, -1)
                    .cpu())
            return out
        return timed

    def _event(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _round(self, record: bool = False) -> None:
        self._record = record
        with self.spans("draw_batch"):
            batch = self.stream.batch(self.round, self.P, self.L,
                                      self.per_client, self.seq, self.device)
        start = self._event()
        self._pending = None
        with self.spans("step"):
            self.state = self.step(self.state, batch, self.draws)
        self.events.append((*(self._pending or (start, start)), start,
                            self._event()))
        self.round += 1

    def units(self, *, seconds: float = 0.0, count: int = 0) -> dict:
        first = len(self.events)
        t0 = time.perf_counter()
        n = 0
        while True:
            self._round()
            n += 1
            if count and n >= count:
                break
            if not count and time.perf_counter() - t0 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        grad_s, step_s = [], []
        for g0, g1, s0, s1 in self.events[first:]:
            if self.device.type == "cuda":
                grad_s.append(g0.elapsed_time(g1) * 1e-3)
                step_s.append(s0.elapsed_time(s1) * 1e-3)
        return {"units": n, "seconds": elapsed, "rounds": n,
                "tokens": n * self.tokens_per_round,
                "grad_s": grad_s, "step_s": step_s}

    def free(self) -> None:
        self.state = self.step = self.draws = None
        self.events = []

    # ------------------------------------------------------------ check

    def reference(self, tf32: bool = False) -> dict:
        """The plain model and round over the checked rounds: every
        client's gradient leaf norms [steps, P, L, leaves], and the leaf
        norms of the first update and of the mean parameters' change."""
        wl, P, L = self.wl, self.P, self.L
        dev, mu = self.device, wl["mu"]
        legacy = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            A = torch.as_tensor(ref.metropolis(wl["topology"], P),
                                dtype=torch.float32, device=dev)
            w = self.flat0.expand(P, -1).clone()
            grad = torch.empty_like(self.flat0)
            moved = torch.zeros_like(self.flat0)
            client, update1 = [], None
            for t in range(wl["check_steps"]):
                batch = self.stream.batch(t, P, L, self.per_client, self.seq,
                                          dev)
                acc = torch.zeros_like(w)
                norms = []
                for p in range(P):
                    for l in range(L):
                        smollm.grad(w[p], batch["tokens"][p, l],
                                    batch["labels"][p, l], self.cfg,
                                    self.leaves, grad)
                        norms.append(smollm.leaf_norms(grad, self.leaves))
                        sq = (grad.to(torch.float64) ** 2).sum()
                        acc[p].add_(grad, alpha=float(
                            ref.clip_coef(sq, wl["grad_bound"])))
                client.append(torch.stack(norms).view(P, L, -1).cpu())
                acc.mul_(mu / L)                 # mu times the mean clipped
                step = acc.mean(0)
                if t == 0:
                    update1 = smollm.leaf_norms(step / mu, self.leaves)
                moved.sub_(step)
                psi = w.sub_(acc)
                del acc
                noise = ref.laplace(ref.combine_uniforms(
                    self.noise_seed, t, (P, self.flat0.numel()), dev),
                    wl["sigma"], torch.float32)
                w = ref.combine(A, psi, noise)
                del psi, noise
            return {"client": torch.stack(client), "update1": update1.cpu(),
                    "change": smollm.leaf_norms(moved, self.leaves).cpu()}
        finally:
            torch.backends.cuda.matmul.allow_tf32 = legacy

    def program_numbers(self) -> dict:
        rec = self.recorded
        return {"client": torch.stack(rec["client"]),
                "update1": rec["update1"], "change": rec["change"]}

    def check(self, window: dict, stand_in=None) -> dict:
        """The numbers compared, each the widest gap of leaf norms
        (:func:`gap`): every client's gradient in the checked rounds, the
        first update, the change over the checked rounds.  ``stand_in()``
        replaces the program's side, for a control."""
        want = self.reference()
        if stand_in is not None:
            prog = stand_in()
        elif len(self.recorded["client"]) == self.wl["check_steps"]:
            prog = self.program_numbers()
        else:                   # the step never asked for the gradients
            prog = {k: torch.zeros_like(v) for k, v in want.items()}
        return {name: gap(prog[key].to(torch.float64),
                          want[key].to(torch.float64))
                for name, key in (("client_grad_gap", "client"),
                                  ("update1_gap", "update1"),
                                  ("change_gap", "change"))}
