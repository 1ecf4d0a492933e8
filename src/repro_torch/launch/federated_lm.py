"""Federated language-model training: the GFL protocol applied to a
transformer on synthetic token streams (mirrors
``examples/federated_lm.py``).

P servers on a ring each average L clients' clipped one-step SGD updates
under secure-aggregation masks (eq. 23), then mix with their neighbours
under graph-homomorphic noise (eq. 24); the loss falls while the privacy
accountant tracks eps(i).

    PYTHONPATH=src python -m repro_torch.launch.federated_lm [--steps 200]
    PYTHONPATH=src python -m repro_torch.launch.federated_lm --device cpu \\
        --steps 4

The model is ``smollm-135m`` reduced (2 layers, d 256, f32), as the
example's; :func:`run` takes any ``ModelConfig`` (the card's smoke runs it
at smollm-135m's full width).  The parameters are flat [P, D] vectors in
the reference's ``ravel_pytree`` order (:mod:`repro_torch.models.flat`);
each client's gradient is one forward and backward of ``Model.loss`` at
its server's parameters.  ``--use-kernels`` (the reference ``launch/
train.py``'s flag) runs the client fold through K1 + K2 and the combine
through K3.  Runs on ``cuda`` unless ``--device cpu`` is given; the token
batches are drawn on the host, so both devices train on the same data.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import torch

from repro_torch import resolve_device, rng
from repro_torch.configs.base import GFLConfig, ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import gfl
from repro_torch.core.privacy.mechanism import list_mechanisms, mechanism_for
from repro_torch.core.topology import combination_matrix, spectral_gap
from repro_torch.data.synthetic import TokenStream, federated_token_batches
from repro_torch.draws import Draws
from repro_torch.models.flat import FlatView
from repro_torch.models.model import Model

PER_CLIENT = 2          # sequences a client a round
EVAL_SEED, EVAL_SEQS = 99, 4


def gfl_config(servers: int, clients: int, privacy: str, sigma: float,
               use_kernels: bool = False) -> GFLConfig:
    """The example's protocol: a ring, mu 0.5, B 5."""
    return GFLConfig(num_servers=servers, clients_per_server=clients,
                     privacy=privacy, sigma_g=sigma, mu=0.5,
                     topology="ring", grad_bound=5.0,
                     use_kernels=use_kernels)


def make_grad_fn(model: Model, view: FlatView):
    """grad_fn(params [P, D], batch) -> [P, L, D]: each client's gradient
    of ``model.loss`` at its server's parameters, one forward and backward
    each, written into one buffer."""
    def grad_fn(params: torch.Tensor, batch: dict) -> torch.Tensor:
        P, L = batch["tokens"].shape[:2]
        out = torch.empty((P, L, view.size), dtype=params.dtype,
                          device=params.device)
        for p in range(P):
            for l in range(L):
                b = {k: v[p, l] for k, v in batch.items()}
                view.grad(model, params[p], lambda: model.loss(**b)[0],
                          out=out[p, l])
        return out
    return grad_fn


@torch.no_grad()
def eval_loss(model: Model, view: FlatView, w: torch.Tensor,
              batch: dict) -> torch.Tensor:
    """The loss at the flat parameters ``w`` [D], a device scalar."""
    with view.bind(model, w):
        return model.loss(**batch)[0]


@dataclass
class Trainer:
    """The example's pieces, built once: the model (its own weights are
    the init), its flat view, the step, the stream and the eval batch."""
    cfg: ModelConfig
    gcfg: GFLConfig
    model: Model
    view: FlatView
    flat0: torch.Tensor
    A: object
    grad_fn: object
    stream: TokenStream
    eval_batch: dict
    per_client: int
    seq: int

    @classmethod
    def build(cls, cfg: ModelConfig, gcfg: GFLConfig, *, seq: int,
              per_client: int = PER_CLIENT, seed: int = 0,
              device=None) -> "Trainer":
        dev = resolve_device(device)
        model = Model.init(cfg, rng(seed, dev))
        view = FlatView(model)
        flat0 = view.ravel(model)
        P = gcfg.num_servers
        stream = TokenStream(vocab=cfg.vocab_size, seed=0)
        ev = federated_token_batches(stream, EVAL_SEED, 0, P, 1, EVAL_SEQS,
                                     seq)
        return cls(cfg, gcfg, model, view, flat0,
                   combination_matrix("ring", P),
                   make_grad_fn(model, view), stream,
                   {k: v[0, 0].to(dev) for k, v in ev.items()}, per_client,
                   seq)

    def init_state(self) -> gfl.GFLState:
        P = self.gcfg.num_servers
        return gfl.GFLState(self.flat0.expand(P, -1).clone(), 0)

    def batch(self, i: int, seed: int = 0) -> dict:
        """Round ``i``'s client batches, drawn on the host and moved to the
        parameters' device."""
        b = federated_token_batches(self.stream, seed, i,
                                    self.gcfg.num_servers,
                                    self.gcfg.clients_per_server,
                                    self.per_client, self.seq)
        return {k: v.to(self.flat0.device) for k, v in b.items()}

    def step_fn(self, gcfg: GFLConfig | None = None, grad_fn=None):
        return gfl.make_gfl_step(self.A, grad_fn or self.grad_fn,
                                 gcfg or self.gcfg)

    def eval(self, params: torch.Tensor) -> float:
        return float(eval_loss(self.model, self.view, gfl.centroid(params),
                               self.eval_batch))


def run(cfg: ModelConfig, *, steps: int = 200, servers: int = 4,
        clients: int = 2, seq: int = 64, per_client: int = PER_CLIENT,
        privacy: str = "hybrid", sigma: float = 0.01,
        use_kernels: bool = False, device=None, seed: int = 0,
        log_every: int = 0, log=print) -> dict:
    """Train ``cfg`` for ``steps`` GFL rounds; returns ``history`` (a list
    of {step, loss, eps, seconds} at every ``log_every``-th round and the
    last, the centroid's eval loss and the accountant's epsilon), ``D``,
    the ``spectral_gap`` and the final ``state``."""
    gcfg = gfl_config(servers, clients, privacy, sigma, use_kernels)
    tr = Trainer.build(cfg, gcfg, seq=seq, per_client=per_client,
                       seed=seed, device=device)
    gap = spectral_gap(tr.A)
    log(f"model: {cfg.name}  ({tr.view.size:,} params)   "
        f"servers={servers} clients/round={clients}")
    log(f"ring graph spectral gap lambda = {gap:.3f}")
    step = tr.step_fn()
    state = tr.init_state()
    draws = Draws(seed, tr.flat0.device)
    # mechanism-aware accountant: the noise profile picks the curve (eps
    # is inf for a zero-noise config, the honest Theorem-2 answer)
    mech = mechanism_for(gcfg)
    tracked = mech.noise_profile().curve != "none"
    acc = mech.accountant()
    every = log_every or max(steps // 10, 1)
    history = []
    t0 = time.perf_counter()
    for i in range(steps):
        state = step(state, tr.batch(i), draws)
        if i % every == 0 or i == steps - 1:
            lv = tr.eval(state.params)
            eps = acc.advance(every) if tracked else float("nan")
            history.append({"step": i, "loss": lv, "eps": eps,
                            "seconds": time.perf_counter() - t0})
            log(f"step {i:4d}  centroid eval loss {lv:.4f}  "
                f"eps(i)={eps:9.1f}  ({time.perf_counter() - t0:.0f}s)")
    log("done: loss should have decreased from ~ln(V) while training "
        "stayed private at the recorded eps schedule")
    return {"history": history, "D": tr.view.size, "spectral_gap": gap,
            "state": state}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--servers", type=int, default=4)
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--privacy", default="hybrid",
                    choices=list_mechanisms())
    ap.add_argument("--sigma", type=float, default=0.01)
    ap.add_argument("--use-kernels", action="store_true",
                    help="fold through K1 + K2, combine through K3")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(get_config("smollm-135m").reduced(), steps=args.steps,
               servers=args.servers, clients=args.clients, seq=args.seq,
               privacy=args.privacy, sigma=args.sigma,
               use_kernels=args.use_kernels, device=args.device)


if __name__ == "__main__":
    main()
