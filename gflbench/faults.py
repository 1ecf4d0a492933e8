"""Faults planted in the program, for the check's own tests: each must
make ``correct`` come out false.

``unchanged``   the step returns its state unchanged;
``half_batch``  half of each server's clients left out, the fold's mean
                taken over the rest (their gradients stand in for the
                others');
``answer``      an answer altered where it is produced: a run's final
                parameters (the Section V runs) or a client's gradient
                (the LM rounds).

:func:`planted` patches the program's own functions for the block and
restores them after it.
"""
from __future__ import annotations

from contextlib import contextmanager

FAULTS = ("unchanged", "half_batch", "answer")


def _half(grads):
    half = grads.shape[1] // 2
    grads[:, half:2 * half] = grads[:, :half]
    return grads


@contextmanager
def planted(fault: str, driver: str):
    from repro_torch.core import gfl, simulate
    from repro_torch.core.population import engine
    from repro_torch.launch import federated_lm
    saved = []

    def patch(owner, name, value):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    if fault == "unchanged":
        def make_step(A, grad_fn, cfg):
            return lambda state, batch, draws: gfl.GFLState(
                state.params, state.step + 1)
        patch(gfl, "make_gfl_step", make_step)
        patch(gfl.StagedStep, "body", lambda self, *a: None)
    elif fault == "half_batch":
        module = engine if driver == "gfl_runs" else federated_lm
        inner = module.make_grad_fn

        def make_grad_fn(*args):
            fn = inner(*args)
            return lambda params, batch: _half(fn(params, batch))
        patch(module, "make_grad_fn", make_grad_fn)
    elif fault == "answer" and driver == "gfl_runs":
        run_gfl = simulate.run_gfl

        def altered(*args, **kw):
            msd, params = run_gfl(*args, **kw)
            params = params.clone()
            params[0, 0] += 0.05 * params.abs().max()
            return msd, params
        patch(simulate, "run_gfl", altered)
    elif fault == "answer":
        inner = federated_lm.make_grad_fn

        def make_grad_fn(*args):
            fn = inner(*args)

            def grad_fn(params, batch):
                out = fn(params, batch)
                out[0, 0].mul_(1.01)
                return out
            return grad_fn
        patch(federated_lm, "make_grad_fn", make_grad_fn)
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    try:
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)
