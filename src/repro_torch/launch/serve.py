"""Serving launcher: batched prefill + greedy decode of a dense GQA arch
(mirrors ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \\
        --batch 4 --prompt-len 4096 --new-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

Weights are random, drawn from ``--seed``, as the reference's launcher's
are.  Runs on ``cuda`` unless ``--device cpu`` is given; decode attention
goes through the K8 kernel there.  Prints the prefill time and the decode
rate.  The reference's ``--mesh`` (several cards) is not ported: ROADMAP
queue 1, item 20.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device, rng
from repro_torch.configs.registry import get_config
from repro_torch.models.model import Model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Model, prompt: torch.Tensor, new_tokens: int) -> dict:
    """Prefill ``prompt`` [B, S], then ``new_tokens`` greedy decode steps.

    Returns the generated tokens [B, 1 + new_tokens] (the first from the
    prefill logits), the last logits [B, V], the cache, and host-clock
    times of the prefill and the decode loop, each ending in a device
    synchronize."""
    dev = prompt.device
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompt)
    toks = [logits.argmax(-1)]
    _sync(dev)
    t1 = time.perf_counter()
    for _ in range(new_tokens):
        logits, cache = model.decode_step(toks[-1], cache)
        toks.append(logits.argmax(-1))
    _sync(dev)
    t2 = time.perf_counter()
    return {"tokens": torch.stack(toks, dim=1), "logits": logits,
            "cache": cache, "prefill_s": t1 - t0, "decode_s": t2 - t1}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = rng(args.seed, dev)
    model = Model.init(cfg, gen)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    out = generate(model, prompt, args.new_tokens)
    n = args.batch * args.new_tokens
    print(f"prefill {args.batch}x{args.prompt_len} in "
          f"{out['prefill_s'] * 1e3:.0f} ms ({dev})")
    print(f"decoded {n} tokens in {out['decode_s'] * 1e3:.0f} ms "
          f"({n / max(out['decode_s'], 1e-9):.0f} tok/s, {dev})")
    if not torch.isfinite(out["logits"].float()).all():
        raise RuntimeError("non-finite logits")
    return out


if __name__ == "__main__":
    main()
