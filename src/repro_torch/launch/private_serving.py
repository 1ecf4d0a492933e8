"""Serving example: batched prefill + greedy decode with the consensus
model (mirrors ``examples/private_serving.py``).

The serving path of the port — KV caches, ring buffers for sliding-window
archs, batched requests — on a reduced config (phi3 by default), through
:func:`repro_torch.launch.serve.generate`; a vlm's requests carry
``image_embeds`` and whisper's ``frames``, 0.1 N(0, 1) each.

    PYTHONPATH=src python -m repro_torch.launch.private_serving \\
        [--arch phi3-mini-3.8b] [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device, rng
from repro_torch.configs.registry import get_config
from repro_torch.launch.serve import generate, stub_inputs
from repro_torch.models.model import Model


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    gen = rng(None, dev)
    model = Model.init(cfg, gen)
    print(f"serving {cfg.name} (window={cfg.sliding_window or 'full'})")
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    out = generate(model, prompt, args.new_tokens,
                   **stub_inputs(cfg, args.batch, gen))
    print(f"prefill: {args.batch}x{args.prompt_len} tokens in "
          f"{out['prefill_s'] * 1e3:.0f} ms")
    total = args.batch * args.new_tokens
    print(f"decode: {total} tokens in {out['decode_s'] * 1e3:.0f} ms "
          f"({total / max(out['decode_s'], 1e-9):.0f} tok/s on {dev}, "
          "reduced config)")
    print("sample token ids:", out["tokens"][0][:16].tolist())
    if not torch.isfinite(out["logits"].float()).all():
        raise RuntimeError("non-finite logits")
    print("OK")
    return out


if __name__ == "__main__":
    main()
