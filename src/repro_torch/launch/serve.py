"""Serving launcher: batched prefill + greedy decode of any arch — the
dense and MoE families with GQA or MLA attention, RWKV-6, the Mamba2
hybrid, the vlm (image embeddings ahead of the prompt) and whisper
(mirrors ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \\
        --batch 4 --prompt-len 4096 --new-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \\
        --reduced --device cpu      # also deepseek-v2-lite-16b, minicpm3-4b,
                                    # zamba2-1.2b, rwkv6-3b,
                                    # llava-next-mistral-7b, whisper-tiny

Weights are random, drawn from ``--seed``, as the reference's launcher's
are, and so are the stub inputs: a vlm's ``image_embeds`` [B, N_img, D]
and whisper's ``frames`` [B, Se, D], 0.1 N(0, 1) each.  Runs on ``cuda``
unless ``--device cpu`` is given; GQA decode attention (zamba2's shared
block and whisper's self-attention too) goes through the K8 kernel there,
MLA decode attends in its latent space, and whisper's cross-attention
and the Mamba2 and RWKV-6 recurrences run in plain torch (the reference
has no kernel for them).  Prints the prefill time and the decode rate.

``--mesh DxM`` (the reference's flag) splits the requests over the data
ranks of a ``torch.distributed`` world (``torchrun``; one process holds
every data position of its mesh) and gathers the tokens at the end;
``1x1``, the default, is the one-process path.  A model axis above 1 is
tensor parallelism, which the port does not run yet (ROADMAP item 20c).

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --reduced --mesh 2x1 --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import rng
from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import init_world, parse_mesh
from repro_torch.models.model import Model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stub_inputs(cfg, batch: int, gen: torch.Generator) -> dict:
    """The stubbed encoders' outputs a vlm or whisper request carries, as
    keywords of ``Model.prefill``: 0.1 N(0, 1) from ``gen``, f32."""
    if cfg.family == "vlm":
        return {"image_embeds": 0.1 * torch.randn(
            (batch, cfg.num_image_tokens, cfg.d_model), generator=gen,
            device=gen.device)}
    if cfg.family == "audio":
        return {"frames": 0.1 * torch.randn(
            (batch, cfg.encoder_seq_len, cfg.d_model), generator=gen,
            device=gen.device)}
    return {}


def generate(model: Model, prompt: torch.Tensor, new_tokens: int,
             **inputs) -> dict:
    """Prefill ``prompt`` [B, S] (with a vlm's ``image_embeds`` or
    whisper's ``frames``), then ``new_tokens`` greedy decode steps.

    Returns the generated tokens [B, 1 + new_tokens] (the first from the
    prefill logits), the last logits [B, V], the cache, and host-clock
    times of the prefill and the decode loop, each ending in a device
    synchronize."""
    dev = prompt.device
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompt, **inputs)
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
    ap.add_argument("--mesh", default="1x1",
                    help="DxM: requests split over the data ranks")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = init_world(args.device)
    mesh = parse_mesh(args.mesh, dev)
    if mesh.shape["model"] > 1:
        raise NotImplementedError(
            f"a model axis of {mesh.shape['model']} is tensor parallelism "
            "over 'model', which the port does not run yet: ROADMAP item "
            "20c.  Use a model axis of 1")
    lay = mesh.layout()
    if args.batch % lay["server_ranks"]:
        raise ValueError(f"{args.batch} requests do not split over "
                         f"{lay['server_ranks']} data ranks")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    # every rank draws the same weights and the whole batch, then serves
    # its block of the requests
    gen = rng(args.seed, dev)
    model = Model.init(cfg, gen)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    inputs = stub_inputs(cfg, args.batch, gen)
    per = args.batch // lay["server_ranks"]
    rows = slice(lay["block"] * per, (lay["block"] + 1) * per)
    out = generate(model, prompt[rows], args.new_tokens,
                   **{k: v[rows] for k, v in inputs.items()})
    out["tokens"] = mesh.all_gather_servers(out["tokens"])
    n = args.batch * args.new_tokens
    if mesh.rank == 0:
        print(f"prefill {args.batch}x{args.prompt_len} in "
              f"{out['prefill_s'] * 1e3:.0f} ms ({dev}, {mesh.world} "
              f"rank(s))")
        print(f"decoded {n} tokens in {out['decode_s'] * 1e3:.0f} ms "
              f"({n / max(out['decode_s'], 1e-9):.0f} tok/s, {dev})")
    if not torch.isfinite(out["logits"].float()).all():
        raise RuntimeError("non-finite logits")
    return out


if __name__ == "__main__":
    main()
