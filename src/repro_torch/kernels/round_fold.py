"""K1 ``fold_norms`` and K2 ``fold_apply``: the fused round fold (eqs. 6-7).

Port of the Pallas kernels in ``repro/kernels/round_fold.py``.  The two
streaming passes over the ``[P, L, D]`` gradients are CUDA kernels
(``csrc/fold_norms.cu``, ``csrc/fold_apply.cu``); the tiny ``[P, L]``
clip/weight math between them stays in torch (``ops.round_fold``).  Each
wrapper checks its operands, runs the plain version beside it for CPU
tensors, and launches the kernel for CUDA tensors: one device op a call,
no padded copies (the kernels mask ragged L and D themselves).

The launch layouts are pure functions of the shape, so the CPU tests
read them: :func:`norms_plan` (K1: a few rows a block at small D, a row
cut into splits at wide D, one launch either way) and :func:`fold_layout`
(K2: features x pair slices a block).  ``ref.fold_apply_regrouped_plain``
is K2's summation order in plain torch.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import _build
from repro_torch.kernels.common import (FLOAT_TYPES, operand, raw_stream,
                                        stream_workspace)
from repro_torch.kernels.ref import hash_net_mask_fold

MODES = {"none": 0, "laplace": 1, "mask": 2}
SEED_TYPES = (torch.int32, torch.int64)
THREADS = 256          # a block, both kernels
LOADS = 4              # K1: 16-byte loads in flight a thread
BLOCKS_PER_SM = 4      # K1: split blocks an SM holds (its launch bound)
WAVES = 4              # K1: waves of split blocks at most
MAX_SERVERS = 65535    # K2: P in the grid's y and 16 bits of its shape word
MAX_CLIENTS = 8192     # K2: the [L] weights and alive list in shared memory

__all__ = ["fold_norms", "fold_norms_plain", "fold_apply", "fold_apply_plain",
           "norms_plan", "norms_workspace", "fold_layout"]


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def norms_plan(rows: int, D: int, esize: int, n_sm: int) -> dict:
    """K1's launch at a shape: [rows, D] elements of ``esize`` bytes on a
    card of ``n_sm`` SMs.  One launch at every D.

    A thread covers ``LOADS`` 16-byte vectors a step.  When a warp or
    fewer lanes cover a row in one step, the "rows" layout gives each row
    ``lanes`` threads (a power of two), as many rows a block as spread the
    rows over the SMs, from one warp to ``THREADS`` threads a block.  Else
    the "split" layout cuts each row into ``pieces`` of ``THREADS``
    vectors, dealt in turn to ``splits`` blocks of ``THREADS``: as many
    splits as keep the grid within ``WAVES`` waves of ``BLOCKS_PER_SM``
    blocks on each SM and give every thread a full step; the last block
    of a row to finish adds the partials."""
    vec = 16 // esize
    step = LOADS * vec
    lanes = -(-D // step)
    if lanes <= 32:
        lanes = _pow2_at_least(lanes)
        threads = min(THREADS, max(32, _pow2_at_least(-(-rows // n_sm) * lanes)))
        return {"layout": "rows", "lanes": lanes, "threads": threads,
                "splits": 1, "blocks": -(-rows // (threads // lanes))}
    splits = max(1, min(D // (THREADS * step),
                        WAVES * n_sm * BLOCKS_PER_SM // rows))
    return {"layout": "split", "lanes": THREADS, "threads": THREADS,
            "splits": splits, "pieces": -(-(-(-D // vec)) // THREADS),
            "blocks": rows * splits}


def norms_workspace(rows: int, splits: int) -> int:
    """Floats of K1's workspace at ``splits`` a row: each block's partial
    and one ticket a row, or none when one split suffices."""
    return 0 if splits == 1 else rows * splits + rows


_NORMS: dict = {}


def _norms_launch(device: torch.device, rows: int, D: int,
                  dtype: torch.dtype) -> tuple:
    """((packed plan, workspace pointer, workspace), raw stream) of a
    shape on the current stream.  With splits > 1 the workspace holds the
    partials and the rows' tickets, which the kernel leaves at zero, so it
    is cleared once; it is cached per (device, stream, shape) by
    ``common.stream_workspace``, so a round pays one dict lookup, two
    streams never share tickets, and a captured CUDA graph gets a
    workspace of its own."""
    def make():
        esize = 2 if dtype is torch.bfloat16 else 4
        p = norms_plan(rows, D, esize,
                       torch.cuda.get_device_properties(device)
                       .multi_processor_count)
        bits = int(dtype is torch.bfloat16)
        if p["layout"] == "rows":
            bits |= (p["lanes"].bit_length() - 1) << 1 | \
                (p["threads"].bit_length() - 1) << 4
        else:
            bits |= (THREADS.bit_length() - 1) << 4 | p["splits"] << 8
        n = norms_workspace(rows, p["splits"])
        ws = torch.zeros(n, dtype=torch.float32, device=device) if n else None
        return bits, None if ws is None else ws.data_ptr(), ws

    return stream_workspace(_NORMS, device, (rows, D, dtype), make)


def fold_norms_plain(grads: torch.Tensor) -> torch.Tensor:
    """[P, L, D] -> [P, L] f32 squared norms."""
    g = grads.to(torch.float32)
    return (g * g).sum(dim=-1)


def _check_grads(grads: torch.Tensor) -> torch.device:
    """Raise unless grads is a contiguous [P, L, D] f32/bf16 tensor on a
    card or the CPU; returns its device."""
    if grads.dim() != 3:
        raise ValueError(f"grads: shape {tuple(grads.shape)}, expected "
                         f"[P, L, D]")
    if grads.dtype not in FLOAT_TYPES:
        raise TypeError(f"grads: dtype {grads.dtype}, expected one of "
                        f"{FLOAT_TYPES}")
    if not grads.is_contiguous():
        raise ValueError("grads: must be contiguous")
    dev = grads.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {dev}")
    return dev


def fold_norms(grads: torch.Tensor) -> torch.Tensor:
    """Phase 1: per-(server, client) squared gradient norms, [P, L] f32."""
    dev = _check_grads(grads)
    if dev.type == "cpu":
        return fold_norms_plain(grads)
    P, L, D = grads.shape
    (bits, ws, hold), stream = _norms_launch(dev, P * L, D, grads.dtype)
    out = torch.empty((P, L), dtype=torch.float32, device=dev)
    _build.check(_build.function("fold_norms")(
        grads.data_ptr(), out.data_ptr(), ws, P * L, D, bits, stream),
        "fold_norms")
    _k.LAUNCHES["fold_norms"] += 1
    return out


def fold_layout(D: int, mode: str) -> tuple:
    """K2's block at width D: (F feature columns, S pair slices, features a
    thread), F S = ``THREADS``.  Below ``THREADS`` features a block cannot
    fill itself with one thread a feature, so F is the next power of two
    >= D and the S slices split the clients and pairs; at wide D, S = 1,
    and in mask mode a thread owns 2 or 4 features, so each pair key it
    reads from shared memory serves all of them."""
    if D < THREADS:
        F = _pow2_at_least(D)
        return F, THREADS // F, 1
    if mode != "mask":
        return THREADS, 1, 1
    return THREADS, 1, (4 if D >= 4 * THREADS else
                        2 if D >= 2 * THREADS else 1)


def fold_apply_plain(w, grads, stepscale, fold_wn, noise_w, *, mode="none",
                     sigma=0.0, seeds=None, noise=None) -> torch.Tensor:
    """What the fold kernel computes, in torch: psi [P, D] in w.dtype."""
    g = grads.to(torch.float32)
    wb = w.to(torch.float32)
    if w.dim() == 2:
        wb = wb[:, None, :]
    upd = wb - stepscale.to(torch.float32)[..., None] * g
    acc = (fold_wn.to(torch.float32)[..., None] * upd).sum(dim=1)
    nw = noise_w.to(torch.float32)
    if mode == "laplace":
        acc = acc + (nw[..., None] * noise.to(torch.float32)).sum(dim=1)
    elif mode == "mask":
        acc = acc + hash_net_mask_fold(seeds, nw, g.shape[-1], sigma)
    return acc.to(w.dtype)


def fold_apply(w: torch.Tensor, grads: torch.Tensor, stepscale: torch.Tensor,
               fold_wn: torch.Tensor, noise_w: torch.Tensor, *,
               mode: str = "none", sigma: float = 0.0,
               seeds: torch.Tensor | None = None,
               noise: torch.Tensor | None = None) -> torch.Tensor:
    """Phase 2: fused scale/update/privatize/fold.

    w: [P, D] or [P, L, D]; grads: [P, L, D]; stepscale, fold_wn, noise_w:
    [P, L] f32.  Mode "mask" needs ``seeds`` [P] int32 or int64 (uint32
    values, or their bit patterns: the kernel takes the low 32 bits), mode
    "laplace" needs ``noise`` [P, L, D] in grads' dtype.  Returns psi
    [P, D] in w.dtype.

    The checks are a fixed number of attribute reads and the launch the
    one device op, since the main path calls this once a round at D = 2,
    where host time is the cost."""
    code = MODES.get(mode)
    if code is None:
        raise ValueError(f"unknown fold mode {mode!r}")
    dev = _check_grads(grads)
    P, L, D = grads.shape
    per_client = w.dim() == 3
    operand(w, "w", (P, L, D) if per_client else (P, D), FLOAT_TYPES, dev)
    operand(stepscale, "stepscale", (P, L), (torch.float32,), dev)
    operand(fold_wn, "fold_wn", (P, L), (torch.float32,), dev)
    operand(noise_w, "noise_w", (P, L), (torch.float32,), dev)
    aux = None
    if code == 2:
        if seeds is None:
            raise ValueError("mask mode needs per-server seeds [P]")
        operand(seeds, "seeds", (P,), SEED_TYPES, dev)
        aux = seeds
    elif code == 1:
        if noise is None:
            raise ValueError("laplace mode needs pre-drawn noise [P, L, D]")
        operand(noise, "noise", (P, L, D), (grads.dtype,), dev)
        aux = noise
    if dev.type == "cpu":
        return fold_apply_plain(w, grads, stepscale, fold_wn, noise_w,
                                mode=mode, sigma=sigma, seeds=seeds,
                                noise=noise)
    if P > MAX_SERVERS or L > MAX_CLIENTS:
        raise ValueError(f"fold_apply: P={P} > {MAX_SERVERS} or L={L} > "
                         f"{MAX_CLIENTS}")
    if D >= 2 ** 32:
        raise ValueError("fold_apply: the mask streams index D in uint32")
    F, _, fpt = fold_layout(D, mode)
    out = torch.empty((P, D), dtype=w.dtype, device=dev)
    # ctypes converts every argument on every call: the small integers go
    # as two words
    flags = (code | (w.dtype is torch.bfloat16) << 2
             | (grads.dtype is torch.bfloat16) << 3 | per_client << 4
             | (code == 2 and seeds.dtype is torch.int64) << 5
             | (F.bit_length() - 1) << 6 | (fpt.bit_length() - 1) << 10)
    _build.check(_build.function("fold_apply")(
        w.data_ptr(), grads.data_ptr(), stepscale.data_ptr(),
        fold_wn.data_ptr(), noise_w.data_ptr(),
        None if aux is None else aux.data_ptr(), out.data_ptr(),
        P | L << 16, flags, D, float(sigma), raw_stream(dev.index)),
        "fold_apply")
    _k.LAUNCHES["fold_apply"] += 1
    return out
