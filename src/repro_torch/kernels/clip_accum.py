"""K6 ``clip_accum``: per-client clip to the B-ball, then the client mean.

Port of the Pallas kernels in ``repro/kernels/clip_accum.py``
(``_sumsq_kernel``, then ``_scale_mean_kernel``) as one CUDA kernel,
``csrc/clip_accum.cu``, launched cooperatively: each block sums the squares
of its tiles of every row, keeping as many of them as fit in its shared
memory, a grid-wide barrier follows, every block forms the same clip
coefficients from the blocks' partials, and each block writes the clipped
client mean of its tiles, the resident ones read from shared memory and
the rest again from HBM in the reverse order.  One device op a call.

:func:`plan` is the launch as a pure function of the shape, so the CPU
tests read it; ``ref.clip_accum_blocked_plain`` is the kernel's order of
summation in plain torch.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import _build
from repro_torch.kernels.common import (FLOAT_TYPES, check, on_cuda,
                                        stream_workspace)
from repro_torch.kernels.ref import clip_accum_plain

__all__ = ["clip_accum", "clip_accum_plain", "plan", "tile_order",
           "hbm_bytes"]

THREADS = 256          # a block; a tile is a 16-byte vector a thread
BLOCKS_PER_SM = 2      # resident blocks an SM, each with SMEM_BLOCK
SMEM_BLOCK = 112640    # dynamic shared memory a block at most (110 KB)
MAX_RESIDENT = 63      # resident tiles a block: six bits of the plan word
MAX_CLIENTS = 12288    # the L coefficients in 48 KB of shared memory


def plan(L: int, D: int, esize: int, n_sm: int,
         blocks_per_sm: int = BLOCKS_PER_SM) -> dict:
    """The kernel's launch at [L, D] elements of ``esize`` bytes on a card
    of ``n_sm`` SMs that holds ``blocks_per_sm`` blocks an SM at once.

    A tile is ``THREADS`` 16-byte vectors of one row; the D columns make
    ``tiles`` of them, the last one ragged.  The grid is at most the
    co-resident blocks and at most the tiles, so every block owns one at
    least: block b owns tiles b, b + grid, ...  Each block keeps its first
    ``resident`` tiles of every row in shared memory, after the L
    coefficients, within ``SMEM_BLOCK``."""
    tile = THREADS * (16 // esize)
    tiles = -(-D // tile)
    grid = max(1, min(tiles, n_sm * blocks_per_sm))
    coef = -(-L // 4) * 16
    slot = L * THREADS * 16                  # one tile of every row
    resident = max(0, min(-(-tiles // grid), MAX_RESIDENT,
                          (SMEM_BLOCK - coef) // slot))
    return {"tile": tile, "tiles": tiles, "grid": grid,
            "resident": resident, "smem": coef + resident * slot}


def tile_order(p: dict, block: int) -> tuple:
    """(phase 1's tiles, phase 2's tiles) of one block of plan ``p``: its
    own tiles in order, then in reverse.  The first ``p["resident"]`` of
    phase 1 stay in shared memory."""
    mine = list(range(block, p["tiles"], p["grid"]))
    return mine, mine[::-1]


def hbm_bytes(p: dict, L: int, D: int, esize: int) -> int:
    """The bytes the kernel must move at plan ``p`` by its own count: g
    once, the tiles that were not resident a second time (none of them
    counted as an L2 hit), and out once."""
    again = 0
    for b in range(p["grid"]):
        for t in tile_order(p, b)[0][p["resident"]:]:
            again += min(p["tile"], D - t * p["tile"])
    return (L * (D + again) + D) * esize


_PLANS: dict = {}


def _make(device: torch.device, L: int, D: int, dtype: torch.dtype):
    """(packed plan, workspace pointer, workspace) of a shape: the plan at
    the blocks an SM can hold, read from the card, and the workspace of
    the L x grid partials and the barrier's two words, zeroed."""
    bf16 = dtype is torch.bfloat16
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    per_sm = BLOCKS_PER_SM
    while True:
        p = plan(L, D, 2 if bf16 else 4, n_sm, per_sm)
        bits = int(bf16) | p["resident"] << 2 | p["grid"] << 8
        held = _build.function("clip_accum_blocks_per_sm")(bits, L)
        if held < 0:
            _build.check(-held, "clip_accum occupancy")
        if held == 0:
            raise RuntimeError(f"clip_accum: no block of {THREADS} threads "
                               f"and {p['smem']} bytes fits on an SM")
        if p["grid"] <= held * n_sm:
            break
        per_sm = held
    ws = torch.zeros(L * p["grid"] + 2, dtype=torch.int32, device=device)
    return bits, ws.data_ptr(), ws


def clip_accum(grads: torch.Tensor, bound: float) -> torch.Tensor:
    """grads: [L, D] f32/bf16 per-client gradients -> the mean of the
    clipped gradients, [D] in grads' dtype.

    The workspace (partials and the barrier's counter, left at zero) is
    cached per (device, stream, shape) by ``common.stream_workspace``: two
    streams may run this at once, and a captured CUDA graph gets its own."""
    check(grads, "grads", (None, None), FLOAT_TYPES)
    if not on_cuda(grads):
        return clip_accum_plain(grads, bound)
    L, D = grads.shape
    if L > MAX_CLIENTS:
        raise ValueError(f"clip_accum: L={L} exceeds {MAX_CLIENTS}")
    dev = grads.device
    (bits, ws, hold), stream = stream_workspace(
        _PLANS, dev, (L, D, grads.dtype),
        lambda: _make(dev, L, D, grads.dtype))
    out = torch.empty((D,), dtype=grads.dtype, device=dev)
    _build.check(_build.function("clip_accum")(
        grads.data_ptr(), out.data_ptr(), ws, float(bound), L, D, bits,
        stream), "clip_accum")
    _k.LAUNCHES["clip_accum"] += 1
    return out
