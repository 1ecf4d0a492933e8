"""K8 ``swa_decode``: one-token decode attention over a (ring) KV cache.

Port of the Pallas kernel in ``repro/kernels/swa_decode.py``
(``csrc/swa_decode.cu``).  One query token per sequence against the C
slots of one layer's cache, slots ``>= nvalid`` masked, softmax in f32.
GQA is resolved by indexing (query head h reads KV head ``h // G``), not by
repeating K/V as the reference's wrapper does.  ``nvalid`` stays on the
device: the kernel reads it, so a decode step never waits on the host.

The kernel is split-C flash-decoding: a block serves one (sequence, KV
head) over one of ``split_count`` tile-aligned ranges of the slots, and
the last block of each to finish combines the partials in split order.
:func:`plan` (``tile_slots``, ``smem_row``, ``split_count``) is a pure
function of the shape and the card, never of ``nvalid``;
``ref.swa_decode_splits_plain`` is the algorithm in plain torch.
"""
from __future__ import annotations

import math

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import _build
from repro_torch.kernels.common import (FLOAT_TYPES, check, on_cuda,
                                        stream_workspace)
from repro_torch.kernels.ref import swa_decode_attention_plain

MAX_GROUP = 8          # query heads per KV head
MAX_HEAD_DIM = 256
THREADS = 128          # a block: four warps
STAGES = 2             # depth of each warp's cp.async ring
RING_BYTES = 24 * 1024  # the rings' shared memory, at most (one tile fits)
BLOCKS_PER_SM = 4      # resident blocks an SM holds at 128 registers a
                       # thread (the kernel's launch bound)
SPLIT_TILES = 4        # tiles a split, at least, so its copies pipeline
TILES = (64, 32, 16, 8)

__all__ = ["swa_decode", "swa_decode_attention_plain", "plan",
           "split_count", "tile_slots", "smem_row"]


def smem_row(Dh: int, esize: int, tile: int) -> int:
    """Shared-memory stride, in elements, of a cached K or V row in a
    warp's ring, for tiles of ``tile`` slots (a quarter a warp).  The
    ``THREADS // tile`` lanes of a slot read consecutive 16-byte units of
    its row, and a quarter-warp (8 lanes, one shared-memory wavefront)
    spans ``8 // lanes`` rows: the stride is padded by the fewest units
    that put those rows' units on distinct bank groups.  Rows that do not
    split into 16-byte units keep ``Dh``."""
    vec = 16 // esize
    if Dh % vec:
        return Dh
    units, lanes = Dh // vec, THREADS // tile
    rows, width = max(1, 8 // lanes), min(lanes, 8)
    for pad in range(8):
        stride = units + pad
        banks = {(r * stride + c) % 8 for r in range(rows)
                 for c in range(width)}
        if len(banks) == rows * width:
            return stride * vec
    return Dh


def tile_slots(Dh: int, esize: int) -> int:
    """Slots per tile: the largest of 64, 32, 16, 8 whose ``STAGES``-deep
    rings of K and V rows fit ``RING_BYTES`` (8 when none does)."""
    for tile in TILES[:-1]:
        if STAGES * 2 * tile * smem_row(Dh, esize, tile) * esize <= RING_BYTES:
            return tile
    return TILES[-1]


def split_count(bkv: int, n_tiles: int, n_sm: int) -> int:
    """Splits of the slot range per (sequence, KV head): the most that keep
    the grid (``bkv * S`` blocks) within one wave of ``BLOCKS_PER_SM``
    resident blocks on each of ``n_sm`` SMs, with ``SPLIT_TILES`` tiles a
    split or more (fewer splits only cost the combine more), at least 1,
    and no split left without a tile.  It reads the shape and the card
    only, never ``nvalid``: a CUDA graph captured at one ``nvalid`` replays
    right at another."""
    s = max(1, min(-(-n_tiles // SPLIT_TILES),
                   BLOCKS_PER_SM * n_sm // max(bkv, 1)))
    per = -(-n_tiles // s)                   # tiles a split
    return -(-n_tiles // per)


def plan(B: int, KV: int, C: int, Dh: int, esize: int, n_sm: int) -> dict:
    """The kernel's launch plan at a shape: tile, shared row stride,
    splits, slots a split and blocks."""
    tile = tile_slots(Dh, esize)
    n_tiles = -(-C // tile)
    splits = split_count(B * KV, n_tiles, n_sm)
    return {"tile": tile, "ld": smem_row(Dh, esize, tile), "splits": splits,
            "chunk": -(-n_tiles // splits) * tile, "blocks": B * KV * splits}


_PLANS: dict = {}


def _plan(device: torch.device, B: int, KV: int, C: int, G: int, Dh: int,
          esize: int) -> tuple:
    """((tile, ld, splits, workspace pointer, ticket pointer, workspace,
    tickets), raw stream) of a shape (:func:`plan`) on the current
    stream.

    With splits > 1 the plan owns the split partials' workspace and the
    ticket counters: the kernel leaves the tickets at zero, so nothing is
    allocated or cleared again.  Plans are cached per (device, stream,
    shape) by ``common.stream_workspace``, so a decode loop pays one dict
    lookup, launches on two streams never share tickets, and a captured
    CUDA graph gets a workspace of its own, zeroed in the graph."""
    def make():
        p = plan(B, KV, C, Dh, esize,
                 torch.cuda.get_device_properties(device)
                 .multi_processor_count)
        splits = p["splits"]
        ws = tickets = None
        if splits > 1:
            ws = torch.empty(B * KV * splits * G * (Dh + 2),
                             dtype=torch.float32, device=device)
            tickets = torch.zeros(B * KV, dtype=torch.int32, device=device)
        return (p["tile"], p["ld"], splits,
                None if ws is None else ws.data_ptr(),
                None if tickets is None else tickets.data_ptr(), ws, tickets)

    return stream_workspace(_PLANS, device, (B, KV, C, G, Dh, esize), make)


def _check_cache(t: torch.Tensor, name: str, q: torch.Tensor) -> None:
    B, _, Dh = q.shape
    if t.dim() != 4 or t.shape[0] != B or t.shape[3] != Dh:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"(B={B}, C, KV, Dh={Dh})")
    if t.dtype != q.dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected q's {q.dtype}")
    if t.stride(3) != 1 or t.stride(2) != Dh:
        raise ValueError(f"{name}: the (KV, Dh) dims must be dense")


def swa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               nvalid: torch.Tensor) -> torch.Tensor:
    """q: [B, H, Dh]; k, v: [B, C, KV, Dh] (one layer's cache slice, any
    batch and slot strides, KV dividing H); nvalid: [1] int32.  Returns
    [B, H, Dh] in q's dtype."""
    check(q, "q", (None, None, None), FLOAT_TYPES)
    _check_cache(k, "k", q)
    _check_cache(v, "v", q)
    if v.shape != k.shape or v.stride() != k.stride():
        raise ValueError("k and v must share shape and strides")
    B, H, Dh = q.shape
    C, KV = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"KV heads {KV} do not divide query heads {H}")
    check(nvalid, "nvalid", (1,), (torch.int32,))
    if not on_cuda(q, k, v, nvalid):
        return swa_decode_attention_plain(q, k, v, nvalid)
    if H // KV > MAX_GROUP or Dh > MAX_HEAD_DIM:
        raise ValueError(f"swa_decode: G={H // KV} > {MAX_GROUP} or "
                         f"Dh={Dh} > {MAX_HEAD_DIM}")
    out = launch(_build.function("swa_decode"), q, k, v, nvalid)
    _k.LAUNCHES["swa_decode"] += 1
    return out


def launch(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           nvalid: torch.Tensor) -> torch.Tensor:
    """Launch ``fn``, a build of ``csrc/swa_decode.cu``, on operands that
    :func:`swa_decode` has checked, with its plan; counts nothing.
    ``chip_smoke.py`` also gives it the loads-only build of the source."""
    B, H, Dh = q.shape
    C, KV = k.shape[1], k.shape[2]
    (tile, ld, splits, ws, tickets, *hold), stream = _plan(
        q.device, B, KV, C, H // KV, Dh, q.element_size())
    out = torch.empty_like(q)
    _build.check(fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), nvalid.data_ptr(),
        out.data_ptr(), ws, tickets, int(q.dtype == torch.bfloat16), B, H,
        KV, C, Dh, k.stride(0), k.stride(1), 1.0 / math.sqrt(Dh), tile, ld,
        splits, stream), "swa_decode")
    return out
