"""Counter-hash pairwise mask streams (eq. 23) and K5 ``secure_agg_mean``.

Mirrors ``repro/kernels/secure_agg.py``: the device functions
(``_hash_u32``, ``pair_stream``, ``net_mask_stream``), whose CUDA
counterparts live in ``csrc/hash.cuh`` and run inside ``fold_apply``'s mask
mode and K5, and the single-server masked mean ``secure_agg_mean``
(``csrc/secure_agg_mean.cu``).  The streams are uint32 integer math and
match the reference bit for bit; ``pair_streams`` writes them out so the
card can be checked against the plain version.  :func:`plan` is K5's
launch as a pure function of the shape, for the CPU tests.

torch's uint32 dtype supports few operations, so the plain version holds
uint32 values in int64 and masks with ``& 0xFFFFFFFF``.  A product of two
32-bit values overflows int64, so each multiply by a 32-bit constant is
split into its 16-bit halves: ``x*c = x*c_lo + ((x*c_hi) mod 2^16) << 16``
(mod 2^32), each partial product below 2^48.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import _build
from repro_torch.kernels.common import (FLOAT_TYPES, check, on_cuda,
                                        raw_stream, stream_handle)

MASK32 = 0xFFFFFFFF
MAX_CLIENTS = 256          # L(L-1)/2 pair keys in one block's shared memory
THREADS = 256              # K5: threads a block at most
MIN_THREADS = 64           # K5: threads a block at least
FEATURES = 8               # K5: features a thread at most


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """xorshift-multiply mix (Murmur3 finalizer) on uint32 held in int64."""
    x = x.to(torch.int64) & MASK32
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_u32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def pair_stream(pair_id, idx: torch.Tensor, seed, scale) -> torch.Tensor:
    """Uniform(-scale, scale) stream of one client pair at feature ``idx``
    (``pair_id`` broadcasts against ``idx``)."""
    pid = torch.as_tensor(pair_id, dtype=torch.int64, device=idx.device)
    sd = torch.as_tensor(seed, dtype=torch.int64, device=idx.device) & MASK32
    key = hash_u32((_mul_u32(pid & MASK32, 0x9E3779B9) + sd) & MASK32)
    h = hash_u32(idx.to(torch.int64) ^ key)
    u = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
    s = torch.as_tensor(scale, dtype=torch.float32, device=idx.device)
    return (2.0 * u - 1.0) * s


def pair_ids(k: int, L: int, device=None) -> torch.Tensor:
    """[L, 1] pair id of (k, j) for every peer j (row-major a < b order)."""
    j = torch.arange(L, device=device)[:, None]
    a = torch.minimum(j, torch.tensor(k, device=device))
    b = torch.maximum(j, torch.tensor(k, device=device))
    return (a * (2 * L - a - 1)) // 2 + (b - a - 1)


def net_mask_stream(k: int, idx: torch.Tensor, seed, scale, L: int,
                    alive: torch.Tensor | None = None) -> torch.Tensor:
    """Client k's NET pairwise mask at features ``idx`` ([D]):
    ``sum_{j>k} +PRG(pair(k,j)) + sum_{j<k} -PRG(pair(j,k))``, over alive
    peers only when ``alive`` [L] bool is given."""
    j = torch.arange(L, device=idx.device)[:, None]
    s = pair_stream(pair_ids(k, L, idx.device), idx[None, :], seed, scale)
    sgn = torch.where(j > k, 1.0, -1.0)
    m = torch.where(j == k, 0.0, sgn) * s
    if alive is not None:
        m = torch.where(alive[:, None], m, 0.0)
    return m.sum(dim=0)


def pair_streams_plain(seed: int, L: int, D: int, scale,
                       device=None) -> torch.Tensor:
    """[L(L-1)/2, D] every pair's stream, pair ids in order."""
    npairs = L * (L - 1) // 2
    idx = torch.arange(D, device=device)
    pid = torch.arange(npairs, device=device)[:, None]
    return pair_stream(pid, idx[None, :], seed, scale)


def pair_streams(seed: int, L: int, D: int, scale,
                 device) -> torch.Tensor:
    """The CUDA version of :func:`pair_streams_plain` on ``device`` (the
    plain version for the CPU)."""
    probe = torch.empty(0, device=device)
    if not on_cuda(probe):
        return pair_streams_plain(seed, L, D, scale, device)
    npairs = L * (L - 1) // 2
    out = torch.empty((npairs, D), dtype=torch.float32, device=device)
    fn = _build.function("secure_agg")
    _build.check(fn(int(seed) & MASK32, float(scale), out.data_ptr(), npairs,
                    D, stream_handle(out)), "pair_streams")
    _k.LAUNCHES["pair_streams"] += 1
    return out


def plan(L: int, D: int, esize: int, n_sm: int) -> dict:
    """K5's launch at [L, D] elements of ``esize`` bytes on a card of
    ``n_sm`` SMs: ``fpt`` neighbouring features a thread (``FEATURES``:
    two 16-byte vectors of each f32 row, one of each bf16 row), ``threads``
    a block.  When D is too small for that to give a block an SM, features
    a thread are halved first, then threads a block, down to one feature
    and ``MIN_THREADS``.  More than a vector's features a thread (eight
    f32) only when D is a multiple of them, one vector otherwise, so the
    last thread's vectors never reach past D.  The kernel loads 16-byte
    vectors when a thread's features fill them, D is a multiple of them
    and the rows are aligned, elements otherwise."""
    fpt, threads = FEATURES, THREADS
    while -(-D // (threads * fpt)) < n_sm and (fpt > 1 or
                                               threads > MIN_THREADS):
        if fpt > 1:
            fpt //= 2
        else:
            threads //= 2
    if fpt * esize > 16 and D % fpt:
        fpt = 16 // esize
    return {"fpt": fpt, "threads": threads,
            "blocks": -(-D // (threads * fpt)),
            "smem": L * (L - 1) // 2 * 4}


_PLANS: dict = {}


def _plan_word(device: torch.device, L: int, D: int,
               dtype: torch.dtype) -> int:
    """:func:`plan` packed into one ctypes word, cached per device and
    shape: bit 0 bf16, bits 2-3 log2 features a thread, bits 4-7 log2
    threads a block, bits 8+ L."""
    key = (device.index, L, D, dtype)
    word = _PLANS.get(key)
    if word is None:
        bf16 = dtype is torch.bfloat16
        p = plan(L, D, 2 if bf16 else 4,
                 torch.cuda.get_device_properties(device)
                 .multi_processor_count)
        word = _PLANS[key] = (int(bf16) | (p["fpt"].bit_length() - 1) << 2
                              | (p["threads"].bit_length() - 1) << 4
                              | L << 8)
    return word


def secure_agg_mean(updates: torch.Tensor, seed: torch.Tensor,
                    scale: float = 1.0) -> torch.Tensor:
    """Masked client mean: updates [L, D] f32/bf16, seed [1] int32 or
    int64 (a uint32 value, read on the device) -> [D] in updates'
    dtype.  The pairwise masks are generated in the kernel, each pair's
    stream once a feature, added and taken away in pair order as the
    plain version does, so they cancel up to f32 rounding.  The kernel
    reads the seed's first four bytes as a uint32: an int32's bit pattern
    or an int64's low word (little-endian), in both cases the value mod
    2^32, so the seed is used as it lies on the device, with no conversion
    launched."""
    # ref imports this module for the stream functions, so the plain
    # version is imported here, at call time
    from repro_torch.kernels.ref import secure_agg_mean_plain

    check(updates, "updates", (None, None), FLOAT_TYPES)
    check(seed, "seed", (1,), (torch.int32, torch.int64))
    if not on_cuda(updates, seed):
        return secure_agg_mean_plain(updates, seed, scale)
    L, D = updates.shape
    if L > MAX_CLIENTS:
        raise ValueError(f"secure_agg_mean: L={L} exceeds {MAX_CLIENTS}")
    if D >= 2 ** 32:
        raise ValueError("secure_agg_mean: the mask streams index D in "
                         "uint32")
    dev = updates.device
    out = torch.empty((D,), dtype=updates.dtype, device=dev)
    _build.check(_build.function("secure_agg_mean")(
        updates.data_ptr(), seed.data_ptr(), float(scale), out.data_ptr(), D,
        _plan_word(dev, L, D, updates.dtype), raw_stream(dev.index)),
        "secure_agg_mean")
    _k.LAUNCHES["secure_agg_mean"] += 1
    return out
