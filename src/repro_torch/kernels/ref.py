"""Plain torch versions of the on-path ops, mirroring ``repro/kernels/ref.py``.

These compute what the reference's pure-jnp oracles compute, in the same
structure, so the CPU tests hold them against the reference and the chip
check holds the CUDA kernels against them.  Nothing on the main path calls
them when a card is present.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.secure_agg import net_mask_stream, pair_stream


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full float32: TF32 would keep ~3 decimal digits and
    break the 1e-5 parity contract, so it is switched off explicitly."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return a @ b


def graph_combine_ref(a_t: torch.Tensor, psi: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    """out = A^T (psi + g) - g  (eq. 8 with eq. 24 noise structure)."""
    mixed = matmul_f32(a_t.to(torch.float32), (psi + g).to(torch.float32))
    return (mixed - g.to(torch.float32)).to(psi.dtype)


def secure_agg_mean_plain(updates: torch.Tensor, seed: torch.Tensor,
                          scale: float = 1.0) -> torch.Tensor:
    """Masked client mean with the integer-hash pairwise streams
    (``ref.secure_agg_mean_ref``): updates [L, D], seed [1] (a uint32
    value, read on the device) -> [D] in updates' dtype.  Each pair's
    stream is added and taken away again, ``acc + s - s``, pair by pair in
    row-major (a < b) order, so the masks cancel up to f32 rounding."""
    L, D = updates.shape
    acc = updates.to(torch.float32).sum(dim=0)
    idx = torch.arange(D, device=updates.device)
    sd = seed.reshape(-1)[0]
    for pid in range(L * (L - 1) // 2):
        s = pair_stream(pid, idx, sd, scale)
        acc = acc + s - s
    return (acc / L).to(updates.dtype)


def laplace_transform_plain(u: torch.Tensor, sigma: float) -> torch.Tensor:
    """Uniform u in (-1/2, 1/2) -> Lap(0, sigma/sqrt 2)
    (``ref.laplace_transform_ref``), in f32, cast once to u's dtype."""
    b = sigma / (2.0 ** 0.5)
    uf = u.to(torch.float32)
    return (-b * torch.sign(uf) * torch.log1p(-2.0 * torch.abs(uf))
            ).to(u.dtype)


def clip_accum_plain(grads: torch.Tensor, bound: float) -> torch.Tensor:
    """Per-client clip to the B-ball, then the client mean
    (``ref.clip_accum_ref``): grads [L, D] -> [D] in grads' dtype."""
    g = grads.to(torch.float32)
    nrm = torch.linalg.vector_norm(g, dim=1, keepdim=True)
    coef = torch.clamp(bound / torch.clamp(nrm, min=1e-12), max=1.0)
    return (g * coef).mean(dim=0).to(grads.dtype)


def _shuffle_tree(v: torch.Tensor) -> torch.Tensor:
    """A warp's ``__shfl_down_sync`` sum over the last dim (32 lanes):
    halves added lane by lane, 16 apart, then 8, ... -> lane 0."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def clip_accum_blocked_plain(grads: torch.Tensor, bound: float, grid: int,
                             threads: int = 256) -> torch.Tensor:
    """K6's order of summation (csrc/clip_accum.cu) in plain torch, for the
    tests: [L, D] -> [D] in grads' dtype, as :func:`clip_accum_plain`.

    A tile is ``threads`` 16-byte vectors of a row; block b of ``grid``
    owns tiles b, b + grid, ...  Thread t of block b adds the squares of its
    vector of each of the block's tiles in order; a warp adds its 32
    threads by a shuffle tree and the block its warps in order: block b's
    partial of row k.  Each client's squared norm is lane l's sum of
    partials l, l + 32, ... in order, then a shuffle tree; then the clip
    coefficients, and the client mean of the clipped rows, clients in
    order, cast once.  f32 throughout; the kernel fuses the multiply-adds."""
    L, D = grads.shape
    vec = 16 // grads.element_size()
    tile = threads * vec
    tiles = -(-D // tile)
    g = grads.to(torch.float32)
    gp = torch.cat([g, g.new_zeros((L, tiles * tile - D))], dim=1)
    sq = (gp * gp).view(L, tiles, threads, vec)
    vsum = sq[..., 0]
    for j in range(1, vec):
        vsum = vsum + sq[..., j]                          # [L, tiles, t]
    partial = g.new_zeros((L, grid))
    for b in range(grid):
        acc = g.new_zeros((L, threads))
        for t in range(b, tiles, grid):
            acc = acc + vsum[:, t]
        warps = _shuffle_tree(acc.view(L, threads // 32, 32))
        s = warps[:, 0]
        for w in range(1, threads // 32):
            s = s + warps[:, w]
        partial[:, b] = s
    lanes = g.new_zeros((L, 32))
    for j in range(grid):
        lanes[:, j % 32] = lanes[:, j % 32] + partial[:, j]
    nrm = torch.sqrt(_shuffle_tree(lanes))
    coef = torch.clamp(bound / torch.clamp(nrm, min=1e-12), max=1.0)
    out = g.new_zeros((D,))
    for k in range(L):
        out = out + coef[k] * g[k]
    return (out / L).to(grads.dtype)


def hash_net_mask_fold(seeds: torch.Tensor, noise_w: torch.Tensor, D: int,
                       scale) -> torch.Tensor:
    """Per server, the folded net pairwise hash-stream masks
    ``sum_k noise_w[p, k] * mask_k`` -> [P, D].

    ``seeds`` [P] (uint32 values), ``noise_w`` [P, L]; a client with
    ``noise_w <= 0`` is dead and its pair streams never arrive.  One
    [L, D] stream block per (server, owner), as in the reference."""
    P, L = noise_w.shape
    idx = torch.arange(D, device=noise_w.device)
    nw = noise_w.to(torch.float32)
    out = torch.zeros((P, D), dtype=torch.float32, device=noise_w.device)
    for p in range(P):
        alive = nw[p] > 0
        for k in range(L):
            out[p] += nw[p, k] * net_mask_stream(k, idx, seeds[p], scale, L,
                                                 alive)
    return out


PAIR_CHUNK = 2048      # alive pairs a chunk (csrc/fold_apply.cu kPairChunk)


def pair_id(a: int, b: int, n: int) -> int:
    """Row-major (a < b) pair id among n items (csrc/hash.cuh pair_id)."""
    return (a * (2 * n - a - 1)) // 2 + (b - a - 1)


def pair_row(pid: int, n: int) -> int:
    """The row a of pair id ``pid`` among n items, by bisection
    (csrc/hash.cuh pair_row)."""
    lo, hi = 0, n - 2
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if pair_id(mid, mid + 1, n) <= pid:
            lo = mid
        else:
            hi = mid - 1
    return lo


def walk_pairs(n: int, lo: int, hi: int) -> list:
    """csrc/hash.cuh walk_pairs in plain python: [(pid - lo, i, j)] for the
    pairs (i < j) of n items with ids in [lo, hi), in the walk's cell order
    (the cells of the rows that hold [lo, hi), row i0's length wide)."""
    i0, i1 = pair_row(lo, n), pair_row(hi - 1, n) + 1
    width = n - 1 - i0
    out = []
    for t in range((i1 - i0) * width):
        r = t // width
        i = i0 + r
        j = i + 1 + t - r * width
        if j < n and lo <= pair_id(i, j, n) < hi:
            out.append((pair_id(i, j, n) - lo, i, j))
    return out


def alive_pairs(alive, chunk: int = PAIR_CHUNK) -> list:
    """K2's pair list of one server as its kernel builds it: the alive
    clients in order (``alive`` [L] bools), their pairs walked in chunks of
    ``chunk`` ids by :func:`walk_pairs`, each chunk a list of (pair id
    among all L, a, b) in slot order.  A slot no cell fills stays None."""
    L = len(alive)
    live = [k for k in range(L) if bool(alive[k])]
    A = len(live)
    npairs = A * (A - 1) // 2
    chunks = []
    for lo in range(0, npairs, chunk):
        slots = [None] * min(chunk, npairs - lo)
        for c, i, j in walk_pairs(A, lo, lo + len(slots)):
            slots[c] = (pair_id(live[i], live[j], L), live[i], live[j])
        chunks.append(slots)
    return chunks


def _slice_fold(x: torch.Tensor, terms: torch.Tensor, S: int) -> torch.Tensor:
    """x [P, S, D] plus terms [P, n, D], term c into slice c % S, each
    slice's terms added one at a time in index order."""
    P, n, D = terms.shape
    pad = torch.zeros((P, -n % S, D), dtype=terms.dtype, device=terms.device)
    terms = torch.cat([terms, pad], dim=1)
    for r in range(terms.shape[1] // S):
        x = x + terms[:, r * S:(r + 1) * S]
    return x


def fold_apply_regrouped_plain(w, grads, stepscale, fold_wn, noise_w, *,
                               mode="none", sigma=0.0, seeds=None,
                               noise=None, slices: int = 1,
                               chunk: int = PAIR_CHUNK) -> torch.Tensor:
    """K2's order of summation (csrc/fold_apply.cu) in plain torch, for the
    tests: psi [P, D] in w.dtype, as ``round_fold.fold_apply_plain``.

    Slice s of ``slices`` (``round_fold.fold_layout``'s S) folds clients
    s, s + S, ... in order, then the noise terms the same way, or the
    alive pairs s, s + S, ... of each chunk of :func:`alive_pairs`, each
    hashed once with coefficient nw[a] - nw[b]; a tree adds the slices,
    halves first.  f32 throughout; the kernel fuses the multiply-adds."""
    P, L, D = grads.shape
    S = slices
    g = grads.to(torch.float32)
    wb = w.to(torch.float32)
    if w.dim() == 2:
        wb = wb[:, None, :]
    ss = stepscale.to(torch.float32)[..., None]
    fw = fold_wn.to(torch.float32)[..., None]
    nw = noise_w.to(torch.float32)
    zero = torch.zeros((P, S, D), dtype=torch.float32, device=g.device)
    acc = _slice_fold(zero, fw * (wb - ss * g), S)
    nacc = zero
    if mode == "laplace":
        nacc = _slice_fold(zero, nw[..., None] * noise.to(torch.float32), S)
    elif mode == "mask":
        idx = torch.arange(D, device=g.device)
        parts = []
        for p in range(P):
            x = zero[p:p + 1]
            for slots in alive_pairs((nw[p] > 0).tolist(), chunk):
                pid, a, b = (torch.tensor(v, device=g.device)
                             for v in zip(*slots))
                vals = (nw[p, a] - nw[p, b])[:, None] * pair_stream(
                    pid[:, None], idx[None, :], seeds[p], sigma)
                x = _slice_fold(x, vals[None], S)
            parts.append(x)
        nacc = torch.cat(parts)
    total = acc + nacc
    while total.shape[1] > 1:
        h = total.shape[1] // 2
        total = total[:, :h] + total[:, h:]
    return total[:, 0].to(w.dtype)


def round_fold_ref(w: torch.Tensor, grads: torch.Tensor, *, mu: float,
                   bound: float, pre_w: torch.Tensor, fold_w: torch.Tensor,
                   noise_w: torch.Tensor, mode: str = "none",
                   sigma: float = 0.0, seeds: torch.Tensor | None = None,
                   noise: torch.Tensor | None = None):
    """Fused round-fold oracle: clip -> update -> privatize -> fold.

    w: [P, D] or [P, L, D]; grads: [P, L, D]; pre_w / fold_w / noise_w:
    [P, L].  Returns (psi [P, D] in w.dtype, sq [P, L] raw squared grad
    norms) — the contract of :func:`repro_torch.kernels.ops.round_fold`."""
    P, L, D = grads.shape
    g32 = grads.to(torch.float32)
    sq = (g32 * g32).sum(dim=-1)
    pre = pre_w.to(torch.float32)
    nrm = pre * torch.sqrt(sq)
    if bound > 0:
        coef = torch.clamp(bound / torch.clamp(nrm, min=1e-12), max=1.0)
    else:
        coef = torch.ones_like(nrm)
    ss = mu * coef * pre
    wb = w.to(torch.float32)
    if w.dim() == 2:
        wb = wb[:, None, :]
    upd = wb - ss[..., None] * g32
    fw = fold_w.to(torch.float32)
    fwn = fw / torch.clamp(fw.sum(dim=1, keepdim=True), min=1e-12)
    psi = (fwn[..., None] * upd).sum(dim=1)
    nw = noise_w.to(torch.float32)
    if mode == "laplace":
        psi = psi + (nw[..., None] * noise.to(torch.float32)).sum(dim=1)
    elif mode == "mask":
        psi = psi + hash_net_mask_fold(seeds, nw, D, sigma)
    elif mode != "none":
        raise ValueError(f"unknown fold mode {mode!r}")
    return psi.to(w.dtype), sq


def swa_decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               nvalid: torch.Tensor) -> torch.Tensor:
    """Naive masked decode attention (``ref.swa_decode_attention_ref``), with
    GQA by head index: query head h reads KV head ``h // G``.

    q: [B, H, Dh]; k, v: [B, C, KV, Dh] with KV dividing H; nvalid: [1]
    int32, slots ``>= nvalid`` masked.  Scores, softmax and the weighted sum
    in f32 (never TF32), cast once to q's dtype."""
    B, H, Dh = q.shape
    C, KV = k.shape[1], k.shape[2]
    torch.backends.cuda.matmul.allow_tf32 = False
    qg = q.to(torch.float32).reshape(B, KV, H // KV, Dh)    # h = kv * G + g
    s = torch.einsum("bkgd,bckd->bkgc", qg, k.to(torch.float32)) / (Dh ** 0.5)
    valid = torch.arange(C, device=k.device) < nvalid.reshape(-1)[0]
    s = s.masked_fill(~valid, -1e30)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", w, v.to(torch.float32))
    return out.reshape(B, H, Dh).to(q.dtype)


def swa_decode_splits_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, nvalid: torch.Tensor,
                            n_splits: int, *, tile: int = 1,
                            leave_out: int | None = None) -> torch.Tensor:
    """The split-and-combine algorithm of ``csrc/swa_decode.cu`` in plain
    torch, for the tests and the chip check (nothing else calls it).

    The C slots fall into ``n_splits`` ranges of ``chunk`` slots, ``chunk``
    a multiple of ``tile``; each range is clipped to the live slots
    ``[0, n_live)`` (``n_live = min(nvalid, C)``, or C when ``nvalid < 1``
    masks every slot) and gives a partial: its max m, denominator l and
    un-normalised weighted V.  A range with no live slot gives m = -inf,
    l = 0, acc = 0, weighed by exactly 0.  The partials combine in split
    order: M = max m_s, out = sum acc_s e^(m_s - M) / max(sum l_s
    e^(m_s - M), 1e-30).  ``leave_out`` drops one split's partial, as a
    kernel that lost it would.  Shapes and dtypes as
    :func:`swa_decode_attention_plain`."""
    B, H, Dh = q.shape
    C, KV = k.shape[1], k.shape[2]
    G = H // KV
    torch.backends.cuda.matmul.allow_tf32 = False
    nv = int(nvalid.reshape(-1)[0])
    n_live = min(nv, C) if nv >= 1 else C
    chunk = -(-(-(-C // tile)) // n_splits) * tile
    qg = q.to(torch.float32).reshape(B, KV, G, Dh)
    s_all = torch.einsum("bkgd,bckd->bkgc", qg,
                         k.to(torch.float32)) / (Dh ** 0.5)
    if nv < 1:
        s_all = torch.full_like(s_all, -1e30)
    v32 = v.to(torch.float32)
    parts = []
    for s in range(n_splits):
        lo, hi = s * chunk, min(s * chunk + chunk, n_live)
        if hi <= lo or s == leave_out:
            parts.append((torch.full((B, KV, G), float("-inf"),
                                     device=q.device),
                          torch.zeros((B, KV, G), device=q.device),
                          torch.zeros((B, KV, G, Dh), device=q.device)))
            continue
        sc = s_all[..., lo:hi]
        m = sc.amax(dim=-1)
        p = torch.exp(sc - m[..., None])
        parts.append((m, p.sum(dim=-1),
                      torch.einsum("bkgc,bckd->bkgd", p, v32[:, lo:hi])))
    M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    den = torch.zeros_like(M)
    acc = torch.zeros((B, KV, G, Dh), device=q.device)
    for m, l, a in parts:
        w = torch.where(m == float("-inf"), torch.zeros_like(m),
                        torch.exp(m - M))
        den = den + l * w
        acc = acc + a * w[..., None]
    out = acc / torch.clamp(den, min=1e-30)[..., None]
    return out.reshape(B, H, Dh).to(q.dtype)
