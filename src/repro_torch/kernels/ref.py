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
