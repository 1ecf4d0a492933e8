"""Mesh-scale GFL training step and serving steps (mirrors
``repro/launch/steps.py``).

TRAINING (the paper's protocol, eqs. 6-8, over a mesh of ranks)
  - the parameters are the reference's tree, one tensor a leaf keyed by
    its ``/``-joined path (:meth:`repro_torch.models.flat.FlatView.tree`),
    each with a leading server dim: the servers this rank holds
    (:mod:`repro_torch.launch.mesh`);
  - client updates (6): a loop over each server's L clients, each
    gradient weighted, clipped to the paper's bound B (Assumption 3) and
    summed in ``grad_acc_dtype``, then the survivor-count mean;
  - server aggregation (7): the secure-agg masks cancel exactly in the
    mean (eq. 23), so the aggregate is computed directly;
  - server combination (8), ``GFLConfig.combine_impl``:
      dense    the einsum over all P servers (gathered when ranks hold
               parts of them), or, with ``use_kernels`` and cancelling
               noise, K3 (``kernels.ops.graph_combine``) once a leaf;
      rotate   P - 1 ring permutes (:meth:`Mesh.ppermute`), any A;
      sparse   the neighbour permutes of a ring, or of the product graph
               on pod x data;
    under the mechanism's server noise (eq. 24): the permuted buffer
    carries psi_m + g_m, and each server subtracts its own g_p after.

SERVING: consensus-model prefill / decode steps.

Privacy noise comes from the mechanism's tree hooks
(``client_noise_tree`` / ``combine_noise_tree``) on the state's
:class:`~repro_torch.draws.DrawKey`.  Each rank draws the noise of all P
servers at the whole leaf shapes and keeps its own rows, and of each leaf
its block (:func:`repro_torch.launch.sharding.shard_leaf`, which zeroes a
padding head's rows), so a run's noise is the same whatever the rank
layout.

TENSOR PARALLELISM.  A model axis above 1 splits each leaf over the
server's model group, as GSPMD splits it in the reference (the megatron
specs of ``launch.sharding``): the state holds the rank's blocks, and the
model is built on the same group (``Model.init(cfg, gen,
group=ModelGroup.of(mesh))``).  A client's gradient is the backward
through the group's collectives (:mod:`repro_torch.models.parallel`), a
shared K/V head's summed over the ranks that share it, and the whole
leaves a rank reads only in part (``sharding.READ_IN_PART``: Mamba2's
per-channel leaves, RWKV-6's ``u`` and ``ln_scale``) summed over the
group in one packed ``all_reduce`` a client pass; the clip's global
norm, and the telemetry's, sum the blocks' squares over the group, each
block counted once (``sharding.multiplicity``); the combines run on the
blocks (K3 once a leaf on [P, D_local]).  Under ``client_parallel`` the
model axis splits the clients instead and every rank holds whole leaves.
Over gloo with CUDA tensors (ranks sharing one card), whose point-to-point
ops take no CUDA tensors, :meth:`Mesh.ppermute` runs as one sum
``all_reduce`` over the server group.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import GFLConfig, InputShape, ModelConfig
from repro_torch.core.privacy.mechanism import RoundContext, mechanism_for
from repro_torch.core.topology import combination_matrix
from repro_torch.draws import DrawKey, Draws
from repro_torch.kernels import ops as kops
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import Mesh, num_servers, server_axes
from repro_torch.models.flat import FlatView
from repro_torch.models.model import Model, check_supported
from repro_torch.models.parallel import (ModelGroup, gather_blocks,
                                         group_size, sum_over_sharers,
                                         sum_packed)
from repro_torch.optim.clip import clip_by_global_norm


class TrainState(NamedTuple):
    params: dict        # {path: [n_local, ...]}: this rank's servers
    step: int           # (and its block of each leaf over a model group)
    key: DrawKey


class TensorSpec(NamedTuple):
    """Shape, dtype and partition spec of an input, allocating nothing
    (the reference's ``ShapeDtypeStruct`` with its sharding)."""
    shape: tuple
    dtype: torch.dtype
    spec: tuple


# ---------------------------------------------------------------------------
# combine implementations
# ---------------------------------------------------------------------------


def _kernel_dense_combine(A, psi: dict, g) -> dict:
    """The dense combine through K3 (eq. 8 + 24): each leaf flattened to
    [P, D_leaf], combined by ``kernels.ops.graph_combine`` in one pass
    and cast back to the leaf's dtype.  Only the cancelling noise
    structure maps onto the kernel."""
    Pn = next(iter(psi.values())).shape[0]

    def mix(x, noise):
        flat = kops.graph_combine(
            A, x.reshape(Pn, -1),
            None if noise is None else noise.reshape(Pn, -1))
        return flat.reshape(x.shape).to(x.dtype)

    return {k: mix(x, None if g is None else g[k]) for k, x in psi.items()}


def _dense_combine(A, psi: dict, g, cancel: bool = True) -> dict:
    """The einsum: w_p = sum_m A[m,p] psi_m + (A^T g)_p [- g_p], in f32.
    ``cancel`` is the mechanism's ``server_cancels_exactly`` (eq. 24)."""
    A32 = A.to(torch.float32)

    def mix(x, noise):
        if noise is None:
            return torch.einsum("mp,m...->p...", A32,
                                x.to(torch.float32)).to(x.dtype)
        mixed = torch.einsum("mp,m...->p...", A32,
                             (x + noise).to(torch.float32))
        if cancel:
            mixed = mixed - noise.to(torch.float32)
        return mixed.to(x.dtype)

    return {k: mix(x, None if g is None else g[k]) for k, x in psi.items()}


def _ring(n: int, shift: int, base: int = 0, stride: int = 1) -> list:
    """(source, destination) pairs of a ring of ``n`` servers at global
    indices ``base + i * stride``: server i receives from i + shift."""
    return [(base + ((i + shift) % n) * stride, base + i * stride)
            for i in range(n)]


def _weights(A, rows, cols, wt, x):
    """A[rows, cols] in ``wt``, shaped to scale each of x's server rows."""
    return A[rows, cols].to(wt).reshape((-1,) + (1,) * (x.dim() - 1))


def _rotate_combine(mesh: Mesh, gfl: GFLConfig, tree: dict, A) -> dict:
    """The ring-rotation combine over the server dim: P - 1 permutes bring
    every other server's (psi_m + g_m) past each server, which accumulates
    its A[m, p]-weighted share.  ``combine_wire="bf16"`` accumulates in the
    leaf's dtype (rounding after every product and sum, as the reference's
    leaf function does), ``"f32"`` in f32."""
    Pn = num_servers(mesh)
    p = torch.tensor(list(mesh.local_servers), device=A.device)
    ring = _ring(Pn, 1)

    def leaf(x):
        wt = x.dtype if gfl.combine_wire == "bf16" else torch.float32
        buf = x
        acc = _weights(A, p, p, wt, x) * x.to(wt)
        for step in range(1, Pn):
            buf = mesh.ppermute(buf, ring)
            src = torch.remainder(p + step, Pn)
            acc = acc + _weights(A, src, p, wt, x) * buf.to(wt)
        return acc.to(x.dtype)

    return {k: leaf(x) for k, x in tree.items()}


def _sparse_combine(mesh: Mesh, gfl: GFLConfig, tree: dict, A) -> dict:
    """Neighbour-only combine for a ring (one server axis) or the product
    graph A_pod (x) A_ring (pod x data).  On one axis the weights come from
    the runtime ``A`` (a dead link is a zero weight); the product graph's
    factor weights are static (``make_train_step`` refuses link faults
    there).  On a 2-ring left and right are one neighbour, counted once."""
    saxes = server_axes(mesh)
    p = torch.tensor(list(mesh.local_servers), device=A.device)

    def ring_mix(x, Aw, idx, n, base, stride, wt):
        left = mesh.ppermute(x, [pair for b in base
                                 for pair in _ring(n, 1, b, stride)])
        acc = (_weights(Aw, idx, idx, wt, x) * x.to(wt)
               + _weights(Aw, torch.remainder(idx + 1, n), idx, wt, x)
               * left.to(wt))
        if n > 2:   # on a 2-ring left == right: don't double-count
            right = mesh.ppermute(x, [pair for b in base
                                      for pair in _ring(n, -1, b, stride)])
            acc = acc + _weights(Aw, torch.remainder(idx - 1, n), idx, wt,
                                 x) * right.to(wt)
        return acc

    if len(saxes) == 1:
        n = mesh.shape[saxes[0]]

        def leaf(x):
            wt = x.dtype if gfl.combine_wire == "bf16" else torch.float32
            return ring_mix(x, A, p, n, [0], 1, wt).to(x.dtype)
        return {k: leaf(x) for k, x in tree.items()}

    pod_ax, data_ax = saxes
    nd, npod = mesh.shape[data_ax], mesh.shape[pod_ax]
    Ad = torch.as_tensor(combination_matrix("ring", nd), dtype=torch.float32,
                         device=A.device)
    Ap = torch.as_tensor(combination_matrix("ring", npod) if npod > 2
                         else np.full((2, 2), 0.5), dtype=torch.float32,
                         device=A.device)
    pd, pp = torch.remainder(p, nd), torch.div(p, nd, rounding_mode="floor")

    def leaf(x):
        wt = x.dtype if gfl.combine_wire == "bf16" else torch.float32
        # mix along each pod's data ring, then along the pod ring: both
        # pod permutes carry the data-mixed y
        y = ring_mix(x, Ad, pd, nd, [q * nd for q in range(npod)], 1,
                     wt).to(x.dtype)
        return ring_mix(y, Ap, pp, npod, list(range(nd)), nd,
                        wt).to(x.dtype)

    return {k: leaf(x) for k, x in tree.items()}


def make_combination_matrix(mesh: Mesh, gfl: GFLConfig) -> np.ndarray:
    """A for the mesh's server count; multi-pod uses the product graph
    A_pod (x) A_data so the sparse combine factorizes over the two axes."""
    saxes = server_axes(mesh)
    if len(saxes) == 1:
        return combination_matrix(gfl.topology, mesh.shape[saxes[0]],
                                  rows=gfl.torus_rows, seed=gfl.topology_seed)
    npod = mesh.shape[saxes[0]]
    nd = mesh.shape[saxes[1]]
    Ad = combination_matrix(gfl.topology if gfl.topology != "torus"
                            else "ring", nd, seed=gfl.topology_seed)
    Ap = np.full((npod, npod), 1.0 / npod) if npod <= 2 \
        else combination_matrix("ring", npod)
    return np.kron(Ap, Ad)


def make_topology_process(mesh: Mesh, gfl: GFLConfig):
    """The mesh run's fault process: per-round effective A_i and client
    participation masks over the mesh's base graph (the product graph on
    multi-pod meshes).  Feed its realizations to the train step:

        proc = make_topology_process(mesh, gfl_cfg)
        real = proc.realize(step_idx)
        alive = (proc.client_alive(step_idx, L)
                 if proc.fault.client_dropout > 0 else None)
        state, metrics = step(state, batch, real.A, alive)
    """
    from repro_torch.core.resilience import TopologyProcess
    return TopologyProcess(make_combination_matrix(mesh, gfl), gfl.fault,
                           seed=gfl.topology_seed)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def _shared(model: Model) -> dict:
    """{key: r} of the leaves whose block r > 1 ranks of the model's group
    hold (a shared K/V head), each gradient to sum over them."""
    M = group_size(model.group)
    return {k: r for k in FlatView(model).tree_shapes()
            if shd.is_split(k, model.cfg, M)
            and (r := shd.multiplicity(k, model.cfg, M)) > 1}


def _read_in_part(model: Model) -> list:
    """The keys of the whole leaves the model's rank reads only in part,
    each gradient to sum over its group."""
    M = group_size(model.group)
    return [k for k in FlatView(model).tree_shapes()
            if shd.read_in_part(k, M)]


def client_grads(model: Model, tree: dict, batch: dict,
                 remat_policy: str | None = None, view=None,
                 shared=None, partial=None):
    """(loss, {key: gradient}) of ``model.loss(**batch)`` at the
    parameters ``tree`` ({key: tensor} of one server).  On a model split
    over its group the gradients are the rank's blocks of the whole
    model's: the backward runs through the group's collectives, a shared
    K/V head's gradient is summed over the ranks sharing it, and the
    gradients of the whole leaves read in part (``partial``, by default
    :func:`_read_in_part`'s) over the group, in one ``all_reduce``."""
    view = FlatView(model) if view is None else view
    loss, grads = view.tree_grad(model, tree, lambda: model.loss(
        **batch, remat_policy=remat_policy)[0])
    for k, r in (_shared(model) if shared is None else shared).items():
        grads[k] = sum_over_sharers(grads[k], model.group, r)
    partial = _read_in_part(model) if partial is None else partial
    grads.update(zip(partial, sum_packed([grads[k] for k in partial],
                                         model.group)))
    return loss, grads


def _counted(model: Model) -> dict:
    """{key: bool}: whether this rank counts its block of each leaf in a
    sum over the model group (the first of the ranks that hold it)."""
    M = group_size(model.group)
    index = 0 if model.group is None else model.group.index
    return {k: index % shd.multiplicity(k, model.cfg, M) == 0
            for k in FlatView(model).tree_shapes()}


def whole_leaves(tree: dict, cfg: ModelConfig, group) -> dict:
    """One server's whole leaves from the rank's blocks ``tree`` ({key:
    block}, no server dim) of a model split over ``group``, on every rank
    of it: each split leaf's blocks gathered (one sum ``all_reduce``) and
    put together (``sharding.unshard_leaf``).  ``tree`` itself without a
    group."""
    M = group_size(group)
    return {k: shd.unshard_leaf(k, gather_blocks(x, group)
                                if shd.is_split(k, cfg, M) else [x] * M,
                                cfg, M, lead=shd.stack_lead(k))
            for k, x in tree.items()}


def make_train_step(model: Model, gfl: GFLConfig, mesh: Mesh,
                    clients: int = 4,
                    remat_policy: str | None = None) -> Callable:
    """Build the GFL train step.

    State params: {path: [n_local, ...]}; batch leaves: [P, L, b, ...]
    (every rank passes the whole batch and reads its own servers' rows).
    Returns ``step(state, batch[, A_round, client_alive, cohort_weights])
    -> (state, metrics)``.

    The trailing arguments are the resilience / population hooks (the
    defaults are the static path): ``A_round`` replaces the base matrix
    with a round's effective one (:func:`make_topology_process`),
    ``client_alive`` ([P, L]) applies mid-round client dropout (the mean
    renormalizes over survivors), and ``cohort_weights`` ([P, L]) scale
    each client's gradient BEFORE its clip and the server mean (the
    population engine's 1/(K pi_k) estimator, unbiased up to the clip).
    ``clients`` is the reference's argument, unused there too: L comes
    from the batch."""
    from repro_torch.core.resilience import parse_fault_spec
    from repro_torch.core.resilience.runtime import ensure_dropout_safe
    from repro_torch.telemetry import telemetry_active, trace_span

    dev = mesh.device
    with trace_span("make_combination_matrix", combine=gfl.combine_impl):
        A = make_combination_matrix(mesh, gfl)
    Pn = num_servers(mesh)
    Aj = torch.as_tensor(A, dtype=torch.float32, device=dev)

    fault = parse_fault_spec(gfl.fault)
    if fault.straggler > 0:
        raise ValueError(
            "straggler faults are simulator-only for now (they need the "
            "per-server psi cache of repro_torch.core.resilience.runtime); "
            "mesh fault specs support links/outage/dropout components")
    if (fault.perturbs_topology and gfl.combine_impl == "sparse"
            and len(server_axes(mesh)) > 1):
        raise ValueError(
            "sparse combine on a multi-pod mesh derives its product-graph "
            "weights statically and cannot apply per-round link faults; "
            "use combine_impl='rotate' (or 'dense') with fault specs")
    if gfl.combine_impl not in ("dense", "rotate", "sparse"):
        raise ValueError(f"unknown combine_impl {gfl.combine_impl!r}")
    lay = mesh.layout()
    # the rank's model group: None under client_parallel (whole models)
    want = None if gfl.client_parallel else ModelGroup.of(mesh)
    check_supported(model.cfg, group_size(want))
    group, cfg = model.group, model.cfg
    if (group_size(group), getattr(group, "index", 0)) != (
            group_size(want), getattr(want, "index", 0)):
        raise ValueError(
            f"the model is split over {group_size(group)} rank(s), this "
            f"rank's model group on mesh {mesh.shape} over "
            f"{group_size(want)}: build the model with Model.init(cfg, gen, "
            "group=ModelGroup.of(mesh)), or whole under client_parallel")

    acc_dtype = getattr(torch, gfl.grad_acc_dtype)
    view = FlatView(model)
    lo, hi = lay["servers"].start, lay["servers"].stop
    shared = _shared(model)
    partial = _read_in_part(model)
    counted = _counted(model)
    # the whole model's leaf shapes: the noise is drawn whole
    whole = FlatView(abstract_model(cfg) if group is not None
                     else model).tree_shapes()

    def loss_and_grads(w_p, client_batch):
        return client_grads(model, w_p, client_batch, remat_policy, view,
                            shared, partial)

    # every rank runs the same ops (SPMD): a block another rank counts is
    # squared and summed, then selected away
    counts = ({k: torch.tensor(c, device=dev) for k, c in counted.items()}
              if group is not None else None)

    def group_sq(tree) -> torch.Tensor:
        """The sum of squares of the whole leaves whose blocks ``tree``
        holds, f32, on every rank of the group."""
        sq = torch.zeros((), dtype=torch.float32, device=dev)
        for k, g in tree.items():
            sq = sq + torch.where(
                counts[k], torch.sum(torch.square(g.to(torch.float32))), 0.0)
        return group.all_reduce(sq)

    def clip(grads):
        """The clip to the global norm of the whole model's gradient."""
        return clip_by_global_norm(grads, gfl.grad_bound, None if group is None
                                   else torch.sqrt(group_sq(grads)))[0]

    def block(tree, rows) -> dict:
        """``rows`` of a whole [P, ...] noise tree, each leaf's block."""
        return {k: shd.shard_leaf(k, x[rows], cfg, group,
                                  lead=1 + shd.stack_lead(k))
                for k, x in tree.items()}

    def client_mean_grads(w_p, batch_p, alive_p=None, weights_p=None):
        """(6)+(7): L clients; per-client clip to B; mean.  ``alive_p``
        ([L] 0/1): dropped clients contribute nothing and the mean is over
        the survivors.  ``weights_p`` ([L]): cohort weights applied BEFORE
        the per-client clip, the mean still over L (or the survivors)."""
        scaled = alive_p is not None or weights_p is not None
        L = next(iter(batch_p.values())).shape[0]
        if scaled:
            a_all = (torch.ones((L,), device=dev) if alive_p is None
                     else alive_p)
            w_all = (torch.ones((L,), device=dev) if weights_p is None
                     else weights_p)
        acc = {k: torch.zeros(v.shape, dtype=acc_dtype, device=v.device)
               for k, v in w_p.items()}
        losses = []
        for l in range(L):
            loss, grads = loss_and_grads(
                w_p, {k: v[l] for k, v in batch_p.items()})
            if scaled:
                w = w_all[l]
                grads = {k: g * w.to(g.dtype) for k, g in grads.items()}
            if gfl.grad_bound > 0:
                grads = clip(grads)
            if not scaled:
                for k, g in grads.items():
                    acc[k] += g.to(acc_dtype)
            else:
                a = a_all[l].to(acc_dtype)
                for k, g in grads.items():
                    acc[k] += g.to(acc_dtype) * a
                loss = loss * a_all[l]
            losses.append(loss)
        losses = torch.stack(losses)
        if alive_p is None:
            return ({k: (c / L).to(torch.float32) for k, c in acc.items()},
                    losses.mean())
        n = torch.clamp(alive_p.sum(), min=1.0).to(acc_dtype)
        return ({k: (c / n).to(torch.float32) for k, c in acc.items()},
                losses.sum() / n.to(losses.dtype))

    def client_parallel_grads(w_p, batch_p, alive_p=None, weights_p=None):
        """The small-model mode: the L clients split over the model group
        (the parameters are whole on every rank of it), each clipped by
        its own global norm, then summed across the group by an
        all-reduce and averaged."""
        L = next(iter(batch_p.values())).shape[0]
        m, M = lay["model_index"], lay["model_ranks"]
        if L % M:
            raise ValueError(f"client_parallel: {L} clients do not split "
                             f"over {M} model ranks")
        mine = range(m * (L // M), (m + 1) * (L // M))
        plain = alive_p is None and weights_p is None
        a_all = (torch.ones((L,), device=dev) if alive_p is None
                 else alive_p.to(torch.float32))
        acc = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
               for k, v in w_p.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for l in mine:
            loss, grads = loss_and_grads(
                w_p, {k: v[l] for k, v in batch_p.items()})
            if weights_p is not None:
                wf = weights_p[l].to(torch.float32)
                grads = {k: g * wf.to(g.dtype) for k, g in grads.items()}
            if gfl.grad_bound > 0:
                # per-(server, client) global-norm clip over the tree
                sq = sum(torch.sum(torch.square(g.to(torch.float32)))
                         for g in grads.values())
                coef = torch.clamp(gfl.grad_bound / torch.clamp(
                    torch.sqrt(sq), min=1e-12), max=1.0)
                grads = {k: g * coef.to(g.dtype) for k, g in grads.items()}
            for k, g in grads.items():
                acc[k] += (g.to(torch.float32) if plain
                           else g.to(torch.float32) * a_all[l])
            loss_sum = loss_sum + (loss if plain else loss * a_all[l])
        for t in list(acc.values()) + [loss_sum]:
            mesh.all_reduce_model(t)
        n = torch.clamp(a_all.sum(), min=1.0)
        return ({k: c / n for k, c in acc.items()}, loss_sum / n)

    mech = mechanism_for(gfl)
    profile = mech.noise_profile()
    if fault.client_dropout > 0:
        ensure_dropout_safe(profile, where="mesh client dropout")
    grads_fn = client_parallel_grads if gfl.client_parallel \
        else client_mean_grads
    if gfl.combine_impl == "rotate":
        combine = _rotate_combine
    elif gfl.combine_impl == "sparse":
        combine = _sparse_combine

    def step_fn(state: TrainState, batch: dict, A_round=None,
                client_alive=None, cohort_weights=None):
        key = state.key
        ctx = RoundContext(step=state.step, traced_step=True)
        A_rt = Aj if A_round is None else torch.as_tensor(
            A_round, dtype=torch.float32, device=dev)
        alive = (None if client_alive is None or fault.client_dropout == 0
                 else torch.as_tensor(client_alive, dtype=torch.float32,
                                      device=dev))
        weights = (None if cohort_weights is None
                   else torch.as_tensor(cohort_weights, dtype=torch.float32,
                                        device=dev))
        batch_l = {k: v[lo:hi].to(dev) for k, v in batch.items()}
        alive_l = None if alive is None else alive[lo:hi]
        weights_l = None if weights is None else weights[lo:hi]

        # (6)+(7) per server, then psi = w - mu * mean_g in the leaf dtype
        psi = {k: torch.empty_like(v) for k, v in state.params.items()}
        losses = []
        for i in range(hi - lo):
            w_p = {k: v[i] for k, v in state.params.items()}
            b_p = {k: v[i] for k, v in batch_l.items()}
            mean_g, loss = grads_fn(
                w_p, b_p, None if alive_l is None else alive_l[i],
                None if weights_l is None else weights_l[i])
            for k, w in w_p.items():
                psi[k][i] = (w.to(torch.float32) - gfl.mu * mean_g[k]
                             ).to(w.dtype)
            losses.append(loss)
            del mean_g
        loss = torch.stack(losses)

        # the noise trees are drawn whole for all P servers (each rank
        # keeps its rows and blocks), so a run's noise does not depend on
        # the rank layout
        shapes = {k: torch.empty((Pn,) + s, dtype=dt, device="meta")
                  for k, (s, dt) in whole.items()}
        # client-level residual noise: None for the cancelling mechanisms;
        # iid's variance-equivalent draw scales with each server's survivor
        # count under dropout
        if profile.client_sigma > 0:
            L = next(iter(batch.values())).shape[1]
            L_eff = (L if alive is None
                     else torch.clamp(alive.sum(dim=1), min=1.0))
            cg = mech.client_noise_tree(key, shapes, L_eff, ctx)
            if cg is not None:
                cg = block(cg, slice(lo, hi))
                psi = {k: x + cg[k] for k, x in psi.items()}
                del cg

        # (8) with the mechanism's server-level noise (every server's rows
        # for the dense combine, this rank's for the permutes)
        g = (mech.combine_noise_tree(key, shapes, ctx)
             if profile.server_sigma > 0 else None)
        if g is not None:
            g = block(g, slice(None) if gfl.combine_impl == "dense"
                      else slice(lo, hi))
        cancel = profile.server_cancels_exactly

        if gfl.combine_impl == "dense":
            full = {k: mesh.all_gather_servers(x) for k, x in psi.items()}
            if gfl.use_kernels and (g is None or cancel):
                mixed = _kernel_dense_combine(A_rt, full, g)
            else:
                mixed = _dense_combine(A_rt, full, g, cancel=cancel)
            new_params = {k: x[lo:hi] for k, x in mixed.items()}
        elif g is not None:
            # the permuted buffer carries (psi_m + g_m), as the wire
            # protocol does; cancelling mechanisms subtract their own g_p
            # after (eq. 24)
            mixed = combine(mesh, gfl, {k: x + g[k] for k, x in psi.items()},
                            A_rt)
            new_params = ({k: (m.to(torch.float32)
                               - g[k].to(torch.float32)).to(m.dtype)
                           for k, m in mixed.items()} if cancel else mixed)
        else:
            new_params = combine(mesh, gfl, psi, A_rt)
        del psi, g

        server_loss = mesh.all_gather_servers(loss)
        metrics = {"loss": server_loss.mean(), "step": state.step}
        # read-only telemetry tap, only when a session is active
        if telemetry_active():
            sq = torch.zeros((2,), dtype=torch.float32, device=dev)
            for k, n in new_params.items():
                if not counted[k]:
                    continue
                o = state.params[k]
                d = n.to(torch.float32) - o.to(torch.float32)
                sq[0] += torch.sum(d * d)
                sq[1] += torch.sum(n.to(torch.float32) * n.to(torch.float32))
            if group is not None:
                group.all_reduce(sq)
            sq = mesh.all_gather_servers(sq[None]).sum(dim=0)
            metrics["update_norm"] = torch.sqrt(sq[0])
            metrics["param_norm"] = torch.sqrt(sq[1])
        return (TrainState(new_params, state.step + 1,
                           DrawKey(key.draws, key.round + 1)), metrics)

    return step_fn


def init_train_state(model: Model, gfl: GFLConfig, mesh: Mesh,
                     key=0) -> TrainState:
    """Every server starts from the model's weights (the reference's
    replicated init): the rank's blocks of them when the model is split
    over the mesh's model group (``Model.init(cfg, gen,
    group=ModelGroup.of(mesh))``, bitwise the blocks of the whole init).
    ``key`` is the run's :class:`Draws` or its seed."""
    n = len(mesh.local_servers)
    params = {k: v.to(mesh.device).unsqueeze(0).expand((n,) + v.shape)
              .clone() for k, v in FlatView(model).tree(model).items()}
    draws = key if isinstance(key, Draws) else Draws(key, mesh.device)
    return TrainState(params, 0, DrawKey(draws, 0))


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------


def _bound(model: Model, params):
    """The model reading ``params`` (a tree of one server's leaves), or its
    own weights when ``params`` is None."""
    import contextlib
    if params is None:
        return contextlib.nullcontext(model)
    view = FlatView(model)
    return view.bind(model, view.tree_tensors(params))


def make_prefill_step(model: Model) -> Callable:
    """``prefill(params, batch)`` over ``model`` (the rank's blocks and
    its model group's collectives when it is split: any model axis)."""
    def prefill(params, batch):
        with _bound(model, params):
            return model.prefill(batch["tokens"], **{
                k: v for k, v in batch.items() if k != "tokens"})
    return prefill


def make_decode_step(model: Model) -> Callable:
    """``decode(params, tokens, cache)`` over ``model``, split or whole."""
    def decode(params, tokens, cache):
        with _bound(model, params):
            return model.decode_step(tokens, cache)
    return decode


# ---------------------------------------------------------------------------
# input specs (shapes and dtypes from fake tensors; nothing allocated)
# ---------------------------------------------------------------------------


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def abstract_model(cfg: ModelConfig) -> Model:
    """``cfg``'s model on fake (meta-backed) tensors: its shapes and dtypes,
    nothing allocated, at any size."""
    with _fake_mode():
        return Model.init(cfg, torch.Generator())


def sanitize_spec(shape: tuple, spec: tuple, mesh: Mesh) -> tuple:
    """Drop mesh axes from dims they don't divide evenly (e.g. phi3's
    2047-slot sliding-window ring cache can't be 16-way sequence-sharded);
    replication is the safe fallback for such (always small) dims."""
    parts = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        if entry is None:
            parts.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        size = int(np.prod([mesh.shape[a] for a in axes]))
        parts.append(entry if dim % size == 0 else None)
    return tuple(parts)


def train_batch_shape(cfg: ModelConfig, shape: InputShape, n_servers: int,
                      clients: int = 4):
    """(L, b) of the GFL batch's leading dims [P, L, b]."""
    per_server = shape.global_batch // n_servers
    L = min(clients, per_server)
    b = per_server // L
    return L, b


def input_specs(model: Model, shape: InputShape, mesh: Mesh, *,
                gfl: GFLConfig | None = None, clients: int = 4) -> dict:
    """TensorSpec stand-ins for every model input of this shape (the
    reference's dtypes: int32 tokens, the param dtype for embeddings)."""
    cfg = model.cfg
    S = shape.seq_len
    pdt = getattr(torch, cfg.param_dtype)

    if shape.kind == "train":
        Pn = num_servers(mesh)
        L, b = train_batch_shape(cfg, shape, Pn, clients)
        bspecs = shd.batch_specs(
            cfg, mesh, kind="train", gfl_train=True,
            client_parallel=bool(gfl and gfl.client_parallel))
        S_text = S - cfg.num_image_tokens if cfg.family == "vlm" else S
        batch = {k: TensorSpec((Pn, L, b, S_text), torch.int32, bspecs[k])
                 for k in ("tokens", "labels")}
        if cfg.family == "vlm":
            batch["image_embeds"] = TensorSpec(
                (Pn, L, b, cfg.num_image_tokens, cfg.d_model), pdt,
                bspecs["image_embeds"])
        if cfg.family == "audio":
            batch["frames"] = TensorSpec(
                (Pn, L, b, cfg.encoder_seq_len, cfg.d_model), pdt,
                bspecs["frames"])
        return batch

    B = shape.global_batch
    bspecs = shd.batch_specs(cfg, mesh, kind=shape.kind)
    if shape.kind == "prefill":
        S_text = S - cfg.num_image_tokens if cfg.family == "vlm" else S
        batch = {"tokens": TensorSpec((B, S_text), torch.int32,
                                      bspecs["tokens"])}
        if cfg.family == "vlm":
            batch["image_embeds"] = TensorSpec(
                (B, cfg.num_image_tokens, cfg.d_model), pdt,
                bspecs["image_embeds"])
        if cfg.family == "audio":
            batch["frames"] = TensorSpec((B, cfg.encoder_seq_len,
                                          cfg.d_model), pdt,
                                         bspecs["frames"])
        return batch

    # decode: tokens [B] + cache of S tokens
    shard_seq = B == 1
    with _fake_mode():
        cache = model.init_cache(B, S)
    cspecs = shd.cache_specs(cfg, mesh, shard_seq=shard_seq)
    # whisper's cross K/V in the param dtype, as the reference's
    # init_cache makes them (the port's cache keeps them in f32, the dtype
    # the reference's prefill hands on)
    cache = {k: TensorSpec(tuple(v.shape),
                           pdt if k in ("xk", "xv") else v.dtype,
                           sanitize_spec(tuple(v.shape), cspecs[k], mesh))
             for k, v in cache.items()}
    da = shd._data_axes(mesh)
    return {"tokens": TensorSpec((B,), torch.int32,
                                 (None,) if B == 1 else (da,)),
            "cache": cache}


def params_specs(model: Model, mesh: Mesh, *, gfl_train: bool,
                 client_parallel: bool = False) -> tuple:
    """({path: TensorSpec}, {path: spec}) of the parameter tree (with the
    leading server dim when ``gfl_train``)."""
    cfg = model.cfg
    saxes = server_axes(mesh) if gfl_train else None
    shapes = FlatView(model).tree_shapes()
    if gfl_train:
        Pn = num_servers(mesh)
        shapes = {k: ((Pn,) + s, dt) for k, (s, dt) in shapes.items()}
    specs = shd.params_specs(list(shapes), cfg, server_axes=saxes,
                             model_axis=None if client_parallel else "model")
    return ({k: TensorSpec(s, dt, specs[k]) for k, (s, dt) in shapes.items()},
            specs)
