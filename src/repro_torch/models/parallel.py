"""Tensor parallelism over a mesh's model group: the group handle and its
collectives (the reference has no module of its own for them: GSPMD
inserts them where ``launch/sharding.py``'s specs split a leaf over
``"model"``).

A model split over M ranks holds each rank's block of every split leaf
(:func:`repro_torch.launch.sharding.shard_leaf`) and runs Megatron's
pattern: a replicated activation enters a column-parallel product
(:func:`copy_to_group`), the row-parallel product after it leaves a
partial sum, and :func:`reduce_from_group` adds the partials over the
group.  :func:`row_parallel` takes such a product and its sum in f32 on
every rank and rounds once, as the whole product's f32 accumulation
rounds once, where a model's numerics need it: a bf16 partial rounded on
each rank and summed in bf16 moves the sum by up to M half ulps, which
RWKV-6's recurrence carries into its state at every token (its two out
products use it; the other families sum bf16 partials).  The
vocab-parallel logits are gathered by :func:`gather_from_group`.

Every collective here is one sum ``all_reduce`` over the model group
(:meth:`repro_torch.launch.mesh.Mesh.all_reduce_model`): the gather too,
each rank writing its slice into a zeroed full buffer (exact, since
``x + 0 == x``).  So the same code runs on NCCL across cards, on gloo for
ranks that share one card (torch's backend table lists gloo's CUDA support
for ``all_reduce`` and ``broadcast`` alone), and on gloo CPU ranks.

The three are ``torch.autograd.Function``s with Megatron's backward passes
(copy <-> reduce, gather -> slice), for training under tensor parallelism;
serving runs their forward passes under ``no_grad``, where the reduce
works in place on the fresh partial product.  A whole leaf read after a
copy would get only the rank's share of its gradient, so the models read
their whole leaves (norms, the MoE router, MLA's down projections) before
the copy and copy what those leaves produce.

Two more collectives serve activations that every rank reads but whose
consumers are split, so that their backward passes sum: :func:`sum_shared`
(Mamba2's gated norm: the sum of squares over the whole inner width) and
:func:`gather_shared` (Mamba2's B and C, which every head reads: the
ranks' state columns side by side, the gradient summed over the group
before the rank takes its slice).  Three more sums serve the train step:
:func:`sum_over_sharers` (a K/V head's gradient over the ranks that share
it), :func:`sum_packed` (the gradients of the whole leaves a rank reads
only in part) and :func:`gather_blocks` (every rank's block of a leaf,
for the consensus checkpoint).

A model whose ``group`` is ``None`` holds every shard: every world of 1,
at any model axis, runs that way, with whole leaves and no collective.
"""
from __future__ import annotations

import torch


class ModelGroup:
    """The ``size`` ranks that split one model, this one at ``index``;
    its collectives go over ``mesh``'s model group."""

    def __init__(self, size: int, index: int, mesh=None):
        if not 0 <= index < size:
            raise ValueError(f"model index {index} outside a group of {size}")
        self.size, self.index, self.mesh = int(size), int(index), mesh

    @classmethod
    def of(cls, mesh) -> "ModelGroup | None":
        """The rank's model group of ``mesh``; None where one rank holds
        the whole model (a model axis of 1, or a world of 1)."""
        lay = mesh.layout()
        if lay["model_ranks"] == 1:
            return None
        return cls(lay["model_ranks"], lay["model_index"], mesh)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the group, in place."""
        return self.mesh.all_reduce_model(x)


def group_size(group: "ModelGroup | None") -> int:
    return 1 if group is None else group.size


def _all_gather_last(x: torch.Tensor, group: ModelGroup) -> torch.Tensor:
    n = x.shape[-1]
    full = x.new_zeros(*x.shape[:-1], n * group.size)
    full[..., group.index * n:(group.index + 1) * n] = x
    return group.all_reduce(full)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce(grad.clone()), None


class _ReduceFromGroup(torch.autograd.Function):
    """The sum over the group forward; the gradient as it is."""

    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromGroup(torch.autograd.Function):
    """The ranks' last-dim slices side by side forward; the rank's slice
    of the gradient back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[-1]
        return _all_gather_last(x, group)

    @staticmethod
    def backward(ctx, grad):
        i, n = ctx.group.index, ctx.n
        return grad[..., i * n:(i + 1) * n].contiguous(), None


class _SumShared(torch.autograd.Function):
    """The sum over the group forward; the gradient summed over the group
    back (every rank's split consumers read the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce(grad.clone()), None


class _GatherShared(torch.autograd.Function):
    """The ranks' last-dim slices side by side forward; the gradient
    summed over the group, then the rank's slice, back (every rank's
    split consumers read the whole)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[-1]
        return _all_gather_last(x, group)

    @staticmethod
    def backward(ctx, grad):
        i, n = ctx.group.index, ctx.n
        whole = ctx.group.all_reduce(grad.contiguous().clone())
        return whole[..., i * n:(i + 1) * n].contiguous(), None


def _recording(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated activation entering a column-parallel product."""
    if group is None or not _recording(x):
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of a row-parallel product's partials over the group (in
    place on ``x`` when autograd does not record)."""
    if group is None:
        return x
    if _recording(x):
        return _ReduceFromGroup.apply(x, group)
    return group.all_reduce(x)


def row_parallel(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """``x @ w`` of a weight split by rows over ``group`` (``x`` the
    rank's columns), summed over the group: each rank's partial product
    and the sum in f32 (or ``x``'s wider dtype), rounded once to ``x``'s
    dtype; ``x @ w`` itself without a group."""
    if group is None:
        return x @ w
    acc = torch.promote_types(x.dtype, torch.float32)
    return reduce_from_group(x.to(acc) @ w.to(acc), group).to(x.dtype)


def gather_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The group's last-dim slices of ``x`` side by side, in rank order:
    [..., n] on each rank -> [..., n * size], bit for bit."""
    if group is None:
        return x
    if _recording(x):
        return _GatherFromGroup.apply(x, group)
    return _all_gather_last(x, group)


def copy_all_to_group(tensors, group) -> list:
    """:func:`copy_to_group` of several activations of one shape and
    dtype at once (one sum ``all_reduce`` of their stacked gradients in
    the backward); the tensors themselves where autograd does not record."""
    if group is None or not _recording(tensors[0]):
        return list(tensors)
    return list(_CopyToGroup.apply(torch.stack(tensors), group).unbind(0))


def sum_shared(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' partials ``x`` over the group, read by every
    rank's split consumers: its backward sums their gradients over the
    group too (in place on ``x`` when autograd does not record)."""
    if group is None:
        return x
    if _recording(x):
        return _SumShared.apply(x, group)
    return group.all_reduce(x)


def gather_shared(x: torch.Tensor, group) -> torch.Tensor:
    """The group's last-dim slices of ``x`` side by side, as
    :func:`gather_from_group`, for a whole that every rank's split
    consumers read: its backward sums the gradient over the group before
    taking the rank's slice."""
    if group is None:
        return x
    if _recording(x):
        return _GatherShared.apply(x, group)
    return _all_gather_last(x, group)


def sum_packed(tensors, group) -> list:
    """Each tensor's sum over the group, in one sum ``all_reduce`` of
    their f32 concatenation, each cast back to its dtype; the tensors
    themselves without a group."""
    if group is None or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    group.all_reduce(flat)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


def sum_over_sharers(x: torch.Tensor, group, mult: int) -> torch.Tensor:
    """The sum of ``x`` over the ``mult`` ranks of ``group`` that hold the
    same block (consecutive runs: indices ``m // mult`` alike): each rank
    writes its run's slot of a zeroed [size / mult, ...] buffer, one sum
    ``all_reduce`` over the group, each reads its slot back.  ``x`` itself
    where no rank shares (``mult`` 1, no collective on any rank)."""
    if group is None or mult == 1:
        return x
    slot = group.index // mult
    buf = x.new_zeros((group.size // mult,) + tuple(x.shape))
    buf[slot] = x
    return group.all_reduce(buf)[slot]


def gather_blocks(x: torch.Tensor, group) -> list:
    """Every rank's ``x`` (equal shapes) in the group's order, on every
    rank: one sum ``all_reduce`` of a zeroed [size, ...] buffer, each rank
    writing its own slot (exact).  ``[x]`` without a group."""
    if group is None:
        return [x]
    buf = x.new_zeros((group.size,) + tuple(x.shape))
    buf[group.index] = x
    return list(group.all_reduce(buf).unbind(0))
