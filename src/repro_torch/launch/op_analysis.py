"""Per-card FLOPs, HBM bytes, collective bytes and memory of one step,
counted from its dispatched op stream (the port's counterpart of
``repro/launch/hlo_analysis.py``).

The reference parses XLA's optimized HLO text, hence its module's name;
torch has no HLO, and an eager step *is* its op stream, so this module
reads the aten and c10d ops a step dispatches instead, through a
``TorchDispatchMode`` (:class:`OpCounter`).  The same counter runs over a
step on fake tensors (``FakeTensorMode``: the dry run,
:mod:`repro_torch.launch.dryrun`, where nothing is allocated or run) and
over the same step on real tensors on the card, and gives the same
numbers for both.

    with FakeTensorMode():
        ... build the step's inputs ...
        with OpCounter(inputs) as c:
            out = step(*inputs)
        c.finish(out)
    c.stats.flops, c.stats.hbm_bytes, c.stats.peak_bytes

What each field counts, per card (the process is one rank):

``flops``, ``dot_flops``
    Matmul, convolution and attention ops count by
    ``torch.utils.flop_counter``'s formulas (2 m n k for a product), and
    only those go into ``dot_flops``, as only ``dot`` does in the
    reference.  Pointwise ops (``torch.Tag.pointwise``) count one a
    output element and reductions (``torch.Tag.reduction``) one an input
    element, as ``hlo_analysis.py`` counts elementwise and ``reduce`` ops.
``hbm_bytes``
    The operand plus output bytes of every op that materializes a result.
    An op that writes into an argument counts what it reads and writes
    there: the argument read and written (``add_``), written only
    (``copy_``, ``fill_``, an ``out=`` op), or only as many elements as
    its last operand holds (``index_put_``, ``index_copy_``: a cache
    update writes its new rows, not the cache).  View, alias and
    metadata ops, and ``empty*`` (which writes nothing), are left out, as the reference leaves out its ``_NON_MATERIALIZING``
    ops.  The port runs eagerly, so every op boundary is an HBM round
    trip: that is what this count means.  It is *not* XLA's, which reads
    and writes HBM only at fusion boundaries, and it is not held to the
    reference's ``hbm_bytes``.
``collective_bytes``, ``collective_counts``, ``collective_bytes_by_op``
    Each c10d op counts its output bytes on this rank under the
    reference's op names, as the reference counts an HLO collective's
    output: ``all-gather`` the gathered total, ``all-reduce`` the tensor,
    ``collective-permute`` the rows received (``recv_``); ``send`` is not
    counted, so a permute is not counted twice.
``argument_bytes``, ``output_bytes``, ``temp_bytes``, ``peak_bytes``
    The step's inputs (given to :class:`OpCounter`), its outputs (given to
    :meth:`OpCounter.finish`), the most bytes of storage created during
    the step that were alive at once, and arguments plus that.  Storage
    is tracked by a ``weakref.finalize`` on each fresh output's untyped
    storage (a storage's Python object lives exactly as long as the
    storage): an op whose schema returns no alias creates its outputs'
    storage, and the finalizer takes it off the live count when the last
    tensor on it dies.  The caching allocator rounds each block up to 512
    bytes, and cuBLAS keeps a 32 MiB workspace a stream, which no op
    shows.

The reference's ``unknown_trip_loops`` is dropped: it counts while loops
whose trip count XLA could not see, and an eager trace runs every loop,
so there is nothing it could count.

The hand-written kernels K3 (``graph_combine``) and K8 (``swa_decode``)
count as one op each (``kernel_launches``), with the bytes and FLOPs of
their own cost models (``graph_combine.cost``, ``swa_decode.cost``, the
functions ``chip_smoke.py`` bounds them with), reported by the wrappers
through :data:`repro_torch.kernels.LISTENERS`, never recounted from their
plain versions.  RWKV-6's time loop on fake tensors reports its cost the
same way (``models.rwkv.time_loop_cost``: the eager loop's op stream,
exact for its forward, the backward's leading terms), counted under
``modelled``: tracing its S steps op by op takes hours at S = 4096 (the
reference's ``lax.scan`` compiles its body once).
"""
from __future__ import annotations

import threading
import weakref
from collections import Counter
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import kernels as _k

# the c10d ops the port's collectives dispatch, by the reference's HLO
# names (any other counts under its own name); the first argument of each
# holds the tensors the collective writes on this rank.  ``send`` is left
# out: its ``recv_`` counts the permute
_COLLECTIVES = {"allreduce_": "all-reduce", "allgather_": "all-gather",
                "recv_": "collective-permute"}
# ops that allocate without writing
_NO_WRITE = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided"}
# in-place ops that write their argument without reading it
_OVERWRITES = {"copy_", "fill_", "zero_"}
# in-place ops that write only as many elements as their last operand
# holds (the values or source they put into the argument)
_SCATTERS = {"index_put_", "index_copy_"}


@dataclass
class OpStats:
    """The fields of ``hlo_analysis.HLOStats`` (less
    ``unknown_trip_loops``), with the op count, the kernels' launches and
    the memory of the step, per card."""
    flops: float = 0.0
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_counts: dict = field(default_factory=dict)
    collective_bytes_by_op: dict = field(default_factory=dict)
    ops: int = 0
    op_counts: Counter = field(default_factory=Counter)
    kernel_launches: dict = field(default_factory=dict)
    modelled: dict = field(default_factory=dict)
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0

    @property
    def peak_bytes(self) -> int:
        return self.argument_bytes + self.temp_bytes

    def counts(self) -> dict:
        """The counted quantities, for comparing two traces of one step."""
        return {"ops": self.ops, "flops": self.flops,
                "dot_flops": self.dot_flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": self.collective_bytes,
                "collective_counts": dict(self.collective_counts),
                "kernel_launches": dict(self.kernel_launches),
                "modelled": dict(self.modelled)}


def _tensors(tree) -> list:
    """The tensors of ``tree`` that hold memory (not ``meta`` ones)."""
    return [t for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor) and t.device.type != "meta"]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under the tensors of ``tree``."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _views(func) -> bool:
    """Whether ``func`` returns a view of an input (an alias it does not
    write)."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _mutated(func, args, kwargs) -> list:
    """The tensors ``func`` writes into: its arguments whose schema marks
    them written (an in-place op's self, an ``out=``)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        v = kwargs.get(a.name) if (a.kwarg_only or i >= len(args)) \
            else args[i]
        out.extend(_tensors(v))
    return out


def _written_bytes(func, name: str, ins: list, mutated: list) -> int:
    """HBM bytes of an op that writes into its arguments (see the module
    note)."""
    other = [t for t in ins if not any(t is m for m in mutated)]
    read = sum(_nbytes(t) for t in other)
    into = sum(_nbytes(t) for t in mutated)
    if name in _SCATTERS:
        return read + (_nbytes(other[-1]) if other else 0)
    if name in _OVERWRITES or func._overloadname.startswith("out"):
        return read + into
    return read + 2 * into


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is entered into :attr:`stats`.

    ``inputs`` is the step's argument tree: its bytes are
    ``argument_bytes`` unless ``argument_bytes`` is given (a step whose
    argument holds more than the rank reads, such as the train step's
    whole batch).  Entered inside a ``FakeTensorMode`` it sees the ops the
    step dispatches before the fake mode runs them; on real tensors it
    sees the ops that launch.  Call :meth:`finish` with the step's output
    after leaving it."""

    def __init__(self, inputs=(), argument_bytes: int | None = None):
        super().__init__()
        self.stats = OpStats(argument_bytes=storage_bytes(inputs)
                             if argument_bytes is None else argument_bytes)
        self._live = 0
        # the backward of a CUDA step runs on autograd's device thread,
        # and a storage may die on either
        self._lock = threading.RLock()   # a finalizer may fire inside

    # ------------------------------------------------------------ memory

    def _freed(self, nbytes: int) -> None:
        with self._lock:
            self._live -= nbytes

    def _fresh(self, tensors) -> None:
        with self._lock:
            for t in tensors:
                st = t.untyped_storage()
                n = st.nbytes()
                self._live += n
                weakref.finalize(st, self._freed, n)
            self.stats.temp_bytes = max(self.stats.temp_bytes, self._live)

    # --------------------------------------------------------------- ops

    def _kernel(self, name: str, cost: dict) -> None:
        """One reported call: a kernel's launch (one op), or a modelled
        unit (its ``ops``)."""
        s = self.stats
        if name in _k.LAUNCHES:
            s.ops += 1
            s.op_counts[f"kernel.{name}"] += 1
            s.kernel_launches[name] = s.kernel_launches.get(name, 0) + 1
        else:
            s.ops += cost["ops"]
            s.op_counts[f"modelled.{name}"] += 1
            s.modelled[name] = s.modelled.get(name, 0) + 1
        s.hbm_bytes += cost["bytes"]
        s.flops += cost["flops"]
        s.dot_flops += cost["dot_flops"]

    def __enter__(self):
        _k.LISTENERS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        _k.LISTENERS.remove(self._kernel)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":    # metadata: a fake tensor's device
            return out
        s = self.stats
        s.ops += 1
        s.op_counts[str(func.overloadpacket)] += 1
        packet = func.overloadpacket
        name = packet.__name__
        if func.namespace == "c10d":
            if name != "send":
                coll = _COLLECTIVES.get(name, name)
                b = sum(_nbytes(t) for t in _tensors(args[:1]))
                s.collective_bytes += b
                s.collective_counts[coll] = \
                    s.collective_counts.get(coll, 0) + 1
                s.collective_bytes_by_op[coll] = \
                    s.collective_bytes_by_op.get(coll, 0.0) + b
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            s.flops += f
            s.dot_flops += f
        elif torch.Tag.pointwise in func.tags:
            s.flops += sum(t.numel() for t in outs)
        elif torch.Tag.reduction in func.tags:
            s.flops += ins[0].numel() if ins else 0
        if _views(func):
            return out
        mutated = _mutated(func, args, kwargs)
        if mutated:
            s.hbm_bytes += _written_bytes(func, name, ins, mutated)
            return out
        held = {t.untyped_storage()._cdata for t in ins}
        fresh = [t for t in outs if t.untyped_storage()._cdata not in held]
        # an op that returns its inputs' storage without an alias
        # annotation (``_unsafe_view``) is a view too
        if fresh and name not in _NO_WRITE:
            s.hbm_bytes += (sum(_nbytes(t) for t in ins)
                            + sum(_nbytes(t) for t in outs))
        self._fresh(fresh)
        return out

    def finish(self, out) -> OpStats:
        """Record the step's output ``out``; returns :attr:`stats`."""
        self.stats.output_bytes = storage_bytes(out)
        return self.stats
