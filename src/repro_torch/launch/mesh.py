"""The mesh: named axes ``(pod?, data, model)`` over a ``torch.distributed``
world (mirrors ``repro/launch/mesh.py``).

The reference lays its GFL servers over the ``data`` (and ``pod``) axes of
a device mesh, one server a device, and XLA's collectives move the rows.
Here a rank holds a block of consecutive servers: the ``num_servers /
server_ranks`` servers that follow its own in the pod-major order
(``pod * data_size + data``, as ``steps.py`` numbers them), so one H100
holds all four servers of a ``4x1`` mesh and two gloo ranks two each.
Ranks are laid out row-major over (server block, model): rank ``r`` holds
server block ``r // model_ranks`` at model index ``r % model_ranks``.  Its
*server group* is the ranks of its model index (the combines permute rows
there), its *model group* the ranks of its server block (the
client-parallel mode's all-reduce, and tensor parallelism's collectives).

    mesh = make_test_mesh((4, 1))                # world 1: servers 0-3 here
    mesh.local_servers                           # range(0, 4)
    y = mesh.ppermute(x, [((i + 1) % 4, i) for i in range(4)])

A world of 1 needs no process group.  A larger world takes the group
``torch.distributed`` already has, or starts one from ``torchrun``'s
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``):
NCCL for ``cuda`` tensors, gloo for CPU ones, unless the caller names the
backend.  Ranks that share one card (NCCL refuses two ranks on one GPU)
ask for gloo on ``cuda`` tensors and name their card (``cuda:0``); gloo
takes CUDA tensors in ``all_reduce``, ``broadcast`` and ``all_gather``,
the collectives tensor parallelism (:mod:`repro_torch.models.parallel`)
and the dense combine run, but none in ``send`` / ``recv``: there
:meth:`Mesh.ppermute` runs as one sum ``all_reduce``, chosen by the
backend and the device.  A group whose backend is not the one asked for,
or not the device's default when none is, raises; nothing falls back to
another backend.  The dry run (:mod:`repro_torch.launch.dryrun`) asks for
``"fake"``: torch's fake c10d backend, on cuda or cpu tensors, whose
collectives move nothing (:func:`fake_world` starts its group and always
ends it); it models NCCL across cards, so a ppermute is one
``batch_isend_irecv``.
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Optional

import torch

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}
_BACKENDS = {"nccl": ("cuda",), "gloo": ("cuda", "cpu"),
             "fake": ("cuda", "cpu")}


def _dist():
    import torch.distributed as dist
    return dist


class Mesh:
    """Named axes (``axis_names``, sizes ``shape[name]``) over ranks.

    ``world`` and ``rank`` default to the running ``torch.distributed``
    group's, or to 1 and 0 without one.  ``device`` defaults to the
    rank's card (``cuda:LOCAL_RANK``), resolved when first asked for: it
    raises without a card, and never picks the CPU on its own.  The
    layout is checked when a collective or a rank's servers are first
    asked for, so a mesh of any shape can describe specs
    (:mod:`repro_torch.launch.sharding`) on a machine without a card.
    ``backend`` (``"nccl"``, ``"gloo"`` or ``"fake"``) is the process
    group's backend the caller asks for; None takes the device's default (NCCL for cuda,
    gloo for cpu)."""

    def __init__(self, shape, axis_names, *, device=None,
                 world: Optional[int] = None, rank: Optional[int] = None,
                 backend: Optional[str] = None):
        shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or axis_names[-1] != "model":
            raise ValueError(f"mesh axes {axis_names} of shape {shape}: "
                             "expected (pod?, data, model)")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self._device = None if device is None else torch.device(device)
        if backend is not None and backend not in _BACKENDS:
            raise ValueError(f"backend {backend!r}: expected one of "
                             f"{sorted(_BACKENDS)} or None")
        self.backend = backend
        dist = _dist()
        up = dist.is_available() and dist.is_initialized()
        self.world = int(world if world is not None else
                         dist.get_world_size() if up else 1)
        self.rank = int(rank if rank is not None else
                        dist.get_rank() if up else 0)
        self._layout = None

    def __repr__(self) -> str:
        dev = "cuda (default)" if self._device is None else self._device
        return (f"Mesh({self.shape}, world={self.world}, rank={self.rank}, "
                f"device={dev})")

    @property
    def device(self) -> torch.device:
        """The device the mesh's tensors live on (see the class note)."""
        if self._device is None:
            from repro_torch import resolve_device
            self._device = _device_for(resolve_device(None))
        return self._device

    # ------------------------------------------------------------ layout

    def layout(self) -> dict:
        """The rank layout: server and model ranks, this rank's block and
        its groups.  Raises when the world does not fit the mesh."""
        if self._layout is not None:
            return self._layout
        P, M, W = num_servers(self), self.shape["model"], self.world
        if W == 1:
            s_ranks, m_ranks = 1, 1
        elif W % M == 0 and P % (W // M) == 0:
            s_ranks, m_ranks = W // M, M
        else:
            raise ValueError(f"a world of {W} ranks cannot hold mesh "
                             f"{self.shape}: it needs 1 rank, or a multiple "
                             f"of the model axis ({M}) whose quotient "
                             f"divides the {P} servers")
        block, m_idx = divmod(self.rank, m_ranks)
        per = P // s_ranks
        lay = {"server_ranks": s_ranks, "model_ranks": m_ranks,
               "per_rank": per, "block": block, "model_index": m_idx,
               "servers": range(block * per, (block + 1) * per),
               "server_group": None, "model_group": None, "p2p": True,
               "server_group_ranks": [b * m_ranks + m_idx
                                      for b in range(s_ranks)],
               "model_group_ranks": [block * m_ranks + m
                                     for m in range(m_ranks)]}
        if W > 1:
            dist = _dist()
            want = _backend_for(self.device, self.backend)
            have = dist.get_backend()
            if have != want:
                raise RuntimeError(
                    f"the process group's backend is {have!r}; tensors on "
                    f"{self.device} were asked to go over {want!r} (no "
                    "other backend is taken in its place)")
            # gloo sends and receives host tensors only; NCCL, and the
            # fake backend that models it in the dry run, take any
            lay["p2p"] = not (want == "gloo" and self.device.type == "cuda")
            # every rank makes every group, in one order
            for m in range(m_ranks):
                g = dist.new_group([b * m_ranks + m for b in range(s_ranks)])
                if m == m_idx:
                    lay["server_group"] = g
            for b in range(s_ranks):
                g = dist.new_group([b * m_ranks + m for m in range(m_ranks)])
                if b == block:
                    lay["model_group"] = g
        self._layout = lay
        return lay

    @property
    def local_servers(self) -> range:
        """The global indices of the servers this rank holds."""
        return self.layout()["servers"]

    def owner(self, server: int) -> int:
        """The server-group position (server block) holding ``server``."""
        return server // self.layout()["per_rank"]

    # ------------------------------------------------------- collectives

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """The counterpart of ``jax.lax.ppermute`` over the server dim:
        ``x`` holds this rank's servers' rows [n_local, ...]; ``perm``
        lists ``(source, destination)`` global server indices.  Row
        ``dst`` of the result is row ``src`` of the input, zeros where no
        pair names it.  Rows that stay on the rank are an index copy; the
        rest go by one ``batch_isend_irecv`` (each peer's rows as one
        message, ordered by destination), or, where the backend has no
        point-to-point op for the device (gloo on cuda), by one sum
        ``all_reduce`` over the server group (:meth:`_ppermute_reduce`)."""
        lay = self.layout()
        if not lay["p2p"] and any(self.owner(s) != self.owner(d)
                                  for s, d in perm):
            return self._ppermute_reduce(x, perm)
        return self._ppermute_p2p(x, perm)

    def _ppermute_p2p(self, x: torch.Tensor, perm) -> torch.Tensor:
        lay = self.layout()
        lo = lay["servers"].start
        me = lay["block"]
        local_src, local_dst = [], []
        sends: dict = {}
        recvs: dict = {}
        for src, dst in sorted(perm, key=lambda sd: sd[1]):
            so, do = self.owner(src), self.owner(dst)
            if so == me and do == me:
                local_src.append(src - lo)
                local_dst.append(dst - lo)
            elif so == me:
                sends.setdefault(do, []).append(src - lo)
            elif do == me:
                recvs.setdefault(so, []).append(dst - lo)
        idx = torch.tensor(local_src, dtype=torch.int64, device=x.device)
        if not sends and not recvs and local_dst == list(range(len(x))):
            return x.index_select(0, idx)     # a whole local permutation
        out = torch.zeros_like(x)
        if local_src:
            out[torch.tensor(local_dst, device=x.device)] = \
                x.index_select(0, idx)
        if not sends and not recvs:
            return out
        dist = _dist()
        ranks = lay["server_group_ranks"]
        ops, bufs = [], []
        for peer, rows in sorted(sends.items()):
            buf = x[rows].contiguous()
            ops.append(dist.P2POp(dist.isend, buf, ranks[peer],
                                  lay["server_group"]))
        for peer, rows in sorted(recvs.items()):
            buf = torch.empty((len(rows),) + tuple(x.shape[1:]),
                              dtype=x.dtype, device=x.device)
            bufs.append((rows, buf))
            ops.append(dist.P2POp(dist.irecv, buf, ranks[peer],
                                  lay["server_group"]))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for rows, buf in bufs:
            out[rows] = buf
        return out

    def _ppermute_reduce(self, x: torch.Tensor, perm) -> torch.Tensor:
        """:meth:`ppermute` as one sum ``all_reduce`` over the server
        group: each rank writes its rows into a zeroed [P, ...] buffer
        (exact: each row has one writer), and reads the rows its
        destinations name.  Every rank of the group takes part."""
        lay = self.layout()
        lo, hi = lay["servers"].start, lay["servers"].stop
        buf = x.new_zeros((num_servers(self),) + tuple(x.shape[1:]))
        buf[lo:hi] = x
        _dist().all_reduce(buf, group=lay["server_group"])
        pairs = sorted((d - lo, s) for s, d in perm if lo <= d < hi)
        out = torch.zeros_like(x)
        if pairs:
            dst, src = zip(*pairs)
            out[torch.tensor(dst, device=x.device)] = buf.index_select(
                0, torch.tensor(src, device=x.device))
        return out

    def all_gather_servers(self, x: torch.Tensor) -> torch.Tensor:
        """The server group's rows in server order, from each rank's
        [n_local, ...] (equal shapes): [P, ...] of a server tree's leaf."""
        lay = self.layout()
        if lay["server_ranks"] == 1:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(lay["server_ranks"])]
        _dist().all_gather(parts, x, group=lay["server_group"])
        return torch.cat(parts)

    def all_reduce_model(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the model group (in place)."""
        lay = self.layout()
        if lay["model_ranks"] > 1:
            _dist().all_reduce(x, group=lay["model_group"])
        return x


def _backend_for(device: torch.device, backend: Optional[str]) -> str:
    """The backend asked for, checked against the device, or the device's
    default."""
    if backend is None:
        if device.type not in _BACKEND:
            raise RuntimeError(f"no process-group backend for {device}")
        return _BACKEND[device.type]
    if device.type not in _BACKENDS.get(backend, ()):
        raise ValueError(f"backend {backend!r} does not take tensors on "
                         f"{device}")
    return backend


def _device_for(device) -> torch.device:
    """The rank's device: ``cuda:LOCAL_RANK`` for cuda, else as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """A ``world``-rank process group over torch's ``"fake"`` backend, this
    process as rank ``rank``: every collective returns at once and moves
    nothing (the dry run, :mod:`repro_torch.launch.dryrun`, traces one
    rank of a production mesh this way).  The group is destroyed on exit,
    also when the block raises, so no later :class:`Mesh` sees its world.
    """
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist = _dist()
    if dist.is_initialized():
        raise RuntimeError("a process group is already up: the fake world "
                           "would replace its world")
    dist.init_process_group("fake", store=FakeStore(), rank=int(rank),
                            world_size=int(world))
    try:
        yield
    finally:
        dist.destroy_process_group()


def init_world(device=None, dist_backend: Optional[str] = None
               ) -> torch.device:
    """Join ``torchrun``'s world when its environment names one of more
    than one rank (``dist_backend``, or NCCL for ``cuda`` and gloo for
    ``cpu``); returns the rank's device (``cuda:LOCAL_RANK`` unless the
    device names its card, as ranks sharing one card do).  A world of 1
    starts nothing."""
    from repro_torch import resolve_device
    dev = _device_for(resolve_device(device))
    backend = _backend_for(dev, dist_backend)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    dist = _dist()
    if world > 1 and not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method="env://")
    return dev


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         dist_backend: Optional[str] = None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device=device, backend=dist_backend)


def make_test_mesh(shape=(2, 4), axes=("data", "model"), *,
                   device=None, dist_backend: Optional[str] = None) -> Mesh:
    """A small mesh for CPU runs and tests."""
    return Mesh(shape, axes, device=device, backend=dist_backend)


def parse_mesh(spec: str, device=None,
               dist_backend: Optional[str] = None) -> Mesh:
    """``DxM`` or ``PODxDxM``: a test mesh of those axes."""
    dims = tuple(int(x) for x in spec.split("x"))
    axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    return make_test_mesh(dims, axes, device=device,
                          dist_backend=dist_backend)


def mesh_from_arg(spec: str, device=None,
                  dist_backend: Optional[str] = None) -> Mesh:
    """A ``--mesh`` argument: ``production``, ``production-multipod`` or
    a :func:`parse_mesh` spec."""
    if spec in ("production", "production-multipod"):
        return make_production_mesh(multi_pod=spec.endswith("multipod"),
                                    device=device, dist_backend=dist_backend)
    return parse_mesh(spec, device, dist_backend)


def server_axes(mesh: Mesh) -> tuple:
    """Mesh axes that carry the GFL server dimension."""
    return tuple(a for a in mesh.axis_names if a != "model")


def num_servers(mesh: Mesh) -> int:
    return math.prod(mesh.shape[a] for a in server_axes(mesh))
