"""Client populations: any client's shard from (data_seed, server, client)
— port of ``repro.core.population.population``.

A :class:`ClientPopulation` makes K a *virtual* quantity: ``gather``
materializes exactly the sampled cohort ``[P, L, B, M]``, so memory and
compute scale with the cohort, not with the population ``[P, K]`` (the
partial-participation regime of arXiv:2203.07105).  Three families:

``DensePopulation``
    materialized ``[P, K, N, M]`` tensors (the Section-V problem), the
    regression anchor of the engine.
``SyntheticPopulation``
    the Section-V generative model, evaluated per client on demand.  The
    reference draws a shard through threefry ``fold_in`` chains, which
    torch cannot reproduce; here every value is a pure function of
    ``(data_seed, p, k, n, m)`` through the port's uint32 counter hash
    (``kernels.secure_agg.hash_u32``, the Murmur3 finalizer that K4
    mirrors), so the same clients give the same bits on the CPU and the
    card whatever the cohort around them.  The floats made from those bits
    (Box-Muller's log and cos) may differ by an ulp between the two.
``DirichletPopulation``
    label skew over a finite pool through
    :func:`repro_torch.data.partition.dirichlet_partition` (numpy, the
    reference's split index for index): the pool is held once and only a
    ``[P, K, N]`` index tensor is built.

Specs are the reference's strings (``GFLConfig.population``)::

    dense
    synthetic:iid,sigma=1.0
    synthetic:hetero,lo=0.5,hi=1.5
    synthetic:mixture,clusters=4,drift=0.5
    dirichlet:0.3,pool=4000
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.secure_agg import MASK32, hash_u32

_KINDS = ("dense", "synthetic", "iid", "hetero", "mixture", "dirichlet")


@dataclass(frozen=True)
class PopulationSpec:
    """Parsed ``GFLConfig.population`` string."""
    kind: str                      # dense | iid | hetero | mixture | dirichlet
    args: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown population kind {self.kind!r}; "
                             f"expected one of {_KINDS}")


# keys each population kind accepts (shared: n, dim, rho); misspelled keys
# are rejected rather than silently falling back to defaults
_ALLOWED_KEYS = {
    "dense": frozenset(),
    "iid": frozenset({"sigma", "n", "dim", "rho"}),
    "hetero": frozenset({"lo", "hi", "n", "dim", "rho"}),
    "mixture": frozenset({"clusters", "drift", "sigma", "n", "dim", "rho"}),
    "dirichlet": frozenset({"alpha", "pool", "sigma", "n", "dim", "rho"}),
}


def parse_population_spec(spec: str) -> PopulationSpec:
    """Parse a ``GFLConfig.population`` string.

    Form: ``name[:variant][,key=value]*`` — ``synthetic:<variant>`` selects
    the heterogeneity model, ``dirichlet:<alpha>`` passes alpha positionally.
    """
    spec = (spec or "dense").strip()
    head, _, rest = spec.partition(",")
    name, _, variant = head.partition(":")
    args: dict = {}
    if rest:
        for part in rest.split(","):
            k, sep, v = part.partition("=")
            if not sep:
                raise ValueError(
                    f"bad population argument {part!r} in spec {spec!r}; "
                    "expected key=value")
            try:
                args[k.strip()] = float(v) if "." in v or "e" in v.lower() \
                    else int(v)
            except ValueError:
                raise ValueError(
                    f"bad population argument value {v!r} in {spec!r}"
                ) from None
    if name == "dense":
        if variant:
            raise ValueError(f"dense population takes no variant: {spec!r}")
        kind = "dense"
    elif name == "synthetic":
        kind = variant or "hetero"
        if kind not in ("iid", "hetero", "mixture"):
            raise ValueError(
                f"unknown synthetic variant {variant!r} in {spec!r}; "
                "expected iid | hetero | mixture")
    elif name == "dirichlet":
        kind = "dirichlet"
        if variant:
            args["alpha"] = float(variant)
    else:
        raise ValueError(f"unknown population spec {spec!r}; expected "
                         "dense | synthetic:<variant> | dirichlet:<alpha>")
    unknown = set(args) - _ALLOWED_KEYS[kind]
    if unknown:
        raise ValueError(
            f"unknown argument(s) {sorted(unknown)} for population kind "
            f"{kind!r} in {spec!r}; allowed: "
            f"{sorted(_ALLOWED_KEYS[kind])}")
    return PopulationSpec(kind, args)


def _fmt_arg(v) -> str:
    # repr keeps the "." / "e" marker the parser uses to pick float vs int
    return repr(v) if isinstance(v, float) else str(v)


def population_to_spec(spec: PopulationSpec) -> str:
    """Inverse of :func:`parse_population_spec` (canonical form)."""
    args = dict(spec.args)
    if spec.kind == "dense":
        head = "dense"
    elif spec.kind == "dirichlet":
        # the positional slot re-parses as float, so an int alpha stays a
        # keyword to keep its type
        if isinstance(args.get("alpha"), float):
            head = f"dirichlet:{_fmt_arg(args.pop('alpha'))}"
        else:
            head = "dirichlet"
    else:
        head = f"synthetic:{spec.kind}"
    tail = ",".join(f"{k}={_fmt_arg(v)}" for k, v in sorted(args.items()))
    return head + ("," + tail if tail else "")


class ClientPopulation:
    """A virtual fleet of P x K clients with deterministic shard access.

    ``gather`` materializes exactly the requested cohort ``[P, L, B, M]``
    from tensor ops only, so it runs inside a captured round graph.
    ``w_ref`` is a reference minimizer for MSD traces (exact for dense
    populations; for lazy ones ``engine.estimate_w_ref`` estimates one)."""

    P: int
    num_clients: int
    samples_per_client: int
    dim: int
    rho: float = 0.01
    w_ref: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    def gather(self, client_idx: torch.Tensor, batch_idx: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """client_idx [P, L] in [0, K); batch_idx [P, L, B] in [0, N) ->
        (h [P, L, B, M], gamma [P, L, B])."""
        raise NotImplementedError

    def client_shard(self, p: int, k: int) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
        """One client's full shard (h [N, M], gamma [N])."""
        N = self.samples_per_client
        cid = torch.full((self.P, 1), int(k), dtype=torch.int64,
                         device=self.device)
        bidx = torch.arange(N, device=self.device).expand(self.P, 1, N)
        h, g = self.gather(cid, bidx)
        return h[p, 0], g[p, 0]


class DensePopulation(ClientPopulation):
    """Materialized arrays as a population; ``gather`` is the reference's
    fancy indexing, index for index."""

    def __init__(self, features: torch.Tensor, labels: torch.Tensor,
                 rho: float = 0.01, w_ref: Optional[torch.Tensor] = None):
        P, K, N, M = features.shape
        self.features = features
        self.labels = labels
        self.P, self.num_clients = P, K
        self.samples_per_client, self.dim = N, M
        self.rho = rho
        self.w_ref = w_ref

    @classmethod
    def from_problem(cls, prob) -> "DensePopulation":
        """Wrap a :class:`repro_torch.core.simulate.LogisticProblem`."""
        return cls(prob.features, prob.labels, rho=prob.rho,
                   w_ref=prob.w_opt)

    @property
    def device(self) -> torch.device:
        return self.features.device

    def gather(self, client_idx, batch_idx):
        p_idx = torch.arange(self.P, device=client_idx.device)[:, None, None]
        h = self.features[p_idx, client_idx[:, :, None], batch_idx]
        g = self.labels[p_idx, client_idx[:, :, None], batch_idx]
        return h, g


# the counter hash's streams.  A value's key is a chain of hashes from the
# data seed: (clients, p, k) for a client, then (sigma) for its scale or
# (samples, n) for a sample, then (label) or (noise, m); a cluster mean's
# is (clusters, cluster, m).  Each level's labels differ, so no two values
# share a key.
_CLIENTS, _CLUSTERS = 1, 2        # under the seed
_SIGMA, _SAMPLES = 1, 2           # under a client
_LABEL, _NOISE = 1, 2             # under a sample
_GOLDEN = 0x9E3779B9
_U24 = 1.0 / (1 << 24)


def _hash_int(x: int) -> int:
    """:func:`hash_u32` on a Python int (the chain's constant levels, so
    a captured round graph copies no host value to the device)."""
    x &= MASK32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & MASK32
    x ^= x >> 15
    x = (x * 0x846CA68B) & MASK32
    return x ^ (x >> 16)


def _mix(key, x):
    """The key one level down the chain: hash(key ^ hash(x + golden)); an
    int where both are ints, else an int64 tensor."""
    if isinstance(x, int):
        hx = _hash_int(x + _GOLDEN)
    else:
        hx = hash_u32((x + _GOLDEN) & MASK32)
    if isinstance(key, int) and isinstance(hx, int):
        return _hash_int(key ^ hx)
    return hash_u32(key ^ hx)


def _uniform(h: torch.Tensor) -> torch.Tensor:
    """[0, 1) from a hash's top 24 bits (float64)."""
    return (h >> 8).to(torch.float64) * _U24


def _normal(key: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Standard normal of coordinates ``m`` (int64) under ``key``
    (float64): Box-Muller on the pair j = m // 2, cos for even m and sin
    for odd."""
    j = m // 2
    u1 = ((_mix(key, 2 * j) >> 8) + 1).to(torch.float64) * _U24  # (0, 1]
    u2 = _uniform(_mix(key, 2 * j + 1))
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = (2.0 * math.pi) * u2
    return r * torch.where(m % 2 == 0, torch.cos(theta), torch.sin(theta))


class SyntheticPopulation(ClientPopulation):
    """Section-V generative model, lazily per client.

    Client ``(p, k)``'s shard is a pure function of ``(data_seed, p, k)``:
    labels gamma = +-1 Bernoulli(1/2), features h | gamma ~ N(gamma * m_k,
    sigma_k^2 I).  The mode picks (m_k, sigma_k):

    ``iid``      m_k = 1-vector, sigma_k = sigma;
    ``hetero``   m_k = 1-vector, sigma_k ~ U[lo, hi] per client (the
                 paper's Section-V heterogeneity);
    ``mixture``  client k belongs to cluster ``k mod clusters``, whose class
                 mean is the 1-vector plus a drift-scaled Gaussian offset;
                 sigma_k = sigma.

    ``gather`` hashes only the ``[P, L, B, M]`` values it returns: no
    ``[P, K, ...]`` tensor, nor a client's whole ``[N, M]`` shard, is made.
    """

    def __init__(self, P: int, K: int, *, mode: str = "hetero",
                 N: int = 100, M: int = 2, data_seed: int = 0,
                 sigma: float = 1.0, lo: float = 0.5, hi: float = 1.5,
                 clusters: int = 4, drift: float = 0.5, rho: float = 0.01,
                 device=None):
        if mode not in ("iid", "hetero", "mixture"):
            raise ValueError(f"unknown synthetic mode {mode!r}")
        self.P, self.num_clients = P, K
        self.samples_per_client, self.dim = N, M
        self.mode, self.data_seed = mode, data_seed
        self.sigma, self.lo, self.hi = sigma, lo, hi
        self.clusters, self.drift = max(int(clusters), 1), drift
        self.rho = rho
        self.w_ref = None
        self._device = resolve_device(device)

    @property
    def device(self) -> torch.device:
        return self._device

    def _root(self, stream: int) -> int:
        return _mix(_hash_int(int(self.data_seed)), stream)

    def _client_key(self, client_idx: torch.Tensor) -> torch.Tensor:
        """[P, L] keys of the clients ``client_idx`` [P, L]."""
        p_ids = torch.arange(client_idx.shape[0],
                             device=client_idx.device)[:, None]
        return _mix(_mix(self._root(_CLIENTS), p_ids), client_idx)

    def _client_mean(self, k: torch.Tensor) -> torch.Tensor:
        """Class-conditional mean m_k [..., M] (float64) for client ids k."""
        ms = torch.arange(self.dim, device=k.device)
        if self.mode != "mixture":
            return torch.ones(k.shape + (self.dim,), dtype=torch.float64,
                              device=k.device)
        ckey = _mix(self._root(_CLUSTERS), k % self.clusters)
        return 1.0 + self.drift * _normal(ckey[..., None], ms)

    def _client_sigma(self, key_pk: torch.Tensor) -> torch.Tensor:
        if self.mode == "hetero":
            u = _uniform(_mix(key_pk, _SIGMA))
            return self.lo + (self.hi - self.lo) * u
        return torch.full(key_pk.shape, float(self.sigma),
                          dtype=torch.float64, device=key_pk.device)

    def gather(self, client_idx, batch_idx):
        dev = client_idx.device
        key_pk = self._client_key(client_idx)                    # [P, L]
        key_pkn = _mix(_mix(key_pk, _SAMPLES)[..., None], batch_idx)
        gamma = torch.where((_mix(key_pkn, _LABEL) >> 31) == 1, 1.0, -1.0)
        noise = _normal(_mix(key_pkn, _NOISE)[..., None],
                        torch.arange(self.dim, device=dev))     # [P,L,B,M]
        sigma = self._client_sigma(key_pk)[..., None, None]
        mean = self._client_mean(client_idx)[:, :, None, :]
        h = gamma[..., None].to(torch.float64) * mean + sigma * noise
        return h.to(torch.float32), gamma.to(torch.float32)


class DirichletPopulation(ClientPopulation):
    """Label-skew shards over a finite pool via ``dirichlet_partition``.

    The pool ([n, M] features, [n] +-1 labels) is held once; each client
    owns an index list from the Dirichlet split, cycled out to a fixed
    length N so the gather stays rectangular.  The extra memory is the
    [P, K, N] index tensor (int64), for materialized datasets at modest K
    (for virtual-K scale use a synthetic population)."""

    def __init__(self, features: torch.Tensor, labels: torch.Tensor, P: int,
                 K: int, *, alpha: float = 0.5, N: int = 0,
                 data_seed: int = 0, rho: float = 0.01):
        from repro_torch.data.partition import dirichlet_partition

        shards = dirichlet_partition(labels.cpu().numpy(), P, K, alpha=alpha,
                                     seed=data_seed, min_per_client=1)
        n_max = max(len(shards[p][k]) for p in range(P) for k in range(K))
        N = int(N) or n_max
        idx = np.zeros((P, K, N), np.int64)
        for p in range(P):
            for k in range(K):
                # cycled out to length N: every index of the shard appears
                # at least once when N >= its length
                idx[p, k] = np.resize(shards[p][k], N)
        self._hold(features, labels, torch.from_numpy(idx).to(
            features.device), alpha, rho)

    @classmethod
    def from_index(cls, features: torch.Tensor, labels: torch.Tensor,
                   index: torch.Tensor, *, alpha: float = 0.5,
                   rho: float = 0.01) -> "DirichletPopulation":
        """A population on a pool and an index table [P, K, N] made
        elsewhere (the reference's, carried across), with no new split."""
        pop = cls.__new__(cls)
        pop._hold(features, labels, index, alpha, rho)
        return pop

    def _hold(self, features, labels, index, alpha, rho) -> None:
        self.pool_h, self.pool_g, self.index = features, labels, index
        self.P, self.num_clients, self.samples_per_client = index.shape
        self.dim = int(features.shape[-1])
        self.alpha, self.rho = alpha, rho
        self.w_ref = None

    @classmethod
    def synthetic_pool(cls, P: int, K: int, *, alpha: float = 0.5,
                       pool: int = 0, M: int = 2, sigma: float = 1.0,
                       N: int = 0, data_seed: int = 0, rho: float = 0.01,
                       device=None) -> "DirichletPopulation":
        """Section-V-style pool (gamma = +-1, h ~ N(gamma*1, sigma^2 I)) of
        ``pool`` samples from a Generator seeded with ``data_seed``,
        Dirichlet-split across the P x K clients."""
        dev = resolve_device(device)
        n = int(pool) or P * K * 20
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(data_seed))
        g = torch.where(torch.rand((n,), generator=gen, device=dev) < 0.5,
                        1.0, -1.0)
        h = g[:, None] + sigma * torch.randn((n, M), generator=gen,
                                             device=dev)
        return cls(h, g, P, K, alpha=alpha, N=N, data_seed=data_seed,
                   rho=rho)

    @property
    def device(self) -> torch.device:
        return self.pool_h.device

    def gather(self, client_idx, batch_idx):
        p_idx = torch.arange(self.P, device=client_idx.device)[:, None, None]
        sample_idx = self.index[p_idx, client_idx[:, :, None], batch_idx]
        return self.pool_h[sample_idx], self.pool_g[sample_idx]


def population_from_spec(cfg, *, P: Optional[int] = None,
                         K: Optional[int] = None,
                         device=None) -> ClientPopulation:
    """Build the population named by ``cfg.population`` on ``device``.

    ``dense`` has no generator: callers hold the materialized problem and
    wrap it with :meth:`DensePopulation.from_problem`."""
    spec = parse_population_spec(cfg.population)
    P = P or cfg.num_servers
    K = K or cfg.clients_per_server
    a = spec.args
    if spec.kind == "dense":
        raise ValueError(
            "population='dense' wraps a materialized problem — pass the "
            "problem to the engine (DensePopulation.from_problem) instead "
            "of building it from the spec")
    if spec.kind in ("iid", "hetero", "mixture"):
        return SyntheticPopulation(
            P, K, mode=spec.kind,
            N=int(a.get("n", 100)), M=int(a.get("dim", 2)),
            data_seed=cfg.data_seed,
            sigma=float(a.get("sigma", 1.0)),
            lo=float(a.get("lo", 0.5)), hi=float(a.get("hi", 1.5)),
            clusters=int(a.get("clusters", 4)),
            drift=float(a.get("drift", 0.5)),
            rho=float(a.get("rho", 0.01)), device=device)
    return DirichletPopulation.synthetic_pool(
        P, K, alpha=float(a.get("alpha", 0.5)),
        pool=int(a.get("pool", 0)), M=int(a.get("dim", 2)),
        sigma=float(a.get("sigma", 1.0)), N=int(a.get("n", 0)),
        data_seed=cfg.data_seed, rho=float(a.get("rho", 0.01)),
        device=device)
