"""Training under tensor parallelism, on the CPU: gloo ranks spawned with
``torch.multiprocessing`` (two spawns, both started once for the module
and run beside this process's world-1 runs: world 2 and world 4; one
intra-op thread a rank, each spawn joined within its own timeout; one
``xdist_group``).

- **Gradients.**  Every ``tests/test_torch_tp.py::CASES`` entry at M = 2
  (mesh 1x2) and M = 4 (1x4): each rank's gradient of ``Model.loss``
  (``launch.steps.client_grads``, the train step's) against its block of
  the world-1 gradient within 1e-5 of the leaf's largest (a zero head's
  block exactly 0), the vocab-parallel loss within 1e-6 of the world-1
  loss.  That covers the router and MLA's whole leaves, shared K/V heads
  (smollm at M = 4), padding heads (the 3-head cases, RWKV-6's among
  them), the norms, Mamba2's gathered B and C and its gated norm's sum,
  RWKV-6's decay and whisper's cross K/V, with every bias and norm scale
  nonzero (``test_torch_tp.with_biases``).
  RWKV-6's cases run with f64 params: its recurrence runs in f32 whatever
  they are, and with f32 params the whole model's ``u`` gradient is
  itself about 4e-5 of its largest value from an f64 run's.
- **Leaves read in part.**  Before the train step's sum, a rank's
  gradient differs from its block of the whole exactly on the leaves of
  ``sharding.READ_IN_PART`` (zamba2, rwkv6, whisper at M = 2 and 4).
- **Train steps.**  ``2x2`` (world 4) against the port's own ``2x1``
  world-1 step, the same seed and draws, three chained steps, every leaf
  unsharded (``sharding.unshard_leaf``) within 1e-5 after each step, the
  loss too, with a clip bound every gradient exceeds: dense with
  kernels off and on (K3's plain version here),
  rotate and sparse, each under none, hybrid and iid_dp, on smollm with 3
  heads (a zero padding head on the second rank); then cohort weights,
  client dropout, the telemetry tap's norms, a K/V head shared by both
  ranks (1 K/V head), and rotate through the all_reduce form of
  ``Mesh.ppermute`` (bitwise the point-to-point run); then dense through
  K3 under hybrid for each other split family: llava (vlm), mixtral (MoE,
  the ff split), deepseek-v2-lite (MLA, MoE), minicpm3 (MLA with a
  compressed query), zamba2 (Mamba2 and the shared block) and RWKV-6
  with 3 heads (a zero head on the second rank).  Padding heads stay
  exactly zero, and leaves the ranks of a server replicate stay bitwise
  equal.
- **ppermute.**  The all_reduce form bitwise the point-to-point form for
  the rotate and sparse permutations of P = 2 and P = 4 (meshes 2x1, 4x1
  and the pod mesh 2x2x1 in world 2, 2x2 in world 4).
- **Checkpoint.**  ``launch.train --mesh 2x2 --backend gloo``'s consensus
  checkpoint holds whole leaves: the ``2x1`` run's keys and shapes, its
  values within 1e-5.

``spawn_ranks`` is the spawn helper; ``tests/test_torch_mesh_steps.py``
uses it for its ``2x2`` oracle cases.
"""
import dataclasses
import os
import socket
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import rng
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs.base import GFLConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.synthetic import TokenStream, federated_token_batches
from repro_torch.launch import sharding, steps, train
from repro_torch.launch.mesh import make_test_mesh, num_servers
from repro_torch.models.flat import FlatView
from repro_torch.models.model import Model
from repro_torch.models.parallel import ModelGroup
from repro_torch.telemetry import session
from test_torch_tp import CASES, port_config, stub_inputs, with_biases

pytestmark = pytest.mark.xdist_group("tp_train")

JOIN_TIMEOUT_S = 300
SEED = 3
B, S = 2, 16                       # a gradient case's batch
L, PER_CLIENT, SEQ, STEPS = 2, 2, 16, 3
SIGMA, MU = 0.01, 0.1
BOUND = 1.0          # under the clients' gradient norms: every step clips
ATOL_GRAD, ATOL_LOSS, ATOL_STEP = 1e-5, 1e-6, 1e-5
WEIGHTS = [[2.0, 0.5], [1.5, 1.0]]
# the gradient cases run with f64 params (the module note)
GRAD_F64 = ("rwkv6", "rwkv6-3heads")
# the cases whose leaves read in part are checked, and those leaves
PART_LEAVES = {"zamba2": {f"blocks/ssm/{k}" for k in (
                   "conv_w", "conv_b", "dt_bias", "A_log", "D",
                   "norm_scale")},
               "rwkv6": {"blocks/att/u", "blocks/att/ln_scale"},
               "rwkv6-3heads": {"blocks/att/u", "blocks/att/ln_scale"},
               "whisper": set()}
PART_CASES = tuple(PART_LEAVES)
# smollm with 3 heads (padded at M = 2), and with one K/V head (shared)
TRAIN_ARCHS = {"3heads": {"num_heads": 3, "num_kv_heads": 3,
                          "head_dim": 64},
               "shared": {"num_heads": 4, "num_kv_heads": 1,
                          "head_dim": 64}}


def _run(name, combine, privacy, arch="3heads", kernels=False, run="static",
         fault="none"):
    return dict(name=name, combine=combine, privacy=privacy, arch=arch,
                kernels=kernels, run=run, fault=fault)


RUNS = ([_run(f"{c}{'_k' if k else ''}-{p}", c, p, kernels=k)
         for c, k in (("dense", False), ("dense", True), ("rotate", False),
                      ("sparse", False))
         for p in ("none", "hybrid", "iid_dp")]
        + [_run("dense_k-hybrid-weights", "dense", "hybrid", kernels=True,
                run="weights"),
           _run("rotate-iid_dp-alive", "rotate", "iid_dp", run="alive",
                fault="dropout:0.3"),
           _run("dense-hybrid-telemetry", "dense", "hybrid",
                run="telemetry"),
           _run("sparse-hybrid-shared", "sparse", "hybrid", arch="shared"),
           _run("rotate-hybrid-reduce", "rotate", "hybrid", run="reduce")]
        + [_run(f"{name}-dense_k-hybrid", "dense", "hybrid", arch=name,
                kernels=True)
           for name in ("llava", "mixtral", "deepseek", "minicpm3",
                        "zamba2", "rwkv6-3heads")])
# the train runs whose model has zero heads at M = 2
PADDED_ARCHS = ("3heads", "rwkv6-3heads")
PERM_MESHES = {2: [((2, 1), ("data", "model")), ((4, 1), ("data", "model")),
                   ((2, 2, 1), ("pod", "data", "model"))],
               4: [((2, 2), ("data", "model"))]}
CKPT_ARGS = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
             "--steps", "2", "--seq", str(SEQ), "--privacy", "hybrid",
             "--combine", "dense"]


# ------------------------------------------------------------- spawning


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, out_dir, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=JOIN_TIMEOUT_S))
    try:
        torch.save(fn(rank, world, *args), Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


class spawn_ranks:
    """``fn(rank, world, *args)`` on ``world`` gloo CPU ranks, started
    now; :meth:`results` joins them (within JOIN_TIMEOUT_S of the start)
    and returns each rank's return value.  The ranks inherit one OpenMP
    thread each.  ``fn`` is a module-level function (spawn pickles it by
    name)."""

    def __init__(self, fn, world, out_dir, *args):
        self.world, self.dir = world, Path(out_dir)
        omp = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = "1"
        try:
            self.ctx = mp.start_processes(
                _rank_main, args=(world, _free_port(), str(out_dir), fn,
                                  args),
                nprocs=world, join=False, start_method="spawn")
        finally:
            if omp is None:
                del os.environ["OMP_NUM_THREADS"]
            else:
                os.environ["OMP_NUM_THREADS"] = omp
        self.deadline = time.monotonic() + JOIN_TIMEOUT_S
        self.out = None

    def results(self) -> list:
        if self.out is None:
            try:
                while not self.ctx.join(timeout=1):
                    if time.monotonic() > self.deadline:
                        raise TimeoutError(f"{self.world} ranks did not "
                                           f"finish in {JOIN_TIMEOUT_S} s")
            finally:
                for p in self.ctx.processes:
                    if p.is_alive():
                        p.kill()
            self.out = [torch.load(self.dir / f"rank{r}.pt",
                                   weights_only=False)
                        for r in range(self.world)]
        return self.out


# ------------------------------------------------------------ the cases


def grad_batch(cfg) -> dict:
    """A gradient case's batch, from numpy's seeded generator."""
    r = np.random.default_rng(S)
    toks = r.integers(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": torch.tensor(toks[:, :-1]),
             "labels": torch.tensor(toks[:, 1:])}
    batch.update({k: torch.tensor(v)
                  for k, v in stub_inputs(cfg, r, (B,)).items()})
    return batch


def grad_model(name, group):
    """A gradient case's model (its biases nonzero), whole or split."""
    cfg = port_config(name)
    if name in GRAD_F64:
        cfg = dataclasses.replace(cfg, param_dtype="float64")
    return with_biases(Model.init(cfg, rng(SEED, "cpu"), group=group))


def grads_of(name, group):
    """(loss, {key: gradient}) of the case's whole model (group None) or
    of the rank's split one, the train step's gradient function."""
    model = grad_model(name, group)
    loss, grads = steps.client_grads(model, FlatView(model).tree(model),
                                     grad_batch(model.cfg))
    return float(loss), grads


def raw_grads_of(name, group) -> dict:
    """The rank's gradients of the case before the train step's sums
    over its group."""
    model = grad_model(name, group)
    view = FlatView(model)
    return view.tree_grad(model, view.tree(model), lambda: model.loss(
        **grad_batch(model.cfg))[0])[1]


def train_config(arch):
    """A train run's config: smollm's variants, or a gradient case's."""
    if arch in CASES:
        return port_config(arch)
    return dataclasses.replace(get_config("smollm-135m").reduced(),
                               **TRAIN_ARCHS[arch])


def run_train(run, mesh) -> list:
    """Three chained steps of ``run`` on this rank's servers (and blocks):
    after each, (params, loss, the telemetry norms or None)."""
    cfg = train_config(run["arch"])
    model = with_biases(Model.init(cfg, rng(0, "cpu"),
                                   group=ModelGroup.of(mesh)))
    gfl = GFLConfig(topology="ring", privacy=run["privacy"], sigma_g=SIGMA,
                    mu=MU, grad_bound=BOUND, combine_impl=run["combine"],
                    use_kernels=run["kernels"], fault=run["fault"])
    step = steps.make_train_step(model, gfl, mesh, clients=L)
    state = steps.init_train_state(model, gfl, mesh, 0)
    proc = (steps.make_topology_process(mesh, gfl)
            if run["fault"] != "none" else None)
    stream = TokenStream(vocab=cfg.vocab_size, seed=0)
    P = num_servers(mesh)
    out = []
    for i in range(STEPS):
        batch = federated_token_batches(stream, 0, i, P, L, PER_CLIENT, SEQ)
        batch.update({k: torch.tensor(v) for k, v in stub_inputs(
            cfg, np.random.default_rng(i), (P, L, PER_CLIENT)).items()})
        alive = proc.client_alive(i, L) if run["run"] == "alive" else None
        w = np.asarray(WEIGHTS, np.float32) if run["run"] == "weights" \
            else None
        with session("memory") if run["run"] == "telemetry" \
                else _nothing():
            state, m = step(state, batch, None, alive, cohort_weights=w)
        norms = ([float(m["update_norm"]), float(m["param_norm"])]
                 if run["run"] == "telemetry" else None)
        out.append((state.params, float(m["loss"]), norms))
    return out


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def perm_cases(P, axes):
    """The rotate and sparse permutations of a mesh's P servers."""
    perms = {"ring+1": steps._ring(P, 1), "ring-1": steps._ring(P, -1)}
    if axes[0] == "pod":        # the sparse combine's data and pod rings
        perms["data_rings"] = [pair for b in (0, 2)
                               for pair in steps._ring(2, 1, b, 1)]
        perms["pod_ring"] = [pair for b in (0, 1)
                             for pair in steps._ring(2, 1, b, 2)]
    return perms


def ppermute_forms(rank, world):
    """Per (mesh, permutation): the point-to-point form's rows and the
    all_reduce form's, on this rank."""
    out = {}
    for shape, axes in PERM_MESHES[world]:
        mesh = make_test_mesh(shape, axes, device="cpu", dist_backend="gloo")
        n = len(mesh.local_servers)
        x = (torch.arange(n * 15, dtype=torch.float32).reshape(n, 3, 5)
             + 100.0 * mesh.local_servers.start + 0.25 * rank)
        for tag, perm in perm_cases(num_servers(mesh), axes).items():
            out[(shape, tag)] = (mesh._ppermute_p2p(x, perm),
                                 mesh._ppermute_reduce(x, perm))
    return out


def rank_work(rank, world, ckpt_dir):
    """A rank's share of the module's checks (see the module note)."""
    M = 2 if world == 2 else 4
    mesh = make_test_mesh((1, M), device="cpu", dist_backend="gloo")
    group = ModelGroup.of(mesh)
    out = {"group": (group.size, group.index),
           "grads": {name: grads_of(name, group) for name in CASES},
           "raw": {name: raw_grads_of(name, group) for name in PART_CASES},
           "perm": ppermute_forms(rank, world)}
    if world == 4:
        mesh = make_test_mesh((2, 2), device="cpu", dist_backend="gloo")
        out["servers"] = list(mesh.local_servers)
        for run in RUNS:
            if run["run"] == "reduce":
                mesh.layout()["p2p"] = False
            out[run["name"]] = run_train(run, mesh)
            mesh.layout()["p2p"] = True
        train.main(CKPT_ARGS + ["--mesh", "2x2", "--backend", "gloo",
                                "--checkpoint", str(Path(ckpt_dir) / "2x2")])
    return out


# ------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both spawns' results, the spawns started together, joined on first
    use."""
    torch.set_num_threads(1)
    ckpt = tmp_path_factory.mktemp("tp_ckpt")
    spawns = {w: spawn_ranks(rank_work, w, tmp_path_factory.mktemp(f"w{w}"),
                             str(ckpt))
              for w in (2, 4)}
    return {"get": lambda w: spawns[w].results(), "ckpt": ckpt}


@pytest.fixture(scope="module")
def world1(ranks):
    """This process's world-1 runs, made while the ranks run."""
    torch.set_num_threads(1)
    mesh = make_test_mesh((2, 1), device="cpu")
    out = {"grads": {name: grads_of(name, None) for name in CASES}}
    out.update({run["name"]: run_train(run, mesh) for run in RUNS})
    train.main(CKPT_ARGS + ["--mesh", "2x1", "--checkpoint",
                            str(ranks["ckpt"] / "2x1")])
    return out


# ------------------------------------------------------------- gradients


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("M", [2, 4])
def test_rank_gradient_is_its_block_of_the_whole(M, name, ranks, world1):
    cfg = port_config(name)
    want_loss, want = world1["grads"][name]
    got = ranks["get"](M)
    assert [r["group"] for r in got] == [(M, i) for i in range(M)]
    for i, r in enumerate(got):
        loss, grads = r["grads"][name]
        assert abs(loss - want_loss) <= ATOL_LOSS, (i, loss, want_loss)
        assert grads.keys() == want.keys()
        for k, g in want.items():
            blk = sharding.shard_leaf(k, g, cfg, ModelGroup(M, i),
                                      lead=sharding.stack_lead(k))
            tol = ATOL_GRAD * float(g.abs().max())
            err = float((grads[k] - blk).abs().max())
            assert grads[k].shape == blk.shape and err <= tol, \
                (i, k, err, tol)
            for pad in pad_blocks(k, grads[k], cfg, M, i):
                assert not pad.any(), (i, k)


@pytest.mark.parametrize("name", PART_CASES)
@pytest.mark.parametrize("M", [2, 4])
def test_read_in_part_leaves_are_the_partial_gradients(M, name, ranks,
                                                       world1):
    """Before the train step's sums, a rank's gradient is its block of the
    whole exactly on the leaves outside ``sharding.READ_IN_PART``; on
    each leaf of it, every rank's differs (its part's alone), and the sum
    over the ranks is the whole."""
    cfg = port_config(name)
    want = world1["grads"][name][1]
    table = {k for k in want if sharding.read_in_part(k, M)}
    assert table == PART_LEAVES[name]
    got = [r["raw"][name] for r in ranks["get"](M)]
    for k, g in want.items():
        tol = ATOL_GRAD * float(g.abs().max())
        for i, raw in enumerate(got):
            blk = sharding.shard_leaf(k, g, cfg, ModelGroup(M, i),
                                      lead=sharding.stack_lead(k))
            err = float((raw[k] - blk).abs().max())
            assert (err > tol) == (k in table), (i, k, err, tol)
        if k in table:
            total = sum(raw[k] for raw in got)
            assert float((total - g).abs().max()) <= tol, k


def pad_blocks(k, x, cfg, M, m, lead=0) -> list:
    """Rank m's blocks of ``x`` (its block of the leaf ``k``, behind
    ``lead`` dims and the leaf's layer dim) that belong to a zero head."""
    hs = sharding._head_set(k, cfg, M)
    if hs is None:
        return []
    mine = hs[0][m]
    dim = lead + sharding.stack_lead(k) + \
        sharding.param_spec(k, cfg).index("model")
    width = x.shape[dim] // len(mine)
    return [x.narrow(dim, h * width, width)
            for h, j in enumerate(mine) if j < 0]


# ----------------------------------------------------------- train steps


def _unsharded(ranks_out, name, i, cfg):
    """Step i's params of the four 2x2 ranks as whole [2, ...] leaves."""
    servers = {}
    for b in range(2):
        blocks = [ranks_out[2 * b + m][name][i][0] for m in range(2)]
        servers[b] = {k: sharding.unshard_leaf(
            k, [blk[k] for blk in blocks], cfg, 2,
            lead=1 + sharding.stack_lead(k)) for k in blocks[0]}
    return {k: torch.cat([servers[0][k], servers[1][k]]) for k in servers[0]}


@pytest.mark.parametrize("run", RUNS, ids=lambda r: r["name"])
def test_2x2_step_matches_2x1_world1(run, ranks, world1):
    got, want = ranks["get"](4), world1[run["name"]]
    cfg = train_config(run["arch"])
    assert [r["servers"] for r in got] == [[0], [0], [1], [1]]
    for i in range(STEPS):
        whole = _unsharded(got, run["name"], i, cfg)
        params, loss, norms = want[i]
        assert whole.keys() == params.keys()
        for k, v in params.items():
            err = float((whole[k] - v).abs().max())
            assert whole[k].shape == v.shape and err <= ATOL_STEP, (i, k, err)
        for r in got:
            assert abs(r[run["name"]][i][1] - loss) <= ATOL_STEP, i
            if norms is not None:
                np.testing.assert_allclose(r[run["name"]][i][2], norms,
                                           rtol=ATOL_STEP)
    moved = max(float((want[-1][0][k][0] - want[0][0][k][0]).abs().max())
                for k in want[0][0])
    assert moved > 1e-4                 # the steps move the params


@pytest.mark.parametrize("run", RUNS, ids=lambda r: r["name"])
def test_padding_heads_stay_zero_and_replicas_equal(run, ranks):
    got = ranks["get"](4)
    cfg = train_config(run["arch"])
    lay = sharding.heads(cfg, 2)
    padded = run["arch"] in PADDED_ARCHS
    assert any(j < 0 for j in lay.q[1]) == padded
    for i in range(STEPS):
        for rank, r in enumerate(got):
            m = rank % 2
            params = r[run["name"]][i][0]
            for k, x in params.items():
                for pad in pad_blocks(k, x, cfg, 2, m, lead=1):
                    assert not pad.any(), (i, rank, k)
        for b in range(2):
            a, c = (got[2 * b + m][run["name"]][i][0] for m in range(2))
            for k in a:
                if sharding.multiplicity(k, cfg, 2) == 2:
                    assert torch.equal(a[k], c[k]), (i, b, k)


def test_all_reduce_form_is_the_p2p_run_bitwise(ranks):
    got = ranks["get"](4)
    for r in got:
        for i in range(STEPS):
            a, b = r["rotate-hybrid-reduce"][i], r["rotate-hybrid"][i]
            assert a[1] == b[1]
    # the same mechanism and combine on the 3-head model: only the
    # ppermute form differs
    for r in got:
        for k, v in r["rotate-hybrid"][-1][0].items():
            assert torch.equal(r["rotate-hybrid-reduce"][-1][0][k], v), k


# -------------------------------------------------------------- ppermute


@pytest.mark.parametrize("world", [2, 4])
def test_ppermute_all_reduce_form_is_p2p_bitwise(world, ranks):
    got = ranks["get"](world)
    cases = [(shape, tag) for shape, axes in PERM_MESHES[world]
             for tag in perm_cases(int(np.prod(shape[:-1])), axes)]
    for r in got:
        assert sorted(r["perm"]) == sorted(cases)
        for key, (p2p, red) in r["perm"].items():
            assert torch.equal(p2p, red), key
            assert p2p.abs().sum() > 0, key


# ------------------------------------------------------------ checkpoint


def test_2x2_checkpoint_holds_the_whole_leaves(ranks, world1):
    ranks["get"](4)
    model = Model.init(get_config("smollm-135m").reduced(), rng(0, "cpu"))
    like = FlatView(model).tree(model)       # the whole leaves' shapes
    want, w_step = load_checkpoint(str(ranks["ckpt"] / "2x1"), like)
    got, g_step = load_checkpoint(str(ranks["ckpt"] / "2x2"), like)
    assert g_step == w_step == 2
    assert got.keys() == want.keys() == like.keys()
    for k, v in want.items():
        g, v = torch.as_tensor(got[k]), torch.as_tensor(v)
        assert g.shape == v.shape == like[k].shape, k
        assert float((g - v).abs().max()) <= ATOL_STEP, k
    assert any(not torch.equal(torch.as_tensor(want[k]), like[k])
               for k in like)                 # the steps moved them
