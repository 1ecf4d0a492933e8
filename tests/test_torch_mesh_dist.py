"""The mesh over several ranks: gloo CPU ranks spawned with
``torch.multiprocessing`` (two spawns, one intra-op thread a rank, each
joined within its own timeout), held against the same runs in this one
process (a world of 1, which holds every server).

- World 2 on meshes (2, 1) and (4, 1) (two servers a rank): the rotate and
  sparse combines bitwise equal to world 1 under hybrid and iid_dp noise
  (each rank draws every server's noise and keeps its rows), and the dense
  combine (its rows gathered) too; then ``serve --mesh 2x1``: the same
  tokens as one process.
- World 4 on (2, 2) with ``client_parallel`` (each rank one client of its
  server, the gradients summed over the model group) against the client
  loop of world 1 on (2, 1), within atol 1e-5 (the two sum the clients'
  gradients in another order), and the two model ranks of a server equal.
"""
import os
import socket
import time
from datetime import timedelta
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import rng
from repro_torch.configs.base import GFLConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.synthetic import TokenStream, federated_token_batches
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_test_mesh, num_servers
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models.model import Model

L, PER_CLIENT, SEQ, STEPS = 2, 2, 16, 2
JOIN_TIMEOUT_S = 240
TRAIN_CASES = [((2, 1), "rotate", "hybrid"), ((2, 1), "sparse", "iid_dp"),
               ((4, 1), "rotate", "iid_dp"), ((4, 1), "sparse", "hybrid"),
               ((4, 1), "dense", "gaussian_dp")]
SERVE_ARGS = ["--reduced", "--device", "cpu", "--batch", "4",
              "--prompt-len", "16", "--new-tokens", "4", "--seed", "0"]
ATOL_CLIENT_PARALLEL = 1e-5


def run_case(shape, combine, privacy, client_parallel=False):
    """Two GFL steps of reduced smollm-135m on this rank's servers:
    ({path: [n_local, ...]}, the last loss, the local servers)."""
    cfg = get_config("smollm-135m").reduced()
    model = Model.init(cfg, rng(0, "cpu"))
    mesh = make_test_mesh(shape, device="cpu")
    gfl = GFLConfig(topology="ring", privacy=privacy, sigma_g=0.01, mu=0.1,
                    grad_bound=10.0, combine_impl=combine,
                    client_parallel=client_parallel)
    step = make_train_step(model, gfl, mesh, clients=L)
    state = init_train_state(model, gfl, mesh, 0)
    stream = TokenStream(vocab=cfg.vocab_size, seed=0)
    for i in range(STEPS):
        batch = federated_token_batches(stream, 0, i, num_servers(mesh), L,
                                        PER_CLIENT, SEQ)
        state, m = step(state, batch)
    return state.params, float(m["loss"]), mesh.local_servers


def _worker(rank, world, port, out_dir, task):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=JOIN_TIMEOUT_S))
    try:
        out = {}
        if task == "world2":
            for case in TRAIN_CASES:
                params, loss, servers = run_case(*case)
                out[case] = (params, loss, list(servers))
            out["serve"] = serve.main(SERVE_ARGS + ["--mesh", "2x1"])[
                "tokens"]
        else:
            params, loss, servers = run_case((2, 2), "sparse", "hybrid",
                                             client_parallel=True)
            out["cp"] = (params, loss, list(servers))
        torch.save(out, Path(out_dir) / f"{task}_{rank}.pt")
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(task, world, out_dir) -> list:
    """Run ``task`` on ``world`` gloo ranks; each rank's results.  The
    ranks inherit one OpenMP thread each."""
    omp = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        ctx = mp.start_processes(_worker, args=(world, _free_port(),
                                                str(out_dir), task),
                                 nprocs=world, join=False,
                                 start_method="spawn")
    finally:
        if omp is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = omp
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{task}: ranks did not finish in "
                                   f"{JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(Path(out_dir) / f"{task}_{r}.pt") for r in
            range(world)]


def _assemble(parts) -> dict:
    """The whole [P, ...] tree from each rank's (params, loss, servers)."""
    rows = {}
    for params, _, servers in parts:
        for i, p in enumerate(servers):
            rows.setdefault(p, {k: v[i] for k, v in params.items()})
    return {k: torch.stack([rows[p][k] for p in sorted(rows)])
            for k in rows[0]}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    torch.set_num_threads(1)
    return _spawn("world2", 2, tmp_path_factory.mktemp("world2"))


@pytest.mark.parametrize("case", TRAIN_CASES,
                         ids=lambda c: "x".join(map(str, c[0])) + "-"
                         + "-".join(c[1:]))
def test_world2_equals_world1_bitwise(case, world2):
    want, loss, servers = run_case(*case)
    assert list(servers) == list(range(case[0][0]))
    got = _assemble([r[case] for r in world2])
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    half = case[0][0] // 2
    assert [r[case][2] for r in world2] == [list(range(half)),
                                           list(range(half, 2 * half))]
    assert all(r[case][1] == loss for r in world2)


def test_serve_mesh_2x1_same_tokens(world2):
    want = serve.main(SERVE_ARGS)["tokens"]
    for r in world2:
        assert torch.equal(r["serve"], want)


def test_client_parallel_world4_matches_the_client_loop(tmp_path):
    torch.set_num_threads(1)
    ranks = _spawn("world4", 4, tmp_path)
    want, loss, _ = run_case((2, 1), "sparse", "hybrid")
    # ranks 0, 1 hold server 0 (model index 0, 1); ranks 2, 3 server 1
    assert [r["cp"][2] for r in ranks] == [[0], [0], [1], [1]]
    for a, b in ((0, 1), (2, 3)):
        for k in want:
            assert torch.equal(ranks[a]["cp"][0][k], ranks[b]["cp"][0][k])
    got = _assemble([ranks[0]["cp"], ranks[2]["cp"]])
    for k, v in want.items():
        err = float((got[k] - v).abs().max())
        assert err <= ATOL_CLIENT_PARALLEL, (k, err)
    assert abs(ranks[0]["cp"][1] - loss) <= ATOL_CLIENT_PARALLEL
