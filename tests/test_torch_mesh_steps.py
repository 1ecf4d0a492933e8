"""The port's mesh train step (``repro_torch.launch.steps``) against the
reference's (``repro/launch/steps.py``), three steps chained, with the
reference's draws replayed.

The reference's step runs on a forced-device CPU mesh, so it runs in
subprocesses (this file run as a script: ``--oracle``), started once for
the module: two of them, each taking every other case of those the session
collected from this file (``-k`` selects fewer), writing one file a case
that the test reads and deletes.  The file is one ``xdist_group``, so
``--dist loadfile`` or ``loadgroup`` runs it, and its oracle, on one
worker.  jax 0.9 refuses a second call of a
jitted mesh step on the state the first returned (its ``data`` sharding
against the host batch's none), so the oracle chains its steps through
host arrays, as ROADMAP queue 3 records.  Every case starts from the
reference's init of reduced smollm-135m (f32), with L = 2 clients of 2 x
16 tokens a server, sigma 0.01, mu 0.1, B 10 (the reference trainer's
defaults); the port is built from the same init (``convert``), reads the
same token batches and the same draws (``ReplayDraws``, each noise tree one
draw of its stream at the step's round), and its state chains on its own.

The cases: the dense combine with kernels off and on (K3's plain version
here, the reference's kernel through its plain ``ref`` backend), rotate
and sparse, on P = 4 and P = 2, and on the (3, 2, 1) pod mesh (sparse),
each under none, hybrid, iid_dp, gaussian_dp and scheduled (the hybrid
schedule at an epsilon target of 3000 over 10 steps: sigma 0.0094, 0.019,
0.028); then the runtime arguments: cohort weights (all ones, and
spread), client dropout (``client_alive``) and a per-round A from
``links:0.2``.

Tolerance, after each step: atol 1e-5 on every parameter and 4e-5 on the
tied embedding table, the contract ``tests/test_torch_federated_lm.py``
argues for these client gradients (the table's frequent-token rows drift
apart in f32 over the steps); the loss within 2e-5.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
L, PER_CLIENT, SEQ, STEPS = 2, 2, 16, 3
SIGMA, MU, BOUND = 0.01, 0.1, 10.0
SCHEDULE = dict(epsilon_target=3000.0, epsilon_horizon=10)
PRIVACY = ("none", "hybrid", "iid_dp", "gaussian_dp", "scheduled")
ATOL, ATOL_EMBED, ATOL_LOSS = 1e-5, 4e-5, 2e-5
ORACLE_TIMEOUT_S = 600
# eight host devices, one thread each: the oracle's time is compiling
XLA_FLAGS = ("--xla_force_host_platform_device_count=8 "
             "--xla_cpu_multi_thread_eigen=false "
             "intra_op_parallelism_threads=1")
WEIGHTS = [[2.0, 0.5], [1.5, 1.0], [0.7, 1.3], [1.0, 0.25]]


def _case(combine, shape, privacy, kernels=False, run="static", fault="none"):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    name = "-".join([combine + ("_k" if kernels else ""),
                     "x".join(map(str, shape)), privacy, run])
    return dict(name=name, combine=combine, shape=list(shape),
                axes=list(axes), privacy=privacy, kernels=kernels, run=run,
                fault=fault)


COMBINES = (("dense", False), ("dense", True), ("rotate", False),
            ("sparse", False))
CASES = ([_case(c, shape, priv, kernels=k) for shape in ((4, 1), (2, 1))
          for c, k in COMBINES for priv in PRIVACY]
         + [_case("sparse", (3, 2, 1), priv) for priv in PRIVACY]
         + [_case("dense", (4, 1), "none", run="ones"),
            _case("dense", (4, 1), "hybrid", run="weights"),
            _case("rotate", (4, 1), "iid_dp", run="alive",
                  fault="dropout:0.3"),
            _case("rotate", (4, 1), "hybrid", run="A", fault="links:0.2"),
            _case("sparse", (4, 1), "gaussian_dp", run="A",
                  fault="links:0.2")])


def _gfl_kwargs(case):
    kw = dict(topology="ring", privacy=case["privacy"], sigma_g=SIGMA, mu=MU,
              grad_bound=BOUND, combine_impl=case["combine"],
              use_kernels=case["kernels"], fault=case["fault"])
    if case["privacy"] == "scheduled":
        kw.update(SCHEDULE)
    return kw


def _runtime_args(case, proc, i):
    """(A_round, client_alive, cohort_weights) of step i, numpy."""
    P = int(np.prod(case["shape"][:-1]))
    A = alive = w = None
    if case["run"] in ("A", "alive"):
        A = np.asarray(proc.realize(i).A, np.float32)
    if case["run"] == "alive":
        alive = np.asarray(proc.client_alive(i, L), np.float32)
    if case["run"] == "ones":
        w = np.ones((P, L), np.float32)
    if case["run"] == "weights":
        w = np.asarray(WEIGHTS[:P], np.float32)
    return A, alive, w


# ------------------------------------------------------------- the oracle


def _oracle(out_dir: Path, names: list) -> None:
    """Run the reference's jitted mesh step for each named case; write
    ``<name>.npz`` (params after each step, the losses, the draws of each
    step and the runtime arguments) atomically, in order."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import GFLConfig
    from repro.configs.registry import get_config
    from repro.core.privacy.mechanism import IIDLaplaceDP, mechanism_for
    from repro.data import TokenStream, federated_token_batches
    from repro.launch import steps as S
    from repro.launch.mesh import make_test_mesh
    from repro.models import Model

    cfg = get_config("smollm-135m").reduced()
    model = Model(cfg)
    params0 = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    flat0 = jax.tree_util.tree_flatten_with_path(params0)[0]
    keys = ["/".join(k.key for k in path) for path, _ in flat0]
    if not (out_dir / "init.npz").exists():
        np.savez(out_dir / "init.tmp.npz",
                 **{k: v for k, (_, v) in zip(keys, flat0)})
        os.replace(out_dir / "init.tmp.npz", out_dir / "init.npz")
    stream = TokenStream(vocab=cfg.vocab_size, seed=0)
    batches = {}
    draw_fns = {}

    def draw_tree(key, leaves, dist):
        """What the reference's _tree_noise samples: one split key a leaf,
        f32 uniforms in the Laplace sampler's interval or normals (one
        compiled function a set of shapes)."""
        shapes = tuple(x.shape for x in leaves)
        if (shapes, dist) not in draw_fns:
            def fn(k):
                ks = jax.random.split(k, len(shapes))
                return [jax.random.uniform(kj, s, jnp.float32,
                                           -0.5 + 1e-7, 0.5 - 1e-7)
                        if dist == "laplace" else
                        jax.random.normal(kj, s, jnp.float32)
                        for kj, s in zip(ks, shapes)]
            draw_fns[shapes, dist] = jax.jit(fn)
        return [np.asarray(x) for x in draw_fns[shapes, dist](key)]

    for name in names:
        case = next(c for c in CASES if c["name"] == name)
        mesh = make_test_mesh(tuple(case["shape"]), tuple(case["axes"]))
        P = int(np.prod(case["shape"][:-1]))
        if P not in batches:
            batches[P] = [federated_token_batches(stream, 0, i, P=P, L=L,
                                                  per_client=PER_CLIENT,
                                                  seq_len=SEQ)
                          for i in range(STEPS)]
        gfl = GFLConfig(**_gfl_kwargs(case))
        mech = mechanism_for(gfl)
        prof = mech.noise_profile()
        inner = getattr(mech, "inner", mech)
        proc = (S.make_topology_process(mesh, gfl)
                if case["fault"] != "none" else None)
        step = jax.jit(S.make_train_step(model, gfl, mesh, clients=L))
        params = jax.tree.map(
            lambda x: np.broadcast_to(x[None], (P,) + x.shape).copy(),
            params0)
        state = S.TrainState(params, np.int32(0),
                             np.asarray(jax.random.PRNGKey(0)))
        out = {}
        for i in range(STEPS):
            _, k_noise, k_client = jax.random.split(state.key, 3)
            leaves = jax.tree_util.tree_leaves(state.params)
            if prof.client_sigma > 0 and isinstance(inner, IIDLaplaceDP):
                for j, x in enumerate(draw_tree(k_client, leaves,
                                                "laplace")):
                    out[f"d{i}/client/{j}"] = x
            if prof.server_sigma > 0:
                for j, x in enumerate(draw_tree(k_noise, leaves,
                                                prof.distribution)):
                    out[f"d{i}/combine/{j}"] = x
            A, alive, w = _runtime_args(case, proc, i)
            for tag, v in (("A", A), ("alive", alive), ("w", w)):
                if v is not None:
                    out[f"{tag}{i}"] = v
            with mesh:
                if case["run"] == "static":
                    state, m = step(state, batches[P][i])
                else:
                    state, m = step(state, batches[P][i], A, alive,
                                    cohort_weights=w)
            state = jax.tree.map(np.asarray, state)
            out[f"loss{i}"] = np.asarray(m["loss"])
            for k, (_, v) in zip(keys, jax.tree_util.tree_flatten_with_path(
                    state.params)[0]):
                out[f"s{i}/{k}"] = v
        for i in range(STEPS):
            for k, v in batches[P][i].items():
                out[f"b{i}/{k}"] = np.asarray(v)
        np.savez(out_dir / f"{name}.tmp.npz", **out)
        os.replace(out_dir / f"{name}.tmp.npz", out_dir / f"{name}.npz")
        print(name, flush=True)


if __name__ == "__main__" and sys.argv[1:2] == ["--oracle"]:
    _oracle(Path(sys.argv[2]), sys.argv[3:])
    sys.exit(0)


# --------------------------------------------------------------- the port

import torch  # noqa: E402

from repro_torch.configs.base import GFLConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.draws import ReplayDraws  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

torch.set_num_threads(1)


class Oracle:
    """The two oracle processes and the files they write."""

    def __init__(self, out_dir: Path, names: list):
        self.dir = out_dir
        env = dict(os.environ)
        env.update(XLA_FLAGS=XLA_FLAGS, JAX_PLATFORMS="cpu",
                   REPRO_KERNEL_BACKEND="ref",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT / "src"), str(ROOT / "tests"),
                        env.get("PYTHONPATH", "")]))
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, "--oracle", str(out_dir)]
            + names[half::2], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for half in (0, 1)
            if names[half::2]]
        self.t0 = time.monotonic()

    def take(self, name: str) -> dict:
        """The case's arrays, once written; the file is removed."""
        path = self.dir / f"{name}.npz"
        while not path.exists():
            for p in self.procs:
                if p.poll() not in (None, 0):
                    raise RuntimeError(f"oracle failed:\n{p.stderr.read()}")
            if time.monotonic() - self.t0 > ORACLE_TIMEOUT_S:
                raise TimeoutError(f"oracle: no {name} after "
                                   f"{ORACLE_TIMEOUT_S} s")
            time.sleep(0.05)
        with np.load(path) as z:
            data = {k: z[k] for k in z.files}
        path.unlink()
        return data

    def init(self) -> dict:
        path = self.dir / "init.npz"
        while not path.exists():
            time.sleep(0.05)
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    def close(self) -> None:
        for p in self.procs:
            try:
                p.wait(timeout=ORACLE_TIMEOUT_S)
            finally:
                if p.poll() is None:
                    p.kill()
            p.stdout.close()
            p.stderr.close()


pytestmark = pytest.mark.xdist_group("mesh_oracle")


@pytest.fixture(scope="module")
def oracle(request, tmp_path_factory):
    """The oracle of the cases collected from this file, in their order."""
    names = [item.callspec.params["case"]["name"]
             for item in request.session.items
             if getattr(item, "module", None) is request.module
             and hasattr(item, "callspec")]
    o = Oracle(tmp_path_factory.mktemp("mesh_oracle"), names)
    yield o
    o.close()


def _nested(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *parents, leaf = key.split("/")
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = v
    return out


def port_model(init: dict) -> Model:
    cfg = get_config("smollm-135m").reduced()
    return Model(cfg, model_params_from_numpy(_nested(init), cfg, "cpu"))


def replay_rounds(data: dict, n_leaves: int) -> list:
    """The oracle's draws as ReplayDraws rounds: per step, the client tree
    then the combine tree, each one draw of its stream."""
    rounds = []
    for i in range(STEPS):
        entries = []
        for stream in ("client", "combine"):
            if f"d{i}/{stream}/0" not in data:
                continue
            kind = ("normal_tree" if stream == "combine"
                    and data.get("dist") == "gaussian"
                    else "laplace_uniform_tree")
            entries.append((stream, kind, [data[f"d{i}/{stream}/{j}"]
                                           for j in range(n_leaves)]))
        rounds.append(entries)
    return rounds


def run_port(case: dict, data: dict, init: dict):
    """The port's three steps on the oracle's batches, draws and runtime
    arguments; yields (step, state, metrics)."""
    model = port_model(init)
    mesh = make_test_mesh(tuple(case["shape"]), tuple(case["axes"]),
                          device="cpu")
    gfl = GFLConfig(**_gfl_kwargs(case))
    data["dist"] = ("gaussian" if case["privacy"] == "gaussian_dp"
                    else "laplace")
    draws = ReplayDraws(replay_rounds(data, len(init)), device="cpu")
    step = steps.make_train_step(model, gfl, mesh, clients=L)
    state = steps.init_train_state(model, gfl, mesh, draws)
    proc = (steps.make_topology_process(mesh, gfl)
            if case["fault"] != "none" else None)
    for i in range(STEPS):
        batch = {k: torch.from_numpy(data[f"b{i}/{k}"].astype(np.int64))
                 for k in ("tokens", "labels")}
        A, alive, w = _runtime_args(case, proc, i)
        for tag, v in (("A", A), ("alive", alive), ("w", w)):
            assert (v is None) == (f"{tag}{i}" not in data), tag
            if v is not None:       # the fault draws are numpy's: exact
                assert np.array_equal(v, data[f"{tag}{i}"]), tag
        if case["run"] == "static":
            state, m = step(state, batch)
        else:
            state, m = step(state, batch, A, alive, cohort_weights=w)
        yield i, state, m
    assert draws.remaining == 0


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_mesh_step_matches_the_reference(case, oracle):
    data = oracle.take(case["name"])
    init = oracle.init()
    for i, state, m in run_port(case, data, init):
        worst = {}
        for k, v in state.params.items():
            tol = ATOL_EMBED if k == "embed/table" else ATOL
            err = float(np.abs(v.numpy() - data[f"s{i}/{k}"]).max())
            worst[k] = err / tol
            assert err <= tol, (i, k, err)
        assert abs(float(m["loss"]) - float(data[f"loss{i}"])) <= ATOL_LOSS
    moved = max(float(np.abs(data[f"s{STEPS - 1}/{k}"][0] - v).max())
                for k, v in init.items())
    assert moved > 1e-3                  # the steps move the params
