"""The dry run (``repro_torch.launch.dryrun``) and its op analysis
(``repro_torch.launch.op_analysis``) on the CPU, on fake CPU tensors.

- Dot FLOPs of the port's op stream equal the reference's
  ``hlo_analysis.analyze_hlo(...).dot_flops`` of the same step compiled on
  one CPU device, exactly: the reduced prefill of smollm-135m (B 2, S 64)
  and of mixtral-8x7b, and the GFL train step at a 1x1 mesh under the
  default remat policy and under "dots" (both sides recompute the same
  products).
- A real step on CPU tensors and its fake trace count the same ops,
  FLOPs, bytes and live storage.
- Parameter bytes a rank holds at 2x4 equal the reference's
  ``params_specs`` shard shapes summed (one subprocess, 8 forced host
  devices); collectives of the dense combine and the sparse ring against
  a hand count from the leaf shapes; K3 one launch a leaf; rank 0 and the
  last rank count alike; the production meshes through ``run_one``.
- K3's and K8's fake branches give their plain versions' shape and dtype,
  report their cost, and reach no build; no fake process group outlives a
  dry-run call; MLA's host scalars no longer read a tensor under fake
  tensors, and the step is bitwise what it was.
- rwkv6-3b's decode at 16x16 traces on rank 0 (three real heads), 13 (one
  and two zero heads) and 15 (zero heads only), counting alike but for
  the zero fill; RWKV-6's time loop on fake tensors, reported by its
  cost model, counts what the eager loop counts (its forward exactly,
  its backward within 1 %).
"""
import contextlib
import functools
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import kernels
from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import get_config
from repro_torch.kernels import _build, graph_combine as gc, swa_decode as sd
from repro_torch.launch import dryrun, sharding, steps
from repro_torch.launch.mesh import Mesh, fake_world
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.models import attention
from repro_torch.models.model import Model
from repro_torch.models.parallel import ModelGroup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = ("data", "model")
PARAM_ARCHS = ("yi-6b", "mixtral-8x7b")
REF_PARAM_BYTES = """
    import json, math
    import jax
    from repro.configs.registry import get_config
    from repro.launch.mesh import make_test_mesh
    from repro.launch import steps
    from repro.models import Model
    mesh = make_test_mesh((2, 4), ("data", "model"))
    out = {}
    for arch in ARCHS:
        sds, _ = steps.params_specs(Model(get_config(arch)), mesh,
                                    gfl_train=True)
        out[arch] = sum(math.prod(s.sharding.shard_shape(s.shape))
                        * s.dtype.itemsize for s in jax.tree.leaves(sds))
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_param_bytes():
    """The reference's bytes a device holds at 2x4, from a subprocess
    started when the module's first test runs and read by the last."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = f"ARCHS = {PARAM_ARCHS!r}\n" + textwrap.dedent(REF_PARAM_BYTES)
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)

    def read():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        return json.loads(out.strip().splitlines()[-1])
    yield read
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(autouse=True)
def _start_reference_subprocess(ref_param_bytes):
    """Every test asks for the fixture, so the subprocess runs beside the
    first test."""


def _ref_dot_flops(fn, *args) -> float:
    import jax
    from repro.launch.hlo_analysis import analyze_hlo
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()
                       ).dot_flops


# ------------------------------------------------------------ reference


@pytest.mark.parametrize("arch", ["smollm-135m", "mixtral-8x7b"])
def test_prefill_dot_flops_equal_the_references_hlo(arch):
    import jax
    import jax.numpy as jnp
    from repro import rng_key
    from repro.configs.registry import get_config as ref_config
    from repro.models import Model as RefModel

    rm = RefModel(ref_config(arch).reduced())
    want = _ref_dot_flops(
        lambda p, b: rm.prefill(p, b), jax.eval_shape(rm.init, rng_key()),
        {"tokens": jax.ShapeDtypeStruct((2, 64), jnp.int32)})
    stats, _ = dryrun.trace_step(get_config(arch).reduced(),
                                 InputShape("p", 64, 2, "prefill"), (1, 1),
                                 AXES, device="cpu")
    assert stats.dot_flops == want
    if arch == "smollm-135m":
        assert want == 319_291_392     # the probe's count


@pytest.mark.parametrize("policy", [None, "dots"])
def test_train_step_dot_flops_equal_the_references_hlo(policy):
    """The GFL step at 1x1 (L 2, b 1, S 32, hybrid, sparse): the same
    remat policy on both sides recomputes the same products."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import GFLConfig as RefGFL
    from repro.configs.registry import get_config as ref_config
    from repro.launch import steps as ref_steps
    from repro.launch.mesh import make_test_mesh
    from repro.models import Model as RefModel

    rm = RefModel(ref_config("smollm-135m").reduced())
    mesh = make_test_mesh((1, 1), AXES)
    gfl = RefGFL(topology="ring", privacy="hybrid", sigma_g=0.2,
                 grad_bound=10.0, mu=0.1, combine_impl="sparse")
    sds = jax.ShapeDtypeStruct
    with mesh:
        step = ref_steps.make_train_step(rm, gfl, mesh, clients=2,
                                         remat_policy=policy)
        p, _ = ref_steps.params_specs(rm, mesh, gfl_train=True)
        state = ref_steps.TrainState(
            jax.tree.map(lambda s: sds(s.shape, s.dtype), p),
            sds((), jnp.int32), sds((2,), jnp.uint32))
        batch = {k: sds((1, 2, 1, 32), jnp.int32)
                 for k in ("tokens", "labels")}
        want = _ref_dot_flops(step, state, batch)
    stats, _ = dryrun.trace_step(
        get_config("smollm-135m").reduced(), InputShape("t", 32, 2, "train"),
        (1, 1), AXES, device="cpu", clients=2, remat_policy=policy)
    assert stats.dot_flops == want


# ------------------------------------------------- the counter, real/fake


def _real_counts(cfg, shape, combine):
    """The op analysis of ``cfg``'s step on real CPU tensors at 1x1, after
    one warm-up step (as the card's run takes it)."""
    gen = torch.Generator().manual_seed(0)
    model = Model.init(cfg, gen)
    if shape.kind == "train":
        gfl = dryrun.default_gfl(combine)
        mesh = Mesh((1, 1), AXES, device="cpu")
        step = steps.make_train_step(model, gfl, mesh, clients=2)
        state = steps.init_train_state(model, gfl, mesh, key=0)
        batch = {k: torch.zeros(s.shape, dtype=s.dtype)
                 for k, s in steps.input_specs(model, shape, mesh, gfl=gfl,
                                               clients=2).items()}
        state = step(state, batch)[0]     # round 1 draws anew
        counter = OpCounter(state.params)
        with counter:
            out = step(state, batch)
    else:
        batch = {"tokens": torch.zeros((shape.global_batch, shape.seq_len),
                                       dtype=torch.int32)}
        step = steps.make_prefill_step(model)
        step(None, batch)
        counter = OpCounter((dict(model.named_parameters()), batch))
        with counter:
            out = step(None, batch)
    return counter.finish(out)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_a_real_step_counts_as_its_fake_trace(kind):
    cfg = get_config("smollm-135m").reduced()
    shape = (InputShape("t", 32, 2, "train") if kind == "train"
             else InputShape("p", 64, 2, "prefill"))
    fake, _ = dryrun.trace_step(cfg, shape, (1, 1), AXES, device="cpu",
                                clients=2)
    real = _real_counts(cfg, shape, "sparse")
    assert fake.counts() == real.counts()
    assert fake.op_counts == real.op_counts
    assert fake.temp_bytes == real.temp_bytes > 0
    assert fake.output_bytes == real.output_bytes > 0
    if kind == "prefill":
        assert fake.argument_bytes == real.argument_bytes


# ------------------------------------------------------ a 2x4 fake world


def _leaf_bytes(cfg, mesh_shape, rank) -> dict:
    """{key: bytes} of one server's leaves as rank ``rank`` of a fake
    world of ``mesh_shape`` holds them."""
    with fake_world(mesh_shape[0] * mesh_shape[1], rank), FakeTensorMode():
        mesh = Mesh(mesh_shape, AXES, device="cpu", backend="fake")
        model = Model.init(cfg, torch.Generator().manual_seed(0),
                           group=ModelGroup.of(mesh))
        state = steps.init_train_state(model, dryrun.default_gfl("dense"),
                                       mesh, key=0)
        return {k: v[0].numel() * v.element_size()
                for k, v in state.params.items()}


TRAIN = InputShape("t", 32, 16, "train")


def test_dense_combine_collectives_against_a_hand_count():
    """At 2x4 a rank holds one server: one all_gather a leaf (the two
    servers' blocks) and one of the loss, K3 once a leaf."""
    cfg = get_config("smollm-135m").reduced()
    leaves = _leaf_bytes(cfg, (2, 4), 0)
    stats, _ = dryrun.trace_step(cfg, TRAIN, (2, 4), AXES, device="cpu",
                                 combine="dense", clients=2,
                                 gfl_over={"use_kernels": True})
    assert stats.kernel_launches == {"graph_combine": len(leaves)}
    assert stats.collective_counts["all-gather"] == len(leaves) + 1
    assert stats.collective_bytes_by_op["all-gather"] == \
        2 * sum(leaves.values()) + 2 * 4
    assert stats.collective_counts["all-reduce"] > 0
    assert "collective-permute" not in stats.collective_counts


def test_sparse_ring_receives_a_hand_count():
    """At 4x2 the four servers make a ring: each leaf's rows come from
    both neighbours, one ``recv_`` of one row each."""
    cfg = get_config("smollm-135m").reduced()
    leaves = _leaf_bytes(cfg, (4, 2), 0)
    stats, _ = dryrun.trace_step(cfg, TRAIN, (4, 2), AXES, device="cpu",
                                 combine="sparse", clients=2)
    assert stats.collective_counts["collective-permute"] == 2 * len(leaves)
    assert stats.collective_bytes_by_op["collective-permute"] == \
        2 * sum(leaves.values())
    assert stats.collective_bytes_by_op["all-gather"] == 4 * 4   # the loss


def test_every_rank_counts_alike():
    cfg = get_config("smollm-135m").reduced()
    first, _ = dryrun.trace_step(cfg, TRAIN, (2, 4), AXES, device="cpu",
                                 combine="dense", clients=2, rank=0)
    last, _ = dryrun.trace_step(cfg, TRAIN, (2, 4), AXES, device="cpu",
                                combine="dense", clients=2, rank=7)
    assert first.counts() == last.counts()
    assert first.peak_bytes == last.peak_bytes


@pytest.mark.parametrize("arch", PARAM_ARCHS)
def test_param_bytes_a_rank_holds_equal_the_references_shards(
        arch, ref_param_bytes):
    mine = sum(_leaf_bytes(get_config(arch), (2, 4), 5).values())
    assert mine == ref_param_bytes()[arch]


# ------------------------------------------------------ production meshes


def test_production_mesh_decode():
    """The reference's ``test_dryrun_entrypoint_production_mesh``, on one
    fake rank of 256."""
    rec = dryrun.run_one("smollm-135m", "decode_32k", multi_pod=False,
                         device="cpu")
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["flops"] > 0 and rec["collective_bytes"] >= 0
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    assert rec["kernel_launches"] == {"swa_decode": 30}   # one a layer
    assert rec["memory_per_device"]["peak_bytes"] > 0
    assert not dist.is_initialized()


def test_production_multipod_train():
    rec = dryrun.run_one("whisper-tiny", "train_4k", multi_pod=True,
                         clients=1, device="cpu")
    assert rec["chips"] == 512 and rec["mesh"] == "2x16x16"
    assert rec["flops"] > 0 and rec["collective_bytes"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert not dist.is_initialized()


def test_long_context_skips_with_the_references_reason(capsys):
    rec = dryrun.run_one("yi-6b", "long_500k", multi_pod=False,
                         device="cpu")
    assert rec["skip"] == dryrun.LONG_SKIP_REASON["yi-6b"]
    assert capsys.readouterr().out.startswith("SKIP yi-6b_long_500k")


def test_no_fake_world_outlives_a_combo_that_raised():
    with pytest.raises(ValueError, match="combine_impl"):
        dryrun.run_one("smollm-135m", "train_4k", multi_pod=False,
                       combine="ring", device="cpu")
    assert not dist.is_initialized()
    with fake_world(4, 1):
        assert dist.get_world_size() == 4 and dist.get_rank() == 1
        with pytest.raises(RuntimeError, match="already up"):
            with fake_world(2, 0):
                pass
    assert not dist.is_initialized()


# ---------------------------------------------------- K3 and K8 branches


def test_kernel_fake_branches_give_the_plain_shapes(monkeypatch):
    """On fake tensors (cuda ones too, as the card's dry run makes them)
    K3 and K8 return what their plain versions return in shape and dtype,
    report their cost model, and never reach the build."""
    monkeypatch.setattr(_build, "function", lambda *a, **k: pytest.fail(
        "a fake tensor reached the kernel build"))
    seen, launches = [], dict(kernels.LAUNCHES)
    monkeypatch.setattr(kernels, "LISTENERS", [lambda n, c: seen.append(
        (n, c))])
    args3 = [((4, 4), torch.float32), ((4, 100), torch.bfloat16),
             ((4, 100), torch.bfloat16)]
    args8 = [((2, 8, 64), torch.bfloat16), ((2, 48, 2, 64), torch.bfloat16),
             ((2, 48, 2, 64), torch.bfloat16), ((1,), torch.int32)]
    want3 = gc.graph_combine_plain(*[torch.ones(s, dtype=d)
                                     for s, d in args3])
    want8 = sd.swa_decode_attention_plain(*[torch.ones(s, dtype=d)
                                            for s, d in args8])
    for dev in ("cpu", "cuda"):
        with FakeTensorMode():
            got3 = gc.graph_combine(*[torch.empty(s, dtype=d, device=dev)
                                      for s, d in args3])
            got8 = sd.swa_decode(*[torch.empty(s, dtype=d, device=dev)
                                   for s, d in args8])
        assert (got3.shape, got3.dtype) == (want3.shape, want3.dtype)
        assert (got8.shape, got8.dtype) == (want8.shape, want8.dtype)
    assert seen == [("graph_combine", gc.cost(4, 100, 2, g=True)),
                    ("swa_decode", sd.cost(2, 8, 2, 48, 64, 2))] * 2
    assert seen[0][1]["bytes"] == 4 * 4 * 4 + 3 * 4 * 100 * 2
    assert kernels.LAUNCHES == launches        # nothing launched


# ------------------------------------------------ MLA's host constants


def test_mla_step_is_bitwise_what_it_was(monkeypatch):
    """MLA's scale constants were a cached host tensor read by ``float()``
    inside the step: a fake trace can neither read a fake one nor take the
    real one a real run cached.  They are Python floats made outside every
    dispatch mode now; the reduced deepseek prefill and decode are bitwise
    what the old constants give, and only the new ones trace."""
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    model = Model.init(cfg, torch.Generator().manual_seed(3))
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(4))
    decode = InputShape("d", 64, 2, "decode")

    def run():
        logits, cache = model.prefill(tokens)
        return logits, model.decode_step(logits.argmax(-1), cache)[0]

    new = run()
    assert dryrun.trace_step(cfg, decode, (1, 1), AXES,
                             device="cpu")[0].flops > 0

    @functools.lru_cache(maxsize=None)
    def old_sqrt(m):            # the old step's cached host tensor
        return torch.sqrt(torch.tensor(m.qk_nope_head_dim
                                       + m.qk_rope_head_dim,
                                       dtype=torch.float32))
    monkeypatch.setattr(attention, "_mla_scales", lambda m: (
        float(old_sqrt(m)), float(1.0 / old_sqrt(m))))
    for a, b in zip(new, run()):
        assert torch.equal(a, b)
    with pytest.raises(AssertionError, match="convert all Tensors"):
        dryrun.trace_step(cfg, decode, (1, 1), AXES, device="cpu")
    assert not dist.is_initialized()


# ------------------------------------------- RWKV-6 over a model axis of 16


def test_rwkv6_3b_traces_at_16x16_on_every_kind_of_rank():
    """rwkv6-3b's 40 heads over the production model axis of 16, padded
    to 48 with zero heads (3 a rank): rank 13 holds head 39 and two zero
    heads, rank 15 zero heads only.  Its cheapest combo (decode_32k)
    traces on both, and they count what rank 0 (three real heads) counts,
    every rank's shapes being equal, but for the zero fill of a zero
    head's decay, ``u`` and ``ln_scale`` entries: three ops a layer."""
    cfg = get_config("rwkv6-3b")
    heads = sharding.heads(cfg, 16).q
    assert heads[13] == (39, -1, -1) and heads[15] == (-1, -1, -1)
    first, meta = dryrun.trace_combo("rwkv6-3b", "decode_32k",
                                     multi_pod=False, device="cpu", rank=0)
    assert first.flops > 0 and meta["chips"] == 256
    for rank in (13, 15):
        got, m = dryrun.trace_combo("rwkv6-3b", "decode_32k",
                                    multi_pod=False, device="cpu",
                                    rank=rank)
        want = dict(first.counts(), ops=first.ops + 3 * cfg.num_layers,
                    hbm_bytes=got.hbm_bytes)
        assert got.counts() == want, rank
        assert got.hbm_bytes > first.hbm_bytes, rank
        assert got.peak_bytes == first.peak_bytes, rank
        assert m["param_bytes"] == meta["param_bytes"], rank
    assert not dist.is_initialized()


def _loop_counts(S, B, H, hs, grad, fake):
    """The op analysis of ``rwkv.time_loop`` over S steps (y's gradient
    too with ``grad``), on real CPU tensors (the eager loop) or fake ones
    (the modelled loop)."""
    from repro_torch.models import rwkv
    gen = torch.Generator().manual_seed(S)
    args = [torch.randn((S, B, H, hs), generator=gen) for _ in range(4)]
    args += [torch.randn((1, H, hs, 1), generator=gen),
             torch.zeros((B, H, hs, hs))]
    gy = torch.randn((B, S, H, hs), generator=gen)
    with FakeTensorMode() if fake else contextlib.nullcontext() as mode:
        if fake:
            args, gy = [mode.from_tensor(a) for a in args], \
                mode.from_tensor(gy)
        args = [a.requires_grad_(grad and i < 5) for i, a in
                enumerate(args)]
        with OpCounter() as c:
            y, _ = rwkv.time_loop(*args)
            if grad:
                y.backward(gy)
    return c.stats


@pytest.mark.parametrize("dims", [(2, 3, 8), (1, 2, 16)])
@pytest.mark.parametrize("S", [16, 64])
def test_rwkv_time_loop_model_counts_the_eager_loop(S, dims):
    """On fake tensors RWKV-6's time loop is reported by its cost
    (``rwkv.time_loop_cost``) instead of traced step by step: its forward
    counts what the eager loop counts, exactly; with y's gradient, its
    dot FLOPs exactly, its FLOPs and bytes within 1 %, its ops within 4
    % and its peak within 10 % (the storage autograd keeps for the
    backward)."""
    want = _loop_counts(S, *dims, grad=False, fake=False)
    got = _loop_counts(S, *dims, grad=False, fake=True)
    assert got.modelled == {"rwkv6_time_loop": 1}
    for k in ("ops", "flops", "dot_flops", "hbm_bytes"):
        assert getattr(got, k) == getattr(want, k), k
    want = _loop_counts(S, *dims, grad=True, fake=False)
    got = _loop_counts(S, *dims, grad=True, fake=True)
    assert got.modelled == {"rwkv6_time_loop": 1,
                            "rwkv6_time_loop_backward": 1}
    assert got.dot_flops == want.dot_flops
    for k, tol in (("flops", 0.01), ("hbm_bytes", 0.01), ("ops", 0.04)):
        assert abs(getattr(got, k) / getattr(want, k) - 1) <= tol, k
    assert abs(got.temp_bytes / want.temp_bytes - 1) <= 0.10
