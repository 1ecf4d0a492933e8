"""Tensor parallelism for serving, on the CPU: gloo ranks spawned with
``torch.multiprocessing`` (three spawns: world 2 on ``1x2``, world 4 on
``1x4`` and on ``2x2``; one intra-op thread a rank, each spawn joined
within its own timeout), every arch case run in each world.

The cases are reduced configs in f32: phi3 (heads divide M; its window
of 64 wrapped by a prompt of 96), smollm (2 K/V heads: one shared by two
ranks at M = 4), smollm with 3 heads (K/V heads padded with zero heads),
llava (vlm), mixtral (4 experts: the ff split), deepseek-v2-lite (MLA, a
dense first layer, 4 experts: the ff split; and with 16 experts:
expert-parallel), minicpm3 (MLA with query compression; and with 3
heads: padded), zamba2 (Mamba2 and its shared block), rwkv6 (RWKV-6;
and with 3 heads of 32 at d_model 96: a width 2 and 4 divide, heads they
do not, padded with zero heads, all of rank 3's zero at M = 4) and whisper (the encoder-decoder; and with 3 heads: padded, all of rank
3's heads zero at M = 4).  Every bias and norm scale is drawn nonzero
(:func:`nonzero_biases`, numpy, the same values on both sides), so a
bias added once a rank, or a norm read in part, shows.  What they hold:

- a rank's prefill and teacher-forced decode logits equal the world of
  1's (the same seed's whole model) within atol = rtol = 1e-5: only the
  order of the sums over the model group differs;
- a rank's model built from the reference's params through
  ``convert.model_params_from_numpy(..., group=)`` against the
  reference's ``Model.prefill`` / ``decode_step`` within atol = rtol =
  1e-4 (as tests/test_torch_models.py holds the whole models);
- ``serve --mesh 1x4`` / ``2x2`` / ``1x2 --backend gloo`` gives the greedy
  tokens of ``1x1``, for a dense, an MoE, the hybrid, the ssm and the
  audio family;
- Megatron's group functions' backward passes (world 2) against the
  whole product's gradients within 1e-5 of their largest.

In this process: ``Model.init(group=)`` keeps bitwise the blocks of the
whole init (each real head and each block where the whole leaf has it,
padding heads zero, Mamba2's packed ``w_in`` a segment at a time); the
packed ``w_in`` round-trips through ``shard_leaf`` / ``unshard_leaf``;
the ssm, hybrid and audio families init over a group and take a rank's
blocks as params; the vocab-parallel embedding and logits are bitwise
the whole ones; a world of 1 at ``1x4`` is bitwise ``1x1``; the head
layouts; one train step at ``2x2`` in a world of 1 (the whole model)
bitwise the ``2x1`` one; RWKV-6's heads padded with zero heads (the
split round trip, a reference train state cut to the padded blocks, and
every rwkv6-3b leaf's block at the reference's model axis of 16 from its
shapes alone); and the refusals (a split the vocab, Mamba2's heads or
state, or the ff do not allow).  The spawns also hold each rank's RWKV-6
decode state: its real heads the world-1 state's, its zero heads 0.  Training split over a model group:
``tests/test_torch_tp_train.py``.
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
from repro_torch.configs.base import GFLConfig
from repro_torch.configs.registry import get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch import serve, sharding
from repro_torch.launch.mesh import Mesh, init_world, make_test_mesh
from repro_torch.launch.steps import abstract_model, make_train_step
from repro_torch.models import layers
from repro_torch.models.flat import FlatView
from repro_torch.models.model import Model
from repro_torch.models.parallel import (ModelGroup, copy_to_group,
                                         gather_from_group,
                                         reduce_from_group)

JOIN_TIMEOUT_S = 240
SEED = 3
B, N_DEC = 2, 4
ATOL_WORLD1 = 1e-5
ATOL_REF = 1e-4
# name: (arch, reduced-config overrides, MoE overrides, prompt length)
CASES = {
    "phi3": ("phi3-mini-3.8b", {}, {}, 96),
    "smollm": ("smollm-135m", {}, {}, 24),
    "smollm-3heads": ("smollm-135m", {"num_heads": 3, "num_kv_heads": 3,
                                      "head_dim": 64}, {}, 24),
    "llava": ("llava-next-mistral-7b", {}, {}, 24),
    "mixtral": ("mixtral-8x7b", {}, {}, 24),
    "deepseek": ("deepseek-v2-lite-16b", {}, {}, 24),
    "deepseek-16experts": ("deepseek-v2-lite-16b", {}, {"num_experts": 16},
                           24),
    "minicpm3": ("minicpm3-4b", {}, {}, 24),
    "minicpm3-3heads": ("minicpm3-4b", {"num_heads": 3, "num_kv_heads": 3},
                        {}, 24),
    "zamba2": ("zamba2-1.2b", {}, {}, 24),
    "rwkv6": ("rwkv6-3b", {}, {}, 24),
    "rwkv6-3heads": ("rwkv6-3b", {"d_model": 96, "num_heads": 3,
                                  "num_kv_heads": 3, "head_dim": 32}, {}, 24),
    "whisper": ("whisper-tiny", {}, {}, 24),
    "whisper-3heads": ("whisper-tiny", {"num_heads": 3, "num_kv_heads": 3,
                                        "head_dim": 64}, {}, 24),
}
SPAWNS = {"1x2": 2, "1x4": 4, "2x2": 4}
# the cases whose ranks' RWKV-6 decode state is checked, head by head
STATE_CASES = ("rwkv6-3heads",)
SERVE_ARCHS = ("phi3-mini-3.8b", "deepseek-v2-lite-16b", "zamba2-1.2b",
               "rwkv6-3b", "whisper-tiny")
# the biases and norm scales every case draws nonzero (a scale about 1)
BIASES = ("bias", "b_in", "b_out", "conv_b", "dt_bias", "A_log")
SCALES = ("scale", "D", "ln_scale", "norm_scale", "q_norm", "kv_norm")


def _replace(cfg, name):
    _, over, moe_over, _ = CASES[name]
    if moe_over:
        over = dict(over, moe=dataclasses.replace(cfg.moe, **moe_over))
    return dataclasses.replace(cfg, **over)


def port_config(name):
    return _replace(get_config(CASES[name][0]).reduced(), name)


def case_inputs(name, cfg):
    """Tokens [B, S + N_DEC] (the last N_DEC fed to the decode steps) and
    a vlm's image embeddings or whisper's frames, numpy, from the prompt
    length's seed."""
    S = CASES[name][3]
    r = np.random.default_rng(S)
    toks = r.integers(0, cfg.vocab_size, (B, S + N_DEC)).astype(np.int32)
    return toks, stub_inputs(cfg, r, (B,))


def stub_inputs(cfg, r, lead) -> dict:
    """A vlm's image embeddings or whisper's frames behind the ``lead``
    dims, 0.1 N(0, 1) f32 from numpy's generator ``r``."""
    if cfg.family == "vlm":
        return {"image_embeds": (0.1 * r.standard_normal(
            lead + (cfg.num_image_tokens, cfg.d_model))).astype(np.float32)}
    if cfg.family == "audio":
        return {"frames": (0.1 * r.standard_normal(
            lead + (cfg.encoder_seq_len, cfg.d_model))).astype(np.float32)}
    return {}


def nonzero_biases(cfg) -> dict:
    """{reference path: whole value} of every bias and norm scale of
    ``cfg``'s model (a stack's for all its layers), numpy draws from
    SEED: 1 + 0.1 N(0, 1) for a scale (and Mamba2's D), 0.1 N(0, 1) for
    the rest."""
    r = np.random.default_rng(SEED)
    out = {}
    for k, (shape, _) in FlatView(abstract_model(cfg)).tree_shapes().items():
        name = k.rsplit("/", 1)[-1]
        if name in BIASES + SCALES:
            out[k] = (float(name in SCALES) + 0.1 * r.standard_normal(
                shape)).astype(np.float32)
    return out


def with_biases(model):
    """``model`` with :func:`nonzero_biases` in place of its biases and
    norm scales (the rank's blocks of them over its group)."""
    cfg = model.cfg
    vals = nonzero_biases(cfg)
    view = FlatView(model)
    with torch.no_grad():
        for lf in view.leaves:
            k = view.key(lf)
            if k not in vals:
                continue
            for i, pname in enumerate(lf.names):
                full = torch.from_numpy(vals[k][i] if view.stacked(lf)
                                        else vals[k])
                model.get_parameter(pname).copy_(sharding.shard_leaf(
                    k, full, cfg, model.group))
    return model


def tree_with_biases(tree: dict, cfg) -> dict:
    """The reference's param tree (numpy leaves, nested dicts) with
    :func:`nonzero_biases` in place of its biases and norm scales."""
    for k, v in nonzero_biases(cfg).items():
        *parts, leaf = k.split("/")
        node = tree
        for part in parts:
            node = node[part]
        assert node[leaf].shape == v.shape, k
        node[leaf] = v.astype(node[leaf].dtype)
    return tree


def nested_params(model) -> dict:
    """A model's parameters as the params tree ``Model(cfg, params)``
    takes (``blocks`` and ``enc_blocks`` a list of layers)."""
    out: dict = {}
    for name, p in model.named_parameters():
        keys, node = name.split("."), out
        if keys[0] in ("blocks", "enc_blocks"):
            stack = out.setdefault(keys[0], [])
            while len(stack) <= int(keys[1]):
                stack.append({})
            node, keys = stack[int(keys[1])], keys[2:]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = p.data
    return out


def run_model(model, name) -> torch.Tensor:
    """The prefill logits and N_DEC teacher-forced decode steps' logits,
    [1 + N_DEC, B, V]."""
    return run_case(model, name)[0]


def run_case(model, name):
    """:func:`run_model`'s logits and the decode cache after them."""
    S = CASES[name][3]
    toks, extra = case_inputs(name, model.cfg)
    toks = torch.tensor(toks, dtype=torch.int64)
    logits, cache = model.prefill(
        toks[:, :S], **{k: torch.tensor(v) for k, v in extra.items()})
    out = [logits]
    for t in range(N_DEC):
        logits, cache = model.decode_step(toks[:, S + t], cache)
        out.append(logits)
    return torch.stack(out), cache


def serve_args(arch):
    return ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "4",
            "--prompt-len", "16", "--new-tokens", "4", "--seed", "0"]


def backward_case(group):
    """x -> copy -> column-split A -> tanh -> row-split B -> reduce ->
    column-split C -> gather: the loss's gradient with respect to x and
    the gathered output (A, B, C drawn whole from one seed)."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((3, 8), generator=gen, requires_grad=True)
    A, Bw, C = (torch.randn(s, generator=gen) for s in
                ((8, 12), (12, 8), (8, 6)))
    M, i = (1, 0) if group is None else (group.size, group.index)
    a = A[:, i * 12 // M:(i + 1) * 12 // M]
    b = Bw[i * 12 // M:(i + 1) * 12 // M]
    c = C[:, i * 6 // M:(i + 1) * 6 // M]
    h = torch.tanh(copy_to_group(x, group) @ a) @ b
    y = gather_from_group(copy_to_group(reduce_from_group(h, group), group)
                          @ c, group)
    (y * torch.arange(6.0)).square().sum().backward()
    return x.grad, y.detach()


def _worker(rank, world, port, out_dir, spec, tree_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=JOIN_TIMEOUT_S))
    try:
        mesh = make_test_mesh(tuple(int(n) for n in spec.split("x")),
                              device="cpu", dist_backend="gloo")
        group = ModelGroup.of(mesh)
        trees = torch.load(tree_path, weights_only=False)
        out = {"group": (group.size, group.index)}
        for name in CASES:
            cfg = port_config(name)
            model = with_biases(Model.init(cfg, rng(SEED, "cpu"),
                                           group=group))
            out[("init", name)], cache = run_case(model, name)
            if name in STATE_CASES:
                out[("wkv", name)] = cache["wkv"]
            params = model_params_from_numpy(trees[name], cfg, "cpu", group)
            out[("ref", name)] = run_model(Model(cfg, params, group), name)
        for arch in SERVE_ARCHS:
            out[("serve", arch)] = serve.main(
                serve_args(arch) + ["--mesh", spec, "--backend", "gloo"])[
                    "tokens"]
        if world == 2:
            out["backward"] = backward_case(group)
        torch.save(out, Path(out_dir) / f"{spec}_{rank}.pt")
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(spec, out_dir, tree_path) -> list:
    """Every rank's results of the cases on mesh ``spec``, its world
    ``SPAWNS[spec]``.  The ranks inherit one OpenMP thread each."""
    world = SPAWNS[spec]
    omp = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        ctx = mp.start_processes(_worker, args=(world, _free_port(),
                                                str(out_dir), spec,
                                                str(tree_path)),
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
                raise TimeoutError(f"{spec}: ranks did not finish in "
                                   f"{JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(Path(out_dir) / f"{spec}_{r}.pt", weights_only=False)
            for r in range(world)]


# ------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Per case: the reference's init (numpy leaves, saved for the ranks)
    and its prefill and teacher-forced decode logits."""
    import functools

    import jax
    import jax.numpy as jnp

    from repro.configs import registry as ref_registry
    from repro.models import Model as RefModel
    from repro.models import attention as ref_attn
    from test_torch_models import _to_port_config

    trees, logits = {}, {}
    with pytest.MonkeyPatch.context() as mpatch:
        # the reference's window prefill needs chunk + window <= S
        # (tests/test_torch_models.py::test_short_prompt_window_prefill)
        mpatch.setattr(ref_attn, "gqa_forward",
                       functools.partial(ref_attn.gqa_forward, chunk=32))
        for name in CASES:
            cfg = _replace(ref_registry.get_config(CASES[name][0]).reduced(),
                           name)
            assert _to_port_config(cfg) == port_config(name), name
            ref = RefModel(cfg)
            trees[name] = tree_with_biases(jax.tree.map(
                np.array, ref.init(jax.random.PRNGKey(1))), port_config(name))
            params = jax.tree.map(jnp.asarray, trees[name])
            S = CASES[name][3]
            toks, extra = case_inputs(name, cfg)
            batch = {"tokens": jnp.asarray(toks[:, :S]),
                     **{k: jnp.asarray(v) for k, v in extra.items()}}
            want, cache = jax.jit(ref.prefill)(params, batch)
            out = [np.asarray(want)]
            decode = jax.jit(ref.decode_step)
            for t in range(N_DEC):
                want, cache = decode(params, jnp.asarray(toks[:, S + t]),
                                     cache)
                out.append(np.asarray(want))
            logits[name] = np.stack(out)
    path = tmp_path_factory.mktemp("tp_trees") / "trees.pt"
    torch.save(trees, path)
    return {"path": path, "logits": logits}


@pytest.fixture(scope="module")
def world1():
    """Per case: the whole model's logits (a world of 1), and the 1x1
    serve tokens."""
    out = {}
    for name in CASES:
        out[name], cache = run_case(with_biases(Model.init(
            port_config(name), rng(SEED, "cpu"))), name)
        if name in STATE_CASES:
            out[("wkv", name)] = cache["wkv"]
    out.update({("serve", arch): serve.main(serve_args(arch))["tokens"]
                for arch in SERVE_ARCHS})
    return out


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """Every spawn's ranks' results, spawned once each."""
    torch.set_num_threads(1)
    cache = {}

    def get(spec):
        if spec not in cache:
            cache[spec] = _spawn(spec, tmp_path_factory.mktemp(spec),
                                 reference["path"])
        return cache[spec]
    return get


# --------------------------------------------------------- spawned ranks


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("spec", list(SPAWNS))
def test_tp_logits_match_world1(spec, name, ranks, world1):
    got = ranks(spec)
    M = int(spec.split("x")[1])
    assert [r["group"] for r in got] == [
        (M, i % M) for i in range(SPAWNS[spec])]
    for r in got:
        torch.testing.assert_close(r[("init", name)], world1[name],
                                   atol=ATOL_WORLD1, rtol=ATOL_WORLD1)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("spec", list(SPAWNS))
def test_tp_rank_matches_reference(spec, name, ranks, reference):
    want = reference["logits"][name]
    for r in ranks(spec):
        np.testing.assert_allclose(r[("ref", name)].numpy(), want,
                                   atol=ATOL_REF, rtol=ATOL_REF,
                                   err_msg=f"{spec} {name}")


@pytest.mark.parametrize("name", STATE_CASES)
@pytest.mark.parametrize("spec", list(SPAWNS))
def test_rwkv_state_holds_the_ranks_heads_and_zero_pads(spec, name, ranks,
                                                        world1):
    """The decode state [L, B, heads, hs, hs] after the prefill and N_DEC
    steps: a rank's real heads hold the world-1 state's within 1e-5, its
    zero heads exactly 0."""
    cfg = port_config(name)
    want = world1[("wkv", name)]
    for r in ranks(spec):
        M, m = r["group"]
        mine = sharding.heads(cfg, M).q[m]
        got = r[("wkv", name)]
        assert got.shape[2] == len(mine), spec
        for i, j in enumerate(mine):
            if j < 0:
                assert not got[:, :, i].any(), (spec, m, i)
            else:
                torch.testing.assert_close(got[:, :, i], want[:, :, j],
                                           atol=ATOL_WORLD1,
                                           rtol=ATOL_WORLD1)
    if spec == "1x4":
        assert any(all(j < 0 for j in sharding.heads(cfg, 4).q[m])
                   for m in range(4))            # a rank of zero heads


@pytest.mark.parametrize("arch", SERVE_ARCHS)
@pytest.mark.parametrize("spec", list(SPAWNS))
def test_serve_mesh_same_greedy_tokens(spec, arch, ranks, world1):
    for r in ranks(spec):
        assert torch.equal(r[("serve", arch)], world1[("serve", arch)])


def test_group_functions_backward(ranks):
    want_grad, want_y = backward_case(None)
    for r in ranks("1x2"):
        grad, y = r["backward"]
        for got, want in ((y, want_y), (grad, want_grad)):
            scale = float(want.abs().max())
            torch.testing.assert_close(got, want, atol=1e-5 * scale,
                                       rtol=1e-5)


# ------------------------------------------------------------ in process


class _Partial(ModelGroup):
    """A rank of a model group whose sum over the group is left to the
    caller: ``all_reduce`` returns the rank's own term."""

    def all_reduce(self, x):
        return x


def _blocks_of(path, full, cfg, M):
    return [sharding.shard_leaf(path, full, cfg, _Partial(M, i))
            for i in range(M)]


def _assembled(path, full, cfg, M, blocks):
    """Checks the M blocks against the whole leaf: a block split is their
    concatenation; a head split holds each real head once, the same
    values, and zeros for a padding head."""
    dim = sharding.param_spec(path, cfg).index("model")
    hs = sharding._head_set(path, cfg, M)
    if hs is None:
        assert torch.equal(sharding.unshard_leaf(path, blocks, cfg, M),
                           full), path
        return
    mine, n = hs
    width = full.shape[dim] // n
    seen = set()
    for heads, block in zip(mine, blocks):
        for j, head in enumerate(heads):
            got = block.narrow(dim, j * width, width)
            if head < 0:
                assert not got.any(), path
            else:
                assert torch.equal(got, full.narrow(dim, head * width,
                                                    width)), path
                seen.add(head)
    assert seen == set(range(n)), path


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_init_keeps_the_blocks_of_the_whole_init(name, M):
    cfg = port_config(name)
    whole = dict(Model.init(cfg, rng(SEED, "cpu")).named_parameters())
    parts = [dict(Model.init(cfg, rng(SEED, "cpu"),
                             group=_Partial(M, i)).named_parameters())
             for i in range(M)]
    for key, full in whole.items():
        path = sharding_path(key)
        blocks = [p[key] for p in parts]
        assert all(b.shape == sharding.local_shape(path, full.shape, cfg, M)
                   for b in blocks), key
        if "model" not in sharding.param_spec(path, cfg):
            assert all(torch.equal(b, full) for b in blocks), key
        else:
            _assembled(path, full, cfg, M, blocks)
            assert all(torch.equal(b, s) for b, s in
                       zip(blocks, _blocks_of(path, full, cfg, M))), key


def sharding_path(key: str) -> str:
    """A ``named_parameters`` key (``blocks.3.attn.w_q``) as the
    reference's path (``blocks/attn/w_q``)."""
    parts = key.split(".")
    if parts[0] in ("blocks", "enc_blocks"):
        parts = parts[:1] + parts[2:]
    return "/".join(parts)


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("groups", [1, 2])
def test_packed_w_in_round_trips(groups, M):
    """Mamba2's packed ``w_in`` [d, 2 d_inner + 2 G N + H]: each rank's
    block holds its heads' z and x, N / M state columns of each group's B
    and C and its heads' dt, and ``unshard_leaf`` puts the blocks back
    bitwise, behind a server and a layer dim too."""
    cfg = port_config("zamba2")
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, ngroups=groups))
    s = cfg.ssm
    di, N = s.expand * cfg.d_model, s.state_dim
    H = di // s.headdim
    n = 2 * di + 2 * groups * N + H
    full = torch.randn((3, 2, cfg.d_model, n),
                       generator=torch.Generator().manual_seed(M))
    blocks = [sharding.shard_leaf("blocks/ssm/w_in", full, cfg,
                                  ModelGroup(M, m), lead=2)
              for m in range(M)]
    assert all(b.shape[-1] == n // M for b in blocks)
    assert torch.equal(sharding.unshard_leaf("blocks/ssm/w_in", blocks, cfg,
                                             M, lead=2), full)
    cols = torch.arange(n, dtype=torch.float32)[None]
    m, dl, nl = 1, di // M, N // M
    got = sharding.shard_leaf("blocks/ssm/w_in", cols, cfg, ModelGroup(M, m))
    want = (list(range(m * dl, (m + 1) * dl))
            + list(range(di + m * dl, di + (m + 1) * dl))
            + [2 * di + c * groups * N + g * N + j for c in range(2)
               for g in range(groups) for j in range(m * nl, (m + 1) * nl)]
            + list(range(n - H + m * H // M, n - H + (m + 1) * H // M)))
    assert got[0].tolist() == want


@pytest.mark.parametrize("name", ["smollm", "phi3"])   # tied, untied head
def test_vocab_parallel_embed_and_logits_are_bitwise(name):
    cfg = port_config(name)
    M = 4
    model = Model.init(cfg, rng(SEED, "cpu"))
    head = model.embed if cfg.tie_embeddings else model.lm_head
    fn = layers.unembed if cfg.tie_embeddings else layers.lm_head
    key = "table" if cfg.tie_embeddings else "w"
    path = ("embed/table" if cfg.tie_embeddings else "lm_head/w")
    toks = torch.randint(0, cfg.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(1))
    x = torch.randn((2, 9, cfg.d_model),
                    generator=torch.Generator().manual_seed(2))
    rows = _blocks_of("embed/table", model.embed["table"], cfg, M)
    got = sum(layers.embed({"table": t}, toks, _Partial(M, i))
              for i, t in enumerate(rows))
    assert torch.equal(got, layers.embed(model.embed, toks))
    cols = _blocks_of(path, head[key], cfg, M)
    got = sum(fn({key: t}, x, _Partial(M, i)) for i, t in enumerate(cols))
    assert torch.equal(got, fn(head, x))


def test_world1_at_1x4_is_1x1_bitwise():
    want = serve.main(serve_args("mixtral-8x7b"))
    got = serve.main(serve_args("mixtral-8x7b") + ["--mesh", "1x4"])
    assert torch.equal(got["tokens"], want["tokens"])
    assert torch.equal(got["logits"], want["logits"])


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b", "whisper-tiny"])
def test_split_families_init_over_a_model_group(arch):
    """The ssm, hybrid and audio families init over a model group and
    take a rank's blocks as params; a group their heads do not split
    raises, naming the leaf."""
    cfg = get_config(arch).reduced()
    whole = dict(Model.init(cfg, rng(0, "cpu")).named_parameters())
    half = Model.init(cfg, rng(0, "cpu"), group=ModelGroup(2, 0))
    quarter = Model(cfg, nested_params(Model.init(
        cfg, rng(0, "cpu"), group=ModelGroup(4, 1))), group=ModelGroup(4, 1))
    for model, M in ((half, 2), (quarter, 4)):
        assert dict(model.named_parameters()).keys() == whole.keys()
        for name, p in model.named_parameters():
            assert p.shape == sharding.local_shape(
                sharding_path(name), whole[name].shape, cfg, M), name
        assert sum(p.numel() for p in model.parameters()) < sum(
            p.numel() for p in whole.values())
    with pytest.raises(ValueError, match=r"^blocks/\S+: .* 3$"):
        Model.init(cfg, rng(0, "cpu"), group=ModelGroup(3, 0))


def test_train_step_runs_at_2x2_in_a_world_of_1():
    """A world of 1 holds the whole model at any model axis: one step at
    2x2 is bitwise the 2x1 step."""
    from repro_torch.data.synthetic import TokenStream, federated_token_batches
    from repro_torch.launch.steps import init_train_state
    cfg = get_config("smollm-135m").reduced()
    model = Model.init(cfg, rng(0, "cpu"))
    gfl = GFLConfig(topology="ring", privacy="hybrid", sigma_g=0.01, mu=0.1,
                    grad_bound=10.0, combine_impl="rotate")
    batch = federated_token_batches(TokenStream(vocab=cfg.vocab_size,
                                                seed=0), 0, 0, 2, 2, 2, 16)
    out = []
    for shape in ((2, 2), (2, 1)):
        mesh = make_test_mesh(shape, device="cpu")
        step = make_train_step(model, gfl, mesh, clients=2)
        state, m = step(init_train_state(model, gfl, mesh, 0), batch)
        out.append((state.params, float(m["loss"])))
    (got, got_loss), (want, want_loss) = out
    assert got_loss == want_loss and got.keys() == want.keys()
    assert all(torch.equal(got[k], v) for k, v in want.items())


@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (4, 1), (9, 3), (32, 8),
                                  (40, 40), (32, 32), (3, 3), (8, 2)])
@pytest.mark.parametrize("M", [1, 2, 4, 8, 16])
def test_gqa_head_layouts(h, kv, M):
    """Every rank the same count of query and K/V heads, each real query
    head on exactly one rank beside the K/V head it reads, padding heads
    only in whole K/V groups."""
    lay = sharding.gqa_heads(h, kv, M)
    G = h // kv
    assert len(lay.q) == len(lay.kv) == M
    assert len({len(q) for q in lay.q}) == len({len(k) for k in lay.kv}) == 1
    got = sorted(j for q in lay.q for j in q if j >= 0)
    assert got == list(range(h))
    for q, k in zip(lay.q, lay.kv):
        assert len(q) % len(k) == 0
        gl = len(q) // len(k)
        for i, j in enumerate(q):
            kvh = k[i // gl]
            assert (j < 0) == (kvh < 0)
            if j >= 0:
                assert j // G == kvh
    if M == 1:
        assert lay.q == (tuple(range(h)),) and lay.kv == (tuple(range(kv)),)


def test_mla_head_layouts():
    for h, M in ((16, 4), (40, 16), (3, 2), (4, 4)):
        q = sharding.mla_heads(h, M).q
        assert len({len(r) for r in q}) == 1
        assert sorted(j for r in q for j in r if j >= 0) == list(range(h))


@pytest.mark.parametrize("M", [2, 4, 16])
@pytest.mark.parametrize("path", ["blocks/att/w_r", "blocks/att/w_g",
                                  "blocks/att/w_o"])
def test_rwkv_head_split_round_trips(path, M):
    """RWKV-6's time-mixing products split by whole heads padded with zero
    heads (3 heads over 2, 4 and 16 ranks): each block holds its real
    heads bitwise and zeros for its pads, and ``unshard_leaf`` drops the
    pads and puts the whole leaf back bitwise, behind a server and a layer
    dim too."""
    cfg = port_config("rwkv6-3heads")
    d = cfg.d_model
    full = torch.randn((2, 3, d, d),
                       generator=torch.Generator().manual_seed(M))
    blocks = [sharding.shard_leaf(path, full, cfg, ModelGroup(M, m), lead=2)
              for m in range(M)]
    want = sharding.local_shape(path, (d, d), cfg, M)
    assert all(b.shape == (2, 3) + want for b in blocks)
    assert sharding.multiplicity(path, cfg, M) == 1
    assert torch.equal(sharding.unshard_leaf(path, blocks, cfg, M, lead=2),
                       full)
    _assembled(path, full[1, 2], cfg, M, [b[1, 2] for b in blocks])


def test_rwkv6_3b_splits_over_the_references_model_axis():
    """rwkv6-3b at a model group of 16, from its shapes alone (nothing
    allocated): 40 heads padded to 48, 3 a rank (rank 13 holds head 39
    and two zero heads, ranks 14 and 15 zero heads only), the time-mixing
    products 192 columns (rows of ``w_o``) a rank, the channel mix's ff
    and the vocab a flat 1/16, every other leaf whole."""
    from repro_torch.convert import tree_shapes
    from repro_torch.models.model import check_supported
    from repro_torch.models.rwkv import rwkv_dims
    cfg = get_config("rwkv6-3b")
    check_supported(cfg, 16)
    q = sharding.heads(cfg, 16).q
    assert q[0] == (0, 1, 2) and q[13] == (39, -1, -1)
    assert q[14] == q[15] == (-1, -1, -1)
    assert rwkv_dims(cfg, ModelGroup(16, 13)) == (3, 64)
    top, stacks = tree_shapes(cfg)
    leaves = {"/".join(("blocks",) + p): s
              for p, s in stacks["blocks"][1].items()}
    leaves.update({"/".join(p): s for p, s in top.items()})
    want = {"blocks/att/w_r": (2560, 192), "blocks/att/w_k": (2560, 192),
            "blocks/att/w_v": (2560, 192), "blocks/att/w_g": (2560, 192),
            "blocks/att/w_o": (192, 2560), "blocks/ffn/w_k": (2560, 560),
            "blocks/ffn/w_v": (560, 2560), "embed/table": (4096, 2560),
            "lm_head/w": (2560, 4096)}
    assert want.keys() <= leaves.keys()
    for path, shape in leaves.items():
        assert sharding.local_shape(path, shape, cfg, 16) == want.get(
            path, tuple(shape)), path


@pytest.mark.parametrize("M", [2, 4])
def test_rwkv_train_state_cuts_to_the_padded_layout(M):
    """``convert.train_params_from_numpy`` cuts a reference train state
    ([P, ...] leaves) of the 3-head RWKV-6 to a rank's padded blocks: each
    the rank's server row of ``shard_leaf``'s block, zero heads 0."""
    from repro_torch.convert import train_params_from_numpy
    cfg = port_config("rwkv6-3heads")
    model = with_biases(Model.init(cfg, rng(SEED, "cpu")))
    whole = FlatView(model).tree(model)
    tree = {k: np.stack([v.numpy(), 2 * v.numpy()]) for k, v in
            whole.items()}
    for m in range(M):
        group = ModelGroup(M, m)
        got = train_params_from_numpy(tree, cfg, range(1, 2), "cpu",
                                      group=group)
        assert got.keys() == whole.keys()
        for k, v in whole.items():
            want = sharding.shard_leaf(k, 2 * v, cfg, group,
                                       lead=sharding.stack_lead(k))
            assert torch.equal(got[k][0], want), (m, k)


def test_uneven_split_raises_naming_the_leaf():
    cfg = port_config("phi3")
    with pytest.raises(ValueError, match=r"embed/table.* 3"):
        sharding.shard_leaf("embed/table", torch.zeros(512, 4), cfg,
                            ModelGroup(3, 0))
    with pytest.raises(ValueError, match=r"mlp/w_down.* 3"):
        sharding.local_shape("blocks/mlp/w_down", (512, 256), cfg, 3)


def test_mesh_backend_is_the_callers():
    with pytest.raises(ValueError, match="backend"):
        Mesh((1, 2), ("data", "model"), backend="mpi")
    with pytest.raises(ValueError, match="nccl"):
        init_world("cpu", "nccl")
    assert init_world("cpu", "gloo") == torch.device("cpu")
    mesh = make_test_mesh((1, 4), device="cpu", dist_backend="gloo")
    assert mesh.backend == "gloo" and ModelGroup.of(mesh) is None
