"""The mesh's partition specs (``repro_torch.launch.sharding``) and input
and parameter specs (``repro_torch.launch.steps``) against the
reference's, entry for entry: ``param_spec`` for every leaf of every arch
(with and without server axes, and with ``model_axis=None``),
``cache_specs`` and ``batch_specs`` for every family, and ``input_specs``
and ``params_specs`` for every arch and every ``INPUT_SHAPES`` entry —
shapes, dtypes and specs (the reference's ``tests/test_dryrun.py:156``).

The reference builds its specs on a ``jax.sharding.AbstractMesh`` of the
production shape, so no device is forced; the port's come from fake
tensors (``steps.abstract_model``), so nothing is allocated at any size.
"""
import jax
import pytest
import torch
from jax._src.named_sharding import DuplicateSpecError
from jax.sharding import AbstractMesh

from repro.configs.base import GFLConfig as RefGFLConfig
from repro.configs.base import INPUT_SHAPES as REF_SHAPES
from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as ref_get_config
from repro.launch import sharding as ref_shd
from repro.launch import steps as ref_steps
from repro.models import Model as RefModel
from repro_torch.configs.base import INPUT_SHAPES, GFLConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch.mesh import (make_production_mesh, make_test_mesh,
                                     num_servers, server_axes)
from repro_torch.models.flat import FlatView

ARCHS = [a for a in ARCH_IDS if a != "gfl-logreg"]
MESHES = {"production": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
FAMILIES = {}
for _a in ARCHS:
    FAMILIES.setdefault((ref_get_config(_a).family,
                         ref_get_config(_a).attention), _a)


def _ref_mesh(kind):
    return AbstractMesh(*MESHES[kind])


def _port_mesh(kind):
    return (make_production_mesh() if kind == "production"
            else make_production_mesh(multi_pod=True))


def _spec(p):
    return tuple(p)


def _dtype(dt):
    return str(dt).replace("torch.", "")


_MODELS = {}


def _models(arch):
    """(reference model, port model on fake tensors), built once."""
    if arch not in _MODELS:
        _MODELS[arch] = (RefModel(ref_get_config(arch)),
                         steps.abstract_model(get_config(arch)))
    return _MODELS[arch]


def _ref_paths(arch):
    shapes = jax.eval_shape(_models(arch)[0].init, jax.random.PRNGKey(0))
    return {ref_shd._path_str(path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}


def test_input_shapes_are_the_references():
    assert {k: tuple(v.__dict__.values()) for k, v in INPUT_SHAPES.items()} \
        == {k: tuple(v.__dict__.values()) for k, v in REF_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_every_leaf(arch):
    cfg, pcfg = ref_get_config(arch), get_config(arch)
    paths = _ref_paths(arch)
    port_tree = FlatView(_models(arch)[1]).tree_shapes()
    assert set(port_tree) == set(paths)
    cases = [dict(), dict(stacked=True),
             dict(stacked=True, server_axes=("data",)),
             dict(stacked=True, server_axes=("pod", "data")),
             dict(stacked=True, server_axes=("data",), model_axis=None),
             dict(model_axis=None)]
    for ps in paths:
        for kw in cases:
            assert shd.param_spec(ps, pcfg, **kw) == _spec(
                ref_shd.param_spec(ps, cfg, **kw)), (ps, kw)


@pytest.mark.parametrize("kind", list(MESHES))
@pytest.mark.parametrize("family", list(FAMILIES), ids=lambda f: "-".join(f))
def test_cache_and_batch_specs_every_family(family, kind):
    arch = FAMILIES[family]
    cfg, pcfg = ref_get_config(arch), get_config(arch)
    rm, pm = _ref_mesh(kind), _port_mesh(kind)
    for shard_seq in (False, True):
        want = ref_shd.cache_specs(cfg, rm, shard_seq=shard_seq)
        got = shd.cache_specs(pcfg, pm, shard_seq=shard_seq)
        assert got == {k: _spec(v) for k, v in want.items()}, shard_seq
        assert shd.cache_shardings(got, pcfg, pm, shard_seq=shard_seq) \
            == got
    for kw in (dict(kind="prefill"), dict(kind="train", gfl_train=True),
               dict(kind="train", gfl_train=True, client_parallel=True)):
        want = ref_shd.batch_specs(cfg, rm, **kw)
        assert shd.batch_specs(pcfg, pm, **kw) == \
            {k: _spec(v) for k, v in want.items()}, kw


def _flat_specs(tree):
    """{path: (shape, dtype, spec)} of a reference ShapeDtypeStruct tree."""
    return {ref_shd._path_str(path): (tuple(leaf.shape), str(leaf.dtype),
                                      _spec(leaf.sharding.spec))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_flat(specs, prefix=""):
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out.update(_port_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = (tuple(v.shape), _dtype(v.dtype), v.spec)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_params_specs_every_shape(arch):
    ref_model, port_model = _models(arch)
    rm, pm = _ref_mesh("production"), _port_mesh("production")
    refused = []
    for name, shape in REF_SHAPES.items():
        for cp in (False, True):
            got = _port_flat(steps.input_specs(
                port_model, INPUT_SHAPES[name], pm,
                gfl=GFLConfig(client_parallel=cp)))
            try:
                want = _flat_specs(ref_steps.input_specs(
                    ref_model, shape, rm,
                    gfl=RefGFLConfig(client_parallel=cp)))
            except DuplicateSpecError:
                # the reference's client-parallel train batch names "model"
                # twice for image embeddings and frames, which its
                # NamedSharding refuses; the raw specs are held equal by
                # test_cache_and_batch_specs_every_family
                refused.append((name, cp))
                continue
            assert got == want, (name, cp)
    assert all(cp and INPUT_SHAPES[n].kind == "train" and
               port_model.cfg.family in ("vlm", "audio")
               for n, cp in refused), refused
    for gfl_train in (False, True):
        for cp in (False, True):
            sds, shardings = ref_steps.params_specs(
                ref_model, rm, gfl_train=gfl_train, client_parallel=cp)
            got, got_specs = steps.params_specs(
                port_model, pm, gfl_train=gfl_train, client_parallel=cp)
            assert _port_flat(got) == _flat_specs(sds), (gfl_train, cp)
            assert got_specs == {k: s for k, (_, _, s) in
                                 _port_flat(got).items()}


def test_sanitize_and_train_batch_shape():
    rm, pm = _ref_mesh("production"), _port_mesh("production")
    from jax.sharding import PartitionSpec as P
    for shape, spec in [((4, 2047, 32), P(None, "data", "model")),
                        ((32, 16), P(("data", "model"))),
                        ((), P()), ((7,), P("model"))]:
        assert steps.sanitize_spec(shape, _spec(spec), pm) == _spec(
            ref_steps.sanitize_spec(shape, spec, rm))
    for name, shape in REF_SHAPES.items():
        for n, c in ((16, 4), (256, 4), (32, 1), (4, 2)):
            try:
                want = ref_steps.train_batch_shape(
                    ref_get_config("smollm-135m"), shape, n, c)
            except ZeroDivisionError:       # fewer sequences than servers
                with pytest.raises(ZeroDivisionError):
                    steps.train_batch_shape(get_config("smollm-135m"),
                                            INPUT_SHAPES[name], n, c)
                continue
            assert steps.train_batch_shape(get_config("smollm-135m"),
                                           INPUT_SHAPES[name], n, c) == want


def test_abstract_model_allocates_nothing_and_leaves_no_fakes():
    """The fake init of the largest arch takes no real memory, and a real
    CPU model built after it computes as before."""
    import gc
    m = steps.abstract_model(get_config("mixtral-8x7b"))
    assert sum(p.numel() for p in m.parameters()) > 4e10
    del m
    gc.collect()
    from repro_torch import rng
    from repro_torch.models.model import Model
    cfg = get_config("smollm-135m").reduced()
    a = Model.init(cfg, rng(0, "cpu"))
    tok = torch.zeros((1, 8), dtype=torch.int64)
    assert torch.isfinite(a.forward(tok)).all()


def test_test_mesh_axes():
    m = make_test_mesh((3, 2, 1), ("pod", "data", "model"))
    assert num_servers(m) == 6
    assert server_axes(m) == ("pod", "data")
