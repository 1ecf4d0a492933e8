"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's: the same npz + manifest format and path keys, so either
package loads the other's checkpoints bit-exactly (bf16 and float8
included); both reject extra and missing keys; the publish is
crash-atomic."""
import json
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import io as ref_io
from repro.core.gfl import GFLState as RefState
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.checkpoint import io as port_io
from repro_torch.core.gfl import GFLState


class State(NamedTuple):
    """The reference's GFLState's fields, with torch leaves."""
    params: torch.Tensor
    step: torch.Tensor
    key: torch.Tensor


def _numbers(seed=0):
    rng = np.random.default_rng(seed)
    return {"f32": rng.normal(size=(3, 4)).astype(np.float32),
            "f64": rng.normal(size=5),
            "i32": np.arange(6, dtype=np.int32) - 3,
            "bf16": rng.normal(size=(2, 3)).astype(ml_dtypes.bfloat16),
            "params": rng.normal(size=(3, 2)).astype(np.float32)}


def _ref_tree(n):
    return {"f32": jnp.asarray(n["f32"]), "f64": n["f64"],
            "i32": jnp.asarray(n["i32"]), "bf16": jnp.asarray(n["bf16"]),
            "state": RefState(jnp.asarray(n["params"]), jnp.int32(7),
                              jax.random.PRNGKey(3)),
            "seq": [jnp.ones(2), (jnp.zeros(1),)]}


def _port_tree(n, device="cpu"):
    bf = torch.from_numpy(n["bf16"].view(np.int16).copy()).view(
        torch.bfloat16)
    return {"f32": torch.from_numpy(n["f32"]).to(device), "f64": n["f64"],
            "i32": torch.from_numpy(n["i32"]).to(device), "bf16": bf,
            "state": State(torch.from_numpy(n["params"]),
                           torch.tensor(7, dtype=torch.int32),
                           torch.tensor([0, 3], dtype=torch.uint32)),
            "seq": [torch.ones(2), (torch.zeros(1),)]}


def _like(tree):
    """The same structure with zeroed leaves of the same dtype."""
    if isinstance(tree, dict):
        return {k: _like(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_like(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_like(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    if isinstance(tree, np.ndarray):
        return np.zeros_like(tree)
    return jnp.zeros_like(tree)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    if x.dtype.kind not in "biufc":
        return x.view({1: np.uint8, 2: np.uint16}[x.dtype.itemsize])
    return x


def test_paths_are_the_references():
    n = _numbers()
    ref_keys = list(ref_io._flatten_with_paths(_ref_tree(n)))
    port_keys = list(port_io._flatten_with_paths(_port_tree(n)))
    assert port_keys == ref_keys
    assert "state/.params" in port_keys and "seq/1/0" in port_keys
    nested = {"b": None, "a": GFLState(torch.zeros(2), 3)}
    assert list(port_io._flatten_with_paths(nested)) == ["a/.params",
                                                         "a/.step"]


def test_reference_checkpoint_loads_bit_exactly(tmp_path):
    n = _numbers()
    ref_io.save_checkpoint(str(tmp_path / "ck"), _ref_tree(n), step=11)
    like = _like(_port_tree(n))
    got, step = load_checkpoint(str(tmp_path / "ck"), like)
    assert step == 11
    assert got["f64"].dtype == np.float64 and isinstance(got["f64"],
                                                         np.ndarray)
    assert got["bf16"].dtype == torch.bfloat16
    for k in ("f32", "f64", "i32", "bf16"):
        assert np.array_equal(_bits(got[k]), _bits(n[k])), k
    assert isinstance(got["state"], State)
    assert np.array_equal(_bits(got["state"].params), n["params"])
    assert int(got["state"].step) == 7
    assert np.array_equal(_bits(got["state"].key),
                          np.asarray(jax.random.PRNGKey(3)))
    assert isinstance(got["seq"], list) and isinstance(got["seq"][1], tuple)


def test_port_checkpoint_loads_bit_exactly_in_the_reference(tmp_path):
    n = _numbers(1)
    save_checkpoint(str(tmp_path / "ck"), _port_tree(n), step=5)
    manifest = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    assert manifest["dtypes"]["bf16"] == "bfloat16"
    got, step = ref_io.load_checkpoint(str(tmp_path / "ck"),
                                       _like(_ref_tree(n)))
    assert step == 5
    for k in ("f32", "f64", "i32", "bf16"):
        assert np.array_equal(_bits(got[k]), _bits(n[k])), k
    assert got["bf16"].dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(got["state"].params), n["params"])


def test_float8_round_trips_both_ways(tmp_path):
    x = torch.linspace(-3, 3, 12).to(torch.float8_e4m3fn)
    save_checkpoint(str(tmp_path / "a"), {"x": x})
    got, _ = load_checkpoint(str(tmp_path / "a"), {"x": torch.zeros_like(x)})
    assert torch.equal(got["x"].view(torch.uint8), x.view(torch.uint8))
    ref, _ = ref_io.load_checkpoint(str(tmp_path / "a"), {
        "x": jnp.zeros(12, jnp.float8_e4m3fn)})
    assert np.array_equal(np.asarray(ref["x"]).view(np.uint8),
                          x.view(torch.uint8).numpy())


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_extra_and_missing_keys_rejected(writer, tmp_path):
    path = str(tmp_path / "ck")
    if writer == "port":
        save_checkpoint(path, {"a": torch.ones(2), "b": torch.zeros(3)})
    else:
        ref_io.save_checkpoint(path, {"a": jnp.ones(2), "b": jnp.zeros(3)})
    for load, tensor in ((load_checkpoint, torch.zeros),
                         (ref_io.load_checkpoint, jnp.zeros)):
        with pytest.raises(ValueError, match="missing keys"):
            load(path, {"a": tensor(2), "b": tensor(3), "c": tensor(1)})
        with pytest.raises(ValueError, match="keys the restore target "
                                             "does not"):
            load(path, {"a": tensor(2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(path, {"a": torch.zeros(3), "b": torch.zeros(3)})


def test_publish_is_atomic_and_replaces(tmp_path):
    path = str(tmp_path / "ck")
    save_checkpoint(path, {"w": torch.ones(3)}, step=1)
    os.makedirs(f"{path}.tmp-{os.getpid()}")      # an orphaned stage
    save_checkpoint(path, {"w": torch.full((3,), 2.0)}, step=2)
    got, step = load_checkpoint(path, {"w": torch.zeros(3)})
    assert step == 2 and torch.equal(got["w"], torch.full((3,), 2.0))
    assert sorted(os.listdir(tmp_path)) == ["ck"]
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"]


def test_scalars_none_and_dtype_of_the_like_leaf(tmp_path):
    tree = {"n": 3, "x": 0.5, "none": None,
            "t": torch.arange(4, dtype=torch.float64)}
    save_checkpoint(str(tmp_path / "ck"), tree)
    like = {"n": 0, "x": 0.0, "none": None,
            "t": torch.zeros(4, dtype=torch.float32)}
    got, _ = load_checkpoint(str(tmp_path / "ck"), like)
    assert got["n"] == 3 and isinstance(got["n"], int)
    assert got["x"] == 0.5 and got["none"] is None
    assert got["t"].dtype == torch.float32
    assert torch.equal(got["t"], torch.arange(4, dtype=torch.float32))
