"""Pytree checkpointing, npz + json manifest (port of
``repro.checkpoint.io``; either package reads the other's checkpoints).

Leaves are copied to the host and stored flat, keyed by their path in the
tree.  The paths are the strings the reference builds from jax's
``tree_flatten_with_path``: dict keys sorted and written as they are,
list and tuple items by index, NamedTuple fields as ``.name``, joined by
``/`` — ``{"a": GFLState(params, step)}`` gives ``a/.params`` and
``a/.step``.  ``None`` holds no leaf; anything else (a tensor, a numpy
array or scalar, a Python number) is a leaf.

Crash atomicity: a checkpoint directory is never observable half-written.
``save_checkpoint`` stages ``arrays.npz`` + ``manifest.json`` in a
``.tmp-<pid>`` sibling, fsyncs the manifest and publishes with
``os.replace`` (an existing checkpoint is first moved to ``.old-<pid>``,
since a rename cannot replace a non-empty directory): a reader sees the
previous complete checkpoint or the new one, never a torn mix.

Loads are exact-key: a manifest with extra keys OR missing ones relative
to the restore target is rejected.  ``bfloat16`` and ``float8_*`` leaves
round-trip bit-exactly: npz cannot hold them, so their bits are stored as
unsigned integers of their width and the manifest records the true
dtype, which loads map back to torch dtypes (``bfloat16`` bits through an
``int16`` view: torch's ``uint16`` support is thin).  Numpy leaves are
restored at their full dtype on the host; tensors onto the device and
dtype of the ``like`` leaf.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch

# manifest dtype names that npz cannot hold -> (torch dtype, storage width)
_EXTENDED = {
    "bfloat16": (torch.bfloat16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8),
    "float8_e4m3fnuz": (torch.float8_e4m3fnuz, np.uint8),
    "float8_e5m2fnuz": (torch.float8_e5m2fnuz, np.uint8),
}
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """[(path entry, child)] of an inner node, in jax's flatten order; None
    for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten_with_paths(tree, prefix=()) -> dict[str, Any]:
    flat: dict[str, Any] = {}
    if tree is None:
        return flat
    kids = _children(tree)
    if kids is None:
        flat["/".join(prefix)] = tree
        return flat
    for entry, child in kids:
        flat.update(_flatten_with_paths(child, prefix + (entry,)))
    return flat


def _unflatten(like, leaves: dict, prefix=()):
    """``like``'s structure with each leaf replaced from ``leaves``."""
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        return leaves["/".join(prefix)]
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves, prefix + (str(k),))
                for k in like}
    new = [_unflatten(child, leaves, prefix + (entry,))
           for entry, child in kids]
    if _is_namedtuple(like):
        return type(like)(*new)
    return type(like)(new)


def _sanitize(key: str) -> str:
    return key.replace("/", "·")  # npz entries cannot contain path seps


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(storable numpy array, manifest dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = str(t.dtype).split(".")[-1]
        if name in _EXTENDED:
            _, width = _EXTENDED[name]
            if width is np.uint16:
                return t.view(torch.int16).numpy().view(np.uint16), name
            return t.view(torch.uint8).numpy(), name
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "biufc":          # ml_dtypes (bf16/f8) kinds
        return arr.view(_UINT[arr.dtype.itemsize]), str(arr.dtype)
    return arr, str(arr.dtype)


def save_checkpoint(path: str, tree, step: int = 0) -> None:
    """Atomically write ``tree`` as a checkpoint directory at ``path``."""
    flat = _flatten_with_paths(tree)
    storable, dtypes, shapes = {}, {}, {}
    for k, v in flat.items():
        arr, name = _to_host(v)
        storable[_sanitize(k)] = arr
        dtypes[k] = name
        shapes[k] = list(arr.shape)
    manifest = {
        "step": step,
        "keys": sorted(flat.keys()),
        "shapes": shapes,
        "dtypes": dtypes,
    }

    # stage in a temp sibling, fsync, then publish with os.replace: a kill
    # mid-save can orphan the .tmp dir but never tear the published path
    path = path.rstrip(os.sep)
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **storable)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        if not os.path.exists(path):
            os.replace(tmp, path)        # fully atomic: rename into place
        else:
            # retire the old checkpoint first (path -> .old, tmp -> path):
            # a kill between the two renames leaves no live path but a
            # complete .old sibling to recover from, never a torn one
            old = f"{path}.old-{os.getpid()}"
            if os.path.isdir(old):
                shutil.rmtree(old)
            os.replace(path, old)
            os.replace(tmp, path)
            shutil.rmtree(old, ignore_errors=True)
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)


def _restore(arr: np.ndarray, name: str, leaf):
    """One stored array back at the like leaf's kind, device and dtype."""
    if isinstance(leaf, torch.Tensor):
        if name in _EXTENDED:
            dtype, width = _EXTENDED[name]
            bits = (arr.view(np.int16) if width is np.uint16
                    else arr.view(np.uint8))
            t = torch.from_numpy(bits.copy()).view(dtype)
        else:
            t = torch.from_numpy(arr.astype(name))   # a C-ordered copy
        return t.to(device=leaf.device, dtype=leaf.dtype)
    if name in _EXTENDED:
        true = getattr(leaf, "dtype", None)
        if true is None or str(true) != name:
            raise ValueError(f"a {name} leaf restores into a tensor or a "
                             f"numpy array of dtype {name}, not {leaf!r}")
        return arr.view(true)
    if isinstance(leaf, (np.ndarray, np.generic)):
        # numpy restore target: stay on the host at full precision
        return np.asarray(arr, dtype=leaf.dtype)
    if isinstance(leaf, (bool, int, float)):
        return type(leaf)(arr.item())
    return np.asarray(arr, dtype=name)


def load_checkpoint(path: str, like):
    """Restore into the structure of ``like`` (keys/shape/dtype validated).
    Returns (tree, step)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like = _flatten_with_paths(like)
    stored = set(manifest["keys"])
    missing = set(flat_like) - stored
    if missing:
        raise ValueError(
            f"checkpoint at {path} is missing keys required by the restore "
            f"target: {sorted(missing)[:5]} "
            f"({len(missing)} missing of {len(flat_like)})")
    extra = stored - set(flat_like)
    if extra:
        raise ValueError(
            f"checkpoint at {path} has keys the restore target does not: "
            f"{sorted(extra)[:5]} ({len(extra)} extra of {len(stored)}); "
            f"refusing to silently drop stored state — restore into a "
            f"matching structure")

    restored = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for k, leaf in flat_like.items():
            arr = data[_sanitize(k)]
            want = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
            if tuple(arr.shape) != want:
                raise ValueError(f"shape mismatch for {k}: ckpt "
                                 f"{arr.shape} vs {want}")
            restored[k] = _restore(arr, manifest["dtypes"][k], leaf)
    return _unflatten(like, restored), manifest["step"]
