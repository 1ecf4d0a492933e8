"""Argument checks and device dispatch shared by the kernel wrappers."""
from __future__ import annotations

import torch

FLOAT_TYPES = (torch.float32, torch.bfloat16)


def on_cuda(*tensors) -> bool:
    """True when the tensors lie on a CUDA device, False on the CPU; raises
    on a mix of devices or any other device type."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"kernel operands on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {dev}")


def check(t: torch.Tensor, name: str, shape, dtypes) -> None:
    """Raise unless ``t`` has ``shape`` (None entries match anything), one
    of ``dtypes`` and a contiguous layout."""
    if t.dim() != len(shape) or any(
            s is not None and s != n for s, n in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def operand(t: torch.Tensor, name: str, shape: tuple, dtypes,
            device: torch.device) -> None:
    """Raise unless ``t`` has exactly ``shape``, one of ``dtypes``, lies on
    ``device`` and is contiguous: a fixed number of attribute reads, for
    the wrappers the main path calls once a round, where host time is the
    cost."""
    if t.shape != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def raw_stream(index: int) -> int:
    """The raw handle of the current stream on card ``index``, read without
    building a ``torch.cuda.Stream`` object (the binding torch's own
    generated kernels launch with)."""
    return torch._C._cuda_getCurrentRawStream(index)


def stream_handle(t: torch.Tensor) -> int:
    return raw_stream(t.device.index)


def stream_workspace(cache: dict, device: torch.device, key: tuple, make):
    """(``make()``'s workspace, raw stream) for a launch at ``key`` on the
    current stream of ``device``.

    The kernels that keep integer tickets (K1's split layout, K6's grid
    barrier, K8 at S > 1) leave them at zero after every launch, so one
    workspace serves every launch in one stream's order.  Workspaces are
    therefore cached per (device, stream, key): launches on two streams
    never share tickets, and may overlap.  Under CUDA-graph capture the
    cache is neither read nor written: each captured launch gets a
    workspace of its own, allocated from the graph's private pool and
    zeroed by a node of the graph (``make`` allocates with
    ``torch.zeros``), so every replay starts at zero on whatever stream it
    runs, beside any eager launch.  The caller must hold the workspace's
    tensors until its launch is enqueued (captured), and need not after:
    the pool keeps their memory for the graph's replays and gives it back
    when the graph is freed.  A later allocation of the
    same capture may reuse it, after the launch in stream order, and each
    replay zeroes it again before the launch."""
    stream = raw_stream(device.index)
    if torch.cuda.is_current_stream_capturing():
        return make(), stream
    full = (device.index, stream, *key)
    hit = cache.get(full)
    if hit is None:
        hit = cache[full] = make()
    return hit, stream
