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


def raw_stream(index: int) -> int:
    """The raw handle of the current stream on card ``index``, read without
    building a ``torch.cuda.Stream`` object (the binding torch's own
    generated kernels launch with)."""
    return torch._C._cuda_getCurrentRawStream(index)


def stream_handle(t: torch.Tensor) -> int:
    return raw_stream(t.device.index)
