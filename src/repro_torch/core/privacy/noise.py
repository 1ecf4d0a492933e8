"""Additive-noise samplers (Laplace and Gaussian), std-normalized.

Mirrors ``repro.core.privacy.noise``: the Laplace sampler draws
``Lap(0, sigma/sqrt 2)`` (variance sigma**2) by the inverse CDF on uniforms
in the open interval (-1/2 + 1e-7, 1/2 - 1e-7), the Gaussian one
``N(0, sigma**2)``.  Each sampler takes a :class:`torch.Generator` or the
uniforms / normals drawn in advance — the parity tests pass the
reference's own draws through the second door.  ``sigma`` is a Python
number or a 0-d f32 tensor on the device (a round's staged sigma); the
constants of a round are made once per device (:func:`f32_scalar`), so a
round copies nothing from the host.
"""
from __future__ import annotations

import torch

from repro_torch import constant_cache

LAPLACE_U_LO = -0.5 + 1e-7
LAPLACE_U_HI = 0.5 - 1e-7


def laplace_from_uniform(u: torch.Tensor, scale) -> torch.Tensor:
    """Inverse-CDF transform: u in (-1/2, 1/2) -> Lap(0, scale)."""
    return -scale * torch.sign(u) * torch.log1p(-2.0 * torch.abs(u))


def f32_scalar(x, device) -> torch.Tensor:
    """``x`` as a 0-d f32 tensor on ``device``.  A tensor (a round's
    staged sigma) passes through; a Python number is made once per
    (device, value) and kept (:func:`repro_torch.constant_cache`).  It is
    made by a fill on the device, not copied from the host: a copy from
    pageable memory waits for the device, which a round body may not do
    (gflint GFL003; an eager round under
    ``torch.cuda.set_sync_debug_mode("error")`` raises on it), and which a
    CUDA graph cannot capture."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return _f32_constant(torch.device(device), float(x))


@constant_cache
def _f32_constant(device: torch.device, x: float) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=device)


@constant_cache
def _sqrt2(device: torch.device) -> torch.Tensor:
    """f32 sqrt(2) as the reference computes it: the square root of an f32
    2, on the device, kept per device."""
    return _f32_constant(device, 2.0).sqrt()


def sample_laplace(shape, sigma, *, generator: torch.Generator | None = None,
                   uniforms: torch.Tensor | None = None,
                   dtype=torch.float32) -> torch.Tensor:
    """Lap(0, sigma/sqrt(2)), i.e. variance sigma**2, of ``shape``."""
    if uniforms is None:
        if generator is None:
            raise ValueError("sample_laplace needs a generator or uniforms")
        u = torch.rand(tuple(shape), generator=generator,
                       device=generator.device)
        u = u * (LAPLACE_U_HI - LAPLACE_U_LO) + LAPLACE_U_LO
    else:
        u = uniforms.to(torch.float32)
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"uniforms {tuple(u.shape)} != shape {shape}")
    b = f32_scalar(sigma, u.device) / _sqrt2(u.device)
    return laplace_from_uniform(u, b).to(dtype)


def sample_gaussian(shape, sigma, *, generator: torch.Generator | None = None,
                    normals: torch.Tensor | None = None,
                    dtype=torch.float32) -> torch.Tensor:
    """N(0, sigma**2) of ``shape`` — same std normalization as Laplace."""
    if normals is None:
        if generator is None:
            raise ValueError("sample_gaussian needs a generator or normals")
        z = torch.randn(tuple(shape), generator=generator,
                        device=generator.device)
    else:
        z = normals.to(torch.float32)
        if tuple(z.shape) != tuple(shape):
            raise ValueError(f"normals {tuple(z.shape)} != shape {shape}")
    return (z * f32_scalar(sigma, z.device)).to(dtype)


SAMPLERS = {
    "laplace": sample_laplace,
    "gaussian": sample_gaussian,
}


def get_sampler(distribution: str):
    """Resolve an additive-noise sampler by name ("laplace" | "gaussian")."""
    try:
        return SAMPLERS[distribution]
    except KeyError:
        raise ValueError(
            f"unknown noise distribution {distribution!r}; "
            f"expected one of {sorted(SAMPLERS)}") from None


def draw_noise(draws, step: int, stream: str, distribution: str, shape,
               sigma, dtype=torch.float32) -> torch.Tensor:
    """One additive-noise tensor from a run's draws (Laplace through its
    uniforms, Gaussian through its normals)."""
    get_sampler(distribution)            # raises on an unknown name
    if distribution == "laplace":
        noise = sample_laplace(shape, sigma,
                               uniforms=draws.laplace_uniform(step, stream,
                                                              shape),
                               dtype=dtype)
    else:
        noise = sample_gaussian(shape, sigma,
                                normals=draws.normal(step, stream, shape),
                                dtype=dtype)
    return noise
