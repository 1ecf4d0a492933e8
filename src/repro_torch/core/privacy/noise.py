"""Additive-noise samplers (Laplace and Gaussian), std-normalized.

Mirrors ``repro.core.privacy.noise``: the Laplace sampler draws
``Lap(0, sigma/sqrt 2)`` (variance sigma**2) by the inverse CDF on uniforms
in the open interval (-1/2 + 1e-7, 1/2 - 1e-7), the Gaussian one
``N(0, sigma**2)``.  Each sampler takes a :class:`torch.Generator` or the
uniforms / normals drawn in advance — the parity tests pass the
reference's own draws through the second door.
"""
from __future__ import annotations

import torch

LAPLACE_U_LO = -0.5 + 1e-7
LAPLACE_U_HI = 0.5 - 1e-7


def laplace_from_uniform(u: torch.Tensor, scale) -> torch.Tensor:
    """Inverse-CDF transform: u in (-1/2, 1/2) -> Lap(0, scale)."""
    return -scale * torch.sign(u) * torch.log1p(-2.0 * torch.abs(u))


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


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
    b = _f32(sigma, u.device) / _f32(2.0, u.device).sqrt()
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
    return (z * _f32(sigma, z.device)).to(dtype)


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
