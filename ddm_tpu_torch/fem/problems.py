"""Model problems: PDE coefficients as torch callables.

Counterpart of ``ddm_tpu/fem/problems.py`` (reference: examples/poisson.hh
PoissonModelProblem / IslandsModelProblem, examples/poisson_coefficient.lua).
Callables are vectorized: coordinates arrive as (..., d) float64 tensors and
return (...) tensors on the same device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


def _ones(x):
    return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)


def _zeros(x):
    return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)


def _everywhere(x):
    return torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)


@dataclass
class Problem:
    """Scalar diffusion problem description: a(u,v) = ∫ alpha ∇u·∇v,
    rhs ∫ f v, u = g on the Dirichlet part of the boundary selected by
    ``is_dirichlet``.  (The TPU package's convection and reaction terms are
    not ported.)"""

    alpha: Callable = _ones
    f: Callable = _zeros
    g: Callable = _zeros
    is_dirichlet: Callable = _everywhere
    name: str = "custom"


def simple() -> Problem:
    """α=1, f=1, g=0, Dirichlet everywhere (reference: PoissonModelProblem)."""
    return Problem(f=_ones, name="simple")


def islands() -> Problem:
    """IslandsModelProblem (poisson.hh:143-166) == poisson_coefficient.lua:
    diagonal bands, triangle region and a checkerboard of high-contrast
    islands; Dirichlet at x=0 and x=1 with g = 1-x, f = 0."""

    def alpha(xq):
        x, y = xq[..., 0], xq[..., 1]
        kappa = torch.ones_like(x)
        kappa = torch.where(
            (x > 0.3) & (x < 0.9) & (y > 0.6 - (x - 0.3) / 6)
            & (y < 0.8 - (x - 0.3) / 6),
            1e5 * (x + y) * 10.0,
            kappa,
        )
        kappa = torch.where(
            (x > 0.1) & (x < 0.5) & (y > 0.1 + x) & (y < 0.25 + x),
            1e5 * (1.0 + 7.0 * y),
            kappa,
        )
        kappa = torch.where(
            (x > 0.5) & (x < 0.9)
            & (y > 0.15 - (x - 0.5) * 0.25)
            & (y < 0.35 - (x - 0.5) * 0.25),
            torch.full_like(x, 1e5 * 2.5),
            kappa,
        )
        ix = torch.floor(15.0 * x).to(torch.int32)
        iy = torch.floor(15.0 * y).to(torch.int32)
        return torch.where(
            (ix % 2 == 0) & (iy % 2 == 0),
            1e5 * (1.0 + (ix + iy).to(x.dtype)),
            kappa,
        )

    return Problem(
        alpha=alpha,
        g=lambda x: 1.0 - x[..., 0],
        is_dirichlet=lambda x: (x[..., 0] < 1e-6) | (x[..., 0] > 1.0 - 1e-6),
        name="islands",
    )


PROBLEMS = {
    "simple": simple,
    "islands": islands,
}
