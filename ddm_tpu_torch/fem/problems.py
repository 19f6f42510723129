"""Model problems: PDE coefficients as torch callables.

Counterpart of ``ddm_tpu/fem/problems.py`` (reference: examples/poisson.hh
PoissonModelProblem / IslandsModelProblem, examples/poisson_coefficient.lua,
examples/convection_diffusion_coefficient.lua, examples/convectiondiffusiondg.hh,
examples/coefficient.lua + linearelasticity.{cc,hh}).
Callables are vectorized: coordinates arrive as (..., d) float64 tensors and
return (...) tensors on the same device ((..., d) for vector fields).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


def _ones(x):
    return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)


def _zeros(x):
    return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)


def _pick(cond, a: float, b: float, like):
    """``a`` where ``cond`` else ``b``, in ``like``'s dtype (two Python
    scalars alone would give torch's default float32)."""
    return torch.where(cond, torch.full_like(like, a), torch.full_like(like, b))


def _everywhere(x):
    return torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)


@dataclass
class Problem:
    """Scalar convection-diffusion problem description:
    a(u,v) = ∫ alpha ∇u·∇v + (b·∇u) v + c u v, rhs ∫ f v, u = g on the
    Dirichlet part of the boundary selected by ``is_dirichlet``.  ``b``
    (a (..., d) field) and ``c`` are None when absent."""

    alpha: Callable = _ones
    b: Callable | None = None
    c: Callable | None = None
    f: Callable = _zeros
    g: Callable = _zeros
    is_dirichlet: Callable = _everywhere
    name: str = "custom"
    symmetric: bool = True

    def symmetrized(self) -> "Problem":
        """Elliptic part only, convection dropped: the reference's
        ``make_elliptic`` flag for eigenproblem operators
        (convection_diffusion_problems.hh:54-66)."""
        return Problem(alpha=self.alpha, c=self.c, f=self.f, g=self.g,
                       is_dirichlet=self.is_dirichlet,
                       name=self.name + "_elliptic")


def simple() -> Problem:
    """α=1, f=1, g=0, Dirichlet everywhere (reference: PoissonModelProblem)."""
    return Problem(f=_ones, name="simple")


def beams() -> Problem:
    """The intended beams coefficient of PoissonModelProblem
    (poisson.hh:69-93): 8 vertical high-coefficient beams of width 0.02 with
    small hooks near y=0.95, contrast 1e6."""
    width = 0.02
    small, large = 1.0, 1e6
    nb, space = 8, 0.1

    def alpha(xq):
        x, y = xq[..., 0], xq[..., 1]
        hit = torch.zeros_like(x, dtype=torch.bool)
        for i in range(1, nb + 1):
            in_beam = (x >= i * space) & (x <= i * space + width)
            in_hook1 = ((y >= 0.95 - width) & (x >= i * space)
                        & (x <= i * space + 3 * width))
            in_hook2 = ((y >= 0.95 - 2 * width) & (x >= i * space + 2 * width)
                        & (x <= i * space + 3 * width))
            hit = hit | in_beam | in_hook1 | in_hook2
        return _pick((y <= 0.95) & hit, large, small, x)

    return Problem(alpha=alpha, f=_ones, name="beams")


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


def _constant_field(*values):
    """(..., d) convection field with the given constant components."""
    def b(xq):
        return torch.stack([torch.full_like(xq[..., 0], v) for v in values],
                           dim=-1)
    return b


def checkerboard_convection_diffusion(nx: int = 8, ny: int = 8) -> Problem:
    """convection_diffusion_coefficient.lua: nx x ny checkerboard alpha in
    {1e-6, 1}, convection b = (1/3, 1), Dirichlet at x=0 (g=1) and y=0
    (g=0).  Nonsymmetric."""

    def alpha(xq):
        ix = torch.floor(xq[..., 0] * nx).to(torch.int32)
        iy = torch.floor(xq[..., 1] * ny).to(torch.int32)
        return _pick(ix % 2 == iy % 2, 1.0, 1e-6, xq[..., 0])

    return Problem(
        alpha=alpha,
        b=_constant_field(1.0 / 3.0, 1.0),
        g=lambda x: _pick(x[..., 0] < 1e-6, 1.0, 0.0, x[..., 0]),
        is_dirichlet=lambda x: (x[..., 0] < 1e-6) | (x[..., 1] < 1e-6),
        name="checkerboard_cd",
        symmetric=False,
    )


def dg_heterogeneous() -> Problem:
    """The reference's DG test problem (examples/convectiondiffusiondg.hh):
    alpha = 0.01 with a 1e5 block in [0.3,0.4]^2, convection b = (1,1),
    Gaussian source at (0.2, 0.2), Dirichlet g=0 everywhere except the
    outflow sides x > 1-1e-6 and y > 1-1e-6."""

    def alpha(xq):
        x, y = xq[..., 0], xq[..., 1]
        return _pick((x > 0.3) & (x < 0.4) & (y > 0.3) & (y < 0.4), 1e5,
                     0.01, x)

    def f(xq):
        r2 = (xq[..., 0] - 0.2) ** 2 + (xq[..., 1] - 0.2) ** 2
        return 100.0 * torch.exp(-r2 / 0.05**2)

    return Problem(
        alpha=alpha,
        b=_constant_field(1.0, 1.0),
        f=f,
        is_dirichlet=lambda x: (x[..., 0] <= 1.0 - 1e-6)
        & (x[..., 1] <= 1.0 - 1e-6),
        name="dg_heterogeneous",
        symmetric=False,
    )


@dataclass
class ElasticityProblem:
    """Linear elasticity coefficients (reference: coefficient.lua +
    examples/linearelasticity.{cc,hh}: a steel-reinforced rubber bar).
    ``lam``/``mu`` map (..., d) points to (...) Lame parameters, ``f`` and
    ``g`` to (..., d) loads and boundary displacements."""

    lam: Callable
    mu: Callable
    f: Callable
    g: Callable
    is_dirichlet: Callable
    name: str = "elasticity"


def _steel_rubber(in_bar, d: int, name: str) -> ElasticityProblem:
    """Steel (E=2e11, nu=0.3) where ``in_bar`` holds, rubber (E=2e7,
    nu=0.45) elsewhere; clamped at x=0, gravity along the last axis."""

    def young_nu(xq):
        steel = in_bar(xq)
        x = xq[..., 0]
        return _pick(steel, 2e11, 2e7, x), _pick(steel, 0.3, 0.45, x)

    def lam(xq):
        E, nu = young_nu(xq)
        return E * nu / (1.0 + nu) / (1.0 - 2.0 * nu)

    def mu(xq):
        E, nu = young_nu(xq)
        return E / 2.0 / (1.0 + nu)

    def f(xq):
        out = xq.new_zeros(xq.shape[:-1] + (d,))
        out[..., d - 1] = -9.81 * 1e4
        return out

    return ElasticityProblem(
        lam=lam, mu=mu, f=f,
        g=lambda x: x.new_zeros(x.shape[:-1] + (d,)),
        is_dirichlet=lambda x: x[..., 0] < 1e-9,
        name=name,
    )


def steel_rubber_bar() -> ElasticityProblem:
    """coefficient.lua: 2x4 steel bars of radius 0.04 along x in [0,3] at
    y = 0.25 / 0.75, z = 0.3 / 0.6 / 0.9 / 1.2, in rubber."""
    bar_r = 0.04

    def in_bar(xq):
        x, y, z = xq[..., 0], xq[..., 1], xq[..., 2]
        bars_y = xq.new_tensor([0.25, 0.75])
        bars_z = xq.new_tensor([0.3, 0.6, 0.9, 1.2])
        d2 = ((y[..., None, None] - bars_y[:, None]) ** 2
              + (z[..., None, None] - bars_z[None, :]) ** 2)
        return ((d2 <= bar_r**2).any(dim=-1).any(dim=-1)
                & (x >= 0.0) & (x <= 3.0))

    return _steel_rubber(in_bar, 3, "steel_rubber_bar")


def steel_rubber_2d() -> ElasticityProblem:
    """2-D cross-section analogue of :func:`steel_rubber_bar`: steel strips
    of half-width 0.04 at y = 0.25 / 0.75 in rubber on [0,3]x[0,1], the same
    1e4 stiffness contrast."""
    bar_r = 0.04

    def in_bar(xq):
        x, y = xq[..., 0], xq[..., 1]
        bars_y = xq.new_tensor([0.25, 0.75])
        near = (torch.abs(y[..., None] - bars_y) <= bar_r).any(dim=-1)
        return near & (x >= 0.0) & (x <= 3.0)

    return _steel_rubber(in_bar, 2, "steel_rubber_2d")


PROBLEMS = {
    "simple": simple,
    "beams": beams,
    "islands": islands,
    "checkerboard_cd": checkerboard_convection_diffusion,
}
