"""Nonlinear FEM: residual and Jacobian of -div(alpha grad u) + q(u) = f.

Counterpart of ``ddm_tpu/fem/nonlinear.py`` (reference: the
NonlinearPoissonFEM local operator, examples/nonlinearpoisson.hh:17-137,
there with numerical Jacobians); here the Jacobian is exact and batched:

    r_i(u)  = sum_e int alpha grad u_h . grad phi_i + q(u_h) phi_i - f phi_i
    J_ij(u) = A_laplace + sum_e int q'(u_h) phi_i phi_j

The sparsity pattern, the assembly plans and the element geometry are built
once; each iterate only re-evaluates q and q' at the quadrature points and
re-sums through the fixed-order plans.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Callable

import torch

from ..core.sparse import SparseELL, eliminate_dirichlet
from .assemble import element_geometry
from .discretize import Discretization
from .problems import Problem, _everywhere, _ones, _zeros


def _square(u):
    return u * u


def _twice(u):
    return 2.0 * u


def _norm2(x):
    return torch.sum(x * x, dim=-1)


@dataclass
class NonlinearProblem:
    """-div(alpha grad u) + q(u) = f, u = g on the Dirichlet boundary.

    Reference instance (nonlinearpoisson.cc:36): q(u) = eta * u^2,
    f = |x|^2, g = 0.  Callables take and return torch tensors."""

    alpha: Callable = _ones
    q: Callable = _square
    dq: Callable = _twice
    f: Callable = _norm2
    g: Callable = _zeros
    is_dirichlet: Callable = _everywhere
    name: str = "nonlinear_poisson"

    def linearized(self) -> Problem:
        """The alpha part only."""
        return Problem(alpha=self.alpha, f=self.f, g=self.g,
                       is_dirichlet=self.is_dirichlet, name=self.name + "_lin")


class NonlinearDiscretization(Discretization):
    """Discretization whose operator depends on the current iterate."""

    def __init__(self, grid, problem: NonlinearProblem, device,
                 degree: int = 1):
        super().__init__(grid, problem.linearized(), device, n_comp=1,
                         degree=degree)
        self.nl = problem
        self._elems_t = torch.as_tensor(self._elem_nodes, device=self.device)

    @cached_property
    def _fixed_terms(self):
        """The iterate-independent parts per element: |det J| * weights at
        the quadrature points, the alpha stiffness and the load."""
        xq, grads, jxw = element_geometry(self.quad, self.xe)
        Ke = torch.einsum("eq,eqig,eqjg->eij", jxw * self.nl.alpha(xq),
                          grads, grads)
        fe = torch.einsum("eq,qi->ei", jxw * self.nl.f(xq), self.quad.phi)
        return jxw, Ke, fe

    def residual_jacobian(self, u: torch.Tensor) -> tuple[torch.Tensor, SparseELL]:
        """(r, J) at iterate ``u``, both honoring the Dirichlet constraints:
        the residual zeroed and the Jacobian symmetrically eliminated at
        Dirichlet dofs."""
        jxw, Ke, fe = self._fixed_terms
        phi = self.quad.phi
        u_e = u[self._elems_t]  # (n_e, nd)
        uq = torch.einsum("qi,ei->eq", phi, u_e)
        re = (torch.einsum("eij,ej->ei", Ke, u_e)
              + torch.einsum("eq,qi->ei", jxw * self.nl.q(uq), phi) - fe)
        Je = Ke + torch.einsum("eq,qi,qj->eij", jxw * self.nl.dq(uq), phi, phi)
        r = self._rhs_plan.scatter(re, self.n_dofs)
        J = self.pattern.assemble(Je.reshape(-1), self._matrix_plan)
        dmask = self.dirichlet_mask
        return torch.where(dmask, 0.0, r), eliminate_dirichlet(J, dmask)

    def initial_guess(self) -> torch.Tensor:
        """The Dirichlet interpolant (zero elsewhere)."""
        return self.dirichlet_values
