"""Discretization driver: grid + problem -> global system + DDM inputs.

Counterpart of ``ddm_tpu/fem/discretize.py`` (reference: GenericDDMProblem,
examples/generic_ddm_problem.hh:48-407) for nodal Q1 scalar problems.
The constrained system is the correction form

    A_c z = b - A g,   rhs zeroed at Dirichlet dofs,  u = g + z

with A_c symmetrically eliminated (examples/pdelab_helper.hh:33-46).
"""

from __future__ import annotations

from functools import cached_property

import numpy as np
import scipy.sparse as sps
import torch

from ..core.sparse import EllPattern, SparseELL, SumPlan, eliminate_dirichlet
from .assemble import (
    ElementQuadrature,
    assemble_diffusion,
    element_coo_indices,
)
from .grids import Grid
from .problems import Problem


class Discretization:
    """Scalar nodal discretization of ``problem`` on ``grid``; the device
    tensors it makes live on ``device``."""

    def __init__(self, grid: Grid, problem: Problem, device):
        self.grid = grid
        self.problem = problem
        self.device = torch.device(device)
        self.n_dofs = grid.n_nodes
        self.quad = ElementQuadrature(grid.elem_type, self.device)
        self.xe = torch.as_tensor(
            grid.nodes[grid.elems], dtype=torch.float64, device=self.device
        )
        rows, cols = element_coo_indices(grid.elems)
        self.pattern = EllPattern.from_coo(rows, cols, self.n_dofs)
        self._matrix_plan = self.pattern.assembly_plan(self.device)
        e = grid.elems.reshape(-1)
        self._rhs_plan = SumPlan.build(
            np.arange(e.size), e, e.size, self.device
        )
        self._Ke = None

    # -- masks / boundary data --------------------------------------------
    @cached_property
    def _node_coords(self) -> torch.Tensor:
        return torch.as_tensor(
            self.grid.nodes, dtype=torch.float64, device=self.device
        )

    @cached_property
    def dirichlet_mask(self) -> torch.Tensor:
        """(n_dofs,) bool — physical-boundary dofs selected by the problem."""
        bnd = torch.as_tensor(self.grid.boundary_nodes(), device=self.device)
        return bnd & self.problem.is_dirichlet(self._node_coords)

    @cached_property
    def dirichlet_values(self) -> torch.Tensor:
        g = self.problem.g(self._node_coords)
        return torch.where(self.dirichlet_mask, g, 0.0)

    # -- assembly ----------------------------------------------------------
    def element_matrices(self):
        """Batched (Ke, fe) of the problem, computed once."""
        if self._Ke is None:
            p = self.problem
            self._Ke = assemble_diffusion(self.quad, self.xe, p.alpha, p.f)
        return self._Ke

    def assemble(self) -> tuple[SparseELL, torch.Tensor]:
        """Unconstrained global (A, b)."""
        Ke, fe = self.element_matrices()
        A = self.pattern.assemble(Ke.reshape(-1), self._matrix_plan)
        b = self._rhs_plan.scatter(fe, self.n_dofs)
        return A, b

    def constrained_system(self):
        """(A_c, rhs, g) with symmetric Dirichlet elimination."""
        A, b = self.assemble()
        g = self.dirichlet_values
        rhs = torch.where(self.dirichlet_mask, 0.0, b - A.mv(g))
        return eliminate_dirichlet(A, self.dirichlet_mask), rhs, g

    # -- DDM inputs --------------------------------------------------------
    def dof_tuples(self) -> np.ndarray:
        """(n_elems, nl) global dof ids per element (host)."""
        return self.grid.elems

    def neumann_stamps(self):
        """Assembly stamps for subdomain Neumann matrices: one group of
        (dof tuples (n_e, nl) host, element matrices (n_e, nl, nl))."""
        Ke, _ = self.element_matrices()
        return [(self.dof_tuples(), Ke)]

    def adjacency(self) -> sps.csr_matrix:
        """Structurally-symmetric matrix-graph adjacency (pattern only)."""
        p = self.pattern
        return sps.csr_matrix(
            (np.ones(p.rows_csr.size), (p.rows_csr, p.cols_csr)),
            shape=(self.n_dofs, self.n_dofs),
        )
