"""Discretization driver: grid + problem -> global system + DDM inputs.

Counterpart of ``ddm_tpu/fem/discretize.py`` (reference: GenericDDMProblem,
examples/generic_ddm_problem.hh:48-407) for nodal P1/Q1 problems on
triangles, tetrahedra, quadrilaterals and hexahedra: scalar
convection-diffusion (``n_comp = 1``) or vector-valued elasticity
(``n_comp = d``, dof = node * n_comp + component); and, with ``degree = 2``,
scalar P2 triangles and Q2 quadrilaterals, whose edge (and Q2 cell-center)
dofs follow the mesh vertices (``fem/highorder.py``; reference:
PkLocalFiniteElementMap degree 2, nonlinearpoisson.cc:104).  The
constrained system is the correction form

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
    assemble_convection_diffusion,
    assemble_linear_elasticity,
    element_coo_indices,
    element_dofs,
)
from .grids import Grid
from .highorder import p2_dofs
from .problems import ElasticityProblem, Problem


class Discretization:
    """Nodal discretization of ``problem`` on ``grid`` of polynomial
    ``degree`` 1 (P1/Q1 on the mesh vertices) or 2 (P2/Q2), with ``n_comp``
    unknowns per node; the device tensors it makes live on ``device``."""

    #: subdomain Neumann matrices are SPSD (conforming elements are
    #: elementwise PSD); DG discretizations set this False
    definite = True

    def __init__(self, grid: Grid, problem: Problem | ElasticityProblem,
                 device, n_comp: int = 1, degree: int = 1):
        self.grid = grid
        self.problem = problem
        self.device = torch.device(device)
        self.n_comp = n_comp
        self.degree = degree
        if degree == 1:
            self._elem_nodes = grid.elems
            self._node_xy = grid.nodes
            self._node_boundary = grid.boundary_nodes()
            basis = grid.elem_type
        elif degree == 2:
            if n_comp != 1:
                raise ValueError("degree 2 is scalar (n_comp = 1) only")
            (self._elem_nodes, self._node_xy, self._node_boundary,
             basis) = p2_dofs(grid)
        else:
            raise ValueError(f"degree {degree} is not supported (1 or 2)")
        self.n_dofs = self._node_xy.shape[0] * n_comp
        self.quad = ElementQuadrature(basis, self.device)
        self.xe = torch.as_tensor(
            self._node_xy[self._elem_nodes], dtype=torch.float64,
            device=self.device
        )
        rows, cols = element_coo_indices(self._elem_nodes, n_comp)
        self.pattern = EllPattern.from_coo(rows, cols, self.n_dofs)
        self._matrix_plan = self.pattern.assembly_plan(self.device)
        e = self.dof_tuples().reshape(-1)
        self._rhs_plan = SumPlan.build(
            np.arange(e.size), e, e.size, self.device
        )
        self._Ke = None

    # -- masks / boundary data --------------------------------------------
    @cached_property
    def _node_coords(self) -> torch.Tensor:
        """(n_nodes, d) coordinates of the nodes (with degree 2, the mesh
        vertices and then the edge and cell-center dofs)."""
        return torch.as_tensor(
            self._node_xy, dtype=torch.float64, device=self.device
        )

    @cached_property
    def dirichlet_mask(self) -> torch.Tensor:
        """(n_dofs,) bool — physical-boundary dofs selected by the problem."""
        bnd = torch.as_tensor(self._node_boundary, device=self.device)
        node_mask = bnd & self.problem.is_dirichlet(self._node_coords)
        if self.n_comp == 1:
            return node_mask
        return torch.repeat_interleave(node_mask, self.n_comp)

    @cached_property
    def dirichlet_values(self) -> torch.Tensor:
        """(n_dofs,) boundary data; a vector problem's ``g`` returns
        (n_nodes, n_comp), flattened node-major."""
        g = self.problem.g(self._node_coords).reshape(-1)
        return torch.where(self.dirichlet_mask, g, 0.0)

    # -- assembly ----------------------------------------------------------
    def element_matrices(self, problem=None, elems: np.ndarray | None = None):
        """Batched (Ke, fe) of ``problem`` (default: the discretization's
        own, computed once and kept), on the element-id subset ``elems``
        if given."""
        p = problem or self.problem
        cacheable = elems is None and p is self.problem
        if cacheable and self._Ke is not None:
            return self._Ke
        xe = self.xe if elems is None else self.xe[torch.as_tensor(
            np.asarray(elems), device=self.device)]
        if isinstance(p, ElasticityProblem):
            out = assemble_linear_elasticity(self.quad, xe, p.lam, p.mu, p.f)
        else:
            out = assemble_convection_diffusion(self.quad, xe, p.alpha, p.b,
                                                p.c, p.f)
        if cacheable:
            self._Ke = out
        return out

    def assemble(self, problem=None) -> tuple[SparseELL, torch.Tensor]:
        """Unconstrained global (A, b) of ``problem`` (default: the
        discretization's own) on this discretization's pattern."""
        Ke, fe = self.element_matrices(problem)
        A = self.pattern.assemble(Ke.reshape(-1), self._matrix_plan)
        b = self._rhs_plan.scatter(fe, self.n_dofs)
        return A, b

    def constrained_system(self, problem=None):
        """(A_c, rhs, g) of ``problem`` (default: the discretization's own)
        with symmetric Dirichlet elimination; the Dirichlet dofs and data
        are the discretization's own problem's."""
        A, b = self.assemble(problem)
        g = self.dirichlet_values
        # unfused, as the JAX package's eager call rounds it
        rhs = torch.where(self.dirichlet_mask, 0.0, b - A.mv(g, fused=False))
        return eliminate_dirichlet(A, self.dirichlet_mask), rhs, g

    # -- DDM inputs --------------------------------------------------------
    def dof_tuples(self) -> np.ndarray:
        """(n_elems, nl) global dof ids per element (host): the unit of dof
        membership and ownership for the DDM topology."""
        return element_dofs(self._elem_nodes, self.n_comp)

    @property
    def stamps_cover_operator(self) -> bool:
        """True when :meth:`neumann_stamps` sums exactly to the assembled
        global operator (before elimination): the element sum of a problem
        that is already symmetric."""
        return getattr(self.problem, "symmetric", True) is not False

    def neumann_stamps(self, problem=None):
        """Assembly stamps for subdomain Neumann matrices of ``problem``
        (default: the discretization's own): one group of (dof tuples
        (n_e, nl) host, element matrices (n_e, nl, nl)).  A nonsymmetric
        problem stamps its symmetrized (elliptic) operator, as the
        two-operator machinery of generic_ddm_problem.hh:169-220."""
        p = problem or self.problem
        if getattr(p, "symmetric", True) is False:
            p = p.symmetrized()
        Ke, _ = self.element_matrices(p)
        return [(self.dof_tuples(), Ke)]

    def adjacency(self) -> sps.csr_matrix:
        """Structurally-symmetric matrix-graph adjacency (pattern only)."""
        p = self.pattern
        return sps.csr_matrix(
            (np.ones(p.rows_csr.size), (p.rows_csr, p.cols_csr)),
            shape=(self.n_dofs, self.n_dofs),
        )
