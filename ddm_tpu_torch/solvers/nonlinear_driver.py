"""Nonlinear two-level Schwarz driver.

Counterpart of ``ddm_tpu/solvers/nonlinear_driver.py`` (reference:
TwoLevelSchwarzSolver, dune/ddm/twolevel_schwarz.hh:27-175, as used by
examples/nonlinearpoisson.cc):

* the topology, the partition of unity, the extraction map (on the first
  Jacobian) and the coarse basis are built once: a POU space over the
  templates {1, x, y, xy} on the dof coordinates, zeroed at Dirichlet dofs
  (twolevel_schwarz.hh:47-55, 68-98);
* each linear solve re-extracts the subdomain matrices from the current
  Jacobian, refactorizes them and rebuilds the Galerkin coarse matrix
  (:99-104), then combines fine and coarse levels additively or
  multiplicatively per config;
* the inner solver comes from the solver table (BiCGStab in the shipped
  ini).
"""

from __future__ import annotations

import numpy as np
import torch

from ..coarse.pou_space import pou_coarse_space
from ..config import ParamTree
from ..core.indexmaps import dual_scatter_map, extraction_map, pou_weights
from ..core.setup import setup_topology
from ..fem.nonlinear import NonlinearDiscretization
from ..obs.logger import Logger, scoped
from ..precond.combined import CombinedPreconditioner
from ..precond.extract import extract_subdomain_dense
from ..precond.galerkin import build_galerkin
from ..precond.schwarz import SchwarzPreconditioner
from .direct import factor_batched
from .krylov import SOLVERS
from .newton import NewtonResult, newton_from_config

# per-step phases: (logger event, label in ``TwoLevelNewtonSolver.steps``)
STEP_PHASES = ((("Schwarz", "extract"), "extract"),
               (("Schwarz", "factorise"), "factor"),
               (("GalerkinPrec", "build Matrix"), "galerkin"),
               (("GalerkinPrec", "factor A0"), "galerkin"),
               (("Solver", "solve"), "krylov"))


class TwoLevelNewtonSolver:
    """Newton on ``disc`` with two-level Schwarz inner solves, on the
    discretization's device.  After :meth:`solve`, ``steps`` holds one dict
    per linear solve (its inner iterations and reduction, its fine and
    coarse applies, the seconds of each phase of :data:`STEP_PHASES`) and
    ``prec`` the preconditioner of the last one."""

    def __init__(
        self,
        disc: NonlinearDiscretization,
        ptree: ParamTree,
        n_sub: int | None = None,
        parts: tuple | None = None,
    ):
        self.disc = disc
        self.ptree = ptree
        dev = self.device = disc.device
        self.topo, _ = setup_topology(disc, overlap=ptree.get("overlap", 2),
                                      n_sub=n_sub, parts=parts)
        pou = pou_weights(self.topo, ptree.sub("pou").get("type", "distance"),
                          shrink=ptree.sub("pou").get("shrink", 0))
        self.sub2glob = torch.as_tensor(self.topo.sub2glob.astype(np.int64),
                                        device=dev)
        self.valid = torch.as_tensor(self.topo.valid, device=dev)
        self.dualT = torch.as_tensor(
            dual_scatter_map(self.topo).astype(np.int64), device=dev)
        self.pou = torch.as_tensor(pou, dtype=torch.float64, device=dev)
        if ptree.sub("schwarz").get("type", "restricted") != "restricted":
            self.pou = torch.ones_like(self.pou)
        self._local_cols = None  # built on the first Jacobian

        xy = disc._node_coords  # with degree 2, the edge dofs too
        x, y = xy[:, 0], xy[:, 1]
        self.basis = pou_coarse_space(
            self.topo, pou, templates=[torch.ones_like(x), x, y, x * y],
            dirichlet_mask=disc.dirichlet_mask, device=dev)
        self.sub_solver = ptree.sub("schwarz").sub("subdomain_solver").get(
            "type", "umfpack")
        self.mode = ptree.sub("combined_preconditioner").get(
            "mode", "multiplicative")
        stype = ptree.sub("solver").get("type", "bicgstabsolver")
        if stype not in SOLVERS:
            raise ValueError(f"solver type '{stype}' is not ported")
        self.krylov = SOLVERS[stype]
        self.maxit = ptree.sub("solver").get("maxit", 1000)
        self.steps: list[dict] = []
        self.prec: CombinedPreconditioner | None = None

    def _build_prec(self, J) -> CombinedPreconditioner:
        dev = self.device
        if self._local_cols is None:
            with scoped("Newton", "extraction map (host)"):
                self._local_cols = torch.as_tensor(
                    extraction_map(self.topo, J.cols.cpu().numpy()).astype(
                        np.int64), device=dev)
        with scoped("Schwarz", "extract", dev):
            A_sub = extract_subdomain_dense(J, self.sub2glob, self.valid,
                                            self._local_cols)
        with scoped("Schwarz", "factorise", dev):
            factors = factor_batched(A_sub, self.sub_solver)
            del A_sub
        fine = SchwarzPreconditioner(sub2glob=self.sub2glob, valid=self.valid,
                                     pou=self.pou, factors=factors,
                                     dualT=self.dualT)
        coarse = build_galerkin(
            J, self.topo, self.basis,
            self.ptree if "coarse_solver.type" in self.ptree else None,
            method="global")
        op = J if self.mode == "multiplicative" else None
        return CombinedPreconditioner(precs=(fine, coarse), op=op,
                                      mode=self.mode)

    def _linear_solve(self, J, r, lin_red):
        before = _phase_seconds()
        prec = self.prec = self._build_prec(J)
        with scoped("Solver", "solve", self.device):
            res = self.krylov(J.mv, prec.apply, r, torch.zeros_like(r),
                              reduction=lin_red, maxit=self.maxit)
        after = _phase_seconds()
        step = {label: after[label] - before[label] for label in after}
        step.update(inner=int(res.iterations), reduction=lin_red,
                    fine_applies=prec.precs[0].applies,
                    coarse_applies=prec.precs[1].applies,
                    breakdown=res.breakdown)
        self.steps.append(step)
        return res.x, int(res.iterations)

    def _residual_jacobian(self, u):
        with scoped("Newton", "residual + Jacobian", self.device):
            return self.disc.residual_jacobian(u)

    def solve(self, u0=None) -> NewtonResult:
        u0 = u0 if u0 is not None else self.disc.initial_guess()
        self.steps = []
        return newton_from_config(self._residual_jacobian,
                                  self._linear_solve, u0, self.ptree)


def _phase_seconds() -> dict:
    """Seconds spent so far in each label of :data:`STEP_PHASES`."""
    events = Logger.get().events
    out = {}
    for key, label in STEP_PHASES:
        out[label] = out.get(label, 0.0) + (events[key].total
                                            if key in events else 0.0)
    return out
