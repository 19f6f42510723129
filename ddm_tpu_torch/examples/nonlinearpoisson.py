"""Nonlinear Poisson example (reference: examples/nonlinearpoisson.cc).

Counterpart of ``ddm_tpu/examples/nonlinearpoisson.py``: -Δu + eta u² =
|x|², u = 0 on the boundary, by Newton with line search whose linear
solves run BiCGStab under two-level Schwarz (restricted Schwarz plus a POU
coarse space over {1, x, y, xy}), with the setup reused across Newton
steps.  Runs on the CUDA card unless ``device="cpu"`` is passed:

    python -m ddm_tpu_torch.examples.nonlinearpoisson [-key value ...]

Keys beyond the JAX example's: ``degree`` (1: Q1/P1, the default; 2:
Q2/P2) and ``simplex`` (triangles instead of quadrilaterals); the
reference's own configuration is P2 on triangles.  ``-ini_file
ddm_tpu_torch/examples/configs/nonlinearpoisson.ini`` reads the shipped
settings (LU subdomain and coarse solvers).
"""

from __future__ import annotations

import sys

import torch

from ..api import default_device, default_ptree
from ..config import ParamTree, apply_cli_overrides, read_ini_file
from ..fem.grids import structured_grid
from ..fem.nonlinear import NonlinearDiscretization, NonlinearProblem
from ..obs.logger import Logger, scoped, setup_loggers
from ..solvers.newton import NewtonResult
from ..solvers.nonlinear_driver import TwoLevelNewtonSolver


def nonlinear_ptree(argv=()) -> ParamTree:
    """The example's defaults (BASELINE config 5): 64^2 cells, 16
    subdomains, eta 10, Newton to a 1e-8 reduction, BiCGStab inner solves,
    multiplicative combination, LU coarse solve; then ``-key value``
    overrides and an optional ``ini_file``."""
    ptree = default_ptree()
    ptree["gridsize"] = 64
    ptree["subdomains"] = 16
    ptree["newton.Reduction"] = 1e-8
    ptree["solver.type"] = "bicgstabsolver"
    ptree["combined_preconditioner.mode"] = "multiplicative"
    ptree["coarse_solver.type"] = "lu"
    ptree["eta"] = 10.0
    argv = list(argv)
    apply_cli_overrides(ptree, argv)
    ini = ptree.get("ini_file", "")
    if ini:
        read_ini_file(ini, ptree)
        apply_cli_overrides(ptree, argv)
    return ptree


def setup(ptree: ParamTree, device=None,
          parts: tuple[int, int] | None = None) -> TwoLevelNewtonSolver:
    """The nonlinear problem and its Newton solver on ``device`` (default:
    the CUDA card): a ``gridsize``^2 grid, ``parts`` blocks of cells, else
    ``subdomains`` subdomains by recursive coordinate bisection."""
    device = default_device() if device is None else torch.device(device)
    eta = ptree.get("eta", 10.0)
    nlp = NonlinearProblem(q=lambda u: eta * u * u, dq=lambda u: 2.0 * eta * u)
    gs = ptree.get("gridsize", 64)
    grid = structured_grid((gs, gs), simplex=ptree.get("simplex", False))
    disc = NonlinearDiscretization(grid, nlp, device,
                                   degree=ptree.get("degree", 1))
    return TwoLevelNewtonSolver(
        disc, ptree, n_sub=None if parts else ptree.get("subdomains", 16),
        parts=parts)


def main(argv=None, device=None) -> tuple[TwoLevelNewtonSolver, NewtonResult]:
    """Set up and solve; prints the Newton and inner iteration counts and
    the timing table to stderr.  Returns (solver, result)."""
    ptree = nonlinear_ptree(
        setup_loggers(sys.argv[1:] if argv is None else list(argv)))
    Logger.reset()
    with scoped("Driver", "Setup problem"):
        solver = setup(ptree, device)
    with scoped("Driver", "Newton solve", solver.device):
        res = solver.solve()
    print(f"Newton: {res.iterations} iterations (converged {res.converged}), "
          f"{res.linear_iterations} total inner iterations, defect "
          f"{res.defect0:.6e} -> {res.defect:.6e}", file=sys.stderr)
    Logger.get().report(stream=sys.stderr)
    return solver, res


if __name__ == "__main__":
    main()
