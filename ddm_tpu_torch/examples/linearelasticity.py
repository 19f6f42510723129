"""Linear elasticity example (reference: examples/linearelasticity.cc).

Counterpart of ``ddm_tpu/examples/linearelasticity.py``: the
steel-reinforced rubber bar [0,10]x[0,1]x[0,1.5], clamped at x = 0, three
displacement components on hexahedra, ``subdomains_x`` slabs along x,
GenEO coarse space, GMRES to 1e-6.  Runs on the CUDA card unless
``device="cpu"`` is passed:

    python -m ddm_tpu_torch.examples.linearelasticity -ini_file \\
        ddm_tpu_torch/examples/configs/linearelasticity.ini [-key value ...]

``-coefficient_file`` loads the coefficients from a script
(``fem/scripted.py:load_elasticity_problem``), else the built-in
:func:`~ddm_tpu_torch.fem.problems.steel_rubber_bar`.
"""

from __future__ import annotations

import sys

import torch

from ..api import (
    DDMProblem,
    build_preconditioner,
    default_device,
    default_ptree,
    setup_problem,
    solve,
)
from ..config import ParamTree, apply_cli_overrides, read_ini_file
from ..fem.grids import structured_grid
from ..fem.problems import steel_rubber_bar
from ..obs.logger import Logger, logger, scoped, setup_loggers
from ..solvers.krylov import KrylovResult


def elasticity_ptree(argv=()) -> ParamTree:
    """The example's defaults (20 x 4 x 6 cells, GenEO nev 6, LU coarse
    solve, GMRES to 1e-6), then ``-key value`` overrides and an optional
    ``ini_file``."""
    ptree = default_ptree()
    ptree["solver.reduction"] = 1e-6
    ptree["coarsespace.type"] = "geneo"
    ptree["coarse_solver.type"] = "lu"
    ptree["geneo.eigensolver.nev"] = 6
    ptree["cells_x"] = 20
    ptree["cells_y"] = 4
    ptree["cells_z"] = 6
    argv = list(argv)
    apply_cli_overrides(ptree, argv)
    ini = ptree.get("ini_file", "")
    if ini:
        read_ini_file(ini, ptree)
        apply_cli_overrides(ptree, argv)
    return ptree


def main(argv=None, device=None) -> tuple[DDMProblem, KrylovResult]:
    """Set up, build the preconditioner and solve on ``device`` (default:
    the CUDA card); prints the iteration count and the timing table to
    stderr.  Returns (problem, result); the problem's ``prec`` is the
    preconditioner."""
    argv = setup_loggers(sys.argv[1:] if argv is None else list(argv))
    ptree = elasticity_ptree(argv)
    device = default_device() if device is None else torch.device(device)
    Logger.reset()
    with scoped("Driver", "Setup problem", device):
        cells = (ptree.get("cells_x", 20), ptree.get("cells_y", 4),
                 ptree.get("cells_z", 6))
        grid = structured_grid(cells, (0, 0, 0), (10.0, 1.0, 1.5))
        coeff_file = ptree.get("coefficient_file", "")
        if coeff_file:
            from ..fem.scripted import load_elasticity_problem

            problem = load_elasticity_problem(coeff_file)
        else:
            problem = steel_rubber_bar()
        p = setup_problem(ptree, problem=problem, grid=grid,
                          parts=(ptree.get("subdomains_x", 4), 1, 1),
                          n_comp=3, device=device)
    with scoped("Driver", "Setup preconditioner", device):
        prec = p.prec = build_preconditioner(p)
    with scoped("Driver", "Linear solve", device):
        res = solve(p, prec)
    logger.info("Elasticity solve: {} iterations, converged {}",
                res.iterations, res.converged)
    Logger.get().report(stream=sys.stderr)
    return p, res


if __name__ == "__main__":
    main()
