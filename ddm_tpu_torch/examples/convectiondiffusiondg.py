"""Convection-diffusion DG example (reference: examples/convectiondiffusiondg.cc).

Counterpart of ``ddm_tpu/examples/convectiondiffusiondg.py``: the
nonsymmetric Q1 SIPG system of :func:`~ddm_tpu_torch.fem.problems.dg_heterogeneous`
on a structured grid, solved with restricted Schwarz + GenEO coarse space in
multiplicative mode under restarted GMRES (convectiondiffusiondg.ini
semantics).  Runs on the CUDA card unless ``device="cpu"`` is passed:

    python -m ddm_tpu_torch.examples.convectiondiffusiondg [-key value ...]
"""

from __future__ import annotations

import sys

import torch

from ..api import DDMProblem, build_preconditioner, default_device, default_ptree, solve
from ..config import ParamTree, apply_cli_overrides, read_ini_file
from ..core.indexmaps import pou_weights
from ..core.setup import setup_topology
from ..core.sparse import jacobi_equilibrate
from ..fem import problems as pm
from ..fem.dg import DGDiscretization
from ..fem.grids import structured_grid
from ..obs.logger import Logger, scoped, setup_loggers


def dg_ptree(argv=()) -> ParamTree:
    """The example's defaults (convectiondiffusiondg.ini): 32^2 cells,
    overlap 1, 16 subdomains, multiplicative GenEO (nev 6) with LU
    subdomain and coarse solvers and the standard POU; then ``-key value``
    overrides and an optional ``ini_file``."""
    ptree = default_ptree()
    ptree["gridsize"] = 32
    ptree["overlap"] = 1
    ptree["subdomains"] = 16
    ptree["combined_preconditioner.mode"] = "multiplicative"
    ptree["coarsespace.type"] = "geneo"
    ptree["coarse_solver.type"] = "lu"
    ptree["geneo.eigensolver.nev"] = 6
    # nonsymmetric system: LU, not Cholesky (reference ini: umfpack)
    ptree["schwarz.subdomain_solver.type"] = "umfpack"
    ptree["pou.type"] = "standard"
    argv = list(argv)
    apply_cli_overrides(ptree, argv)
    ini = ptree.get("ini_file", "")
    if ini:
        read_ini_file(ini, ptree)
        apply_cli_overrides(ptree, argv)
    return ptree


def setup(ptree: ParamTree, device=None,
          parts: tuple[int, int] | None = None) -> DDMProblem:
    """The DG problem on ``device`` (default: the CUDA card): grid,
    discretization of :func:`~ddm_tpu_torch.fem.problems.dg_heterogeneous`
    or of the script ``coefficient_file`` (``fem/scripted.py``), system
    (Jacobi-equilibrated if ``equilibrate``, off by default as in the
    reference example), topology (``parts`` blocks, else ``subdomains`` by
    recursive coordinate bisection) and POU."""
    device = default_device() if device is None else torch.device(device)
    gs = ptree.get("gridsize", 32)
    with scoped("Setup", "grid (host)"):
        grid = structured_grid((gs, gs))
    coeff_file = ptree.get("coefficient_file", "")
    if coeff_file:
        # scripted coefficients (reference:
        # convection_diffusion_coefficient.lua through LuaProblem)
        from ..fem.scripted import load_problem

        problem = load_problem(coeff_file)
    else:
        problem = pm.dg_heterogeneous()
    with scoped("Setup", "discretize (host pattern)", device):
        disc = DGDiscretization(grid, problem, device)
    with scoped("Setup", "assemble + constrain", device):
        A, b, g = disc.constrained_system()
    scale = None
    if ptree.get("equilibrate", False):
        # the reference example solves the unscaled system; scaled, the
        # residual of a 1e7-contrast system can be read to 1e-10
        with scoped("Setup", "equilibrate", device):
            A, b, scale = jacobi_equilibrate(A, b)
    with scoped("Setup", "topology (host)"):
        topo, elem_part = setup_topology(
            disc, overlap=ptree.get("overlap", 1),
            n_sub=None if parts else ptree.get("subdomains", 16), parts=parts)
    with scoped("Setup", "pou (host)"):
        pou = pou_weights(topo, ptree.sub("pou").get("type", "standard"),
                          shrink=ptree.sub("pou").get("shrink", 0))
    return DDMProblem(disc=disc, topo=topo, A=A, rhs=b, g=g, pou=pou,
                      ptree=ptree, device=device, elem_part=elem_part,
                      scale=scale)


def main(argv=None, device=None):
    """Set up, build the preconditioner and solve; prints the iteration
    count and the timing table to stderr.  Returns (problem, result); the
    problem's ``prec`` is the preconditioner."""
    ptree = dg_ptree(
        setup_loggers(sys.argv[1:] if argv is None else list(argv)))
    Logger.reset()
    with scoped("Driver", "Setup problem"):
        p = setup(ptree, device)
    with scoped("Driver", "Setup preconditioner", p.device):
        prec = p.prec = build_preconditioner(p)
    with scoped("Driver", "Linear solve", p.device):
        res = solve(p, prec)
    print(f"DG solve: {res.iterations} iterations, converged {res.converged}",
          file=sys.stderr)
    Logger.get().report(stream=sys.stderr)
    return p, res


if __name__ == "__main__":
    main()
