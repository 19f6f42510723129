"""Poisson / convection-diffusion example driver.

Counterpart of ``ddm_tpu/examples/poisson.py`` (reference:
examples/poisson.cc:86-408): grid -> partition -> assembly -> overlap
topology -> POU -> fine Schwarz -> coarse space -> Krylov solve -> VTK
output -> timing report, with the reference's phase events ("Setup
problem", "Setup preconditioner", "Linear solve", "Visualisation" and the
total) and config keys.  Runs on the CUDA card unless ``device="cpu"`` is
passed:

    python -m ddm_tpu_torch.examples.poisson -ini_file \\
        ddm_tpu_torch/examples/configs/poisson.ini [-key value ...]

``-coefficient_file`` loads the coefficients from a script
(``fem/scripted.py``), else ``-problem`` names a built-in problem.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..api import (
    DDMProblem,
    build_preconditioner,
    default_device,
    default_ptree,
    setup_problem,
    solution,
    solve,
)
from ..config import ParamTree, apply_cli_overrides, read_ini_file
from ..fem import problems as pm
from ..obs.logger import Logger, logger, scoped, setup_loggers
from ..solvers.krylov import KrylovResult


def run(ptree: ParamTree, problem=None, device=None):
    """Set up, build the preconditioner, solve and, with ``visualise``,
    write the VTK file ``vtk_filename``; prints the timing table to
    stderr.  ``device``: default the CUDA card (see
    :func:`~ddm_tpu_torch.api.default_device`).  Returns (problem,
    result); the problem's ``prec`` is the preconditioner."""
    device = default_device() if device is None else torch.device(device)
    Logger.reset()
    total = scoped("Total", "total time")
    Logger.get().start_event(total.event)
    with scoped("Driver", "Setup problem", device):
        p = setup_problem(ptree, problem=problem, device=device)
    with scoped("Driver", "Setup preconditioner", device):
        prec = p.prec = build_preconditioner(p)
    with scoped("Driver", "Linear solve", device):
        res = solve(p, prec)
    logger.info("Solved in {} iterations (converged: {}), defect {} -> {}",
                res.iterations, res.converged, res.defect0, res.defect)
    if ptree.get("visualise", False):
        with scoped("Driver", "Visualisation"):
            visualise(p, res, ptree.get("vtk_filename", "poisson_out.vtu"),
                      prec=prec)
    Logger.get().end_event(total.event)
    Logger.get().report(stream=sys.stderr)
    return p, res


def visualise(p: DDMProblem, res: KrylovResult, filename: str, prec=None):
    """Solution and DDM debug fields (reference: poisson.cc:324-386): the
    solution, the un-equilibrated right-hand side, the POU sum, the owner
    map and the element partition; for the subdomain ``debug_rank``
    (clamped as poisson.cc:333-334 does) its POU weights, its overlap
    indicator, each of its active coarse-basis vectors as
    ``basis_vec_NNNN`` and, for ring coarse spaces, its ring region (all
    zero otherwise).  Each field comes to the host once."""
    from ..fem.vtk import write_vtu

    u = solution(p, res).cpu().numpy()
    rhs = (p.rhs if p.scale is None else p.rhs / p.scale).cpu().numpy()
    n = p.disc.n_dofs
    topo = p.topo

    def scatter_sub(k, vals):
        """Subdomain k's padded local vector as a global field."""
        out = np.zeros(n + 1)
        np.add.at(out, topo.sub2glob[k], np.where(topo.valid[k], vals, 0.0))
        return out[:n]

    pou_sum = np.zeros(n + 1)
    np.add.at(pou_sum, topo.sub2glob, p.pou)
    owner = np.zeros(n + 1)
    np.add.at(owner, topo.sub2glob,
              topo.owner * (np.arange(topo.n_sub)[:, None] + 1.0))

    dbg = int(p.ptree.get("debug_rank", 0))
    if dbg > topo.n_sub - 1:
        dbg = 0
    point_data = {
        "solution": u,
        "rhs": rhs,
        "pou_sum": pou_sum[:n],
        "owner_subdomain": owner[:n] - 1,
        "pou": scatter_sub(dbg, p.pou[dbg]),
        "ovlp_subdomain": scatter_sub(dbg, np.ones(topo.n_pad)),
    }
    # the Galerkin preconditioner holds V as (n_sub, nev_max, n_pad)
    coarse = None
    if prec is not None:
        precs = getattr(prec, "precs", (prec,))
        coarse = next((q for q in precs if hasattr(q, "V")), None)
    if coarse is not None:
        V = coarse.V[dbg].cpu().numpy()
        active = coarse.active[dbg].cpu().numpy()
        for k in range(V.shape[0]):
            if active[k]:
                point_data[f"basis_vec_{k:04d}"] = scatter_sub(dbg, V[k])
    if p.ptree.sub("coarsespace").get("type", "none").endswith("_ring"):
        ring = topo.valid[dbg] & (topo.bdist[dbg] <= 2 * topo.overlap + 1)
        point_data["ring_region"] = scatter_sub(dbg, ring.astype(np.float64))
    else:
        point_data["ring_region"] = np.zeros(n)
    cell_data = {"partition": np.asarray(p.elem_part, dtype=np.float64)}
    write_vtu(filename, p.disc.grid, point_data, cell_data)
    logger.info("Wrote {}", filename)


def poisson_ptree(argv=()) -> ParamTree:
    """The example's defaults (64^2 cells, 16 subdomains), then ``-key
    value`` overrides and an optional ``ini_file`` (the command line wins
    over the ini)."""
    ptree = default_ptree()
    ptree["gridsize"] = 64
    ptree["subdomains"] = 16
    argv = list(argv)
    apply_cli_overrides(ptree, argv)
    ini = ptree.get("ini_file", "")
    if ini:
        read_ini_file(ini, ptree)
        apply_cli_overrides(ptree, argv)
    return ptree


def main(argv=None, device=None) -> tuple[DDMProblem, KrylovResult]:
    """Run the example on ``device`` (default: the CUDA card).  Returns
    (problem, result)."""
    argv = setup_loggers(sys.argv[1:] if argv is None else list(argv))
    ptree = poisson_ptree(argv)
    coeff_file = ptree.get("coefficient_file", "")
    if coeff_file:
        from ..fem.scripted import load_problem

        problem = load_problem(coeff_file)
    else:
        problem = pm.PROBLEMS[ptree.get("problem", "simple")]()
    return run(ptree, problem, device)


if __name__ == "__main__":
    main()
