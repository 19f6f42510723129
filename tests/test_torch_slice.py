"""The whole two-level GenEO-RAS solve, built independently by the JAX
package and by the PyTorch port from the same configuration: islands
32^2 / 16 subdomains, overlap 2, geneo nev 8, Cholesky coarse solve,
GMRES(50) to 1e-8 — the main path's configuration at a small size.

f64: the same iteration count (JAX: 17).  dd (double-single subdomain
inverse, verified GMRES termination): within 2 iterations (JAX: 22), since
the f32 partial sums are taken in another order.  Both: true relative
residual <= 1e-7 and solutions within 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddm_tpu.api as japi
from ddm_tpu.fem import problems as jproblems
from ddm_tpu_torch import api as tapi
from ddm_tpu_torch.fem import problems as tproblems

torch.set_num_threads(2)

PRECISIONS = ["f64", "dd"]


def _ptree(api, precision):
    pt = api.default_ptree()
    pt["gridsize"] = 32
    pt["overlap"] = 2
    pt["solver.reduction"] = 1e-8
    pt["solver.maxit"] = 400
    pt["solver.restart"] = 50
    pt["coarsespace.type"] = "geneo"
    pt["geneo.eigensolver.nev"] = 8
    pt["coarse_solver.type"] = "cholesky"
    if precision != "f64":
        pt["schwarz.subdomain_solver.precision"] = precision
    return pt


@pytest.fixture(scope="module")
def runs():
    """{precision: (jax (iters, true_res, u), port (iters, true_res, u))},
    each package solving once per precision."""
    out = {}
    for prec in PRECISIONS:
        pj = japi.setup_problem(_ptree(japi, prec), problem=jproblems.islands(),
                                parts=(4, 4))
        rj = japi.solve(pj)
        tr_j = float(jnp.linalg.norm(pj.A.mv(rj.x) - pj.rhs)
                     / jnp.linalg.norm(pj.rhs))
        u_j = np.asarray(japi.solution(pj, rj))

        pt = tapi.setup_problem(_ptree(tapi, prec), problem=tproblems.islands(),
                                parts=(4, 4), device="cpu")
        rt = tapi.solve(pt)
        tr_t = float(torch.linalg.norm(pt.A.mv(rt.x) - pt.rhs)
                     / torch.linalg.norm(pt.rhs))
        u_t = tapi.solution(pt, rt).numpy()
        assert rt.converged and bool(rj.converged)
        out[prec] = ((int(rj.iterations), tr_j, u_j),
                     (rt.iterations, tr_t, u_t))
    return out


@pytest.mark.parametrize("prec,slack", [("f64", 0), ("dd", 2)])
def test_slice_iterations_match_jax(runs, prec, slack):
    (it_j, _, _), (it_t, _, _) = runs[prec]
    assert abs(it_t - it_j) <= slack, (it_t, it_j)


@pytest.mark.parametrize("prec", PRECISIONS)
def test_slice_true_residual(runs, prec):
    (_, tr_j, _), (_, tr_t, _) = runs[prec]
    assert tr_j <= 1e-7 and tr_t <= 1e-7, (tr_j, tr_t)


@pytest.mark.parametrize("prec", PRECISIONS)
def test_slice_solutions_agree(runs, prec):
    (_, _, u_j), (_, _, u_t) = runs[prec]
    assert np.abs(u_t - u_j).max() <= 1e-6 * np.abs(u_j).max()



@pytest.mark.parametrize("solver,schwarz", [("cgsolver", "standard"),
                                            ("restartedgmressolver", "restricted")])
def test_one_level_solvers_match_jax(solver, schwarz):
    """One-level Schwarz (no coarse space) under CG (symmetric additive
    Schwarz) and under GMRES with restart 20, so several restart cycles
    run: the same iteration count as the JAX package, both converged."""
    its = []
    for api, problems, dev in ((japi, jproblems, {}),
                               (tapi, tproblems, {"device": "cpu"})):
        pt = api.default_ptree()
        pt["gridsize"] = 32
        pt["solver.type"] = solver
        pt["solver.reduction"] = 1e-8
        pt["solver.restart"] = 20
        pt["schwarz.type"] = schwarz
        p = api.setup_problem(pt, problem=problems.islands(), parts=(4, 4),
                              **dev)
        res = api.solve(p)
        assert bool(res.converged)
        its.append(int(res.iterations))
    assert its[0] == its[1] and its[0] > 20, its
