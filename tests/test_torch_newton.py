"""The nonlinear Newton path of the PyTorch port against the JAX package:
the nonlinear residual and Jacobian, BiCGStab, Newton with the
Hackbusch-Reusken line search, and the two-level Newton driver on
-Δu + 10 u² = |x|², u = 0 on the boundary (BASELINE config 5's problem).

Inputs are made from numpy.  Tolerances: residuals and Jacobians to 1e-13
of their largest entry; BiCGStab iterations and breakdown flags equal,
solutions within 1e-12 relative; the scalar Newton histories to 1e-12
relative; the two-level Newton count and the inner count of each step
equal, defect histories within 1e-8 relative where the defect is above
1e-12, solutions within 1e-10.  The JAX side stays small (Q1 16^2 / (2, 2),
n_pad 128; P2 triangles 8^2 / 4 RCB subdomains, n_pad 176), and each JAX
Newton solve runs once per module.  The example at BASELINE config 5's
size (64^2 / 16, n_pad 448) runs the port only, against the count the JAX
package gives there under the same ini (3 Newton steps, 10 inner
iterations; the JAX package on the CPU with x64).

The JAX package is imported inside the tests that compare with it, so the
``cuda`` test runs on a machine with a card and no jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_newton.py
"""

import os

import numpy as np
import pytest
import torch

from ddm_tpu_torch.config import ParamTree
from ddm_tpu_torch.fem.grids import structured_grid
from ddm_tpu_torch.fem.nonlinear import NonlinearDiscretization, NonlinearProblem
from ddm_tpu_torch.solvers.krylov import SOLVERS, bicgstab_solve
from ddm_tpu_torch.solvers.newton import newton_solve
from ddm_tpu_torch.solvers.nonlinear_driver import TwoLevelNewtonSolver

from blas_threads import one_blas_thread  # noqa: E402,F401

torch.set_num_threads(2)

ETA = 10.0
# case -> (cells, simplex, degree, decomposition)
CASES = {"q1": ((16, 16), False, 1, {"parts": (2, 2)}),
         "p2": ((8, 8), True, 2, {"n_sub": 4})}
INI = os.path.join(os.path.dirname(__file__), "..", "ddm_tpu_torch",
                   "examples", "configs", "nonlinearpoisson.ini")


def newton_ptree(**extra):
    """tests/test_newton.py's settings: overlap 2, Newton to 1e-8, BiCGStab,
    restricted Schwarz with LU subdomain solves, LU coarse solve,
    multiplicative combination, distance POU."""
    pt = ParamTree({
        "overlap": 2, "newton": {"Reduction": 1e-8},
        "solver": {"type": "bicgstabsolver", "maxit": 1000},
        "schwarz": {"type": "restricted",
                    "subdomain_solver": {"type": "umfpack"}},
        "coarse_solver": {"type": "lu"},
        "combined_preconditioner": {"mode": "multiplicative"},
        "pou": {"type": "distance", "shrink": 0},
    })
    for k, v in extra.items():
        pt[k] = v
    return pt


def port_disc(case, device="cpu"):
    cells, simplex, degree, _ = CASES[case]
    nlp = NonlinearProblem(q=lambda u: ETA * u * u, dq=lambda u: 2 * ETA * u)
    return NonlinearDiscretization(structured_grid(cells, simplex=simplex),
                                   nlp, device, degree=degree)


def jax_disc(case):
    import jax.numpy as jnp

    from ddm_tpu.fem import structured_grid as j_grid
    from ddm_tpu.fem.nonlinear import (
        NonlinearDiscretization as JDisc,
        NonlinearProblem as JProblem,
    )

    cells, simplex, degree, _ = CASES[case]
    nlp = JProblem(q=lambda u: ETA * u * u, dq=lambda u: 2 * ETA * u,
                   f=lambda x: jnp.sum(x * x, -1))
    return JDisc(j_grid(cells, simplex=simplex), nlp, degree=degree)


@pytest.mark.parametrize("case", list(CASES))
def test_residual_jacobian_matches_jax(case):
    """(r, J) at three iterates: zero, small and order-one random fields
    (Dirichlet dofs included: both zero the residual there and eliminate
    the Jacobian symmetrically)."""
    import jax.numpy as jnp

    dj, dt = jax_disc(case), port_disc(case)
    rng = np.random.default_rng(7)
    for u in (np.zeros(dt.n_dofs), 0.1 * rng.standard_normal(dt.n_dofs),
              rng.uniform(-1.0, 1.0, dt.n_dofs)):
        rj, Jj = dj.residual_jacobian(jnp.asarray(u))
        rt, Jt = dt.residual_jacobian(torch.as_tensor(u))
        rj = np.asarray(rj)
        assert np.abs(rt.numpy() - rj).max() <= 1e-13 * np.abs(rj).max()
        Sj, St = dj.pattern.to_scipy(Jj), dt.pattern.to_scipy(Jt)
        assert abs(St - Sj).max() <= 1e-13 * abs(Sj).max()
    assert np.array_equal(dt.initial_guess().numpy(),
                          np.asarray(dj.initial_guess()))


def _bicgstab_case(name):
    """(operator matrix, right-hand side, reduction, maxit) of the cases of
    tests/test_krylov_extra.py: a rotation (<rt, A rt> = 0 trips the h
    breakdown guard on the first half-step), the identity (the first
    half-step already converges) and an SPD system."""
    if name == "breakdown":
        return np.array([[0.0, 1.0], [-1.0, 0.0]]), np.array([1.0, 0.0]), 1e-10, 10
    if name == "half_step":
        return np.eye(3), np.array([1.0, 2.0, 3.0]), 1e-12, 10
    rng = np.random.default_rng(5)
    Q = rng.normal(size=(40, 40))
    return Q @ Q.T + 40 * np.eye(40), rng.normal(size=40), 1e-10, 200


@pytest.mark.parametrize("name", ["breakdown", "half_step", "spd"])
def test_bicgstab_matches_jax(name):
    import jax
    import jax.numpy as jnp

    from ddm_tpu.solvers.krylov import bicgstab_solve as j_bicgstab

    A, b, red, maxit = _bicgstab_case(name)
    op = jax.tree_util.Partial(lambda M, x: M @ x, jnp.asarray(A))
    rj = j_bicgstab(op, None, jnp.asarray(b), jnp.zeros(b.size),
                    reduction=red, maxit=maxit)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    assert SOLVERS["bicgstab"] is SOLVERS["bicgstabsolver"] is bicgstab_solve
    rt = bicgstab_solve(lambda x: At @ x, None, bt, torch.zeros_like(bt),
                        reduction=red, maxit=maxit)
    assert rt.iterations == int(rj.iterations)
    assert rt.breakdown == bool(rj.breakdown) == (name == "breakdown")
    assert rt.converged == bool(rj.converged) == (name != "breakdown")
    xj = np.asarray(rj.x)
    assert np.abs(rt.x.numpy() - xj).max() <= 1e-12 * max(np.abs(xj).max(), 1.0)
    if name == "half_step":
        assert rt.iterations == 1 and rt.defect < 1e-14


def _scalar_cases(xp, asarray):
    """The two scalar problems of tests/test_newton.py, in the array module
    ``xp`` (jax.numpy or torch) with its f64 ``asarray``: a linear residual
    with a 10x overshooting step (damped by the sufficient-decrease test),
    and r(u) = sign(u) sqrt(|u|), where only AcceptBest gets on."""

    def overshoot(u):
        return u, asarray([[0.1]])

    def sqrt_residual(u):
        r = xp.sign(u) * xp.sqrt(xp.abs(u) + 1e-30)
        return r, asarray([[0.5 / float(xp.sqrt(xp.abs(u[0]) + 1e-30))]])

    def linear_solve(J, r, red):
        return r / J[0, 0], 1

    return [(overshoot, linear_solve, dict(reduction=1e-10, maxit=60)),
            (sqrt_residual, linear_solve,
             dict(reduction=1e-3, maxit=8, line_search_accept_best=False)),
            (sqrt_residual, linear_solve,
             dict(reduction=1e-3, maxit=8, line_search_accept_best=True))]


def test_scalar_newton_histories_match_jax():
    import jax.numpy as jnp

    from ddm_tpu.solvers.newton import newton_solve as j_newton

    out = []
    cases_t = _scalar_cases(
        torch, lambda a: torch.tensor(a, dtype=torch.float64))
    for (rj, lj, kw), (rt, lt, _) in zip(_scalar_cases(jnp, jnp.asarray),
                                         cases_t):
        res_j = j_newton(rj, lj, jnp.asarray([1.0]), **kw)
        res_t = newton_solve(rt, lt, torch.tensor([1.0], dtype=torch.float64),
                             **kw)
        assert (res_t.iterations, res_t.converged) == (res_j.iterations,
                                                       res_j.converged)
        np.testing.assert_allclose(res_t.history, res_j.history, rtol=1e-12)
        out.append(res_t)
    hist = out[0].history  # strictly decreasing under the damped steps
    assert out[0].converged and all(b < a for a, b in zip(hist, hist[1:]))
    assert out[2].defect <= out[1].defect


@pytest.fixture(scope="module")
def newton_runs():
    """Both packages' two-level Newton solve of each case, run once: the
    JAX result with its inner BiCGStab count of every step, and the port's
    solver and result."""
    from ddm_tpu.config import ParamTree as JTree
    from ddm_tpu.solvers.nonlinear_driver import TwoLevelNewtonSolver as JSolver

    runs = {}
    for case, (_, _, _, decomp) in CASES.items():
        js = JSolver(jax_disc(case), JTree(newton_ptree().as_dict()), **decomp)
        inner = []
        krylov = js.krylov

        def counted(*args, krylov=krylov, inner=inner, **kwargs):
            res = krylov(*args, **kwargs)
            inner.append(int(res.iterations))
            return res

        js.krylov = counted
        jr = js.solve()
        ts = TwoLevelNewtonSolver(port_disc(case), newton_ptree(), **decomp)
        runs[case] = (jr, inner, ts, ts.solve(), js.topo.n_pad)
    return runs


@pytest.mark.parametrize("case", list(CASES))
def test_two_level_newton_matches_jax(newton_runs, case):
    jr, inner, ts, tr, n_pad = newton_runs[case]
    assert ts.topo.n_pad == n_pad == {"q1": 128, "p2": 176}[case]
    assert tr.converged and bool(jr.converged)
    assert tr.iterations == jr.iterations == 3
    assert [s["inner"] for s in ts.steps] == inner
    assert tr.linear_iterations == jr.linear_iterations == sum(inner)
    assert not any(s["breakdown"] for s in ts.steps)
    hj = np.asarray(jr.history)
    big = hj > 1e-12
    np.testing.assert_allclose(np.asarray(tr.history)[big], hj[big], rtol=1e-8)
    assert np.abs(tr.u.numpy() - np.asarray(jr.u)).max() <= 1e-10
    # the forcing: each step's inner reduction min(1e-3, (d_k/d_(k-1))^2)
    h = tr.history
    want = [1e-3] + [max(min(1e-3, (h[k] / h[k - 1]) ** 2), 1e-12)
                     for k in range(1, len(h) - 1)]
    assert [s["reduction"] for s in ts.steps] == want


def test_example_config5_on_cpu():
    """The example at BASELINE config 5's size under the shipped ini takes
    the JAX package's counts (3 Newton steps, 10 inner iterations)."""
    from ddm_tpu_torch.examples.nonlinearpoisson import main

    solver, res = main(["-ini_file", INI], device="cpu")
    assert solver.topo.n_sub == 16 and solver.topo.n_pad == 448
    assert solver.disc.n_dofs == 65 * 65 and solver.sub_solver == "umfpack"
    assert res.converged and res.iterations == 3 and res.linear_iterations == 10
    assert res.defect <= 1e-8 * res.defect0


def test_example_needs_cuda_unless_asked(monkeypatch):
    from ddm_tpu_torch.examples.nonlinearpoisson import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        main(["-gridsize", "4", "-subdomains", "2"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_newton_dd_coarse_solve(cuda_device):
    """The Q1 case with the dd coarse solve on the card against the exact
    f64 run on the CPU: the same Newton count, inner counts within 1 per
    step, solutions within 1e-6; the kernel launched 3 times per coarse
    apply (1 + 2 refinement steps)."""
    from ddm_tpu_torch.kernels import ddmatvec

    decomp = CASES["q1"][3]
    pt = newton_ptree(**{"coarse_solver.precision": "dd"})
    ddmatvec.dd_matvec_cuda.shapes.clear()
    gs = TwoLevelNewtonSolver(port_disc("q1", cuda_device), pt, **decomp)
    gr = gs.solve()
    launches = sum(ddmatvec.dd_matvec_cuda.shapes.values())
    cs = TwoLevelNewtonSolver(port_disc("q1"), newton_ptree(), **decomp)
    cr = cs.solve()
    assert gr.converged and gr.iterations == cr.iterations
    assert all(abs(a["inner"] - b["inner"]) <= 1
               for a, b in zip(gs.steps, cs.steps))
    assert float((gr.u.cpu() - cr.u).abs().max()) <= 1e-6
    assert launches == 3 * sum(s["coarse_applies"] for s in gs.steps) > 0
