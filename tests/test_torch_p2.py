"""Degree-2 elements in the PyTorch port against the JAX package: the P2/Q2
dof numbering, the degree-4 Dunavant and 3x3 Gauss rules with their shape
functions, the degree-2 constrained system, and a two-level GenEO solve on
P2 triangles.

Inputs are made from numpy.  Tolerances: dofs, coordinates and boundary
masks exactly; quadrature points bit for bit (the islands coefficient jumps
exactly on some of them); element matrices and vectors, and the assembled
constrained system, to 1e-13 relative (the JAX package inverts the Jacobian
in closed form, the port with ``torch.linalg``); GMRES iterations equal and
solutions within 1e-8 relative.  The GenEO slice keeps the JAX side small
(12^2 triangles, 4 subdomains, n_pad 296).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import ddm_tpu.api as japi
from ddm_tpu.fem import assemble as jassemble
from ddm_tpu.fem import problems as jproblems
from ddm_tpu.fem.discretize import Discretization as JDisc
from ddm_tpu.fem.grids import structured_grid as j_grid
from ddm_tpu.fem.highorder import p2_dofs as j_p2_dofs
from ddm_tpu_torch import api as tapi
from ddm_tpu_torch.convert import discretization_from_numpy
from ddm_tpu_torch.fem import assemble as tassemble
from ddm_tpu_torch.fem import problems as tproblems
from ddm_tpu_torch.fem.discretize import Discretization
from ddm_tpu_torch.fem.grids import structured_grid
from ddm_tpu_torch.fem.highorder import p2_dofs

from blas_threads import one_blas_thread  # noqa: E402,F401

torch.set_num_threads(2)

SIMPLEX = {"tri": True, "quad": False}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("kind", list(SIMPLEX))
def test_p2_dofs_match_jax(kind):
    """Element dof tuples, dof coordinates, the boundary mask and the basis
    name equal the JAX package's on 8^2 cells."""
    ours = p2_dofs(structured_grid((8, 8), simplex=SIMPLEX[kind]))
    ref = j_p2_dofs(j_grid((8, 8), simplex=SIMPLEX[kind]))
    for a, b in zip(ours[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)
    assert ours[3] == ref[3] == f"{kind}2"


@pytest.mark.parametrize("kind", list(SIMPLEX))
def test_p2_quadrature_and_element_matrices_match_jax(kind):
    """The islands coefficient with convection, reaction and load terms on
    8^2 cells: quadrature points bit for bit, element matrices and load
    vectors to 1e-13."""
    basis = f"{kind}2"
    ed, xy, _, _ = p2_dofs(structured_grid((8, 8), simplex=SIMPLEX[kind]))
    xe = xy[ed]
    jq = jassemble.ElementQuadrature(basis)
    tq = tassemble.ElementQuadrature(basis, "cpu")
    xq_j = np.asarray(jassemble.element_geometry(jq, jnp.asarray(xe))[0])
    xq_t = tassemble.element_geometry(tq, torch.as_tensor(xe))[0].numpy()
    np.testing.assert_array_equal(xq_t, xq_j)
    pj, pt = jproblems.islands(), tproblems.islands()

    def jb(x):
        return jnp.stack([x[..., 1], -x[..., 0]], -1)

    def tb(x):
        return torch.stack([x[..., 1], -x[..., 0]], -1)

    def c(x):
        return 1.0 + x[..., 0]

    def f(x):
        return 1.0 + x[..., 0] * x[..., 1]

    Kj, fj = jassemble.assemble_convection_diffusion(
        jq, jnp.asarray(xe), pj.alpha, jb, c, f)
    Kt, ft = tassemble.assemble_convection_diffusion(
        tq, torch.as_tensor(xe), pt.alpha, tb, c, f)
    assert _rel(Kt.numpy(), Kj) < 1e-13 and _rel(ft.numpy(), fj) < 1e-13


def _quadratic_problems():
    """u = x^2 + y^2, the exact solution of -Δu = -4 with u = g on the
    boundary, lies in the P2 space."""
    jp = jproblems.Problem(f=lambda x: -4.0 * jnp.ones(x.shape[:-1]),
                           g=lambda x: x[..., 0] ** 2 + x[..., 1] ** 2)
    tp = tproblems.Problem(f=lambda x: torch.full(x.shape[:-1], -4.0,
                                                  dtype=x.dtype),
                           g=lambda x: x[..., 0] ** 2 + x[..., 1] ** 2)
    return jp, tp


@pytest.mark.parametrize("kind", list(SIMPLEX))
def test_p2_constrained_system_matches_jax(kind):
    """The degree-2 constrained system (A_c, rhs, g) of the quadratic
    problem on 8^2 cells to 1e-13, and its solution exact to 1e-9; the
    same system from ``convert.discretization_from_numpy``."""
    jp, tp = _quadratic_problems()
    dj = JDisc(j_grid((8, 8), simplex=SIMPLEX[kind]), jp, degree=2)
    dt = Discretization(structured_grid((8, 8), simplex=SIMPLEX[kind]), tp,
                        "cpu", degree=2)
    assert dt.n_dofs == dj.n_dofs and dt.quad.phi.shape[1] == (6 if kind == "tri" else 9)
    Aj, rj, gj = dj.constrained_system()
    At, rt, gt = dt.constrained_system()
    Sj, St = dj.pattern.to_scipy(Aj), dt.pattern.to_scipy(At)
    assert abs(St - Sj).max() < 1e-13 * abs(Sj).max()
    assert _rel(rt.numpy(), rj) < 1e-13 and _rel(gt.numpy(), gj) < 1e-13
    np.testing.assert_array_equal(dt.dirichlet_mask.numpy(),
                                  np.asarray(dj.dirichlet_mask))
    u = gt.numpy() + spla.spsolve(St.tocsc(), rt.numpy())
    xy = dt._node_coords.numpy()
    np.testing.assert_allclose(u, xy[:, 0] ** 2 + xy[:, 1] ** 2, atol=1e-9)
    # carried across with the JAX package's Dirichlet data pinned
    dc = discretization_from_numpy(
        structured_grid((8, 8), simplex=SIMPLEX[kind]), tp, 1,
        np.asarray(dj.dirichlet_mask), np.asarray(dj.dirichlet_values),
        device="cpu", degree=2)
    Ac, rc, _ = dc.constrained_system()
    assert torch.equal(Ac.vals, At.vals) and torch.equal(rc, rt)


def test_degree_2_is_scalar_only():
    with pytest.raises(ValueError):
        Discretization(structured_grid((4, 4)), tproblems.simple(), "cpu",
                       n_comp=2, degree=2)
    with pytest.raises(ValueError):
        Discretization(structured_grid((4, 4)), tproblems.simple(), "cpu",
                       degree=3)


CELLS, N_SUB = 12, 4


def _geneo_ptree(api):
    pt = api.default_ptree()
    pt["coarsespace.type"] = "geneo"
    pt["coarse_solver.type"] = "cholesky"
    pt["geneo.eigensolver.nev"] = 8
    pt["solver.reduction"] = 1e-8
    pt["solver.restart"] = 50
    return pt


def test_p2_geneo_solve_matches_jax():
    """Islands on P2 triangles, 12^2 cells / 4 RCB subdomains, overlap 2,
    Jacobi-equilibrated, GenEO nev 8, GMRES(50) to 1e-8, each problem built
    by hand as tests/test_p2.py does (``setup_problem`` takes no degree):
    the same topology, the same iterations, solutions within 1e-8."""
    from ddm_tpu.core.indexmaps import pou_weights as j_pou
    from ddm_tpu.core.setup import setup_topology as j_topology
    from ddm_tpu.core.sparse import jacobi_equilibrate as j_equilibrate
    from ddm_tpu.solvers.krylov import gmres_solve as j_gmres
    from ddm_tpu.solvers.krylov import operator_of, prec_of
    from ddm_tpu_torch.core.indexmaps import pou_weights
    from ddm_tpu_torch.core.setup import setup_topology
    from ddm_tpu_torch.core.sparse import jacobi_equilibrate
    from ddm_tpu_torch.solvers.krylov import gmres_solve

    disc = JDisc(j_grid((CELLS, CELLS), simplex=True), jproblems.islands(),
                 degree=2)
    A, rhs, g = disc.constrained_system()
    A, rhs, scale = j_equilibrate(A, rhs)
    topo, ep = j_topology(disc, overlap=2, n_sub=N_SUB)
    pj = japi.DDMProblem(disc=disc, topo=topo, A=A, rhs=rhs, g=g,
                         pou=j_pou(topo, "distance"), ptree=_geneo_ptree(japi),
                         elem_part=ep, scale=scale)
    rj = j_gmres(operator_of(A), prec_of(japi.build_preconditioner(pj)), rhs,
                 jnp.zeros_like(rhs), reduction=1e-8, maxit=300, restart=50)

    dt = Discretization(structured_grid((CELLS, CELLS), simplex=True),
                        tproblems.islands(), "cpu", degree=2)
    At, rt, gt = dt.constrained_system()
    At, rt, st = jacobi_equilibrate(At, rt)
    topo_t, ep_t = setup_topology(dt, overlap=2, n_sub=N_SUB)
    np.testing.assert_array_equal(topo_t.sub2glob, topo.sub2glob)
    pt = tapi.DDMProblem(disc=dt, topo=topo_t, A=At, rhs=rt, g=gt,
                         pou=pou_weights(topo_t, "distance"),
                         ptree=_geneo_ptree(tapi), device=torch.device("cpu"),
                         elem_part=ep_t, scale=st)
    M = tapi.build_preconditioner(pt)
    res = gmres_solve(At.mv, M.apply, rt, torch.zeros_like(rt),
                      reduction=1e-8, maxit=300, restart=50)
    assert res.converged and res.iterations == int(rj.iterations) <= 40
    uj = np.asarray(scale) * np.asarray(rj.x)
    assert _rel((st * res.x).numpy(), uj) < 1e-8
