"""Discontinuous Galerkin in the PyTorch port against the JAX package: Q1
SIPG on structured quads, P1 SIPG on triangles, the indefinite
(``spd=False``) GEVP on DG Neumann pencils, and the two-level DG solve of
the convection-diffusion example (overlap 1, multiplicative GenEO, LU
subdomain and coarse solvers, standard POU).

Tolerances: assembled matrices, right-hand sides and Neumann stamps to
1e-12 relative; u = x reproduced to 1e-10 (SIPG is consistent); eigenvalues
to 1e-8 relative to max(|lambda|, shift) with equal kept counts; GMRES
iterations equal, solutions within 1e-6.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import ddm_tpu.api as japi
from ddm_tpu.fem import dg as jdg
from ddm_tpu.fem import problems as jproblems
from ddm_tpu.fem.grids import structured_grid as j_grid
from ddm_tpu_torch.fem import dg as tdg
from ddm_tpu_torch.fem import problems as tproblems
from ddm_tpu_torch.fem.grids import structured_grid

from blas_threads import one_blas_thread  # noqa: E402,F401

torch.set_num_threads(2)

# kind -> (JAX class, port class, cells, simplex)
KINDS = {"q1": (jdg.DGDiscretization, tdg.DGDiscretization, (6, 6), False),
         "p1": (jdg.SimplexDGDiscretization, tdg.SimplexDGDiscretization,
                (5, 7), True)}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _pair(kind, jp, tp):
    jcls, tcls, cells, simplex = KINDS[kind]
    return (jcls(j_grid(cells, simplex=simplex), jp),
            tcls(structured_grid(cells, simplex=simplex), tp, "cpu"))


@pytest.mark.parametrize("kind", list(KINDS))
def test_dg_matrices_and_stamps_match_jax(kind):
    """The heterogeneous convection-diffusion problem: the assembled matrix
    and right-hand side, and every Neumann stamp group (of the symmetrized
    operator), to 1e-12."""
    dj, dt = _pair(kind, jproblems.dg_heterogeneous(),
                   tproblems.dg_heterogeneous())
    Aj, bj, _ = dj.constrained_system()
    At, bt, gt = dt.constrained_system()
    Sj, St = dj.pattern.to_scipy(Aj), dt.pattern.to_scipy(At)
    assert (Sj != Sj.T).nnz and abs(Sj - St).max() < 1e-12 * abs(Sj).max()
    assert _rel(bt.numpy(), bj) < 1e-12 and not gt.any()
    assert not dt.dirichlet_mask.any() and dt.definite is False
    groups_j, groups_t = dj.neumann_stamps(), dt.neumann_stamps()
    assert len(groups_t) == len(groups_j) == (3 if kind == "q1" else 2)
    for (dofs_j, Kj), (dofs_t, Kt) in zip(groups_j, groups_t):
        np.testing.assert_array_equal(dofs_t, dofs_j)
        assert _rel(Kt.numpy(), Kj) < 1e-12
        np.testing.assert_allclose(Kt.numpy(), Kt.numpy().swapaxes(1, 2),
                                   atol=1e-12 * float(Kt.abs().max()))


@pytest.mark.parametrize("kind", list(KINDS))
def test_dg_stamps_of_another_problem_match_jax(kind):
    """``neumann_stamps(problem)`` and, for Q1, the volume-only
    ``element_matrices(problem)`` of a second (nonsymmetric) problem on the
    same DG discretization equal the JAX package's to 1e-12."""
    dj, dt = _pair(kind, jproblems.dg_heterogeneous(),
                   tproblems.dg_heterogeneous())
    pj = jproblems.checkerboard_convection_diffusion()
    pt = tproblems.checkerboard_convection_diffusion()
    groups_j, groups_t = dj.neumann_stamps(pj), dt.neumann_stamps(pt)
    assert len(groups_t) == len(groups_j)
    for (dofs_j, Kj), (dofs_t, Kt), (_, Kown) in zip(
            groups_j, groups_t, dt.neumann_stamps()):
        np.testing.assert_array_equal(dofs_t, dofs_j)
        assert _rel(Kt.numpy(), Kj) < 1e-12
    assert not torch.equal(Kt, Kown)
    if kind == "q1":
        (Kj, fj), (Kt, ft) = dj.element_matrices(pj), dt.element_matrices(pt)
        assert _rel(Kt.numpy(), Kj) < 1e-12
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-12,
                                   atol=0)


@pytest.mark.parametrize("kind", list(KINDS))
def test_dg_reproduces_linear_exactly(kind):
    """SIPG is consistent: u = x lies in the DG space, so the discrete
    solution is exact (face terms cancel)."""
    _, tcls, cells, simplex = KINDS[kind]
    problem = tproblems.Problem(g=lambda x: x[..., 0])
    disc = tcls(structured_grid(cells, simplex=simplex), problem, "cpu")
    A, b, _ = disc.constrained_system()
    u = spla.spsolve(disc.pattern.to_scipy(A).tocsc(), b.numpy())
    np.testing.assert_allclose(u, disc.node_coords_dg()[:, 0], atol=1e-10)


# -- the two-level DG solve, 16^2 / (2, 2), overlap 1 -------------------------

GRID, PARTS = 16, (2, 2)


def _dg_ptree(api):
    """The example's settings (convectiondiffusiondg.ini) at 16^2, GMRES(50)
    to 1e-8."""
    pt = api.default_ptree()
    pt["gridsize"] = GRID
    pt["overlap"] = 1
    pt["combined_preconditioner.mode"] = "multiplicative"
    pt["coarsespace.type"] = "geneo"
    pt["coarse_solver.type"] = "lu"
    pt["geneo.eigensolver.nev"] = 6
    pt["schwarz.subdomain_solver.type"] = "umfpack"
    pt["solver.reduction"] = 1e-8
    return pt


@pytest.fixture(scope="module")
def dg_runs():
    """Both packages' DG problem, built and solved once: JAX's two-level
    preconditioner assembled as its ``build_two_level`` does, keeping the
    pencils' (lam, active); the port's through its example's ``setup``."""
    from ddm_tpu.coarse.basis import finalize_basis
    from ddm_tpu.coarse.geneo import neumann_matrices
    from ddm_tpu.core.indexmaps import pou_weights
    from ddm_tpu.core.setup import setup_topology
    from ddm_tpu.eigen import EigensolverParams, solve_gevp
    from ddm_tpu.fem.subassembly import scale_matrix_with_pou
    from ddm_tpu.precond.combined import build_combined
    from ddm_tpu.precond.galerkin import build_galerkin
    from ddm_tpu.precond.schwarz import build_schwarz
    from ddm_tpu.solvers.krylov import operator_of, prec_of, solve_from_config
    from ddm_tpu_torch import api as tapi
    from ddm_tpu_torch.examples.convectiondiffusiondg import setup

    ptj = _dg_ptree(japi)
    disc = jdg.DGDiscretization(j_grid((GRID, GRID)), jproblems.dg_heterogeneous())
    A, b, g = disc.constrained_system()
    topo, _ = setup_topology(disc, overlap=1, parts=PARTS)
    pou = pou_weights(topo, "standard")
    pj = japi.DDMProblem(disc=disc, topo=topo, A=A, rhs=b, g=g, pou=pou,
                         ptree=ptj, elem_part=None)
    A_neu, B_neu = neumann_matrices(pj)
    C = scale_matrix_with_pou(B_neu, jnp.asarray(pou))
    params = EigensolverParams.from_ptree(ptj.sub("geneo.eigensolver"))
    lam, V, active = solve_gevp(A_neu, C, params, spd=False)
    basis = finalize_basis(V, jnp.asarray(pou), jnp.asarray(topo.valid), active)
    coarse = build_galerkin(A, topo, basis, pj.ptree, method="pairs")
    fine = build_schwarz(A, topo, pou, pj.ptree)
    prec = build_combined([fine, coarse], pj.ptree, op=A)
    rj = solve_from_config(operator_of(A), prec_of(prec), b, jnp.zeros_like(b),
                           pj.ptree, "solver")
    pt = setup(_dg_ptree(tapi), "cpu", parts=PARTS)
    rt = tapi.solve(pt)
    return dict(
        jax=(pj, int(rj.iterations), np.asarray(rj.x)),
        port=(pt, rt.iterations, rt.x.numpy(), rt.converged),
        A_neu=np.asarray(A_neu), C=np.asarray(C), lam=np.asarray(lam),
        active=np.asarray(active))


def test_dg_neumann_pencils_match_jax(dg_runs):
    """Volume, boundary and face stamp groups summed per subdomain: the
    port's Neumann pencils equal the JAX package's (1e-12); some are
    indefinite."""
    from ddm_tpu_torch.coarse.geneo import neumann_matrices
    from ddm_tpu_torch.fem.subassembly import scale_matrix_with_pou

    pt = dg_runs["port"][0]
    A_neu, B_neu = neumann_matrices(pt)
    C = scale_matrix_with_pou(B_neu, torch.as_tensor(pt.pou))
    assert _rel(A_neu.numpy(), dg_runs["A_neu"]) < 1e-12
    assert _rel(C.numpy(), dg_runs["C"]) < 1e-12
    sym = 0.5 * (dg_runs["A_neu"] + dg_runs["A_neu"].swapaxes(1, 2))
    assert np.linalg.eigvalsh(sym).min() < 0


def test_dg_indefinite_gevp_matches_jax(dg_runs):
    """The spd=False branch on the JAX package's DG pencils: equal kept
    counts, kept eigenvalues to 1e-8 relative to max(|lambda|, shift)."""
    from ddm_tpu_torch.eigen import EigensolverParams, solve_gevp

    params = EigensolverParams.from_ptree(
        dg_runs["port"][0].ptree.sub("geneo.eigensolver"))
    lam, _, active = solve_gevp(torch.tensor(dg_runs["A_neu"]),
                                torch.tensor(dg_runs["C"]), params,
                                spd=False)
    np.testing.assert_array_equal(active.numpy(), dg_runs["active"])
    a = dg_runs["active"]
    ref = dg_runs["lam"][a]
    err = np.abs(lam.numpy()[a] - ref) / np.maximum(np.abs(ref), params.shift)
    assert err.max() < 1e-8


def test_dg_two_level_iterations_match_jax(dg_runs):
    """Multiplicative two-level GenEO on the nonsymmetric DG system: the
    same GMRES iterations as the JAX package, solutions to 1e-6."""
    pj, it_j, x_j = dg_runs["jax"]
    pt, it_t, x_t, converged = dg_runs["port"]
    assert pt.topo.n_pad == pj.topo.n_pad and converged
    assert it_t == it_j
    assert _rel(x_t, x_j) <= 1e-6


def test_dg_example_main_runs_on_cpu():
    """The example's entry point with its ini defaults (16 RCB subdomains)
    at 8^2 cells on the CPU; ``coefficient_file`` loads a scripted
    problem in place of the built-in one."""
    from ddm_tpu_torch.examples.convectiondiffusiondg import dg_ptree, main, setup

    p, res = main(["-gridsize", "8"], device="cpu")
    assert res.converged and p.topo.n_sub == 16
    assert p.disc.n_dofs == 4 * 8 * 8
    script = os.path.join(os.path.dirname(__file__), "..", "ddm_tpu_torch",
                          "examples", "coefficients",
                          "symmetric_convection_diffusion_coefficient.py")
    ps = setup(dg_ptree(["-gridsize", "8", "-coefficient_file", script]),
               "cpu")
    assert ps.disc.problem.name == script and ps.disc.problem.symmetric


def test_dg_ring_two_level_matches_jax(dg_runs):
    """geneo_ring on the DG problem: the ring pencils take the indefinite
    branch and the extension the direct route with LU (the discretization
    is not definite); the same GMRES iterations as the JAX package."""
    import dataclasses

    from ddm_tpu.precond.two_level import build_two_level as j_two_level
    from ddm_tpu.solvers.krylov import operator_of, prec_of, solve_from_config
    from ddm_tpu_torch import api as tapi
    from ddm_tpu_torch.coarse import ring

    def ring_ptree(pt):
        pt["coarsespace.type"] = "geneo_ring"
        pt["geneo_ring.eigensolver.nev"] = 6
        return pt

    pj = dg_runs["jax"][0]
    pj = dataclasses.replace(pj, ptree=ring_ptree(_dg_ptree(japi)))
    rj = solve_from_config(operator_of(pj.A), prec_of(j_two_level(pj)), pj.rhs,
                           jnp.zeros_like(pj.rhs), pj.ptree, "solver")
    pt = dg_runs["port"][0]
    pt = dataclasses.replace(pt, ptree=ring_ptree(_dg_ptree(tapi)))
    before = ring.ROUTES["direct"]
    rt = tapi.solve(pt)
    assert ring.ROUTES["direct"] == before + 1
    assert rt.converged and rt.iterations == int(rj.iterations)


def test_dd_lu_inverses_are_row_major():
    """The DG paths' double-single LU inverses (fine and coarse), which the
    kernel reads row by row: contiguous row-major hi/lo whose f64 sum is
    the inverse, not its transpose."""
    from ddm_tpu_torch.solvers.direct import factor_batched

    rng = np.random.default_rng(5)
    A = torch.as_tensor(rng.standard_normal((3, 40, 40)) + 40 * np.eye(40))
    f = factor_batched(A, "lu", mode="inverse", store_dtype="dd")
    assert f.inv_hi.is_contiguous() and f.inv_lo.is_contiguous()
    inv = f.inv_hi.double() + f.inv_lo.double()
    eye = torch.eye(40, dtype=torch.float64).expand_as(A)
    assert float((inv @ A - eye).abs().max()) < 1e-12
    assert float((inv.mT @ A - eye).abs().max()) > 1e-3
