"""Vector-valued linear elasticity, flexible GMRES, the POU / rigid-body
coarse space, the global coarse-matrix formula, the multiplicative
combination and the LU solver of the PyTorch port, each against the JAX
package on the same inputs (the JAX side on the CPU with x64), and the
steel-rubber slice as a whole: 32^2 cells on [0,3]x[0,1], two displacement
components per node (2,178 dofs), 16 subdomains, overlap 2.

Whole slice, f64: geneo nev 8 under flexible GMRES(50) to 1e-8 takes the
JAX package's iteration count (25), with the solution within 1e-6; left-
preconditioned GMRES "converges" there at a true residual near 4e-4 (the
preconditioner distorts norms by the stiffness contrast), which is why the
elasticity path runs the flexible solver and every check reads the true
residual.  The dd variant: within 2 iterations, true residual <= 1e-7.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddm_tpu.api as japi
from ddm_tpu.coarse.pou_space import rigid_body_modes as j_rigid_body_modes
from ddm_tpu.fem import problems as jproblems
from ddm_tpu.fem.assemble import ElementQuadrature as JQuad
from ddm_tpu.fem.assemble import assemble_linear_elasticity as j_assemble
from ddm_tpu.fem.discretize import Discretization as JDisc
from ddm_tpu.fem.grids import structured_grid as j_grid
from ddm_tpu.precond.combined import build_combined as j_build_combined
from ddm_tpu.precond.galerkin import build_galerkin as j_build_galerkin
from ddm_tpu.precond.galerkin import galerkin_coarse_matrix as j_global_matrix
from ddm_tpu.precond.schwarz import build_schwarz as j_build_schwarz
from ddm_tpu.precond.two_level import build_coarse_space as j_coarse_space
from ddm_tpu.solvers import krylov as jkrylov
from ddm_tpu.solvers.direct import factor_batched as j_factor
from ddm_tpu_torch import api as tapi
from ddm_tpu_torch import convert
from ddm_tpu_torch.coarse.pou_space import rigid_body_modes
from ddm_tpu_torch.fem import problems as tproblems
from ddm_tpu_torch.fem.assemble import ElementQuadrature, assemble_linear_elasticity
from ddm_tpu_torch.fem.discretize import Discretization
from ddm_tpu_torch.fem.grids import structured_grid
from ddm_tpu_torch.precond.combined import build_combined
from ddm_tpu_torch.precond.galerkin import build_galerkin, galerkin_coarse_matrix
from ddm_tpu_torch.precond.two_level import build_coarse_space
from ddm_tpu_torch.solvers import krylov as tkrylov
from ddm_tpu_torch.solvers.direct import BatchedCholesky, BatchedLU, factor_batched

torch.set_num_threads(2)

# (cells, extent, problem name): a 2-D strip and a 3-D bar
CASES = {
    2: ((12, 8), (3.0, 1.0), "steel_rubber_2d"),
    3: ((4, 8, 12), (3.0, 1.0, 1.5), "steel_rubber_bar"),
}


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _discs(dim):
    cells, extent, name = CASES[dim]
    dj = JDisc(j_grid(cells, (0,) * dim, extent), getattr(jproblems, name)(),
               n_comp=dim)
    dt = Discretization(structured_grid(cells, (0,) * dim, extent),
                        getattr(tproblems, name)(), "cpu", n_comp=dim)
    return dj, dt


@pytest.mark.parametrize("dim,elem", [(2, "quad"), (3, "hex")])
def test_assemble_linear_elasticity_matches_jax(dim, elem):
    """Element matrices and load vectors of the steel-rubber coefficients on
    quads and hexes, node-major / component-minor: 1e-13 relative."""
    cells, extent, name = CASES[dim]
    grid = structured_grid(cells, (0,) * dim, extent)
    assert grid.elem_type == elem
    xe = grid.nodes[grid.elems]
    pj, pt = getattr(jproblems, name)(), getattr(tproblems, name)()
    Kj, fj = j_assemble(JQuad(elem), jnp.asarray(xe), pj.lam, pj.mu, pj.f)
    Kt, ft = assemble_linear_elasticity(
        ElementQuadrature(elem, "cpu"), torch.as_tensor(xe), pt.lam, pt.mu, pt.f)
    nl = grid.elems.shape[1] * dim
    assert Kt.shape == (grid.n_elems, nl, nl) and ft.shape == (grid.n_elems, nl)
    assert _relerr(Kt, Kj) < 1e-13 and _relerr(ft, fj) < 1e-13
    # both materials occur, so the coefficient jump is exercised
    k_max = np.abs(np.asarray(Kj)).max(axis=(1, 2))
    assert k_max.max() > 100 * k_max.min()


@pytest.mark.parametrize("dim", [2, 3])
def test_discretization_n_comp_matches_jax(dim):
    """Discretization(n_comp = 2 and 3): the constrained operator, right-hand
    side, the Dirichlet mask repeated per component and the vector boundary
    data: 1e-13 relative."""
    dj, dt = _discs(dim)
    assert dt.n_dofs == dj.n_dofs == dt.grid.n_nodes * dim
    np.testing.assert_array_equal(dt.dof_tuples(), dj.dof_tuples())
    np.testing.assert_array_equal(dt.dirichlet_mask.numpy(),
                                  np.asarray(dj.dirichlet_mask))
    Aj, bj, gj = dj.constrained_system()
    At, bt, gt = dt.constrained_system()
    Sj, St = dj.pattern.to_scipy(Aj), dt.pattern.to_scipy(At)
    assert abs(Sj - St).max() < 1e-13 * abs(Sj).max()
    assert _relerr(bt, bj) < 1e-13
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))


@pytest.mark.parametrize("dim,n_modes", [(2, 3), (3, 6)])
def test_rigid_body_modes_in_kernel(dim, n_modes):
    """The same translations and rotations as the JAX package, and the
    unconstrained elastic operator annihilates them."""
    _, dt = _discs(dim)
    modes = rigid_body_modes(dt.grid.nodes, dim)
    modes_j = j_rigid_body_modes(dt.grid.nodes, dim)
    assert len(modes) == len(modes_j) == n_modes
    A, _ = dt.assemble()
    a_max = float(A.vals.abs().max())
    for m, mj in zip(modes, modes_j):
        np.testing.assert_array_equal(m, np.asarray(mj))
        r = A.mv(torch.as_tensor(m))
        assert float(r.abs().max()) < 1e-9 * a_max * (np.abs(m).max() + 1)


def test_elasticity_entry_point_needs_a_device():
    """``setup_problem(..., n_comp=2)`` without ``device=`` raises where
    there is no CUDA, as the scalar entry point does."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    cells, extent, _ = CASES[2]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.setup_problem(problem=tproblems.steel_rubber_2d(),
                           grid=structured_grid(cells, (0, 0), extent),
                           parts=(2, 2), n_comp=2)


# -- the 32^2 / 16 steel-rubber state, built once by both packages -----------

GRID, PARTS, EXTENT = 32, (4, 4), (3.0, 1.0)


def _ptree(api, coarse="geneo", solver="restartedflexiblegmressolver", **keys):
    pt = api.default_ptree()
    pt["overlap"] = 2
    pt["solver.type"] = solver
    pt["solver.reduction"] = 1e-8
    pt["solver.maxit"] = 400
    pt["solver.restart"] = 50
    pt["solver.verify"] = False
    pt["coarsespace.type"] = coarse
    pt["geneo.eigensolver.nev"] = 8
    pt["coarse_solver.type"] = "cholesky"
    for k, v in keys.items():
        pt[k] = v
    return pt


def _setup(api, problems, grid_fn, pt, **dev):
    return api.setup_problem(
        pt, problem=problems.steel_rubber_2d(),
        grid=grid_fn((GRID, GRID), (0, 0), EXTENT), parts=PARTS, n_comp=2,
        **dev)


def _true_res(p, x, norm):
    return float(norm(p.A.mv(x) - p.rhs) / norm(p.rhs))


@pytest.fixture(scope="module")
def state():
    """The JAX package's problem, geneo basis, preconditioners and FGMRES
    solve, and the port's problem over the same operator and topology
    arrays (carried by ``convert``), with the port's own discretization
    pinned to the JAX package's Dirichlet mask and boundary data."""
    s = {}
    pj = _setup(japi, jproblems, j_grid, _ptree(japi))
    topo = pj.topo
    s["pj"] = pj
    # the geneo basis step by step, as the JAX package's geneo_coarse_space
    # takes them, keeping the pencils and their eigenvalues
    from ddm_tpu.coarse.basis import finalize_basis as j_finalize
    from ddm_tpu.coarse.geneo import neumann_matrices as j_neumann
    from ddm_tpu.eigen import EigensolverParams as JParams
    from ddm_tpu.eigen import solve_gevp as j_solve_gevp
    from ddm_tpu.fem.subassembly import scale_matrix_with_pou as j_scale

    A_neu, B_neu = j_neumann(pj)
    lam, V, active = j_solve_gevp(
        A_neu, j_scale(B_neu, jnp.asarray(pj.pou)),
        JParams.from_ptree(pj.ptree.sub("geneo.eigensolver")))
    s["neumann_j"] = (np.asarray(A_neu), np.asarray(B_neu))
    s["lam_j"], s["act_j"] = np.asarray(lam), np.asarray(active)
    s["basis_j"] = j_finalize(V, jnp.asarray(pj.pou), jnp.asarray(topo.valid),
                              active)
    s["fine_j"] = j_build_schwarz(pj.A, topo, pj.pou, pj.ptree)
    s["gal_j"] = j_build_galerkin(pj.A, topo, s["basis_j"], pj.ptree,
                                  method="pairs")
    from ddm_tpu.core.indexmaps import dual_scatter_map

    dualT = np.asarray(dual_scatter_map(topo))
    grid = structured_grid((GRID, GRID), (0, 0), EXTENT)
    disc = convert.discretization_from_numpy(
        grid, tproblems.steel_rubber_2d(), 2,
        np.asarray(pj.disc.dirichlet_mask), np.asarray(pj.disc.dirichlet_values),
        device="cpu")
    s["pt"] = convert.problem_from_numpy(
        np.asarray(pj.A.colsT), np.asarray(pj.A.valsT), np.asarray(pj.rhs),
        np.asarray(pj.g), np.asarray(pj.scale), pj.pou, topo.sub2glob,
        topo.valid, topo.bdist, topo.boundary, dualT,
        overlap=topo.overlap, device="cpu", ptree=_ptree(tapi), disc=disc)
    s["basis_t"] = convert.basis_from_numpy(
        np.asarray(s["basis_j"].V), np.asarray(s["basis_j"].active),
        device="cpu")
    s["d"] = np.random.default_rng(11).standard_normal(topo.n_glob)
    return s


def test_convert_carries_the_elasticity_problem(state):
    """``convert`` hands over n_comp, the repeated Dirichlet mask and the
    vector boundary data; the port's own assembly over them reproduces the
    JAX package's equilibrated operator."""
    pj, pt = state["pj"], state["pt"]
    assert pt.disc.n_comp == 2 and pt.disc.n_dofs == pj.disc.n_dofs == 2178
    np.testing.assert_array_equal(pt.disc.dirichlet_mask.numpy(),
                                  np.asarray(pj.disc.dirichlet_mask))
    own = _setup(tapi, tproblems, structured_grid, _ptree(tapi), device="cpu")
    Sj = pj.disc.pattern.to_scipy(pj.A)
    St = own.disc.pattern.to_scipy(own.A)
    assert abs(Sj - St).max() < 1e-13 * abs(Sj).max()
    assert _relerr(own.rhs, pj.rhs) < 1e-12


def test_geneo_pencils_keep_the_rigid_body_modes(state):
    """GenEO on the vector-valued pencils (floating subdomains: a singular
    Neumann matrix with 3 rigid-body modes): the same kept-mode counts as
    the JAX package, nonzero eigenvalues within 1e-8 relative, the
    near-zero ones (|lambda| < 1e-6) by absolute size."""
    from ddm_tpu_torch.coarse.geneo import neumann_matrices
    from ddm_tpu_torch.eigen import EigensolverParams, solve_gevp
    from ddm_tpu_torch.fem.subassembly import scale_matrix_with_pou

    pt = state["pt"]
    Aj, Bj = state["neumann_j"]
    At, Bt = neumann_matrices(pt)
    assert _relerr(At, Aj) < 1e-12 and _relerr(Bt, Bj) < 1e-12
    lam_t, _, act_t = solve_gevp(
        At, scale_matrix_with_pou(Bt, torch.as_tensor(pt.pou)),
        EigensolverParams.from_ptree(pt.ptree.sub("geneo.eigensolver")))
    lam_j, lam_t = state["lam_j"], lam_t.numpy()
    np.testing.assert_array_equal(act_t.numpy(), state["act_j"])
    assert int(act_t.sum()) == int(state["basis_j"].active.sum()) == 16 * 8
    small = np.abs(lam_j) < 1e-6
    # 9 interior subdomains float (3 modes each); 3 of the 4 subdomains on
    # the clamped edge x = 0 are held
    assert small.sum(axis=1).tolist().count(3) >= 9
    assert np.abs(lam_t - lam_j)[small].max() < 1e-7
    assert (np.abs(lam_t - lam_j)[~small]
            <= 1e-8 * np.abs(lam_j)[~small]).all()


def test_global_coarse_matrix_matches_pairs_and_jax(state):
    """The always-exact ``global`` formula on the geneo basis: equal to the
    ``pairs`` matrix (the basis vanishes on subdomain boundaries) and to
    the JAX package's ``global`` matrix, 1e-10 relative; in one group and
    in ragged groups of 5 subdomains."""
    pj, pt = state["pj"], state["pt"]
    basis = state["basis_t"]
    s2g = torch.as_tensor(pt.topo.sub2glob.astype(np.int64))
    E_glob = galerkin_coarse_matrix(pt.A, s2g, basis)
    E_grp = galerkin_coarse_matrix(pt.A, s2g, basis, group=5)
    E_j = j_global_matrix(pj.A, jnp.asarray(pj.topo.sub2glob), state["basis_j"])
    gal = build_galerkin(pt.A, pt.topo, basis, pt.ptree, method="pairs")
    E_pairs = gal.E_mat
    assert _relerr(E_glob, E_j) < 1e-10 and _relerr(E_grp, E_j) < 1e-10
    active = basis.active.reshape(-1)
    E_act = E_glob[active][:, active]
    assert _relerr(E_act, E_pairs[active][:, active]) < 1e-10
    # build_galerkin takes the global formula when asked
    gal_g = build_galerkin(pt.A, pt.topo, basis, pt.ptree, method="global")
    assert _relerr(gal_g.E_mat, E_pairs) < 1e-10


def test_two_level_switches_to_global_for_a_non_vanishing_basis(state, monkeypatch):
    """A basis that does not vanish on subdomain boundaries gets the global
    formula from ``build_two_level`` though the config says ``pairs``."""
    from ddm_tpu_torch.precond import two_level

    seen = []
    basis = dataclasses.replace(state["basis_t"], boundary_vanishing=False)
    monkeypatch.setattr(two_level, "build_coarse_space",
                        lambda *a, **k: basis)
    real = two_level.build_galerkin
    monkeypatch.setattr(
        two_level, "build_galerkin",
        lambda *a, method, **k: seen.append(method) or real(*a, method=method, **k))
    M = two_level.build_two_level(state["pt"])
    assert seen == ["global"] and M.mode == "additive" and M.op is None


@pytest.mark.parametrize("mode", ["additive", "multiplicative"])
def test_combined_apply_matches_jax(state, mode):
    """Fine Schwarz + Galerkin correction combined additively and
    multiplicatively (x1 = P1 d, x2 = x1 + P2 (d - A x1)), over the JAX
    package's basis, fine and coarse Cholesky factors carried across.
    The two libraries' triangular solves on the same factors agree to
    eps * cond (the applied vector grows by 1e4): 1e-10 relative, as for
    the scalar Galerkin apply."""
    pj, pt = state["pj"], state["pt"]
    Mj = j_build_combined([state["fine_j"], state["gal_j"]], op=pj.A)
    Mj = dataclasses.replace(Mj, mode=mode)
    fine = convert.schwarz_from_numpy(
        pt.topo.sub2glob, pt.topo.valid, pt.pou, state["pt"].topo._dual_scatter_map,
        chol=np.asarray(state["fine_j"].factors.chol), device="cpu")
    gal = convert.galerkin_from_numpy(
        np.asarray(state["gal_j"].E_mat), np.asarray(state["basis_j"].V),
        np.asarray(state["basis_j"].active), pt.topo.sub2glob,
        state["pt"].topo._dual_scatter_map, device="cpu")
    gal = dataclasses.replace(gal, coarse=BatchedCholesky(
        chol=torch.tensor(np.asarray(state["gal_j"].coarse.chol))))
    pt_mode = tapi.default_ptree()
    pt_mode["combined_preconditioner.mode"] = mode
    Mt = build_combined([fine, gal], pt_mode, op=pt.A)
    assert Mt.mode == mode
    y = Mt.apply(torch.as_tensor(state["d"]))
    assert _relerr(y, Mj.apply(jnp.asarray(state["d"]))) < 1e-10
    if mode == "multiplicative":
        with pytest.raises(ValueError, match="operator A is not provided"):
            build_combined([fine, gal], pt_mode).apply(torch.as_tensor(state["d"]))


def test_pou_rigid_body_basis_matches_jax(state):
    """The POU coarse space with the 3 rigid-body templates of the 2-D
    problem, zeroed at the clamped dofs and POU-finalized: 1e-12."""
    pj, pt = state["pj"], state["pt"]
    bj = j_coarse_space(pj, "pou", pj.ptree)
    bt = build_coarse_space(pt, "pou", pt.ptree)
    assert bt.V.shape == (16, 3, pt.topo.n_pad) and bt.boundary_vanishing
    np.testing.assert_array_equal(bt.active.numpy(), np.asarray(bj.active))
    assert np.abs(bt.V.numpy() - np.asarray(bj.V)).max() < 1e-12


def test_batched_lu_solves_match_jax(state):
    """LU factors of a batch of nonsymmetric, well-conditioned matrices (the
    leading 96 x 96 blocks of four subdomains' Neumann matrices, perturbed
    and shifted by the identity): single and multiple right-hand sides
    against the JAX package's BatchedLU, 1e-12 relative; the explicit
    inverse built from them agrees with the factors' solve."""
    A = state["neumann_j"][0][:4, :96, :96].copy()
    rng = np.random.default_rng(5)
    A += 1e-3 * rng.standard_normal(A.shape) * (np.abs(A) > 0)
    A += np.eye(A.shape[-1])
    b1 = rng.standard_normal(A.shape[:2])
    b3 = rng.standard_normal(A.shape[:2] + (3,))
    Fj = j_factor(jnp.asarray(A), "umfpack")
    Ft = factor_batched(torch.as_tensor(A), "umfpack")
    assert isinstance(Ft, BatchedLU)
    assert _relerr(Ft.solve(torch.as_tensor(b1)), Fj.solve(jnp.asarray(b1))) < 1e-12
    assert _relerr(Ft.solve(torch.as_tensor(b3)), Fj.solve(jnp.asarray(b3))) < 1e-12
    inv = factor_batched(torch.as_tensor(A), "lu", mode="inverse")
    assert _relerr(inv.solve(torch.as_tensor(b1)), Ft.solve(torch.as_tensor(b1))) < 1e-9
    with pytest.raises(ValueError, match="Unknown subdomain solver"):
        factor_batched(torch.as_tensor(A), "qr")


@pytest.mark.parametrize("prec_kind", ["identity", "jacobi"])
def test_fgmres_matches_jax(state, prec_kind):
    """Flexible GMRES(20) on the equilibrated elasticity operator, shifted
    to be well conditioned, with no preconditioner and with a Jacobi-type
    diagonal one, over several restart cycles: the same iteration count
    and the defect history within 1e-10 of the first defect."""
    pj, pt = state["pj"], state["pt"]
    n = pj.A.n
    w = 0.5 + np.random.default_rng(3).random(n)  # a diagonal preconditioner
    shift = 0.3

    def op_j(x):
        return pj.A.mv(x) + shift * x

    def op_t(x):
        return pt.A.mv(x) + shift * x

    import jax

    pre_j = None if prec_kind == "identity" else jax.tree_util.Partial(
        lambda wj, d: wj * d, jnp.asarray(w))
    pre_t = None if prec_kind == "identity" else (
        lambda d, wt=torch.as_tensor(w): wt * d)
    kw = dict(reduction=1e-8, maxit=200, restart=20)
    rj = jkrylov.fgmres_solve(jax.tree_util.Partial(op_j), pre_j, pj.rhs,
                              jnp.zeros(n), **kw)
    rt = tkrylov.fgmres_solve(op_t, pre_t, pt.rhs, torch.zeros(n,
                              dtype=torch.float64), **kw)
    assert rt.converged and bool(rj.converged)
    assert rt.iterations == int(rj.iterations) > 20
    hj = np.asarray(rj.history)
    np.testing.assert_array_equal(np.isnan(rt.history), np.isnan(hj))
    k = rt.iterations + 1
    assert np.abs(rt.history[:k] - hj[:k]).max() < 1e-10 * hj[0]
    assert _relerr(rt.x, rj.x) < 1e-8
    assert rt.estimate_hit == rt.iterations


# -- the slice as a whole -------------------------------------------------------

@pytest.fixture(scope="module")
def slice_runs(state):
    """{case: ((its, true_res, u) of the JAX package, of the port)}: geneo
    under flexible GMRES in f64, and under left-preconditioned GMRES."""
    out = {}
    for case, solver in (("fgmres", "restartedflexiblegmressolver"),
                         ("gmres", "restartedgmressolver")):
        pj = state["pj"]
        ptj = _ptree(japi, solver=solver)
        rj = jkrylov.solve_from_config(
            jkrylov.operator_of(pj.A),
            jkrylov.prec_of(j_build_combined([state["fine_j"], state["gal_j"]])),
            pj.rhs, jnp.zeros_like(pj.rhs), ptj, "solver")
        pt = _setup(tapi, tproblems, structured_grid,
                    _ptree(tapi, solver=solver), device="cpu")
        rt = tapi.solve(pt)
        out[case] = (
            (int(rj.iterations), bool(rj.converged),
             _true_res(pj, rj.x, jnp.linalg.norm),
             np.asarray(japi.solution(pj, rj))),
            (rt.iterations, rt.converged, _true_res(pt, rt.x, torch.linalg.norm),
             tapi.solution(pt, rt).numpy()))
    return out


def test_elasticity_slice_fgmres_matches_jax(slice_runs):
    """geneo + flexible GMRES, f64: the JAX package's count (25), true
    residual <= 1e-8 on both sides, solutions within 1e-6."""
    (it_j, conv_j, tr_j, u_j), (it_t, conv_t, tr_t, u_t) = slice_runs["fgmres"]
    assert conv_j and conv_t
    assert it_t == it_j == 25
    assert tr_j <= 1e-8 and tr_t <= 1e-8
    assert np.abs(u_t - u_j).max() <= 1e-6 * np.abs(u_j).max()


def test_elasticity_left_gmres_is_norm_distorted(slice_runs):
    """Left-preconditioned GMRES reports convergence in the same number of
    iterations as the JAX package (15) at a true residual above 1e-4: the
    reason every elasticity check reads the true residual."""
    (it_j, conv_j, tr_j, _), (it_t, conv_t, tr_t, _) = slice_runs["gmres"]
    assert conv_j and conv_t and it_t == it_j == 15
    assert 1e-4 < tr_j < 1e-3 and 1e-4 < tr_t < 1e-3
    assert abs(tr_t - tr_j) < 1e-3 * tr_j


@pytest.mark.parametrize("keys,its_f64", [
    ({"schwarz.subdomain_solver.precision": "dd",
      "coarse_solver.precision": "dd", "solver.verify": True}, 25),
    ({"coarse_solver.type": "lu", "schwarz.subdomain_solver.type": "lu"}, 25),
    ({"combined_preconditioner.mode": "multiplicative"}, 14),
    ({"coarse_solver.matrix_method": "global"}, 25),
], ids=["dd", "lu", "multiplicative", "global"])
def test_elasticity_slice_variants(keys, its_f64):
    """The port's own variants of the slice through the entry points: the
    dd inverses (verified), LU solves, the multiplicative combination and
    the global coarse matrix: within 2 iterations of the f64 count (the
    multiplicative form needs fewer), true residual <= 1e-7."""
    pt = _setup(tapi, tproblems, structured_grid, _ptree(tapi, **keys),
                device="cpu")
    res = tapi.solve(pt)
    assert res.converged and abs(res.iterations - its_f64) <= 2
    assert _true_res(pt, res.x, torch.linalg.norm) <= 1e-7


def test_pou_slice_matches_jax():
    """The POU / rigid-body coarse space under left-preconditioned GMRES on
    a 16^2 / 4-subdomain strip, to 1e-6, LU coarse solve: the same count
    as the JAX package, solutions within 1e-6 (measured against each
    side's true residual)."""
    def run(api, problems, grid_fn, **dev):
        pt = api.default_ptree()
        pt["overlap"] = 2
        pt["solver.reduction"] = 1e-6
        pt["solver.maxit"] = 300
        pt["solver.restart"] = 100
        pt["coarsespace.type"] = "pou"
        pt["coarse_solver.type"] = "lu"
        p = api.setup_problem(
            pt, problem=problems.steel_rubber_2d(),
            grid=grid_fn((16, 16), (0, 0), EXTENT), parts=(2, 2), n_comp=2,
            **dev)
        res = api.solve(p)
        return p, res

    pj, rj = run(japi, jproblems, j_grid)
    pt, rt = run(tapi, tproblems, structured_grid, device="cpu")
    assert rt.converged and bool(rj.converged)
    assert rt.iterations == int(rj.iterations)
    hj = np.asarray(rj.history)
    k = rt.iterations + 1
    assert np.abs(rt.history[:k] - hj[:k]).max() < 1e-6 * hj[0]
