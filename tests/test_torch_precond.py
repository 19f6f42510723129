"""Preconditioner modules of the PyTorch port against the JAX package, one
module at a time, on islands 32^2 / 16 subdomains.  The JAX package builds
its state (operator, canvas-layout topology, factors, Neumann matrices,
GenEO basis, coarse matrix) and ``ddm_tpu_torch.convert`` carries it across,
so each comparison isolates one module.

Tolerances: f64 data paths to 1e-12 (Schwarz apply over carried factors,
Neumann assembly); 1e-10 where a coarse solve or matrix-vector products
enter (coarse matrix, Galerkin apply); 1e-8 for eigenvalues; the
double-single apply to 1e-6, the repo's bound for f32 partial sums taken in
another order.  Each test states a bound that differs from these.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddm_tpu.api as japi
from ddm_tpu.coarse.basis import finalize_basis as j_finalize
from ddm_tpu.coarse.geneo import neumann_matrices as j_neumann
from ddm_tpu.core.indexmaps import dual_scatter_map
from ddm_tpu.eigen import EigensolverParams as JParams
from ddm_tpu.eigen import solve_gevp as j_solve_gevp
from ddm_tpu.eigen.dense_gevp import cholqr2 as j_cholqr2
from ddm_tpu.fem import problems as jproblems
from ddm_tpu.fem.subassembly import scale_matrix_with_pou as j_pou_scale
from ddm_tpu.precond.galerkin import build_galerkin as j_build_galerkin
from ddm_tpu.precond.schwarz import build_schwarz as j_build_schwarz
from ddm_tpu_torch import api as tapi
from ddm_tpu_torch import convert
from ddm_tpu_torch.coarse.geneo import neumann_matrices
from ddm_tpu_torch.eigen import EigensolverParams, solve_gevp
from ddm_tpu_torch.eigen.dense_gevp import cholqr2
from ddm_tpu_torch.fem import problems as tproblems
from ddm_tpu_torch.fem.discretize import Discretization
from ddm_tpu_torch.fem.grids import structured_grid
from ddm_tpu_torch.precond.extract import extract_subdomain_dense
from ddm_tpu_torch.precond.galerkin import _mask_inactive, galerkin_coarse_matrix_pairs
from ddm_tpu_torch.precond.schwarz import build_schwarz

torch.set_num_threads(2)

GRID, PARTS, NEV = 32, (4, 4), 8


def _ptree(api, precision="f64"):
    pt = api.default_ptree()
    pt["gridsize"] = GRID
    pt["coarsespace.type"] = "geneo"
    pt["geneo.eigensolver.nev"] = NEV
    pt["coarse_solver.type"] = "cholesky"
    if precision != "f64":
        pt["schwarz.subdomain_solver.precision"] = precision
    return pt


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def state():
    """The JAX package's state, and the port's problem over it."""
    pt = _ptree(japi)
    pj = japi.setup_problem(pt, problem=jproblems.islands(), parts=PARTS)
    topo = pj.topo
    s = dict(pj=pj, dualT=dual_scatter_map(topo))
    s["sch_f64"] = j_build_schwarz(pj.A, topo, pj.pou, pt)
    s["sch_dd"] = j_build_schwarz(pj.A, topo, pj.pou, _ptree(japi, "dd"))
    A_neu, B_neu = j_neumann(pj)
    C = j_pou_scale(B_neu, jnp.asarray(pj.pou))
    params = JParams.from_ptree(pt.sub("geneo.eigensolver"))
    lam, V, active = j_solve_gevp(A_neu, C, params)
    basis = j_finalize(V, jnp.asarray(pj.pou), jnp.asarray(topo.valid), active)
    s.update(A_neu=np.asarray(A_neu), B_neu=np.asarray(B_neu), C=np.asarray(C),
             lam=np.asarray(lam), active=np.asarray(active), basis=basis)
    s["gal"] = j_build_galerkin(pj.A, topo, basis, pt, method="pairs")
    disc = Discretization(structured_grid((GRID, GRID)), tproblems.islands(),
                          "cpu")
    s["pt"] = convert.problem_from_numpy(
        np.asarray(pj.A.colsT), np.asarray(pj.A.valsT), np.asarray(pj.rhs),
        np.asarray(pj.g), np.asarray(pj.scale), pj.pou, topo.sub2glob,
        topo.valid, topo.bdist, topo.boundary, s["dualT"],
        overlap=topo.overlap, ptree=_ptree(tapi), disc=disc,
    )
    s["d"] = np.random.default_rng(7).standard_normal(topo.n_glob)
    return s


@pytest.mark.parametrize("origin,tol", [("carried", 1e-12), ("built", 3e-9)])
def test_schwarz_f64_apply_matches_jax(state, origin, tol):
    """Restricted Schwarz apply over the JAX operator and topology, with the
    JAX package's Cholesky factors carried across (1e-12), or with the
    port's own extraction and Cholesky: two LAPACK factorizations of
    subdomain matrices with cond up to 1.4e7 agree to cond * eps ~ 3e-9."""
    p = state["pt"]
    if origin == "carried":
        M = convert.schwarz_from_numpy(
            p.topo.sub2glob, p.topo.valid, p.pou, state["dualT"],
            chol=np.asarray(state["sch_f64"].factors.chol))
    else:
        M = build_schwarz(p.A, p.topo, p.pou, p.ptree)
    y = M.apply(torch.as_tensor(state["d"])).numpy()
    assert _relerr(y, state["sch_f64"].apply(jnp.asarray(state["d"]))) < tol


@pytest.mark.parametrize("origin", ["carried", "built"])
def test_schwarz_dd_apply_matches_jax(state, origin):
    """Double-single Schwarz apply with two exact defect corrections: the
    JAX package's (hi, lo) inverse carried across, or built by the port."""
    p, fj = state["pt"], state["sch_dd"].factors
    if origin == "carried":
        M = convert.schwarz_from_numpy(
            p.topo.sub2glob, p.topo.valid, p.pou, state["dualT"],
            inv_hi=np.asarray(fj.inv_hi), inv_lo=np.asarray(fj.inv_lo),
            sub_vals=np.asarray(fj.sub_vals), sub_cols=np.asarray(fj.sub_cols),
            steps=fj.steps,
        )
    else:
        M = build_schwarz(p.A, p.topo, p.pou, _ptree(tapi, "dd"))
        assert M.factors.steps == fj.steps == 2
    y = M.apply(torch.as_tensor(state["d"])).numpy()
    assert _relerr(y, state["sch_dd"].apply(jnp.asarray(state["d"]))) < 1e-6


def test_neumann_matrices_match_jax(state):
    A_neu, B_neu = neumann_matrices(state["pt"])
    assert _relerr(A_neu.numpy(), state["A_neu"]) < 1e-12
    assert _relerr(B_neu.numpy(), state["B_neu"]) < 1e-12


def test_gevp_matches_jax(state):
    """Dense GEVP on the JAX package's pencils: equal active counts, kept
    eigenvalues to 1e-8 relative.  lambda = 1/mu - shift cancels for the
    near-kernel modes (lambda ~ 1e-10 << shift = 1e-3), so the bound is
    relative to max(|lambda|, shift)."""
    params = EigensolverParams.from_ptree(
        _ptree(tapi).sub("geneo.eigensolver"))
    lam, V, active = solve_gevp(torch.tensor(state["A_neu"]),
                                torch.tensor(state["C"]), params)
    np.testing.assert_array_equal(active.sum(1).numpy(),
                                  state["active"].sum(1))
    a = state["active"]
    ref = state["lam"][a]
    err = np.abs(lam.numpy()[a] - ref) / np.maximum(np.abs(ref), params.shift)
    assert err.max() < 1e-8


def test_coarse_matrix_matches_jax(state):
    """Pairs coarse matrix over the JAX package's GenEO basis."""
    p, basis = state["pt"], state["basis"]
    tb = convert.basis_from_numpy(np.asarray(basis.V), np.asarray(basis.active))
    from ddm_tpu_torch.core.indexmaps import extraction_map

    lc = torch.as_tensor(extraction_map(p.topo, p.A.cols.numpy()).astype(np.int64))
    A_sub = extract_subdomain_dense(
        p.A, torch.as_tensor(p.topo.sub2glob.astype(np.int64)),
        torch.as_tensor(p.topo.valid), lc)
    E = _mask_inactive(galerkin_coarse_matrix_pairs(A_sub, p.topo, tb), tb.active)
    assert _relerr(E.numpy(), state["gal"].E_mat) < 1e-10


def test_galerkin_apply_matches_jax(state):
    gal, p = state["gal"], state["pt"]
    G = convert.galerkin_from_numpy(
        np.asarray(gal.E_mat), np.asarray(gal.V), np.asarray(gal.active),
        p.topo.sub2glob, state["dualT"], refine=gal.refine,
    )
    y = G.apply(torch.as_tensor(state["d"])).numpy()
    assert _relerr(y, gal.apply(jnp.asarray(state["d"]))) < 1e-10


def test_cholqr2_matches_jax():
    W = np.random.default_rng(3).standard_normal((3, 40, 6)) * np.logspace(0, 8, 6)
    Q = cholqr2(torch.as_tensor(W)).numpy()
    np.testing.assert_allclose(np.einsum("spk,spl->skl", Q, Q),
                               np.broadcast_to(np.eye(6), (3, 6, 6)), atol=1e-13)
    assert _relerr(Q, j_cholqr2(jnp.asarray(W))) < 1e-10
