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

from blas_threads import one_blas_thread  # noqa: E402,F401

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
        overlap=topo.overlap, device="cpu", ptree=_ptree(tapi), disc=disc,
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
            chol=np.asarray(state["sch_f64"].factors.chol), device="cpu")
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
            steps=fj.steps, device="cpu",
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
    tb = convert.basis_from_numpy(np.asarray(basis.V), np.asarray(basis.active),
                                  device="cpu")
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
        p.topo.sub2glob, state["dualT"], refine=gal.refine, device="cpu",
    )
    y = G.apply(torch.as_tensor(state["d"])).numpy()
    assert _relerr(y, gal.apply(jnp.asarray(state["d"]))) < 1e-10


def test_cholqr2_matches_jax():
    W = np.random.default_rng(3).standard_normal((3, 40, 6)) * np.logspace(0, 8, 6)
    Q = cholqr2(torch.as_tensor(W)).numpy()
    np.testing.assert_allclose(np.einsum("spk,spl->skl", Q, Q),
                               np.broadcast_to(np.eye(6), (3, 6, 6)), atol=1e-13)
    assert _relerr(Q, j_cholqr2(jnp.asarray(W))) < 1e-10


def test_default_factor_batched_solves_a_nonsymmetric_batch_as_jax():
    """``factor_batched(A)`` at its defaults is LU in both packages, so a
    nonsymmetric batch is solved exactly (a Cholesky default would factor
    (A + A^T) / 2 and miss by ~1e-1): the port's solve lies within 1e-12
    of the JAX package's and of numpy's."""
    from ddm_tpu.solvers.direct import factor_batched as j_factor_batched
    from ddm_tpu_torch.solvers.direct import factor_batched

    rng = np.random.default_rng(11)
    A = rng.standard_normal((2, 8, 8)) + 8 * np.eye(8)
    b = rng.standard_normal((2, 8))
    x = factor_batched(torch.as_tensor(A)).solve(torch.as_tensor(b)).numpy()
    x_j = np.asarray(j_factor_batched(jnp.asarray(A)).solve(jnp.asarray(b)))
    assert np.abs(x - x_j).max() <= 1e-12 * np.abs(x_j).max()
    assert np.abs(x - np.linalg.solve(A, b[..., None])[..., 0]).max() <= 1e-12


@pytest.mark.parametrize("args", [(848,), (848, 8, 6), (1968, 4), (1000, 8, 10),
                                  (2464, 4, 20, 1 << 28)])
def test_batch_chunk_size_matches_jax(args, monkeypatch):
    """Slab sizes equal the JAX package's for the same positional
    arguments (its DDM_TPU_BATCH_CHUNK override unset)."""
    from ddm_tpu.solvers.direct import batch_chunk_size as j_batch_chunk_size
    from ddm_tpu_torch.solvers.direct import batch_chunk_size

    monkeypatch.delenv("DDM_TPU_BATCH_CHUNK", raising=False)
    assert batch_chunk_size(*args) == j_batch_chunk_size(*args)


# -- the reference's 4-rank coarse-matrix fixture and the ``local`` formula --
# (tests/test_galerkin.py: tests/test_galerkin_coarse_matrix.cc of the
# reference, a 9x9 nonsymmetric matrix over 4 subdomains)

EXPECTED_COARSE = np.array([
    [29.52777777777778, 27.02777777777778, 7.277777777777778, 0.0],
    [21.69444444444445, 28.11111111111111, 21.19444444444444, 8.166666666666666],
    [4.611111111111111, 18.52777777777778, 34.11111111111111, 36.91666666666666],
    [0.0, 5.499999999999999, 31.58333333333333, 50.75],
])


@pytest.fixture(scope="module")
def fixture():
    """The fixture's matrix, topology (overlap 1, the copied topology code)
    and POU basis 1/#sharing, which does NOT vanish on subdomain
    boundaries; the JAX package's global and local coarse matrices on it."""
    import scipy.sparse as sps

    from ddm_tpu.coarse.basis import CoarseBasis as JBasis
    from ddm_tpu.core.sparse import EllPattern as JPattern
    from ddm_tpu.precond.extract import extract_subdomain_dense as j_extract
    from ddm_tpu.precond.galerkin import galerkin_coarse_matrix_local as j_local
    from ddm_tpu_torch.core.indexmaps import build_topology, extraction_map
    from ddm_tpu_torch.core.sparse import EllPattern

    rows = list(range(9)) + list(range(8)) + list(range(1, 9))
    cols = list(range(9)) + list(range(1, 9)) + list(range(8))
    vals = np.array([i + 1.0 for i in range(9)] + [18.0 + i for i in range(8)]
                    + [10.0 + i for i in range(8)])
    adj = sps.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(9, 9))
    M0 = sps.csr_matrix(
        (np.ones(12, np.int8), ([0] * 3 + [1] * 3 + [2] * 3 + [3] * 3,
                                [0, 1, 2, 2, 3, 4, 4, 5, 6, 6, 7, 8])),
        shape=(4, 9))
    owner = np.array([0, 0, 0, 1, 1, 2, 2, 3, 3], dtype=np.int32)
    topo = build_topology(adj, M0, owner, 1)
    count = np.zeros(10)
    np.add.at(count, topo.sub2glob, topo.valid.astype(float))
    w = np.where(topo.valid, 1.0 / np.maximum(count[topo.sub2glob], 1), 0.0)
    ell = EllPattern.from_coo(rows, cols, 9).assemble(
        torch.as_tensor(vals), EllPattern.from_coo(rows, cols, 9).assembly_plan("cpu"))
    s2g = torch.as_tensor(topo.sub2glob.astype(np.int64))
    lc = torch.as_tensor(extraction_map(topo, ell.cols.numpy()).astype(np.int64))
    A_sub = extract_subdomain_dense(ell, s2g, torch.as_tensor(topo.valid), lc)
    jell = JPattern.from_coo(np.array(rows), np.array(cols), 9).assemble(
        jnp.asarray(vals))
    jlc = extraction_map(topo, np.asarray(jell.colsT).T)
    jA_sub = j_extract(jell, jnp.asarray(topo.sub2glob), jnp.asarray(topo.valid),
                       jnp.asarray(jlc))
    E_local_j = j_local(jA_sub, jnp.asarray(topo.sub2glob),
                        JBasis(V=jnp.asarray(w)[:, None, :],
                               active=jnp.ones((4, 1), bool)), topo.n_glob)
    return dict(topo=topo, ell=ell, s2g=s2g, A_sub=A_sub,
                basis=convert.basis_from_numpy(w[:, None, :], np.ones((4, 1), bool),
                                               device="cpu"),
                E_local_j=np.asarray(E_local_j))


def test_fixture_global_coarse_matrix_is_expected(fixture):
    """The true Galerkin product v_i^T A v_j of the fixture (nonsymmetric,
    hand-checked in the reference) to 1e-12."""
    from ddm_tpu_torch.precond.galerkin import galerkin_coarse_matrix

    topo = fixture["topo"]
    assert list(topo.sizes) == [4, 5, 5, 4]
    E = galerkin_coarse_matrix(fixture["ell"], fixture["s2g"], fixture["basis"])
    np.testing.assert_allclose(E.numpy(), EXPECTED_COARSE, atol=1e-12)


@pytest.mark.parametrize("group", [None, 1, 3])
def test_fixture_local_coarse_matrix_matches_jax(fixture, group):
    """The reference formula v_ik^T A^(i) v_jl on the fixture's basis,
    which is nonzero on subdomain boundaries (so it differs from the true
    product), equals the JAX package's to 1e-12, in any subdomain grouping."""
    from ddm_tpu_torch.precond.galerkin import galerkin_coarse_matrix_local

    E = galerkin_coarse_matrix_local(fixture["A_sub"], fixture["s2g"],
                                     fixture["basis"], 9, group=group)
    np.testing.assert_allclose(E.numpy(), fixture["E_local_j"], atol=1e-12)
    assert np.abs(E.numpy().T - EXPECTED_COARSE).max() > 1e-3


def _local_ptree(api):
    pt = api.default_ptree()
    pt["gridsize"] = 16
    pt["solver.reduction"] = 1e-8
    pt["coarsespace.type"] = "geneo"
    pt["geneo.eigensolver.nev"] = 4
    pt["coarse_solver.type"] = "lu"
    pt["coarse_solver.matrix_method"] = "local"
    return pt


def test_local_equals_global_transposed_and_two_level_matches_jax():
    """On a POU-finalized GenEO basis (zero on subdomain boundaries) the
    local formula is the global one transposed (1e-12 relative); a
    two-level solve with ``coarse_solver.matrix_method = local`` takes the
    JAX package's GMRES iterations (islands 16^2 / (2, 2))."""
    from ddm_tpu.coarse.basis import finalize_basis as jfin
    from ddm_tpu.precond.combined import build_combined as j_combined
    from ddm_tpu_torch.coarse.geneo import geneo_coarse_space
    from ddm_tpu_torch.core.indexmaps import extraction_map
    from ddm_tpu_torch.precond.galerkin import (
        galerkin_coarse_matrix,
        galerkin_coarse_matrix_local,
    )

    pt = tapi.setup_problem(_local_ptree(tapi), problem=tproblems.islands(),
                            parts=(2, 2), device="cpu")
    basis = geneo_coarse_space(pt, pt.ptree)
    s2g = torch.as_tensor(pt.topo.sub2glob.astype(np.int64))
    lc = torch.as_tensor(extraction_map(pt.topo, pt.A.cols.numpy()).astype(np.int64))
    A_sub = extract_subdomain_dense(pt.A, s2g, torch.as_tensor(pt.topo.valid), lc)
    E_g = galerkin_coarse_matrix(pt.A, s2g, basis).numpy()
    E_l = galerkin_coarse_matrix_local(A_sub, s2g, basis, pt.topo.n_glob).numpy()
    assert np.abs(E_l.T - E_g).max() < 1e-12 * np.abs(E_g).max()
    rt = tapi.solve(pt)

    pj = japi.setup_problem(_local_ptree(japi), problem=jproblems.islands(),
                            parts=(2, 2))
    A_neu, B_neu = j_neumann(pj)
    pou = jnp.asarray(pj.pou)
    _, V, active = j_solve_gevp(
        A_neu, j_pou_scale(B_neu, pou),
        JParams.from_ptree(pj.ptree.sub("geneo.eigensolver")))
    jbasis = jfin(V, pou, jnp.asarray(pj.topo.valid), active)
    from ddm_tpu.core.indexmaps import extraction_map as j_extraction_map
    from ddm_tpu.precond.extract import extract_subdomain_dense as j_extract

    jA_sub = j_extract(pj.A, jnp.asarray(pj.topo.sub2glob),
                       jnp.asarray(pj.topo.valid),
                       jnp.asarray(j_extraction_map(pj.topo, np.asarray(pj.A.colsT).T)))
    coarse = j_build_galerkin(pj.A, pj.topo, jbasis, pj.ptree, method="local",
                              A_sub=jA_sub)
    fine = j_build_schwarz(pj.A, pj.topo, pj.pou, pj.ptree)
    rj = japi.solve(pj, j_combined([fine, coarse], pj.ptree))
    assert rt.converged and rt.iterations == int(rj.iterations)
