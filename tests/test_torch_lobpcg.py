"""Batched LOBPCG and the eigensolver dispatch of the PyTorch port against
the JAX package (``ddm_tpu/eigen/lobpcg.py``, ``ddm_tpu/eigen/__init__.py``).

``lobpcg_gevp`` takes the same numpy start block and preconditioner in both
packages, so the iterates differ by rounding only: the eigenvalues agree to
1e-10 (relative) and the iteration counts are equal, on a known spectrum and
on a GenEO pencil of islands 16^2 / (2, 2), overlap 2 (n_pad 128), at
tolerances the residual reaches.  The
adaptive wrapper draws its own start block in each package (``jax.random``
against ``numpy.random.default_rng``), so there the widths tried, the kept
masks and the eigenvalues to 1e-6 are compared; the GenEO pipeline with
``eigensolver.type = lobpcg`` takes GMRES iterations within 1 of the JAX
package's LOBPCG pipeline and of the dense one.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddm_tpu.api as japi
import ddm_tpu.eigen.lobpcg as jlobpcg
from ddm_tpu.coarse.geneo import neumann_matrices as j_neumann
from ddm_tpu.eigen import EigensolverParams as JParams
from ddm_tpu.fem import problems as jproblems
from ddm_tpu.fem.subassembly import scale_matrix_with_pou as j_pou_scale
import ddm_tpu_torch.eigen as teig
from ddm_tpu_torch import api as tapi
from ddm_tpu_torch.eigen import EigensolverParams, lobpcg as tlobpcg
from ddm_tpu_torch.fem import problems as tproblems

torch.set_num_threads(2)

GRID, PARTS = 16, (2, 2)


def _ptree(api, es_type="spectra"):
    pt = api.default_ptree()
    pt["gridsize"] = GRID
    pt["overlap"] = 2
    pt["solver.reduction"] = 1e-8
    pt["solver.maxit"] = 400
    pt["solver.restart"] = 50
    pt["coarsespace.type"] = "geneo"
    pt["coarse_solver.type"] = "cholesky"
    pt["geneo.eigensolver.type"] = es_type
    pt["geneo.eigensolver.nev"] = 8
    pt["geneo.eigensolver.tolerance"] = 1e-8
    return pt


@pytest.fixture(scope="module")
def geneo_pencil():
    """The JAX package's GenEO pencil (A_neu, D B_neu D) at 16^2 / (2, 2),
    numpy."""
    pj = japi.setup_problem(_ptree(japi), problem=jproblems.islands(),
                            parts=PARTS)
    A, B = j_neumann(pj)
    C = j_pou_scale(B, jnp.asarray(pj.pou))
    return np.asarray(A), np.asarray(C)


def _known_spectrum():
    p = 64
    diag = np.arange(1.0, p + 1)
    return np.diag(diag)[None], np.eye(p)[None], np.diag(1.0 / diag)[None]


@pytest.mark.parametrize("case", ["known_spectrum", "geneo_pencil"])
def test_lobpcg_matches_jax(request, case):
    """The same pencil, start block and preconditioner through both
    packages' ``lobpcg_gevp``."""
    if case == "known_spectrum":
        A, C, prec = _known_spectrum()
        m, maxit, tol = 5, 80, 1e-6
    else:
        A, C = request.getfixturevalue("geneo_pencil")
        # floating subdomains: the regularized inverse, as _default_prec
        prec = np.linalg.inv(A + 1e-10 * np.eye(A.shape[-1]))
        # the relative residual of this pencil floors at 4e-5 (iterations
        # 20-34); below that floor the stall guard ends the loop, and its
        # quality comparisons at rounding level decide the count (34 here
        # against the JAX package's 36 at tol 1e-8), so the convergence
        # test decides here: it stops both at iteration 20 (5.1e-5)
        m, maxit, tol = 8, 200, 1e-4
    X0 = np.random.default_rng(3).standard_normal(A.shape[:2] + (m,))
    lam_j, V_j, rn_j, it_j = jlobpcg.lobpcg_gevp(
        jnp.asarray(A), jnp.asarray(C), jnp.asarray(X0),
        prec_inv=jnp.asarray(prec), maxit=maxit, tol=tol)
    lam, V, rn, it = tlobpcg.lobpcg_gevp(
        *(torch.tensor(x) for x in (A, C, X0)),
        prec_inv=torch.tensor(prec), maxit=maxit, tol=tol)
    lam_j = np.asarray(lam_j)
    assert it == int(it_j) < maxit
    assert V.shape == V_j.shape and rn.shape == rn_j.shape
    assert np.all(np.isfinite(lam_j))
    np.testing.assert_allclose(lam.numpy(), lam_j, rtol=1e-10)
    if case == "known_spectrum":
        np.testing.assert_allclose(lam[0].numpy(), np.arange(1.0, m + 1),
                                   rtol=1e-8)


def test_lobpcg_block_width_m_matches_jax():
    """``m`` is the block width in both packages: given as X0's width it
    changes nothing (the same iterations and eigenvalues as the JAX
    package's with the same ``m``); another width is refused by both."""
    A, C, prec = _known_spectrum()
    X0 = np.random.default_rng(3).standard_normal(A.shape[:2] + (5,))
    kw = dict(maxit=80, tol=1e-6)
    lam_j, _, _, it_j = jlobpcg.lobpcg_gevp(
        jnp.asarray(A), jnp.asarray(C), jnp.asarray(X0),
        prec_inv=jnp.asarray(prec), m=5, **kw)
    tA, tC, tX0, tprec = (torch.tensor(x) for x in (A, C, X0, prec))
    lam, _, _, it = tlobpcg.lobpcg_gevp(tA, tC, tX0, tprec, 5, **kw)
    lam0, _, _, it0 = tlobpcg.lobpcg_gevp(tA, tC, tX0, tprec, **kw)
    assert it == it0 == int(it_j)
    assert torch.equal(lam, lam0)
    np.testing.assert_allclose(lam.numpy(), np.asarray(lam_j), rtol=1e-10)
    with pytest.raises(ValueError, match="width"):
        tlobpcg.lobpcg_gevp(tA, tC, tX0, tprec, 4, **kw)
    with pytest.raises(TypeError, match="carry"):
        jlobpcg.lobpcg_gevp(jnp.asarray(A), jnp.asarray(C), jnp.asarray(X0),
                            prec_inv=jnp.asarray(prec), m=4, **kw)


def test_adaptive_escalation_matches_jax(monkeypatch):
    """threshold 6.5 on diag(1..32): the block doubles 2 -> 4 -> 8 in both
    packages, and the kept masks are the same below-threshold prefix."""
    p = 32
    A = np.stack([np.diag(np.arange(1.0, p + 1))] * 2)
    C = np.stack([np.eye(p)] * 2)
    keys = dict(type="lobpcg", nev=2, blocksize=2, nev_max=8, threshold=6.5,
                tolerance=1e-9, maxit=400)
    widths_j = []

    def spy(A_, C_, X0, **kw):
        widths_j.append(X0.shape[-1])
        return jlobpcg_gevp(A_, C_, X0, **kw)

    jlobpcg_gevp = jlobpcg.lobpcg_gevp
    monkeypatch.setattr(jlobpcg, "lobpcg_gevp", spy)
    lam_j, _, keep_j = jlobpcg.lobpcg_gevp_adaptive(
        jnp.asarray(A), jnp.asarray(C), JParams(**keys))
    tlobpcg.RUNS.clear()
    lam, V, keep = tlobpcg.lobpcg_gevp_adaptive(
        torch.as_tensor(A), torch.as_tensor(C), EigensolverParams(**keys))
    assert [r["widths"] for r in tlobpcg.RUNS] == [widths_j] == [[2, 4, 8]]
    assert lam.shape == (2, 8) and V.shape == (2, 8, p)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_j))
    np.testing.assert_array_equal(keep.sum(1).numpy(), [6, 6])
    np.testing.assert_allclose(lam[:, :6].numpy(), np.asarray(lam_j)[:, :6],
                               rtol=1e-6)
    np.testing.assert_allclose(lam[:, :6].numpy(),
                               np.tile(np.arange(1.0, 7), (2, 1)), rtol=1e-6)


@pytest.mark.parametrize("name", ["KrylovSchur", "lobpcg", "lanczos",
                                  "blocklanczos"])
def test_iterative_names_dispatch_to_lobpcg(geneo_pencil, name):
    """Every iterative name reaches LOBPCG (one adaptive run recorded) and
    finds the dense solver's eigenvalues; an indefinite pencil refuses the
    iterative path."""
    A, C = (torch.tensor(x) for x in geneo_pencil)
    keys = dict(nev=4, threshold=-1.0, tolerance=1e-10, maxit=400)
    lam_d, _, act_d = teig.solve_gevp(A, C, EigensolverParams(**keys))
    tlobpcg.RUNS.clear()
    lam_i, _, act_i = teig.solve_gevp(A, C,
                                      EigensolverParams(type=name, **keys))
    assert len(tlobpcg.RUNS) == 1
    assert bool(act_i.all()) and bool(act_d.all())
    np.testing.assert_allclose(lam_i.numpy(), lam_d.numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="SPD"):
        teig.solve_gevp(A, C, EigensolverParams(type=name, **keys), spd=False)


def test_auto_dispatch_picks_by_subdomain_size(geneo_pencil, monkeypatch):
    """``auto``: dense at and below AUTO_CROSSOVER_P (2048, the JAX
    package's value), LOBPCG above it, dense for an indefinite pencil at any
    size; an unknown type raises."""
    assert teig.AUTO_CROSSOVER_P == 2048
    A, C = (torch.tensor(x) for x in geneo_pencil)
    keys = dict(nev=4, threshold=-1.0, tolerance=1e-10, maxit=400)
    auto = EigensolverParams(type="auto", **keys)
    dense = EigensolverParams(**keys)
    tlobpcg.RUNS.clear()
    np.testing.assert_array_equal(teig.solve_gevp(A, C, auto)[0],
                                  teig.solve_gevp(A, C, dense)[0])
    assert not tlobpcg.RUNS
    monkeypatch.setattr(teig, "AUTO_CROSSOVER_P", 8)
    np.testing.assert_array_equal(
        teig.solve_gevp(A, C, auto)[0],
        teig.solve_gevp(A, C, EigensolverParams(type="lobpcg", **keys))[0])
    assert len(tlobpcg.RUNS) == 2
    np.testing.assert_array_equal(teig.solve_gevp(A, C, auto, spd=False)[0],
                                  teig.solve_gevp(A, C, dense, spd=False)[0])
    assert len(tlobpcg.RUNS) == 2
    with pytest.raises(ValueError, match="Unknown eigensolver type"):
        teig.solve_gevp(A, C, EigensolverParams(type="arnoldi", **keys))


def test_lobpcg_slabs_match_one_batch(geneo_pencil, monkeypatch):
    """Under the dispatch's slabs (one subdomain each here) every slab runs
    its own loop from its own start block; each slab equals the adaptive
    solve of its subdomain alone."""
    import ddm_tpu_torch.solvers.direct as tdirect

    A, C = (torch.tensor(x) for x in geneo_pencil)
    params = EigensolverParams(type="lobpcg", nev=4, threshold=-1.0,
                               tolerance=1e-10, maxit=400)
    monkeypatch.setattr(tdirect, "SLAB_BYTES", 1)
    tlobpcg.RUNS.clear()
    lam, _, _ = teig.solve_gevp(A, C, params)
    assert len(tlobpcg.RUNS) == A.shape[0]
    for s in range(A.shape[0]):
        lam_s, _, _ = tlobpcg.lobpcg_gevp_adaptive(A[s:s + 1], C[s:s + 1],
                                                   params)
        np.testing.assert_array_equal(lam[s:s + 1], lam_s)


@pytest.fixture(scope="module")
def pipelines():
    """GMRES iterations of the GenEO pipeline: the JAX package with
    LOBPCG, the port with LOBPCG and with the dense solver."""
    pj = japi.setup_problem(_ptree(japi, "lobpcg"),
                            problem=jproblems.islands(), parts=PARTS)
    rj = japi.solve(pj)
    out = {"jax_lobpcg": (int(rj.iterations), bool(rj.converged))}
    pt = tapi.setup_problem(_ptree(tapi, "lobpcg"),
                            problem=tproblems.islands(), parts=PARTS,
                            device="cpu")
    for es in ("lobpcg", "spectra"):
        p = dataclasses.replace(pt, ptree=_ptree(tapi, es))
        tlobpcg.RUNS.clear()
        r = tapi.solve(p)
        out[f"port_{es}"] = (r.iterations, r.converged)
        out[f"runs_{es}"] = list(tlobpcg.RUNS)
    return out


def test_geneo_with_lobpcg_matches_jax_and_dense(pipelines):
    it, conv = pipelines["port_lobpcg"]
    assert conv and pipelines["jax_lobpcg"][1]
    assert abs(it - pipelines["jax_lobpcg"][0]) <= 1
    assert abs(it - pipelines["port_spectra"][0]) <= 1
    # the lobpcg pipeline ran LOBPCG (one slab at this size), dense did not
    assert len(pipelines["runs_lobpcg"]) == 1
    assert pipelines["runs_lobpcg"][0]["widths"] == [8]
    assert not pipelines["runs_spectra"]
