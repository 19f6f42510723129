"""The ``geneo_ring`` coarse space and the double-single coarse solve of the
PyTorch port against the JAX package, on islands 32^2 / 16 subdomains,
overlap 2, nev 8.

Module by module, the JAX package builds its problem and
``ddm_tpu_torch.convert`` carries it across, so each comparison isolates
one module; the whole solve is built independently by both packages.

Tolerances: the compaction maps are exact; the ring Neumann matrix to 1e-12
(one f64 element sum in another order); the direct extensions to 1e-10, on
the ring's own free set (interior + inner ring boundary) — on the
near-whole-subdomain free set bdist >= 2 the blocks reach cond ~1e7 and two
Cholesky codes differ by ~1.5e-10; the PCG extensions, on that harder set
as in the JAX package's own test (tests/test_coarse_spaces.py), to a
residual of 1e-8 and to the direct result within 1e-7; eigenvalues and kept
spans to 1e-8.  The f64 solve takes the JAX package's iteration count
(17), the dd solve lands within 2 (f32 partial sums in another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddm_tpu.api as japi
import ddm_tpu.coarse.ring as jring
from ddm_tpu.coarse import basis as jbasis
from ddm_tpu.coarse import extension as jext
from ddm_tpu.coarse.geneo import region_neumann as j_region_neumann
from ddm_tpu.core.indexmaps import dual_scatter_map
from ddm_tpu.fem import problems as jproblems
from ddm_tpu.precond import galerkin as jgalerkin
from ddm_tpu.solvers import direct as jdirect
from ddm_tpu_torch import api as tapi
from ddm_tpu_torch import convert
from ddm_tpu_torch.coarse import extension as text
from ddm_tpu_torch.coarse import ring as tring
from ddm_tpu_torch.coarse.geneo import region_neumann
from ddm_tpu_torch.core.indexmaps import extraction_map
from ddm_tpu_torch.eigen import EigensolverParams, solve_gevp
from ddm_tpu_torch.fem import problems as tproblems
from ddm_tpu_torch.fem.discretize import Discretization
from ddm_tpu_torch.fem.grids import structured_grid
from ddm_tpu_torch.precond.extract import extract_subdomain_dense
from ddm_tpu_torch.precond.galerkin import build_galerkin
from ddm_tpu_torch.precond.schwarz import build_schwarz
from ddm_tpu_torch.precond.two_level import build_two_level
from ddm_tpu_torch.solvers.direct import (
    BatchedCholesky,
    BatchedInverseDD,
    factor_batched,
    pack_inverse,
)

torch.set_num_threads(2)

GRID, PARTS, NEV = 32, (4, 4), 8
PRECISIONS = ["f64", "dd"]


def _ptree(api, precision="f64"):
    pt = api.default_ptree()
    pt["gridsize"] = GRID
    pt["overlap"] = 2
    pt["solver.reduction"] = 1e-8
    pt["solver.maxit"] = 400
    pt["solver.restart"] = 50
    pt["solver.verify"] = True
    pt["coarsespace.type"] = "geneo_ring"
    pt["geneo_ring.eigensolver.nev"] = NEV
    pt["coarse_solver.type"] = "cholesky"
    if precision != "f64":
        pt["schwarz.subdomain_solver.precision"] = precision
        pt["coarse_solver.precision"] = precision
    return pt


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _ring_mask(topo):
    return topo.valid & (topo.bdist <= 2 * topo.overlap + 1)


@pytest.fixture(scope="module")
def state():
    """The JAX package's problem, the port's problem over it, 3 random data
    vectors, two extension free sets (the ring's, and bdist >= 2) and the
    exact f64 inverse of the port's Dirichlet matrices (unit padding
    diagonal)."""
    pj = japi.setup_problem(_ptree(japi), problem=jproblems.islands(),
                            parts=PARTS)
    topo = pj.topo
    disc = Discretization(structured_grid((GRID, GRID)), tproblems.islands(),
                          "cpu")
    p = convert.problem_from_numpy(
        np.asarray(pj.A.colsT), np.asarray(pj.A.valsT), np.asarray(pj.rhs),
        np.asarray(pj.g), np.asarray(pj.scale), pj.pou, topo.sub2glob,
        topo.valid, topo.bdist, topo.boundary, dual_scatter_map(topo),
        overlap=topo.overlap, device="cpu", ptree=_ptree(tapi), disc=disc,
    )
    rng = np.random.default_rng(1)
    U = rng.standard_normal((topo.n_sub, 3, topo.n_pad)) * topo.valid[:, None, :]
    lc = extraction_map(p.topo, p.A.cols.numpy())
    ring = _ring_mask(topo)
    irb = tring._adjacent_to(topo, lc, topo.valid & ~ring, ring)
    A_dir = extract_subdomain_dense(
        p.A, torch.as_tensor(topo.sub2glob.astype(np.int64)),
        torch.as_tensor(topo.valid), torch.as_tensor(lc.astype(np.int64)))
    return dict(pj=pj, p=p, U=U, free_ring=(topo.valid & ~ring) | irb,
                free=topo.valid & (topo.bdist >= 2),
                A_dir=A_dir, Minv=np.linalg.inv(A_dir.numpy()))


@pytest.mark.parametrize("kind", ["ring", "random"])
def test_compaction_is_exact(state, kind):
    """compact_maps (stable slot order), compact_mat and expand_rows equal
    the JAX package's bit for bit."""
    topo = state["pj"].topo
    rng = np.random.default_rng(5)
    mask = (_ring_mask(topo) if kind == "ring"
            else rng.random(topo.valid.shape) < 0.4)
    got = text.compact_maps(mask)
    want = jext.compact_maps(mask)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3]
    idx, pos, r_pad = got[0], got[2], got[3]
    B = rng.standard_normal((topo.n_sub, topo.n_pad, topo.n_pad))
    Vc = rng.standard_normal((topo.n_sub, 4, r_pad))
    np.testing.assert_array_equal(
        text.compact_mat(torch.as_tensor(B), torch.as_tensor(idx).long()),
        np.asarray(jext.compact_mat(jnp.asarray(B), jnp.asarray(idx))))
    np.testing.assert_array_equal(
        text.expand_rows(torch.as_tensor(Vc), torch.as_tensor(pos).long()),
        np.asarray(jext.expand_rows(jnp.asarray(Vc), jnp.asarray(pos))))


def test_region_neumann_matches_jax(state):
    ring = _ring_mask(state["pj"].topo)
    got = region_neumann(state["p"], ring).numpy()
    want = np.asarray(j_region_neumann(state["pj"], ring, method="sum"))
    assert _relerr(got, want) < 1e-12


def test_direct_extensions_match_jax(state):
    """Sparse (compact Cholesky) extension = dense masked extension = the
    JAX package's sparse extension, on the ring's free set."""
    p, pj, U, free = state["p"], state["pj"], state["U"], state["free_ring"]
    sparse = text.energy_minimal_extension_sparse(p.A, p.topo, free,
                                                  torch.as_tensor(U))
    dense = text.energy_minimal_extension(state["A_dir"],
                                          torch.as_tensor(free),
                                          torch.as_tensor(U))
    want = jext.energy_minimal_extension_sparse(pj.A, pj.topo, free,
                                                jnp.asarray(U))
    assert _relerr(sparse, want) < 1e-10
    assert _relerr(dense, want) < 1e-10


@pytest.mark.parametrize("maxit,maxit32", [(60, 0), (16, 40)],
                         ids=["f64", "mixed"])
def test_pcg_extension_matches_jax(state, maxit, maxit32):
    """PCG on the free block with the same explicit inverse as the JAX
    package, pure f64 and mixed f32 -> f64: converged residuals, and the
    direct route's result."""
    p, pj, U, free = state["p"], state["pj"], state["U"], state["free"]
    got, rel = text.energy_minimal_extension_pcg(
        p.A, p.topo, free, torch.as_tensor(U), torch.as_tensor(state["Minv"]),
        maxit=maxit, maxit32=maxit32)
    want, rel_j = jext.energy_minimal_extension_pcg(
        pj.A, pj.topo, free, jnp.asarray(U), jnp.asarray(state["Minv"]),
        maxit=maxit, maxit32=maxit32)
    direct = text.energy_minimal_extension_sparse(p.A, p.topo, free,
                                                  torch.as_tensor(U))
    assert float(rel.max()) <= 1e-8 and float(np.max(rel_j)) <= 1e-8
    assert np.abs(got.numpy() - direct.numpy()).max() <= 1e-7
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-7


def _spans_differ(V1, a1, V2, a2):
    """Largest entry of the difference of the orthogonal projectors onto the
    kept basis vectors, over the subdomains."""
    worst = 0.0
    for s in range(V1.shape[0]):
        Q1, _ = np.linalg.qr(V1[s][a1[s]].T)
        Q2, _ = np.linalg.qr(V2[s][a2[s]].T)
        worst = max(worst, np.abs(Q1 @ Q1.T - Q2 @ Q2.T).max())
    return worst


@pytest.fixture(scope="module")
def ring_spaces(state):
    """Both packages' geneo_ring bases over the same problem (no fine level:
    the direct extension), with the eigenvalues their GEVPs returned."""
    out = {}
    for name, mod, p in (("jax", jring, state["pj"]), ("port", tring,
                                                        state["p"])):
        seen = {}

        def spy(*a, _solve=mod.solve_gevp, **k):
            seen["lam"], _, seen["active"] = res = _solve(*a, **k)
            return res

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mod, "solve_gevp", spy)
            basis = mod.geneo_ring_coarse_space(p, _ptree(tapi))
        out[name] = dict(V=np.asarray(basis.V), active=np.asarray(basis.active),
                         lam=np.asarray(seen["lam"]),
                         gevp_active=np.asarray(seen["active"]))
    return out


def test_ring_active_counts_match_jax(ring_spaces):
    j, t = ring_spaces["jax"], ring_spaces["port"]
    np.testing.assert_array_equal(t["gevp_active"].sum(1),
                                  j["gevp_active"].sum(1))
    np.testing.assert_array_equal(t["active"].sum(1), j["active"].sum(1))


def test_ring_eigenvalues_match_jax(ring_spaces):
    """Kept eigenvalues to 1e-8, relative to max(|lambda|, shift) as in
    tests/test_torch_precond.py."""
    j, t = ring_spaces["jax"], ring_spaces["port"]
    a = j["gevp_active"]
    shift = EigensolverParams.from_ptree(
        _ptree(tapi).sub("geneo_ring.eigensolver")).shift
    err = np.abs(t["lam"][a] - j["lam"][a]) / np.maximum(np.abs(j["lam"][a]),
                                                        shift)
    assert err.max() < 1e-8


def test_ring_spans_match_jax(ring_spaces):
    j, t = ring_spaces["jax"], ring_spaces["port"]
    assert _spans_differ(t["V"], t["active"], j["V"], j["active"]) < 1e-8


def _fine_with_inverse(p, ptree):
    """The fine level with an explicit f64 inverse, as CUDA builds it."""
    fine = build_schwarz(p.A, p.topo, p.pou, ptree)
    A_sub = extract_subdomain_dense(
        p.A, fine.sub2glob, fine.valid,
        torch.as_tensor(extraction_map(p.topo, p.A.cols.numpy())
                        .astype(np.int64)))
    return dataclasses.replace(
        fine, factors=factor_batched(A_sub, "cholesky", mode="inverse"))


def test_ring_pcg_route_matches_direct(state, ring_spaces):
    """With the fine level's f64 inverse and the bench's extension keys
    (maxit64 4, tolerance 1e-6) the extension takes PCG without escalating,
    and the kept spans stay those of the direct route to the accepted
    residual."""
    p = state["p"]
    pt = _ptree(tapi)
    pt["geneo_ring.extension.maxit64"] = 4
    pt["geneo_ring.extension.tolerance"] = 1e-6
    before = dict(tring.ROUTES)
    basis = tring.geneo_ring_coarse_space(p, pt, fine=_fine_with_inverse(p, pt))
    assert tring.ROUTES["pcg"] == before["pcg"] + 1
    assert tring.ROUTES["escalations"] == before["escalations"]
    assert tring.ROUTES["direct"] == before["direct"]
    t = ring_spaces["port"]
    assert _spans_differ(basis.V.numpy(), basis.active.numpy(), t["V"],
                         t["active"]) < 1e-5


def test_ring_extension_escalates_to_direct(state, ring_spaces, capsys):
    """An unreachable tolerance (1e-14) with one iteration per attempt: the
    mixed and the f64 PCG attempts are both rejected with a warning, the
    escalations are counted, and the basis is the direct route's."""
    p = state["p"]
    pt = _ptree(tapi)
    for key in ("maxit32", "maxit64", "maxit"):
        pt[f"geneo_ring.extension.{key}"] = 1
    pt["geneo_ring.extension.tolerance"] = 1e-14
    fine = _fine_with_inverse(p, pt)
    before = dict(tring.ROUTES)
    basis = tring.geneo_ring_coarse_space(p, pt, fine=fine)
    assert tring.ROUTES["escalations"] == before["escalations"] + 2
    assert tring.ROUTES["direct"] == before["direct"] + 1
    assert tring.ROUTES["pcg"] == before["pcg"]
    assert capsys.readouterr().err.count("escalating") == 2
    np.testing.assert_array_equal(basis.V.numpy(), ring_spaces["port"]["V"])


@pytest.fixture(scope="module")
def dd_coarse(state, ring_spaces):
    """The port's Galerkin correction over the port's ring basis, with its
    Cholesky coarse factor and with the double-single inverse of the same
    E, the f64 inverse itself, and one random defect."""
    p = state["p"]
    basis = convert.basis_from_numpy(ring_spaces["port"]["V"],
                                     ring_spaces["port"]["active"],
                                     device="cpu")
    G = build_galerkin(p.A, p.topo, basis, _ptree(tapi), method="global")
    G_dd = build_galerkin(p.A, p.topo, basis, _ptree(tapi, "dd"),
                          method="global")
    assert isinstance(G_dd.coarse, BatchedCholesky)
    # the inverse the Galerkin builder forms on the card (lower triangle)
    inv = factor_batched(G.E_mat[None], "cholesky", mode="inverse",
                         symmetrize=False).inv
    G_dd = dataclasses.replace(G_dd, coarse=pack_inverse(inv, "dd"))
    assert isinstance(G_dd.coarse, BatchedInverseDD)
    d = np.random.default_rng(7).standard_normal(p.topo.n_glob)
    return dict(G=G, G_dd=G_dd, inv=inv.numpy(), d=d,
                y_dd=G_dd.apply(torch.as_tensor(d)).numpy())


def test_dd_coarse_apply_matches_f64(dd_coarse):
    """A Galerkin correction whose coarse factor is a double-single inverse
    (plain dd_matvec on the CPU) against the Cholesky one; the dd key alone
    keeps the CPU's Cholesky factors, as the JAX package does on the CPU."""
    G, G_dd = dd_coarse["G"], dd_coarse["G_dd"]
    assert _relerr(dd_coarse["y_dd"], G.apply(torch.as_tensor(dd_coarse["d"]))) < 1e-10
    assert G.applies == G_dd.applies == 1


def test_dd_coarse_apply_matches_jax(state, ring_spaces, dd_coarse):
    """The same dd coarse apply against the JAX package's: its Galerkin
    correction over the same basis, with the dd_split of the same f64
    inverse as its BatchedInverseDD coarse factor (refine 2).  The two
    coarse matrices agree to 1e-12; the refinement steps use the port's, so
    both applies see the same inputs (E is near-singular on ring bases, and
    its last-bit differences reach the apply at ~1e-10)."""
    pj, E = state["pj"], dd_coarse["G"].E_mat.numpy()
    basis = jbasis.CoarseBasis(V=jnp.asarray(ring_spaces["port"]["V"]),
                               active=jnp.asarray(ring_spaces["port"]["active"]))
    Gj = jgalerkin.build_galerkin(pj.A, pj.topo, basis, _ptree(japi, "dd"),
                                 method="global")
    assert Gj.refine == dd_coarse["G_dd"].refine == 2
    assert _relerr(E, Gj.E_mat) < 1e-12
    Gj = dataclasses.replace(Gj, E_mat=jnp.asarray(E),
                             coarse=jdirect.BatchedInverseDD(
                                 *jdirect.dd_split(jnp.asarray(dd_coarse["inv"]))))
    want = np.asarray(Gj.apply(jnp.asarray(dd_coarse["d"])))
    assert _relerr(dd_coarse["y_dd"], want) < 1e-10


def test_coarse_factor_symmetrization_within_apply_noise(state, ring_spaces,
                                                         dd_coarse):
    """The Galerkin coarse factor reads E's lower triangle, where the JAX
    package's ``jnp.linalg.cholesky`` factors (E + E^T) / 2.  E is
    symmetric to the last bit and near-singular (cond ~5e7), so the
    distance of the port's dd coarse apply from the JAX package's (same
    inputs, as above) is rounding noise of order cond(E) x eps: for five
    defects it stays under 2.5e-10 whether the inverse comes from the
    lower triangle, from the symmetric part, or from the JAX package's own
    Cholesky, and no inverse is nearer to the JAX package's for every
    defect (pytest -s prints the table)."""
    pj, E = state["pj"], dd_coarse["G"].E_mat
    En = E.numpy()
    assert np.abs(En - En.T).max() / np.abs(En).max() < 1e-15
    eye = torch.eye(En.shape[0], dtype=torch.float64)
    Lj = np.asarray(jnp.linalg.cholesky(jnp.asarray(En)))
    Lij = np.linalg.solve(Lj, np.eye(En.shape[0]))
    invs = {
        "lower": factor_batched(E[None], "cholesky", mode="inverse",
                                symmetrize=False).inv,
        "symmetric": factor_batched(E[None], "cholesky", mode="inverse").inv,
        "jax": torch.as_tensor(Lij.T @ Lij)[None],
    }
    assert torch.equal(invs["lower"], torch.as_tensor(dd_coarse["inv"]))
    basis = jbasis.CoarseBasis(V=jnp.asarray(ring_spaces["port"]["V"]),
                               active=jnp.asarray(ring_spaces["port"]["active"]))
    Gj = jgalerkin.build_galerkin(pj.A, pj.topo, basis, _ptree(japi, "dd"),
                                 method="global")
    errs = {}
    for name, inv in invs.items():
        G_dd = dataclasses.replace(dd_coarse["G_dd"],
                                   coarse=pack_inverse(inv, "dd"))
        Gi = dataclasses.replace(Gj, E_mat=jnp.asarray(En),
                                 coarse=jdirect.BatchedInverseDD(
                                     *jdirect.dd_split(jnp.asarray(inv.numpy()))))
        for seed in (7, 1, 2, 3, 4):
            d = np.random.default_rng(seed).standard_normal(pj.topo.n_glob)
            errs[name, seed] = _relerr(G_dd.apply(torch.as_tensor(d)).numpy(),
                                       np.asarray(Gi.apply(jnp.asarray(d))))
    for name in invs:
        print(name, " ".join(f"{errs[name, s]:.3e}" for s in (7, 1, 2, 3, 4)))
    assert max(errs.values()) < 2.5e-10
    for name in invs:
        assert any(errs[name, s] > min(errs[o, s] for o in invs)
                   for s in (7, 1, 2, 3, 4))


@pytest.fixture(scope="module")
def runs():
    """{precision: (jax (iters, true_res, u), port (iters, true_res, u))},
    each package solving the geneo_ring slice once per precision."""
    out = {}
    for prec in PRECISIONS:
        pj = japi.setup_problem(_ptree(japi, prec), problem=jproblems.islands(),
                                parts=PARTS)
        rj = japi.solve(pj)
        tr_j = float(jnp.linalg.norm(pj.A.mv(rj.x) - pj.rhs)
                     / jnp.linalg.norm(pj.rhs))
        u_j = np.asarray(japi.solution(pj, rj))

        pt = tapi.setup_problem(_ptree(tapi, prec), problem=tproblems.islands(),
                                parts=PARTS, device="cpu")
        M = tapi.build_preconditioner(pt)
        rt = tapi.solve(pt, M)
        tr_t = float(torch.linalg.norm(pt.A.mv(rt.x) - pt.rhs)
                     / torch.linalg.norm(pt.rhs))
        u_t = tapi.solution(pt, rt).numpy()
        assert rt.converged and bool(rj.converged)
        assert M.precs[0].applies == M.precs[1].applies > 0
        out[prec] = ((int(rj.iterations), tr_j, u_j),
                     (rt.iterations, tr_t, u_t))
    return out


@pytest.mark.parametrize("prec,expect,slack", [("f64", 17, 0), ("dd", None, 2)])
def test_ring_iterations_match_jax(runs, prec, expect, slack):
    (it_j, _, _), (it_t, _, _) = runs[prec]
    assert abs(it_t - it_j) <= slack, (it_t, it_j)
    assert expect is None or it_j == expect


@pytest.mark.parametrize("prec", PRECISIONS)
def test_ring_true_residual(runs, prec):
    (_, tr_j, _), (_, tr_t, _) = runs[prec]
    assert tr_j <= 1e-7 and tr_t <= 1e-7, (tr_j, tr_t)


@pytest.mark.parametrize("prec", PRECISIONS)
def test_ring_solutions_agree(runs, prec):
    (_, _, u_j), (_, _, u_t) = runs[prec]
    assert np.abs(u_t - u_j).max() <= 1e-6 * np.abs(u_j).max()


def test_setup_problem_defaults_to_the_card(monkeypatch):
    """Without ``device`` the problem goes to the CUDA card; with no CUDA it
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.setup_problem(_ptree(tapi), problem=tproblems.islands(),
                           parts=PARTS)


def test_unported_coarse_space_and_pencil_raise(state):
    """As in the JAX package: an unknown coarse space raises ValueError, and
    an iterative eigensolver type refuses an indefinite pencil."""
    p = state["p"]
    pt = _ptree(tapi)
    pt["coarsespace.type"] = "no_such_space"
    with pytest.raises(ValueError, match="Unknown coarse space type"):
        build_two_level(dataclasses.replace(p, ptree=pt))
    pt["geneo_ring.eigensolver.type"] = "lobpcg"
    params = EigensolverParams.from_ptree(pt.sub("geneo_ring.eigensolver"))
    eye = torch.eye(4, dtype=torch.float64)[None]
    with pytest.raises(ValueError, match="SPD"):
        solve_gevp(eye, eye, params, spd=False)
