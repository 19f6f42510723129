"""Eight coarse spaces of the PyTorch port (``algebraic_geneo``,
``constraint_geneo``, the three msgfem variants, ``msgfem_ring``,
``harmonic_extension``, ``svd``) against the JAX package,
on islands 16^2 / (2, 2), overlap 2 (n_pad 128), Cholesky coarse solve,
GMRES(50) to 1e-8.

The JAX package sets its problem up once; ``ddm_tpu_torch.convert`` carries
it across (same slot order), and each variant builds on that shared problem
with its own config in both packages, through the two-level entry point.
Kept eigenvalues agree to 1e-8 (relative to max(|lambda|, shift)), kept
counts are equal, the spans of the kept basis vectors agree to 1e-8
(largest entry of the difference of their orthogonal projectors) and the
GMRES iteration counts are equal.

One span bound differs: ``algebraic_geneo``'s pencil has an indefinite
A_neu (eigenvalues down to -0.38 and near-null ones at 5e-7 here), whose
congruence factor A^{-1/2} amplifies rounding; the JAX package's own kept
spans move by up to 1.5e-5 when A_neu is perturbed by 1e-16 relative, so
the port is held to 1e-4 there.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddm_tpu.api as japi
import ddm_tpu.coarse.msgfem as jmsgfem
import ddm_tpu.coarse.ring as jring
import ddm_tpu.eigen as jeig
import ddm_tpu.precond.two_level as jtwo
from ddm_tpu.coarse import extension as jext
from ddm_tpu.coarse.svd import singular_values as j_singular_values
from ddm_tpu.core.indexmaps import dual_scatter_map
from ddm_tpu.fem import problems as jproblems
import ddm_tpu_torch.coarse.geneo as tgeneo
import ddm_tpu_torch.coarse.msgfem as tmsgfem
import ddm_tpu_torch.coarse.ring as tring
import ddm_tpu_torch.precond.two_level as ttwo
from ddm_tpu_torch import api as tapi
from ddm_tpu_torch import convert
from ddm_tpu_torch.coarse import extension as text
from ddm_tpu_torch.coarse.svd import singular_values
from ddm_tpu_torch.eigen import EigensolverParams
from ddm_tpu_torch.fem import problems as tproblems
from ddm_tpu_torch.fem.discretize import Discretization
from ddm_tpu_torch.fem.grids import structured_grid

from blas_threads import one_blas_thread  # noqa: E402,F401

torch.set_num_threads(2)

GRID, PARTS = 16, (2, 2)
# coarse space -> its config keys (the sizes of tests/test_coarse_spaces.py)
VARIANTS = {
    "algebraic_geneo": {"algebraic_geneo.eigensolver.nev": 8},
    "constraint_geneo": {"constraint_geneo.eigensolver.nev": 8},
    "msgfem": {"msgfem.eigensolver.nev": 10},
    "msgfem_euclid": {"msgfem_euclid.eigensolver.nev": 10},
    "algebraic_msgfem": {"algebraic_msgfem.eigensolver.nev": 10},
    "msgfem_ring": {"msgfem_ring.eigensolver.nev": 10},
    "harmonic_extension": {"harmonic_extension.n_basis_vectors": 8},
    "svd": {"svd_coarse_space.n": 10},
}
NO_GEVP = ("harmonic_extension", "svd")
SPAN_TOL = {"algebraic_geneo": 1e-4}  # see the module docstring


def _ptree(api, cs="none"):
    pt = api.default_ptree()
    pt["gridsize"] = GRID
    pt["overlap"] = 2
    pt["solver.reduction"] = 1e-8
    pt["solver.maxit"] = 400
    pt["solver.restart"] = 50
    pt["coarse_solver.type"] = "cholesky"
    pt["coarsespace.type"] = cs
    for k, v in VARIANTS.get(cs, {}).items():
        pt[k] = v
    return pt


@pytest.fixture(scope="module")
def state():
    """The JAX package's problem, the port's problem over it, and a cache
    of both packages' builds per variant."""
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
    return dict(pj=pj, p=p, built={})


def _build(mp, api, p, coarse_mod, gevp_sites):
    """Two-level build and solve of ``p`` through ``api``, with spies on
    the coarse-space dispatch and on the GEVP entry points ``gevp_sites``
    ((module, name) pairs).  Returns numpy (V, active), the GEVP's (lam,
    active) or None, and the iteration count."""
    seen = {}

    def spy_gevp(fn):
        def run(*a, **k):
            seen["lam"], _, seen["gevp_active"] = out = fn(*a, **k)
            return out
        return run

    def spy_basis(*a, _fn=coarse_mod.build_coarse_space, **k):
        seen["basis"] = basis = _fn(*a, **k)
        return basis

    for mod, name in gevp_sites:
        mp.setattr(mod, name, spy_gevp(getattr(mod, name)))
    mp.setattr(coarse_mod, "build_coarse_space", spy_basis)
    res = api.solve(p, api.build_preconditioner(p))
    assert bool(res.converged)
    out = dict(V=np.asarray(seen["basis"].V),
               active=np.asarray(seen["basis"].active),
               iterations=int(res.iterations))
    if "lam" in seen:
        out.update(lam=np.asarray(seen["lam"]),
                   gevp_active=np.asarray(seen["gevp_active"]))
    return out


def _built(state, cs):
    if cs not in state["built"]:
        with pytest.MonkeyPatch.context() as mp:
            j = _build(mp, japi, dataclasses.replace(
                state["pj"], ptree=_ptree(japi, cs)), jtwo,
                [(jeig, "solve_gevp"), (jmsgfem, "solve_gevp_dense_auto"),
                 (jring, "solve_gevp")])
        with pytest.MonkeyPatch.context() as mp:
            t = _build(mp, tapi, dataclasses.replace(
                state["p"], ptree=_ptree(tapi, cs)), ttwo,
                [(tgeneo, "solve_gevp"), (tmsgfem, "solve_gevp_dense_slabs"),
                 (tring, "solve_gevp")])
        state["built"][cs] = (j, t)
    return state["built"][cs]


def _spans_differ(V1, a1, V2, a2):
    """Largest entry of the difference of the orthogonal projectors onto the
    kept basis vectors, over the subdomains."""
    worst = 0.0
    for s in range(V1.shape[0]):
        Q1, _ = np.linalg.qr(V1[s][a1[s]].T)
        Q2, _ = np.linalg.qr(V2[s][a2[s]].T)
        worst = max(worst, np.abs(Q1 @ Q1.T - Q2 @ Q2.T).max())
    return worst


@pytest.mark.parametrize("cs", list(VARIANTS))
def test_coarse_space_matches_jax(state, cs):
    j, t = _built(state, cs)
    assert ("lam" in t) == ("lam" in j) == (cs not in NO_GEVP)
    if "lam" in t:
        a = j["gevp_active"]
        np.testing.assert_array_equal(t["gevp_active"], a)
        shift = EigensolverParams.from_ptree(
            _ptree(tapi, cs).sub(f"{cs}.eigensolver")).shift
        err = (np.abs(t["lam"][a] - j["lam"][a])
               / np.maximum(np.abs(j["lam"][a]), shift))
        assert err.max() < 1e-8, err.max()
    np.testing.assert_array_equal(t["active"], j["active"])
    assert t["active"].sum() > 0
    assert (_spans_differ(t["V"], t["active"], j["V"], j["active"])
            < SPAN_TOL.get(cs, 1e-8))
    assert t["iterations"] == j["iterations"]


def test_svd_basis_orthonormal_and_singular_values(state):
    """The svd basis is orthonormal per subdomain, and the singular values
    of T match the JAX package's to 1e-10 of the largest."""
    _, t = _built(state, "svd")
    for V in t["V"]:
        np.testing.assert_allclose(V @ V.T, np.eye(V.shape[0]), atol=1e-8)
    s = singular_values(state["p"])
    s_j = np.asarray(j_singular_values(state["pj"]))
    assert s.shape == s_j.shape
    assert np.abs(s - s_j).max() <= 1e-10 * s_j.max()


@pytest.fixture(scope="module")
def extension_case(state):
    """A_dir of the port's problem, its exact inverse, a free set (the
    ring-extension free set bdist > 2*overlap - 1) and 3 random data
    vectors."""
    p = state["p"]
    topo = p.topo
    A_dir, _ = tgeneo.dirichlet_dense(p)
    free = topo.valid & (topo.bdist > 2 * topo.overlap - 1)
    U = (np.random.default_rng(2).standard_normal((topo.n_sub, 3, topo.n_pad))
         * topo.valid[:, None, :])
    return dict(A_dir=A_dir, Minv=torch.linalg.inv(A_dir), free=free, U=U,
                c_mask=topo.valid & ~free)


def test_inverse_harmonic_extension_matches(extension_case):
    """The Schur identity through the inverse equals the factored
    extension, and the JAX package's Schur identity over the same inverse,
    to 1e-8 (its error grows as eps * cond(A)^2)."""
    c = extension_case
    free = torch.as_tensor(c["free"])
    got = text.inverse_harmonic_extension(c["Minv"], free,
                                          torch.as_tensor(c["U"]), c["c_mask"])
    want = text.energy_minimal_extension(c["A_dir"], free,
                                         torch.as_tensor(c["U"]))
    jax_got = jext.inverse_harmonic_extension(
        jnp.asarray(c["Minv"].numpy()), jnp.asarray(c["free"]),
        jnp.asarray(c["U"]), c["c_mask"])
    scale = np.abs(want.numpy()).max()
    assert np.abs(got.numpy() - want.numpy()).max() <= 1e-8 * scale
    assert np.abs(got.numpy() - np.asarray(jax_got)).max() <= 1e-8 * scale


@pytest.mark.parametrize("form", ["full", "compact"])
def test_harmonic_parameter_basis_matches_jax(state, extension_case, form):
    """The harmonic parameter basis (full, and column-compacted at the
    parameter dofs) of the port's A_dir equals the JAX package's to 1e-10
    and is A-harmonic on the interior."""
    topo = state["p"].topo
    A = extension_case["A_dir"]
    interior = topo.valid & ~topo.boundary
    par = topo.valid & topo.boundary
    if form == "full":
        H = text.harmonic_parameter_basis(A, torch.as_tensor(interior),
                                          torch.as_tensor(par))
        H_j = jext.harmonic_parameter_basis(
            jnp.asarray(A.numpy()), jnp.asarray(interior), jnp.asarray(par))
    else:
        pidx, pval, _, _ = text.compact_maps(par)
        H = text.harmonic_parameter_basis_compact(
            A, torch.as_tensor(interior), torch.as_tensor(pidx).long(),
            torch.as_tensor(pval))
        H_j = jext.harmonic_parameter_basis_compact(
            jnp.asarray(A.numpy()), jnp.asarray(interior), jnp.asarray(pidx),
            jnp.asarray(pval))
    H_j = np.asarray(H_j)
    assert H.shape == H_j.shape
    assert np.abs(H.numpy() - H_j).max() <= 1e-10 * np.abs(H_j).max()
    R = (A @ H).numpy()
    assert np.abs(R[np.broadcast_to(interior[:, :, None], R.shape)]).max() < 1e-10


def test_default_galerkin_matches_jax_on_a_non_vanishing_basis(
        state, extension_case):
    """``build_galerkin`` at its defaults (``method="global"``, no ptree:
    an LU coarse factor) gives the JAX package's default E to 1e-10 over a
    basis that does not vanish on subdomain boundaries, where the ``pairs``
    formula is not exact (1.6e-2 off here): four vectors per subdomain from
    ``numpy.random.default_rng(0)`` on its valid dofs (this fixture's svd
    and harmonic bases are POU-finalized and vanish there).  So does
    ``method="local"`` given the dense subdomain batch ``A_sub``, which
    equals the port's own extraction bit for bit."""
    from ddm_tpu.coarse.basis import CoarseBasis as JBasis
    from ddm_tpu.precond.galerkin import build_galerkin as j_build_galerkin
    from ddm_tpu_torch.precond.galerkin import build_galerkin
    from ddm_tpu_torch.solvers.direct import BatchedLU

    p, pj = state["p"], state["pj"]
    topo = p.topo
    V = (np.random.default_rng(0).standard_normal((topo.n_sub, 4, topo.n_pad))
         * topo.valid[:, None, :])
    active = np.ones((topo.n_sub, 4), bool)
    basis = convert.basis_from_numpy(V, active, device="cpu")
    jbasis = JBasis(V=jnp.asarray(V), active=jnp.asarray(active))
    G = build_galerkin(p.A, topo, basis)
    Gj = j_build_galerkin(pj.A, pj.topo, jbasis)
    E, E_j = G.E_mat.numpy(), np.asarray(Gj.E_mat)
    assert np.abs(E - E_j).max() <= 1e-10 * np.abs(E_j).max()
    assert isinstance(G.coarse, BatchedLU)
    A_sub = extension_case["A_dir"]
    G_loc = build_galerkin(p.A, topo, basis, method="local", A_sub=A_sub)
    Gj_loc = j_build_galerkin(pj.A, pj.topo, jbasis, method="local",
                              A_sub=jnp.asarray(A_sub.numpy()))
    E_loc = G_loc.E_mat.numpy()
    assert np.abs(E_loc - np.asarray(Gj_loc.E_mat)).max() <= 1e-10 * np.abs(
        E_loc).max()
    assert torch.equal(G_loc.E_mat, build_galerkin(
        p.A, topo, basis, method="local").E_mat)


@pytest.mark.parametrize("solver_type", ["lu", "cholesky"])
def test_energy_minimal_extension_solver_types_match_jax(extension_case,
                                                         solver_type):
    """The dense extension factored by LU (the default in both packages)
    and by Cholesky equals the JAX package's with the same solver to
    1e-10."""
    c = extension_case
    free, U = torch.as_tensor(c["free"]), torch.as_tensor(c["U"])
    got = text.energy_minimal_extension(c["A_dir"], free, U, solver_type)
    want = np.asarray(jext.energy_minimal_extension(
        jnp.asarray(c["A_dir"].numpy()), jnp.asarray(c["free"]),
        jnp.asarray(c["U"]), solver_type))
    assert np.abs(got.numpy() - want).max() <= 1e-10 * np.abs(want).max()
    if solver_type == "lu":
        assert torch.equal(got, text.energy_minimal_extension(
            c["A_dir"], free, U))


def _two_level(api, two_level, schwarz, p, cs, fine=None):
    p = dataclasses.replace(p, ptree=_ptree(api, cs))
    if fine == "build":
        fine = schwarz.build_schwarz(p.A, p.topo, p.pou, p.ptree)
    return fine, two_level.build_two_level(p, fine=fine)


def test_two_level_reuses_a_given_fine_level(state):
    """``build_two_level(p, fine=)`` keeps the given Schwarz level, applies
    as the one built without it (bit for bit) and as the JAX package's
    with its own given fine level: each package factors its own subdomain
    matrices, which agree to cond * eps, 3e-9 relative, as the built
    Schwarz apply of tests/test_torch_precond.py.  With
    ``coarsespace.type = none`` both packages return the fine level
    itself."""
    import ddm_tpu.precond.schwarz as jschwarz
    import ddm_tpu_torch.precond.schwarz as tschwarz

    p, pj = state["p"], state["pj"]
    d = np.random.default_rng(5).standard_normal(pj.topo.n_glob)
    fine, M = _two_level(tapi, ttwo, tschwarz, p, "pou", "build")
    _, M0 = _two_level(tapi, ttwo, tschwarz, p, "pou")
    _, Mj = _two_level(japi, jtwo, jschwarz, pj, "pou", "build")
    assert M.precs[0] is fine
    y = M.apply(torch.as_tensor(d)).numpy()
    assert np.array_equal(y, M0.apply(torch.as_tensor(d)).numpy())
    y_j = np.asarray(Mj.apply(jnp.asarray(d)))
    assert np.linalg.norm(y - y_j) <= 3e-9 * np.linalg.norm(y_j)
    for api, two_level, schwarz, q in ((tapi, ttwo, tschwarz, p),
                                       (japi, jtwo, jschwarz, pj)):
        fine, M = _two_level(api, two_level, schwarz, q, "none", "build")
        assert M is fine


def test_two_level_refuses_a_fine_level_of_another_mesh(state):
    """Under ``setup_sharding`` a fine level built without the mesh is
    refused, as ``solve_sharded`` refuses such a preconditioner."""
    import ddm_tpu_torch.precond.schwarz as tschwarz
    from ddm_tpu_torch.core.mesh import SubdomainMesh, setup_sharding

    p = state["p"]
    fine, _ = _two_level(tapi, ttwo, tschwarz, p, "none", "build")
    mesh = SubdomainMesh(group=None, rank=0, size=1,
                         device=torch.device("cpu"), backend="gloo")
    with setup_sharding(mesh, p.topo.n_sub):
        with pytest.raises(ValueError, match="another mesh"):
            ttwo.build_two_level(dataclasses.replace(
                p, ptree=_ptree(tapi, "pou")), fine=fine)


def _rank_deficient_pencils():
    """Three pencils (I, C) of size 300 whose C is a random symmetric PSD
    matrix of rank 35 on 36 rows (1-26 and every 27th from 53) and zero
    elsewhere, the pattern and spectrum of a msgfem reduced pencil at
    islands 384^2/256; MKL's syevd does not converge on at least one of them
    under 1 to 8 threads."""
    n, idx = 300, np.r_[1:27, 53:300:27]
    Cs = []
    for seed in (0, 4, 25):
        rng = np.random.default_rng(seed)
        ev = np.sort(rng.uniform(0, 1, len(idx)) ** 4) * 2.5
        ev[0] = 0.0
        Q, _ = np.linalg.qr(rng.standard_normal((len(idx), len(idx))))
        C = np.zeros((n, n))
        C[np.ix_(idx, idx)] = (Q * ev) @ Q.T
        Cs.append(0.5 * (C + C.T))
    return np.broadcast_to(np.eye(n), (3, n, n)).copy(), np.stack(Cs)


def test_dense_gevp_of_a_rank_deficient_pencil_matches_jax():
    """The dense GEVP of pencils that MKL's eigh does not converge on: the
    JAX package's kept eigenvalues (to 1e-10 of the largest) and masks."""
    from ddm_tpu.eigen.dense_gevp import solve_gevp_dense as j_gevp
    from ddm_tpu.eigen.params import EigensolverParams as JParams
    from ddm_tpu_torch.eigen.dense_gevp import solve_gevp_dense

    A, C = _rank_deficient_pencils()
    lam, _, kept = solve_gevp_dense(torch.as_tensor(A), torch.as_tensor(C),
                                    EigensolverParams(nev=8))
    lam_j, _, kept_j = j_gevp(jnp.asarray(A), jnp.asarray(C), JParams(nev=8))
    kept, kept_j = kept.numpy(), np.asarray(kept_j)
    assert np.array_equal(kept, kept_j) and kept.any()
    mu, mu_j = 1.0 / lam.numpy()[kept], 1.0 / np.asarray(lam_j)[kept_j]
    assert np.abs(mu - mu_j).max() <= 1e-10 * np.abs(mu_j).max()
