"""The 3-D hex path of the PyTorch port against the JAX package: islands
(z-extruded), Q1 hexahedra on 8^3 cells (729 dofs), 8 subdomains
(2, 2, 2), nev 8, Cholesky coarse solve, GMRES(50) to 1e-8 — the 3-D main
paths' configuration at a small size, where every subdomain touches all 7
others (the full-size paths have 27-neighbour interiors).  The size is set
by the JAX side's cost when the whole suite runs on six workers; at 12^3
(2,197 dofs) both packages take the same counts as here.

f64: the JAX package's iteration counts (geneo 12 at overlap 1, 10 at
overlap 2; geneo_ring 12 and 11), solutions within 1e-6, GenEO eigenvalues
within 1e-8 with equal kept-mode counts.  dd inverses: within 2 iterations
of f64, true relative residual <= 1e-7.  The card tests that hold the
kernel at the 3-D fine shapes (3, 1000, 1000) and (2, 1728, 1728) against
its plain version and the f64 product are in tests/test_torch_kernels.py,
which a machine without jax can collect.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddm_tpu.api as japi
from ddm_tpu.fem import problems as jproblems
from ddm_tpu.fem.grids import structured_grid as j_grid
from ddm_tpu_torch import api as tapi
from ddm_tpu_torch.core.indexmaps import dual_scatter_map
from ddm_tpu_torch.fem import problems as tproblems
from ddm_tpu_torch.fem.grids import structured_grid
from ddm_tpu_torch.kernels import ddmatvec
from ddm_tpu_torch.precond.galerkin import _pairs_maps

torch.set_num_threads(2)

GRID, PARTS = 8, (2, 2, 2)
# (coarse space, overlap) -> the JAX package's f64 iteration count
JAX_ITERS = {("geneo", 1): 12, ("geneo", 2): 10,
             ("geneo_ring", 1): 12, ("geneo_ring", 2): 11}
CONFIGS = list(JAX_ITERS)


def _ptree(api, coarse, overlap, **keys):
    pt = api.default_ptree()
    pt["gridsize"] = GRID
    pt["overlap"] = overlap
    pt["solver.reduction"] = 1e-8
    pt["solver.maxit"] = 400
    pt["solver.restart"] = 50
    pt["coarsespace.type"] = coarse
    pt[f"{coarse}.eigensolver.nev"] = 8
    pt["coarse_solver.type"] = "cholesky"
    for k, v in keys.items():
        pt[k] = v
    return pt


def _true_res(p, x, norm):
    return float(norm(p.A.mv(x) - p.rhs) / norm(p.rhs))


def _jax_geneo(pj):
    """The JAX package's geneo preconditioner built step by step as its
    ``build_two_level`` does (basis, pairs coarse matrix, fine level last),
    keeping the pencils' eigenvalues: (preconditioner, lam, active)."""
    from ddm_tpu.coarse.basis import finalize_basis
    from ddm_tpu.coarse.geneo import neumann_matrices
    from ddm_tpu.eigen import EigensolverParams, solve_gevp
    from ddm_tpu.fem.subassembly import scale_matrix_with_pou
    from ddm_tpu.precond.combined import build_combined
    from ddm_tpu.precond.galerkin import build_galerkin
    from ddm_tpu.precond.schwarz import build_schwarz

    A_neu, B_neu = neumann_matrices(pj)
    pou = jnp.asarray(pj.pou)
    lam, V, active = solve_gevp(
        A_neu, scale_matrix_with_pou(B_neu, pou),
        EigensolverParams.from_ptree(pj.ptree.sub("geneo.eigensolver")))
    basis = finalize_basis(V, pou, jnp.asarray(pj.topo.valid), active)
    coarse = build_galerkin(pj.A, pj.topo, basis, pj.ptree, method="pairs")
    fine = build_schwarz(pj.A, pj.topo, pj.pou, pj.ptree)
    return build_combined([fine, coarse], pj.ptree), np.asarray(lam), \
        np.asarray(active)


@pytest.fixture(scope="module")
def runs():
    """{(coarse, overlap): (jax (p, iters, true_res, u), port (...))}, each
    package building and solving once per configuration; the geneo entries
    carry the JAX pencils' (lam, active) as a fifth item."""
    out = {}
    for coarse, overlap in CONFIGS:
        pj = japi.setup_problem(
            _ptree(japi, coarse, overlap), problem=jproblems.islands(),
            grid=j_grid((GRID,) * 3), parts=PARTS)
        extra = ()
        if coarse == "geneo":
            prec_j, *extra = _jax_geneo(pj)
            rj = japi.solve(pj, prec_j)
        else:
            rj = japi.solve(pj)
        pt = tapi.setup_problem(
            _ptree(tapi, coarse, overlap), problem=tproblems.islands(),
            grid=tapi.make_grid(_ptree(tapi, coarse, overlap), dim=3),
            parts=PARTS, device="cpu")
        rt = tapi.solve(pt)
        assert rt.converged and bool(rj.converged)
        out[coarse, overlap] = (
            (pj, int(rj.iterations), _true_res(pj, rj.x, jnp.linalg.norm),
             np.asarray(japi.solution(pj, rj)), *extra),
            (pt, rt.iterations, _true_res(pt, rt.x, torch.linalg.norm),
             tapi.solution(pt, rt).numpy()))
    return out


@pytest.mark.parametrize("coarse,overlap", CONFIGS)
def test_hex_slice_iterations_match_jax(runs, coarse, overlap):
    (_, it_j, tr_j, *_), (_, it_t, tr_t, _) = runs[coarse, overlap]
    assert it_t == it_j == JAX_ITERS[coarse, overlap]
    assert tr_j <= 1e-7 and tr_t <= 1e-7


@pytest.mark.parametrize("coarse,overlap", CONFIGS)
def test_hex_slice_solutions_agree(runs, coarse, overlap):
    (pj, _, _, u_j, *_), (pt, _, _, u_t) = runs[coarse, overlap]
    assert pt.disc.n_dofs == pj.disc.n_dofs == 9**3
    assert pt.topo.n_pad == {1: 216, 2: 344}[overlap]
    assert np.abs(u_t - u_j).max() <= 1e-6 * np.abs(u_j).max()


def test_hex_system_and_topology_match_jax(runs):
    """The hex operator and right-hand side (1e-13), and the copied
    topology code on a 3-D partition: the same members, owners and
    boundary distances per subdomain as the JAX package (whose slots may
    be ordered by its box canvas)."""
    (pj, *_), (pt, *_) = runs["geneo", 2]
    Sj, St = pj.disc.pattern.to_scipy(pj.A), pt.disc.pattern.to_scipy(pt.A)
    assert pt.A.m == 27
    assert abs(Sj - St).max() < 1e-13 * abs(Sj).max()
    assert np.abs(pt.rhs.numpy() - np.asarray(pj.rhs)).max() \
        < 1e-13 * np.abs(np.asarray(pj.rhs)).max()
    tj, tt = pj.topo, pt.topo
    assert (tj.n_sub, tj.n_pad) == (tt.n_sub, tt.n_pad) == (8, 344)
    np.testing.assert_array_equal(tj.dof_owner, tt.dof_owner)
    for k in range(tt.n_sub):
        oj = np.argsort(tj.sub2glob[k][tj.valid[k]])
        ot = np.argsort(tt.sub2glob[k][tt.valid[k]])
        for name in ("sub2glob", "bdist", "boundary", "owner"):
            np.testing.assert_array_equal(
                getattr(tj, name)[k][tj.valid[k]][oj],
                getattr(tt, name)[k][tt.valid[k]][ot])
        np.testing.assert_allclose(pj.pou[k][tj.valid[k]][oj],
                                   pt.pou[k][tt.valid[k]][ot], rtol=1e-15)


def test_hex_pairs_and_dual_maps(runs):
    """With every subdomain overlapping all others, the pairs map holds
    8 x 8 pairs and the scatter's dual map is 8 wide (the dofs around the
    centre lie in all 8 subdomains); each pair's slot map points at the
    same global dof."""
    _, (pt, *_) = runs["geneo", 2]
    topo = pt.topo
    pi, pj_, m_pair = _pairs_maps(topo)
    assert pi.size == 64 and dual_scatter_map(topo).shape == (8, topo.n_glob)
    x = np.random.default_rng(0).integers(0, pi.size)
    hit = m_pair[x] < topo.n_pad
    assert hit.any()
    np.testing.assert_array_equal(topo.sub2glob[pj_[x]][m_pair[x][hit]],
                                  topo.sub2glob[pi[x]][hit])


@pytest.mark.parametrize("overlap", [1, 2])
def test_geneo_hex_eigenvalues_match_jax(runs, overlap):
    """GenEO pencils of 3-D subdomains: the same kept-mode counts as the
    JAX package and eigenvalues within 1e-8 relative (they do not depend
    on the slot order of either package)."""
    from ddm_tpu_torch.coarse.geneo import neumann_matrices
    from ddm_tpu_torch.eigen import EigensolverParams, solve_gevp
    from ddm_tpu_torch.fem.subassembly import scale_matrix_with_pou

    (_, _, _, _, lam_j, act_j), (pt, *_) = runs["geneo", overlap]
    At, Bt = neumann_matrices(pt)
    lam_t, _, act_t = solve_gevp(
        At, scale_matrix_with_pou(Bt, torch.as_tensor(pt.pou)),
        EigensolverParams.from_ptree(pt.ptree.sub("geneo.eigensolver")))
    np.testing.assert_array_equal(act_t.numpy(), act_j)
    assert int(act_t.sum()) == 8 * 8
    lam_t = lam_t.numpy()
    assert (np.abs(lam_t - lam_j) <= 1e-8 * np.abs(lam_j) + 1e-12).all()


@pytest.mark.parametrize("coarse,overlap", [("geneo", 2), ("geneo_ring", 1)])
def test_hex_slice_dd_within_two_of_f64(runs, coarse, overlap):
    """dd subdomain and coarse inverses, verified termination: within 2
    iterations of the f64 count, true residual <= 1e-7, the f64 solution
    to 1e-6."""
    _, (_, it_f64, _, u_f64) = runs[coarse, overlap]
    pt_ = _ptree(tapi, coarse, overlap,
                 **{"schwarz.subdomain_solver.precision": "dd",
                    "coarse_solver.precision": "dd"})
    p = tapi.setup_problem(pt_, problem=tproblems.islands(),
                           grid=structured_grid((GRID,) * 3), parts=PARTS,
                           device="cpu")
    res = tapi.solve(p)
    assert res.converged and abs(res.iterations - it_f64) <= 2
    assert _true_res(p, res.x, torch.linalg.norm) <= 1e-7
    u = tapi.solution(p, res).numpy()
    assert np.abs(u - u_f64).max() <= 1e-6 * np.abs(u_f64).max()


def test_make_grid_dim_and_refine(tmp_path):
    """``make_grid(ptree, dim)`` with ``refine``: a 3-D grid of 4 cells per
    axis refined once is the 8-cell grid; a ``meshfile`` is read instead
    (tests/test_torch_unstructured.py), so a missing one raises."""
    pt = tapi.default_ptree()
    pt["gridsize"] = 4
    pt["refine"] = 1
    g = tapi.make_grid(pt, dim=3)
    ref = structured_grid((8, 8, 8))
    assert g.elem_type == "hex" and g.shape == (8, 8, 8)
    np.testing.assert_allclose(g.nodes, ref.nodes, atol=1e-15)
    np.testing.assert_array_equal(g.elems, ref.elems)
    pt["meshfile"] = str(tmp_path / "bar.msh")
    with pytest.raises(FileNotFoundError):
        tapi.make_grid(pt, dim=3)


@pytest.mark.parametrize("n_sub,P", [(512, 1000), (512, 1728), (256, 888),
                                     (1, 4096)])
def test_plan_at_the_new_shapes(n_sub, P):
    """The launch plan at the 3-D and elasticity shapes on a 132-SM card:
    full batches keep 64 rows and one chunk; the (1, 4096, 4096) coarse
    inverse splits into 32 rows x 2 chunks of 2048 columns, 256 blocks."""
    pl = ddmatvec.plan(n_sub, P, 132)
    if n_sub > 1:
        assert (pl.rows, pl.chunks, pl.cols) == (64, 1, P)
        assert pl.blocks == n_sub * -(-P // 64)
    else:
        assert (pl.rows, pl.chunks, pl.cols, pl.blocks) == (32, 2, 2048, 256)
