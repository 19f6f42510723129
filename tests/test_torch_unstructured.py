"""The unstructured simplex path of the PyTorch port against the JAX package:
the gmsh reader, P1 triangle and tetrahedron assembly with convection and
reaction terms, and the two-level solve on a refined L-shaped mesh read from
a gmsh file with recursive-coordinate-bisection subdomains.

Inputs are made from numpy (meshes written to ``tmp_path``).  Tolerances:
the reader exactly; quadrature points bit for bit (coefficients jump
exactly on some of them); element matrices and vectors to 1e-13 relative
(the JAX package inverts the Jacobian in closed form, the port with
``torch.linalg``); GMRES iterations equal, solutions within 1e-6, true
residuals within 1e-10 of each other, GenEO eigenvalues within 1e-8 with
equal kept counts.  The L-shape slice keeps the JAX side small (n_pad <=
~350) because the whole suite runs it on six workers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import ddm_tpu.api as japi
from ddm_tpu.fem import assemble as jassemble
from ddm_tpu.fem import problems as jproblems
from ddm_tpu.fem.grids import structured_grid as j_grid
from ddm_tpu.fem.msh import read_msh as j_read_msh
from ddm_tpu_torch import api as tapi
from ddm_tpu_torch.fem import assemble as tassemble
from ddm_tpu_torch.fem import problems as tproblems
from ddm_tpu_torch.fem.grids import structured_grid
from ddm_tpu_torch.fem.msh import read_msh

torch.set_num_threads(2)

_GMSH = {"tri": 2, "quad": 3, "tet": 4, "hex": 5, "line": 1}


def write_msh(path, nodes, blocks, ids=None):
    """gmsh v2.2 ASCII: ``nodes`` (n, 2|3), ``blocks`` a list of (gmsh
    type name, (n_e, nn) zero-based connectivity); ``ids`` the gmsh node
    numbers (default 1..n)."""
    nodes = np.asarray(nodes, dtype=np.float64)
    if nodes.shape[1] == 2:
        nodes = np.concatenate([nodes, np.zeros((nodes.shape[0], 1))], axis=1)
    ids = np.arange(1, nodes.shape[0] + 1) if ids is None else np.asarray(ids)
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes",
             str(nodes.shape[0])]
    lines += [f"{i} {float(x)!r} {float(y)!r} {float(z)!r}"
              for i, (x, y, z) in zip(ids, nodes)]
    lines += ["$EndNodes", "$Elements"]
    elems = [(name, row) for name, conn in blocks for row in conn]
    lines.append(str(len(elems)))
    for k, (name, row) in enumerate(elems, start=1):
        lines.append(f"{k} {_GMSH[name]} 2 0 1 " + " ".join(str(ids[v]) for v in row))
    lines.append("$EndElements")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def lshape_msh(path, n):
    """The L-shape [0,1]^2 minus (0.5,1]^2: the triangles of an n x n cell
    simplex grid (n even) whose cells lie outside the removed quadrant."""
    g = structured_grid((n, n), simplex=True)
    c = g.elem_centroids()
    keep = ~((c[:, 0] > 0.5) & (c[:, 1] > 0.5))
    return write_msh(path, g.nodes, [("tri", g.elems[keep])])


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


# -- the reader --------------------------------------------------------------

def _msh_case(kind, tmp_path):
    """A small mesh of each kind with what the reader must see past: gmsh
    ids that are not 1..n, an unused node, lower-dimensional elements."""
    if kind == "tri":
        g = structured_grid((3, 2), simplex=True)
        blocks = [("line", [[0, 1], [1, 2]]), ("tri", g.elems)]
    elif kind == "tet":
        g = structured_grid((2, 1, 1), simplex=True)
        blocks = [("tri", g.elems[:3, :3]), ("tet", g.elems)]
    else:  # quads in gmsh's counter-clockwise order
        g = structured_grid((3, 2))
        blocks = [("line", [[0, 1]]), ("quad", g.elems[:, [0, 1, 3, 2]])]
    nodes = np.concatenate([g.nodes, np.full((1, g.nodes.shape[1]), 9.0)])
    ids = 7 + 3 * np.arange(nodes.shape[0])
    return g, write_msh(tmp_path / f"{kind}.msh", nodes, blocks, ids=ids)


@pytest.mark.parametrize("kind", ["tri", "tet", "quad"])
def test_read_msh_matches_jax(kind, tmp_path):
    """The same nodes, elements and types as the JAX package's reader; the
    highest-dimensional block kept, the unused node dropped, quads back in
    lexicographic order (so a structured grid round-trips)."""
    g, path = _msh_case(kind, tmp_path)
    gt, gj = read_msh(path), j_read_msh(path)
    assert gt.elem_type == gj.elem_type == g.elem_type
    np.testing.assert_array_equal(gt.nodes, gj.nodes)
    np.testing.assert_array_equal(gt.elems, gj.elems)
    np.testing.assert_array_equal(gt.nodes, g.nodes)
    np.testing.assert_array_equal(gt.elems, g.elems)


# -- assembly ----------------------------------------------------------------

def _grid_for(case):
    if case == "elasticity_tet":
        return j_grid((3, 1, 2), (0, 0, 0), (10.0, 1.0, 1.5), simplex=True)
    return j_grid((3, 3, 3) if case == "simple_tet" else (6, 6), simplex=True)


ASSEMBLY = ["islands_tri", "checkerboard_tri", "simple_tet", "elasticity_tet"]


@pytest.mark.parametrize("case", ASSEMBLY)
def test_simplex_element_matrices_match_jax(case):
    """Quadrature points bit for bit; Ke and fe to 1e-13 relative."""
    g = _grid_for(case)
    et = g.elem_type
    qj = jassemble.ElementQuadrature(et)
    qt = tassemble.ElementQuadrature(et, "cpu")
    xj = jnp.asarray(g.nodes[g.elems])
    xt = torch.as_tensor(g.nodes[g.elems])
    np.testing.assert_array_equal(
        tassemble.element_geometry(qt, xt)[0].numpy(),
        np.asarray(jassemble.element_geometry(qj, xj)[0]))
    name = case.rsplit("_", 1)[0]
    if name == "elasticity":
        pj, pt = jproblems.steel_rubber_bar(), tproblems.steel_rubber_bar()
        Kj, fj = jassemble.assemble_linear_elasticity(qj, xj, pj.lam, pj.mu, pj.f)
        Kt, ft = tassemble.assemble_linear_elasticity(qt, xt, pt.lam, pt.mu, pt.f)
    else:
        make = {"islands": "islands", "simple": "simple",
                "checkerboard": "checkerboard_convection_diffusion"}[name]
        pj, pt = getattr(jproblems, make)(), getattr(tproblems, make)()
        Kj, fj = jassemble.assemble_convection_diffusion(
            qj, xj, pj.alpha, pj.b, pj.c, pj.f)
        Kt, ft = tassemble.assemble_convection_diffusion(
            qt, xt, pt.alpha, pt.b, pt.c, pt.f)
    assert _rel(Kt.numpy(), Kj) < 1e-13
    fj = np.asarray(fj)
    if np.abs(fj).max() > 0:
        assert _rel(ft.numpy(), fj) < 1e-13
    else:
        assert not ft.numpy().any()


def test_convection_reaction_terms_match_jax():
    """The reaction term and both convection forms on triangles."""
    g = _grid_for("islands_tri")
    qj = jassemble.ElementQuadrature("tri")
    qt = tassemble.ElementQuadrature("tri", "cpu")
    xj = jnp.asarray(g.nodes[g.elems])
    xt = torch.as_tensor(g.nodes[g.elems])
    cj, ct = jproblems.checkerboard_convection_diffusion(), \
        tproblems.checkerboard_convection_diffusion()
    for div_form in (False, True):
        Kj, _ = jassemble.assemble_convection_diffusion(
            qj, xj, cj.alpha, cj.b, lambda x: 1.0 + x[..., 0], cj.f,
            convection_divergence_form=div_form)
        Kt, _ = tassemble.assemble_convection_diffusion(
            qt, xt, ct.alpha, ct.b, lambda x: 1.0 + x[..., 0], ct.f,
            convection_divergence_form=div_form)
        assert _rel(Kt.numpy(), Kj) < 1e-13


# -- the L-shape slice -------------------------------------------------------

LSHAPE_CELLS, LSHAPE_REFINE, LSHAPE_SUBS = 4, 2, 8
COARSE = ["geneo", "geneo_ring"]


def _lshape_ptree(api, meshfile, coarse):
    pt = api.default_ptree()
    pt["meshfile"] = meshfile
    pt["refine"] = LSHAPE_REFINE
    pt["overlap"] = 2
    pt["solver.reduction"] = 1e-8
    pt["solver.maxit"] = 400
    pt["solver.restart"] = 50
    pt["coarsespace.type"] = coarse
    pt[f"{coarse}.eigensolver.nev"] = 8
    pt["coarse_solver.type"] = "cholesky"
    return pt


def _true_res(p, x, norm):
    return float(norm(p.A.mv(x) - p.rhs) / norm(p.rhs))


def _jax_geneo(pj):
    """The JAX package's geneo preconditioner built as its
    ``build_two_level`` does, keeping the pencils' (lam, active)."""
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
def lshape(tmp_path_factory):
    """{coarse: (jax (p, iters, true_res, u[, lam, active]), port (...))},
    each package reading the same mesh file through ``make_grid``
    (``meshfile``, ``refine``) and splitting it by RCB."""
    path = lshape_msh(tmp_path_factory.mktemp("msh") / "lshape.msh",
                      LSHAPE_CELLS)
    out = {}
    for coarse in COARSE:
        pj = japi.setup_problem(_lshape_ptree(japi, path, coarse),
                                problem=jproblems.islands(), n_sub=LSHAPE_SUBS)
        extra = ()
        if coarse == "geneo":
            prec_j, *extra = _jax_geneo(pj)
            rj = japi.solve(pj, prec_j)
        else:
            rj = japi.solve(pj)
        pt = tapi.setup_problem(_lshape_ptree(tapi, path, coarse),
                                problem=tproblems.islands(),
                                n_sub=LSHAPE_SUBS, device="cpu")
        rt = tapi.solve(pt)
        assert rt.converged and bool(rj.converged)
        out[coarse] = (
            (pj, int(rj.iterations), _true_res(pj, rj.x, jnp.linalg.norm),
             np.asarray(japi.solution(pj, rj)), *extra),
            (pt, rt.iterations, _true_res(pt, rt.x, torch.linalg.norm),
             tapi.solution(pt, rt).numpy()))
    return out


def test_lshape_mesh_system_and_topology_match_jax(lshape):
    """The refined mesh (24 x 16 triangles), the operator and right-hand
    side (1e-13), and the RCB topology: the same subdomains, slot for
    slot."""
    (pj, *_), (pt, *_) = lshape["geneo"]
    gt, gj = pt.disc.grid, pj.disc.grid
    assert gt.elem_type == "tri" and gt.n_elems == 24 * 4**LSHAPE_REFINE
    np.testing.assert_array_equal(gt.nodes, gj.nodes)
    np.testing.assert_array_equal(gt.elems, gj.elems)
    Sj, St = pj.disc.pattern.to_scipy(pj.A), pt.disc.pattern.to_scipy(pt.A)
    assert abs(Sj - St).max() < 1e-13 * abs(Sj).max()
    assert _rel(pt.rhs.numpy(), pj.rhs) < 1e-13
    tj, tt = pj.topo, pt.topo
    assert tt.n_sub == LSHAPE_SUBS and tt.n_pad == tj.n_pad <= 350
    for name in ("sub2glob", "valid", "bdist", "boundary"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(tj, name))
    np.testing.assert_array_equal(pt.pou, pj.pou)


@pytest.mark.parametrize("coarse", COARSE)
def test_lshape_iterations_and_residuals_match_jax(lshape, coarse):
    (_, it_j, tr_j, *_), (_, it_t, tr_t, _) = lshape[coarse]
    assert it_t == it_j
    assert abs(tr_t - tr_j) <= 1e-10 and tr_t <= 1e-7


@pytest.mark.parametrize("coarse", COARSE)
def test_lshape_solutions_agree(lshape, coarse):
    (_, _, _, u_j, *_), (_, _, _, u_t) = lshape[coarse]
    assert _rel(u_t, u_j) <= 1e-6


def test_lshape_geneo_eigenvalues_match_jax(lshape):
    """GenEO pencils of RCB subdomains: equal kept counts, eigenvalues to
    1e-8 relative to max(|lambda|, shift)."""
    from ddm_tpu_torch.coarse.geneo import neumann_matrices
    from ddm_tpu_torch.eigen import EigensolverParams, solve_gevp
    from ddm_tpu_torch.fem.subassembly import scale_matrix_with_pou

    (_, _, _, _, lam_j, act_j), (pt, *_) = lshape["geneo"]
    params = EigensolverParams.from_ptree(pt.ptree.sub("geneo.eigensolver"))
    At, Bt = neumann_matrices(pt)
    lam_t, _, act_t = solve_gevp(
        At, scale_matrix_with_pou(Bt, torch.as_tensor(pt.pou)), params)
    np.testing.assert_array_equal(act_t.numpy(), act_j)
    err = np.abs(lam_t.numpy() - lam_j)[act_j] / np.maximum(
        np.abs(lam_j[act_j]), params.shift)
    assert err.max() < 1e-8


# -- nonsymmetric conforming problem, tet elasticity -------------------------

def test_checkerboard_convection_diffusion_two_level_matches_jax():
    """Nonsymmetric P1 problem (convection b = (1/3, 1)) on triangles,
    GenEO on the symmetrized stamps, LU subdomain and coarse solvers:
    the same GMRES iterations as the JAX package, solutions to 1e-6."""
    def ptree(api):
        pt = api.default_ptree()
        pt["solver.reduction"] = 1e-8
        pt["overlap"] = 1
        pt["coarsespace.type"] = "geneo"
        pt["geneo.eigensolver.nev"] = 6
        pt["coarse_solver.type"] = "lu"
        pt["schwarz.subdomain_solver.type"] = "lu"
        return pt

    pj = japi.setup_problem(ptree(japi),
                            problem=jproblems.checkerboard_convection_diffusion(),
                            grid=j_grid((12, 12), simplex=True), n_sub=4)
    rj = japi.solve(pj)
    pt = tapi.setup_problem(ptree(tapi),
                            problem=tproblems.checkerboard_convection_diffusion(),
                            grid=structured_grid((12, 12), simplex=True),
                            n_sub=4, device="cpu")
    assert not pt.disc.stamps_cover_operator
    rt = tapi.solve(pt)
    assert rt.converged and bool(rj.converged)
    assert rt.iterations == int(rj.iterations)
    assert _rel(tapi.solution(pt, rt).numpy(), japi.solution(pj, rj)) <= 1e-6


def test_tet_elasticity_matches_jax_and_direct_solve():
    """The reference's elasticity setup (linearelasticity.cc:40-43): the
    steel-rubber bar on 8 x 2 x 3 Kuhn-tetrahedron cells, vector P1,
    4 RCB subdomains, GenEO (nev 8) with an LU coarse solve, GMRES to 1e-6:
    the JAX package's iterations, the direct solution to 1e-4; the
    rigid-body templates are 6 modes in the kernel of the Neumann
    operator."""
    from ddm_tpu_torch.coarse.pou_space import rigid_body_modes

    def ptree(api):
        pt = api.default_ptree()
        pt["solver.reduction"] = 1e-6
        pt["solver.maxit"] = 300
        pt["coarsespace.type"] = "geneo"
        pt["coarse_solver.type"] = "lu"
        pt["geneo.eigensolver.nev"] = 8
        return pt

    box = ((8, 2, 3), (0, 0, 0), (10.0, 1.0, 1.5))
    pj = japi.setup_problem(ptree(japi), problem=jproblems.steel_rubber_bar(),
                            grid=j_grid(*box, simplex=True), n_sub=4,
                            n_comp=3)
    rj = japi.solve(pj)
    grid = structured_grid(*box, simplex=True)
    pt = tapi.setup_problem(ptree(tapi), problem=tproblems.steel_rubber_bar(),
                            grid=grid, n_sub=4, n_comp=3, device="cpu")
    rt = tapi.solve(pt)
    assert grid.elem_type == "tet" and grid.n_elems == 8 * 2 * 3 * 6
    assert rt.converged and rt.iterations == int(rj.iterations)
    u = tapi.solution(pt, rt).numpy()
    Ac, rhs, g = pt.disc.constrained_system()
    u_ref = g.numpy() + spla.spsolve(pt.disc.pattern.to_scipy(Ac).tocsc(),
                                     rhs.numpy())
    assert np.abs(u - u_ref).max() <= 1e-4 * np.abs(u_ref).max()
    Ke, fe = pt.disc.element_matrices()
    Ks, fs = pt.disc.element_matrices(elems=np.array([3, 0, 17]))
    assert torch.equal(Ks, Ke[[3, 0, 17]]) and torch.equal(fs, fe[[3, 0, 17]])
    modes = rigid_body_modes(grid.nodes, 3)
    assert len(modes) == 6
    A, _ = pt.disc.assemble()
    scale = float(A.vals.abs().max())
    for m in modes:
        m = torch.as_tensor(np.asarray(m))
        assert float(A.mv(m).abs().max()) < 1e-9 * scale * float(m.abs().max() + 1)
