"""Core layers of the PyTorch port against the JAX package: the copied
topology code, the ELL SpMV, assembly + constraints + equilibration, and the
port's independence from jax."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddm_tpu.api as japi
from ddm_tpu.core import indexmaps as jidx
from ddm_tpu.fem import problems as jproblems
from ddm_tpu_torch import api as tapi
from ddm_tpu_torch import convert
from ddm_tpu_torch.core import indexmaps as tidx
from ddm_tpu_torch.core.sparse import EllPattern, SumPlan
from ddm_tpu_torch.fem import problems as tproblems
from ddm_tpu_torch.fem.assemble import element_coo_indices
from ddm_tpu_torch.fem.grids import structured_grid

torch.set_num_threads(2)


def _pt(api, gridsize):
    pt = api.default_ptree()
    pt["gridsize"] = gridsize
    return pt


@pytest.fixture(scope="module")
def problems_32():
    """islands 32^2 / 16 subdomains built independently by both packages."""
    pj = japi.setup_problem(_pt(japi, 32), problem=jproblems.islands(),
                            parts=(4, 4))
    pt = tapi.setup_problem(_pt(tapi, 32), problem=tproblems.islands(),
                            parts=(4, 4), device="cpu")
    return pj, pt


def _check_topology(gridsize, parts, overlap, n_comp=1):
    """The copied topology code on ``n_comp`` dofs per node (node-major,
    component-minor): every array equal to the JAX package's."""
    import scipy.sparse as sps

    g = structured_grid((gridsize, gridsize))
    part = tidx.partition_structured(g.shape, parts)
    np.testing.assert_array_equal(
        part, jidx.partition_structured(g.shape, parts))
    n = g.n_nodes * n_comp
    r, c = element_coo_indices(g.elems, n_comp)
    adj = sps.csr_matrix((np.ones(r.size), (r, c)), shape=(n, n))
    M0 = tidx.dof_membership_from_elems(g.elems, part, n, part.max() + 1,
                                        n_comp=n_comp)
    own = tidx.dof_owner_lowest(g.elems, part, n, n_comp=n_comp)
    assert (M0 != jidx.dof_membership_from_elems(
        g.elems, part, n, part.max() + 1, n_comp=n_comp)).nnz == 0
    np.testing.assert_array_equal(
        own, jidx.dof_owner_lowest(g.elems, part, n, n_comp=n_comp))
    t = tidx.build_topology(adj, M0, own, overlap)
    j = jidx.build_topology(adj, M0, own, overlap)
    for f in ("n_glob", "n_sub", "n_pad", "overlap", "bdist_cap"):
        assert getattr(t, f) == getattr(j, f), f
    for f in ("sub2glob", "valid", "owner", "boundary", "bdist", "dof_owner",
              "g2l_keys", "g2l_locs", "sizes"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    assert (t.membership != j.membership).nnz == 0
    np.testing.assert_array_equal(tidx.pou_weights(t), jidx.pou_weights(j))
    np.testing.assert_array_equal(tidx.dual_scatter_map(t),
                                  jidx.dual_scatter_map(j))
    ell_cols = EllPattern.from_coo(r, c, n).cols
    np.testing.assert_array_equal(tidx.extraction_map(t, ell_cols),
                                  jidx.extraction_map(j, ell_cols))
    return t


@pytest.mark.parametrize("gridsize,parts,overlap", [(16, (2, 2), 1),
                                                    (32, (4, 4), 2)])
def test_build_topology_equals_jax(gridsize, parts, overlap):
    _check_topology(gridsize, parts, overlap)


def test_build_topology_two_components_equals_jax():
    """A 2-component 16^2 grid, 4 subdomains, overlap 2: the same
    ``sub2glob``, ``valid`` and owners as the JAX package, and both
    components of a node always share their subdomains."""
    t = _check_topology(16, (2, 2), 2, n_comp=2)
    assert t.n_glob == 2 * 17 * 17
    ids = t.sub2glob[0][t.valid[0]]
    np.testing.assert_array_equal(ids[0::2] + 1, ids[1::2])


@pytest.mark.parametrize("k", [0, 3])
def test_sparse_mv_matches_jax(problems_32, k):
    """Row-major ELL SpMV on the JAX package's operator (carried across)
    against the JAX SpMV, 1-D and (n, k) inputs, to 1e-14."""
    pj, _ = problems_32
    ell = convert.problem_from_numpy(
        np.asarray(pj.A.colsT), np.asarray(pj.A.valsT), np.asarray(pj.rhs),
        np.asarray(pj.g), None, pj.pou, pj.topo.sub2glob, pj.topo.valid,
        pj.topo.bdist, pj.topo.boundary, jidx.dual_scatter_map(pj.topo),
        overlap=2, device="cpu",
    ).A
    rng = np.random.default_rng(k)
    x = rng.standard_normal((ell.n, k) if k else ell.n)
    y = ell.mv(torch.as_tensor(x)).numpy()
    y_j = np.asarray(pj.A.mv(jnp.asarray(x)))
    assert np.abs(y - y_j).max() <= 1e-14 * np.abs(y_j).max()


def test_constrained_system_matches_jax(problems_32):
    """Assembled, constrained and equilibrated system equals the JAX
    package's to 1e-12 (compared as CSR: ELL slot orders differ)."""
    pj, pt = problems_32
    Aj = pj.disc.pattern.to_scipy(pj.A)
    At = pt.disc.pattern.to_scipy(pt.A)
    assert abs(Aj - At).max() <= 1e-12 * abs(Aj).max()
    for name in ("rhs", "g", "scale"):
        a = getattr(pt, name).numpy()
        b = np.asarray(getattr(pj, name))
        assert np.abs(a - b).max() <= 1e-12 * max(np.abs(b).max(), 1e-300), name
    np.testing.assert_array_equal(pt.disc.dirichlet_mask.numpy(),
                                  np.asarray(pj.disc.dirichlet_mask))


@pytest.mark.parametrize("name", ["beams", "checkerboard_cd"])
def test_assembly_of_another_problem_matches_jax(problems_32, name):
    """``assemble``, ``constrained_system`` and ``neumann_stamps`` given a
    second problem on the discretization's grid (beams, and the
    nonsymmetric checkerboard convection-diffusion, whose stamps are
    symmetrized) equal the JAX package's ``disc.<method>(problem)`` to
    1e-12 relative, as the discretization's own system above (the element
    quadrature sums round differently from XLA's in the last bits); the
    discretization's own problem stays the default."""
    pj, pt = problems_32
    dj, dt = pj.disc, pt.disc
    pb_j, pb_t = jproblems.PROBLEMS[name](), tproblems.PROBLEMS[name]()

    def close(a, b):
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() <= 1e-12 * max(np.abs(b).max(), 1e-300)

    def close_csr(Aj, At):
        Sj, St = dj.pattern.to_scipy(Aj), dt.pattern.to_scipy(At)
        assert abs(Sj - St).max() <= 1e-12 * abs(Sj).max()

    Aj, bj = dj.assemble(pb_j)
    At, bt = dt.assemble(pb_t)
    close_csr(Aj, At)
    close(bt.numpy(), bj)
    Acj, rj, gj = dj.constrained_system(pb_j)
    Act, rt, gt = dt.constrained_system(pb_t)
    close_csr(Acj, Act)
    close(rt.numpy(), rj)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    (dofs_j, K_j), = dj.neumann_stamps(pb_j)
    (dofs_t, K_t), = dt.neumann_stamps(pb_t)
    np.testing.assert_array_equal(dofs_t, dofs_j)
    close(K_t.numpy(), K_j)
    own, = dt.neumann_stamps()
    assert not torch.equal(own[1], K_t)
    assert torch.equal(own[1], dt.neumann_stamps(dt.problem)[0][1])


def test_sum_plan_scatter_add():
    """SumPlan equals np.add.at (to rounding), lists each target's sources
    in ascending order, and leaves untouched targets zero."""
    rng = np.random.default_rng(0)
    src_idx = rng.integers(0, 50, 400)
    tgt_idx = rng.integers(0, 30, 400)
    src = rng.standard_normal(50)
    plan = SumPlan.build(src_idx, tgt_idx, 50, "cpu")
    got = plan.scatter(torch.as_tensor(src), 40).numpy()
    want = np.zeros(40)
    np.add.at(want, tgt_idx, src[src_idx])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
    assert not got[30:].any()
    dual = plan.dual.numpy()
    real = np.where(dual < 50, dual, np.iinfo(np.int64).max)
    assert (np.diff(real, axis=1) >= 0).all()


def test_import_leaves_jax_out():
    code = (
        "import sys, ddm_tpu_torch.api, ddm_tpu_torch.convert, "
        "ddm_tpu_torch.kernels.build, ddm_tpu_torch.precond.two_level, "
        "ddm_tpu_torch.bench, ddm_tpu_torch._native\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'ddm_tpu' not in sys.modules, 'ddm_tpu imported'\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])
