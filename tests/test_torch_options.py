"""Options and small modules of the PyTorch port against the JAX package:
the scripted coefficient files and their loader, Matrix Market input and
output, the log levels, ``modify_subdomain_matrix``, the f32 subdomain
precision (``SparseRefinedInverse``) and 2-D elasticity on a generated
triangle bar.

Inputs are made from numpy.  Tolerances: coefficients at the same 50
points from ``numpy.random.default_rng(0)`` equal to 1e-15 relative
(booleans equal); Matrix Market matrices equal; iteration counts equal,
solutions within 1e-8 relative; the f32 inverse's refined solves within
1e-5 of the JAX package's (its products are f32 sums in another order).
The JAX side stays small (n_pad <= 448) and each JAX result is computed
once per module.
"""

import io
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
COEFFS = {pkg: os.path.join(ROOT, pkg, "examples", "coefficients")
          for pkg in ("ddm_tpu", "ddm_tpu_torch")}
SCALAR_FILES = ["poisson_coefficient.py", "convection_diffusion_coefficient.py",
                "symmetric_convection_diffusion_coefficient.py"]
SCALAR_KEYS = ("alpha", "b", "c", "f", "g", "is_dirichlet")
ELASTICITY_KEYS = ("lam", "mu", "f", "g", "is_dirichlet")


def _points(d):
    return np.random.default_rng(0).uniform(size=(50, d))


def _same(t, j):
    """Port output equal to the JAX output (1e-15 relative for floats)."""
    t, j = t.numpy(), np.asarray(j)
    assert t.shape == j.shape and t.dtype.kind == j.dtype.kind
    if j.dtype == bool:
        assert np.array_equal(t, j)
    else:
        assert np.allclose(t, j, rtol=1e-15, atol=0.0)


def _compare(tp, jp, keys, x):
    import jax.numpy as jnp

    for key in keys:
        tf, jf = getattr(tp, key), getattr(jp, key)
        assert (tf is None) == (jf is None), key
        if tf is not None:
            _same(tf(torch.as_tensor(x)), jf(jnp.asarray(x)))


@pytest.mark.parametrize("name", SCALAR_FILES)
def test_scalar_coefficient_files_match_jax(name):
    """Every function the JAX file defines (and the defaults it leaves),
    at the same 50 points; convection makes both problems nonsymmetric."""
    from ddm_tpu.fem.scripted import load_problem as j_load
    from ddm_tpu_torch.fem.scripted import load_problem

    tp = load_problem(os.path.join(COEFFS["ddm_tpu_torch"], name))
    jp = j_load(os.path.join(COEFFS["ddm_tpu"], name))
    assert tp.symmetric == jp.symmetric
    _compare(tp, jp, SCALAR_KEYS, _points(2))


def test_poisson_coefficient_file_is_islands():
    """The scripted islands file equals the port's built-in islands
    problem (the JAX package's test_scripted_problem_matches_builtin)."""
    from ddm_tpu_torch.fem import problems
    from ddm_tpu_torch.fem.scripted import load_problem

    tp = load_problem(os.path.join(COEFFS["ddm_tpu_torch"], SCALAR_FILES[0]))
    x = torch.as_tensor(_points(2))
    for key in ("alpha", "g", "is_dirichlet"):
        assert torch.equal(getattr(tp, key)(x),
                           getattr(problems.islands(), key)(x))


def test_elasticity_coefficient_file_matches_jax():
    """lam and mu derived from (E, nu), and the defaults f, g,
    is_dirichlet, at the 50 points spread over [0,4]x[0,1]x[0,1.5] and
    the eight bar centres (steel), against the JAX file and the port's
    built-in steel_rubber_bar."""
    from ddm_tpu.fem.scripted import load_elasticity_problem as j_load
    from ddm_tpu_torch.fem import problems
    from ddm_tpu_torch.fem.scripted import load_elasticity_problem

    name = "elasticity_coefficient.py"
    tp = load_elasticity_problem(os.path.join(COEFFS["ddm_tpu_torch"], name))
    jp = j_load(os.path.join(COEFFS["ddm_tpu"], name))
    centres = np.array([[1.0, y, z] for y in (0.25, 0.75)
                        for z in (0.3, 0.6, 0.9, 1.2)])
    x = np.concatenate([_points(3) * [4.0, 1.0, 1.5], centres])
    _compare(tp, jp, ELASTICITY_KEYS, x)
    built_in = problems.steel_rubber_bar()
    xt = torch.as_tensor(x)
    assert (tp.lam(xt)[-8:] > 1e11).all()
    for key in ("lam", "mu"):
        assert torch.equal(getattr(tp, key)(xt), getattr(built_in, key)(xt))


def test_incomplete_elasticity_file_raises_keyerror(tmp_path):
    from ddm_tpu.fem.scripted import load_elasticity_problem as j_load
    from ddm_tpu_torch.fem.scripted import load_elasticity_problem

    path = tmp_path / "partial.py"
    path.write_text("def youngs_modulus(x, y, z):\n    return x\n")
    for load in (load_elasticity_problem, j_load):
        with pytest.raises(KeyError):
            load(str(path))


MM = """%%MatrixMarket matrix coordinate real general
3 3 5
1 1 2.0
1 2 -1.0
2 2 2.0
3 2 -1.0
3 3 2.0
"""


def test_matrix_market_roundtrip(tmp_path):
    """tests/test_io_and_meshes.py's round trip on the port."""
    from ddm_tpu_torch.core.io import read_matrix_market, write_matrix_market

    pat, ell = read_matrix_market(MM, "cpu")
    dense = pat.to_scipy(ell).toarray()
    assert np.array_equal(dense, [[2, -1, 0], [0, 2, 0], [0, -1, 2]])
    assert np.array_equal(ell.mv(torch.ones(3, dtype=torch.float64)).numpy(),
                          dense.sum(1))
    path = str(tmp_path / "a.mtx")
    write_matrix_market(path, pat, ell)
    pat2, ell2 = read_matrix_market(path, "cpu")
    assert np.array_equal(pat2.to_scipy(ell2).toarray(), dense)


def test_matrix_market_across_packages(tmp_path):
    """A file the JAX package wrote reads into the same matrix in the
    port, and the other way round."""
    import scipy.io
    import scipy.sparse as sps

    from ddm_tpu.core.io import read_matrix_market as j_read
    from ddm_tpu.core.io import write_matrix_market as j_write
    from ddm_tpu_torch.core.io import read_matrix_market, write_matrix_market

    rng = np.random.default_rng(0)
    S = sps.random(30, 30, density=0.15, random_state=rng, format="csr")
    S = S + sps.eye(30)
    src = io.BytesIO()
    scipy.io.mmwrite(src, S)
    jpat, jell = j_read(src.getvalue().decode())
    j_path = str(tmp_path / "jax.mtx")
    j_write(j_path, jpat, jell)
    tpat, tell = read_matrix_market(j_path, "cpu")
    assert np.array_equal(tpat.to_scipy(tell).toarray(), S.toarray())
    t_path = str(tmp_path / "port.mtx")
    write_matrix_market(t_path, tpat, tell)
    jpat2, jell2 = j_read(t_path)
    assert np.array_equal(jpat2.to_scipy(jell2).toarray(), S.toarray())


def test_profile_trace_writes_a_chrome_trace_as_jax(tmp_path):
    """Both packages' ``profile_trace(log_dir)`` write a Chrome trace of
    the work inside the context under ``log_dir``: the JAX package's as
    the ``*.trace.json.gz`` of its TensorBoard profile, the port's as
    ``trace_*.json``; both hold trace events, the port's the torch ops it
    ran, and the port's keeps its profiler for ``key_averages()``."""
    import gzip
    import json

    import jax.numpy as jnp

    from ddm_tpu.obs.logger import profile_trace as j_profile_trace
    from ddm_tpu_torch.obs.logger import profile_trace

    with j_profile_trace(str(tmp_path / "jax")):
        (jnp.ones((64, 64)) @ jnp.ones((64, 64))).block_until_ready()
    j_trace, = (tmp_path / "jax").rglob("*.trace.json.gz")
    with gzip.open(j_trace) as f:
        assert json.load(f)["traceEvents"]
    with profile_trace(str(tmp_path / "port")) as tr:
        torch.ones((64, 64), dtype=torch.float64) @ torch.ones(
            (64, 64), dtype=torch.float64)
    t_trace, = (tmp_path / "port").glob("trace_*.json")
    assert str(t_trace) == tr.path
    with open(t_trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in tr.prof.key_averages())


def test_log_level_parsing():
    """tests/test_obs.py:test_log_level_parsing on the port, and the
    levels' filtering and {}-formatting."""
    from ddm_tpu_torch.obs.logger import Level, logger, setup_loggers

    rest = setup_loggers(["--log-level=debug", "-gridsize", "4"])
    assert rest == ["-gridsize", "4"]
    assert logger.get_level() is Level.debug
    stream, logger.stream = logger.stream, io.StringIO()
    try:
        logger.trace("hidden {}", 1)
        logger.debug("shown {} {}", 2, "x")
        logger.set_level("error")
        logger.warn("hidden")
        logger.critical("kept")
        out = logger.stream.getvalue()
    finally:
        logger.stream = stream
        logger.set_level("info")
    assert out == "[debug] shown 2 x\n[critical] kept\n"
    assert setup_loggers(None) == []


def test_modify_subdomain_matrix_matches_jax():
    """simple 32^2 / (2, 2), one level, subdomain-boundary dofs eliminated
    before factorising (tests/test_misc.py:test_modify_subdomain_matrix_
    converges): the JAX package's iteration count and solution."""
    import ddm_tpu.api as japi
    from ddm_tpu.fem import problems as jproblems
    from ddm_tpu_torch import api
    from ddm_tpu_torch.fem import problems

    runs = []
    for mod, prob, kw in ((japi, jproblems, {}),
                          (api, problems, {"device": "cpu"})):
        pt = mod.default_ptree()
        pt["gridsize"] = 32
        pt["modify_subdomain_matrix"] = True
        p = mod.setup_problem(pt, problem=prob.simple(), parts=(2, 2), **kw)
        res = mod.solve(p)
        runs.append((int(res.iterations), bool(res.converged),
                     np.asarray(mod.solution(p, res))))
    (it_j, conv_j, u_j), (it_t, conv_t, u_t) = runs
    assert conv_j and conv_t and it_t == it_j
    assert np.abs(u_t - u_j).max() <= 1e-8 * np.abs(u_j).max()


@pytest.fixture(scope="module")
def refined_inputs():
    """tests/test_krylov_extra.py:test_sparse_refined_inverse's inputs,
    built in both packages: islands 16^2 / (2, 2), overlap 2, the f64
    Cholesky inverses, the subdomains' sparse rows and a random
    right-hand side."""
    import jax.numpy as jnp

    from ddm_tpu.core.indexmaps import extraction_map as j_extraction_map
    from ddm_tpu.core.setup import setup_topology as j_setup_topology
    from ddm_tpu.fem import problems as jproblems
    from ddm_tpu.fem import structured_grid as j_grid
    from ddm_tpu.fem.discretize import Discretization as JDisc
    from ddm_tpu.precond.extract import extract_subdomain_dense as j_extract
    from ddm_tpu.solvers.direct import factor_batched as j_factor
    from ddm_tpu_torch.core.indexmaps import extraction_map
    from ddm_tpu_torch.core.setup import setup_topology
    from ddm_tpu_torch.fem import problems
    from ddm_tpu_torch.fem.discretize import Discretization
    from ddm_tpu_torch.fem.grids import structured_grid
    from ddm_tpu_torch.precond.extract import extract_subdomain_dense
    from ddm_tpu_torch.solvers.direct import factor_batched

    jdisc = JDisc(j_grid((16, 16)), jproblems.islands())
    jA, _, _ = jdisc.constrained_system()
    jtopo, _ = j_setup_topology(jdisc, overlap=2, parts=(2, 2))
    jlc = jnp.asarray(j_extraction_map(jtopo, np.asarray(jA.colsT).T))
    js2g, jvalid = jnp.asarray(jtopo.sub2glob), jnp.asarray(jtopo.valid)
    jinv = j_factor(j_extract(jA, js2g, jvalid, jlc), "cholesky",
                    mode="inverse", refine_steps=1)
    jvals, _ = jA.rows_dense_gather(jnp.minimum(js2g, jA.n - 1))
    jvals = jnp.where(jlc >= jtopo.n_pad, 0.0, jvals * jvalid[:, :, None])

    disc = Discretization(structured_grid((16, 16)), problems.islands(), "cpu")
    A, _, _ = disc.constrained_system()
    topo, _ = setup_topology(disc, overlap=2, parts=(2, 2))
    lc = torch.as_tensor(extraction_map(topo, A.cols.numpy()).astype(np.int64))
    s2g = torch.as_tensor(topo.sub2glob.astype(np.int64))
    valid = torch.as_tensor(topo.valid)
    inv = factor_batched(extract_subdomain_dense(A, s2g, valid, lc),
                         "cholesky", mode="inverse")
    vals, _ = A.rows_dense_gather(torch.clamp(s2g, max=A.n - 1))
    vals = torch.where(lc >= topo.n_pad, 0.0, vals * valid[:, :, None])
    b = np.random.default_rng(0).normal(size=topo.sub2glob.shape) * topo.valid
    return dict(jax=(jinv, jvals, jlc), port=(inv, vals, lc), b=b)


def test_sparse_refined_inverse_contracts(refined_inputs):
    """tests/test_krylov_extra.py:75-99 on the port: each refinement step
    contracts the error of the f32 solve against the f64 inverse's."""
    from ddm_tpu_torch.solvers.direct import SparseRefinedInverse

    inv, vals, lc = refined_inputs["port"]
    b = torch.as_tensor(refined_inputs["b"])
    x_ref = inv.solve(b)
    errs = []
    for steps in (0, 1, 2):
        sri = SparseRefinedInverse(inv32=inv.inv.to(torch.float32),
                                   sub_vals=vals, sub_cols=lc, steps=steps)
        errs.append(float((sri.solve(b) - x_ref).abs().max()
                          / x_ref.abs().max()))
    assert errs[1] < 0.5 * errs[0]
    assert errs[2] <= errs[1] * 1.5
    # several right-hand sides are refined column by column
    B = torch.stack([b, 2.0 * b], dim=-1)
    X = sri.solve(B)
    assert torch.equal(X[..., 0], sri.solve(b))


def test_sparse_refined_inverse_matches_jax(refined_inputs):
    """steps = 0, 1, 2: the port's solves within 1e-5 (relative to the
    largest entry) of the JAX package's on the same inputs."""
    import jax.numpy as jnp

    from ddm_tpu.solvers.direct import SparseRefinedInverse as JSRI
    from ddm_tpu_torch.solvers.direct import SparseRefinedInverse

    jinv, jvals, jlc = refined_inputs["jax"]
    inv, vals, lc = refined_inputs["port"]
    b = refined_inputs["b"]
    for steps in (0, 1, 2):
        xj = np.asarray(JSRI(inv32=jinv.inv.astype(jnp.float32), sub_vals=jvals,
                             sub_cols=jlc, steps=steps).solve(jnp.asarray(b)))
        xt = SparseRefinedInverse(inv32=inv.inv.to(torch.float32),
                                  sub_vals=vals, sub_cols=lc,
                                  steps=steps).solve(torch.as_tensor(b))
        assert np.abs(xt.numpy() - xj).max() <= 1e-5 * np.abs(xj).max()


def write_tri_bar_msh(path, cells=(40, 8)):
    """[0,10]x[-1,1] as a gmsh v2.2 ASCII file of the triangles of a
    cells[0] x cells[1] simplex grid (the reference's bar.msh is a 2-D
    triangle bar on the same rectangle)."""
    from ddm_tpu_torch.fem.grids import structured_grid

    g = structured_grid(cells, (0.0, -1.0), (10.0, 1.0), simplex=True)
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes",
             str(g.n_nodes)]
    lines += [f"{k + 1} {float(x)!r} {float(y)!r} 0.0"
              for k, (x, y) in enumerate(g.nodes)]
    lines += ["$EndNodes", "$Elements", str(g.n_elems)]
    lines += [f"{k + 1} 2 2 0 1 {a + 1} {b + 1} {c + 1}"
              for k, (a, b, c) in enumerate(g.elems)]
    lines.append("$EndElements")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def test_triangle_bar_elasticity_matches_jax(tmp_path):
    """tests/test_elasticity.py:test_elasticity_bar_msh's case (lam 100,
    mu 1e4, gravity, clamped at x = 0, geneo nev 8, LU coarse solve, 8 RCB
    subdomains, GMRES(50) to 1e-6) on a generated triangle bar read by both
    packages from the same file: the JAX package's iteration count and
    solution."""
    import jax.numpy as jnp

    import ddm_tpu.api as japi
    from ddm_tpu.fem.msh import read_msh as j_read_msh
    from ddm_tpu.fem.problems import ElasticityProblem as JEP
    from ddm_tpu.solvers.krylov import gmres_solve as j_gmres
    from ddm_tpu.solvers.krylov import operator_of, prec_of
    from ddm_tpu_torch import api
    from ddm_tpu_torch.fem.msh import read_msh
    from ddm_tpu_torch.fem.problems import ElasticityProblem
    from ddm_tpu_torch.solvers.krylov import gmres_solve

    path = str(tmp_path / "bar.msh")
    write_tri_bar_msh(path)

    def ptree(mod):
        pt = mod.default_ptree()
        pt["solver.reduction"] = 1e-6
        pt["coarsespace.type"] = "geneo"
        pt["coarse_solver.type"] = "lu"
        pt["geneo.eigensolver.nev"] = 8
        return pt

    jep = JEP(
        lam=lambda x: jnp.full(x.shape[:-1], 100.0),
        mu=lambda x: jnp.full(x.shape[:-1], 10000.0),
        f=lambda x: jnp.stack(
            [jnp.zeros(x.shape[:-1]), jnp.full(x.shape[:-1], -9.81)], -1),
        g=lambda x: jnp.zeros(x.shape[:-1] + (2,)),
        is_dirichlet=lambda x: x[..., 0] < 1e-9, name="bar2d")
    jp = japi.setup_problem(ptree(japi), problem=jep, grid=j_read_msh(path),
                            n_sub=8, n_comp=2)
    jres = j_gmres(operator_of(jp.A), prec_of(japi.build_preconditioner(jp)),
                   jp.rhs, jnp.zeros_like(jp.rhs), reduction=1e-6, maxit=300,
                   restart=50)

    def f(x):
        out = x.new_zeros(x.shape)
        out[..., 1] = -9.81
        return out

    tep = ElasticityProblem(
        lam=lambda x: x.new_full(x.shape[:-1], 100.0),
        mu=lambda x: x.new_full(x.shape[:-1], 10000.0), f=f,
        g=lambda x: x.new_zeros(x.shape), is_dirichlet=lambda x: x[..., 0] < 1e-9,
        name="bar2d")
    grid = read_msh(path)
    assert grid.elem_type == "tri"
    tp = api.setup_problem(ptree(api), problem=tep, grid=grid, n_sub=8,
                           n_comp=2, device="cpu")
    tres = gmres_solve(tp.A.mv, api.build_preconditioner(tp).apply, tp.rhs,
                       torch.zeros_like(tp.rhs), reduction=1e-6, maxit=300,
                       restart=50)
    assert tp.topo.n_pad == jp.topo.n_pad
    assert bool(jres.converged) and tres.converged
    assert tres.iterations == int(jres.iterations) <= 100
    xj = np.asarray(jres.x)
    assert np.abs(tres.x.numpy() - xj).max() <= 1e-8 * np.abs(xj).max()
