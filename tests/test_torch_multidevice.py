"""The port's multi-device path (``ddm_tpu_torch/core/mesh.py``;
``api.build_preconditioner(p, mesh=)``, ``api.solve(p, mesh=)``) on W = 4
gloo ranks on the CPU, against the port's single-device path and, for the
two-level GenEO cases, the JAX package's single-device solve.

The counterpart of tests/test_multichip.py (its TPU-construction case is
replaced by the dd subdomain precision; the ``global`` and ``local``
coarse matrices are added).  The four ranks are spawned once for the
module (``spawn`` start method, a ``file://`` rendezvous under the test's
temporary directory, one thread each, a 120 s collective timeout): each
runs every case and writes its results, which each test reads; the parent
builds the single-device references meanwhile, at the ranks' one thread
(the CPU's matrix products round differently under another thread count).
The ranks never import jax: this module imports the JAX package inside
its reference function only.

Tolerances: the sharded build solves the same subdomain problems in slabs
of n_sub / W, and the sharded apply sums the same slab contributions in the
same fixed order, so the sharded iterates equal the single-device ones up
to the rounding of batched products over another batch size (none on this
CPU: they agree bit for bit): one-level x within 1e-12, two-level within
1e-10 (CG, as tests/test_multichip.py), the ring space bit for bit, the
slab-boundary case within 1e-9 (as there).  The JAX package's single-device solve of the same
configuration: the same count and x within 1e-6 relative, the bound of
tests/test_torch_slice.py.  LOBPCG starts each slab from its own numpy
block, so its count may move by 2 (as tests/test_multichip.py allows).
The iterates of the four ranks must be bit-identical.
"""

import dataclasses
import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ddm_tpu_torch import api as tapi
from ddm_tpu_torch.core import mesh as dmesh
from ddm_tpu_torch.fem import problems as tproblems

torch.set_num_threads(2)

W = 4
TIMEOUT = datetime.timedelta(seconds=120)


def _cg(pt, coarse="none", nev=4):
    """tests/test_multichip.py:_problem's settings."""
    pt["solver.type"] = "cgsolver"
    pt["solver.reduction"] = 1e-8
    pt["solver.maxit"] = 200
    # standard AS keeps the preconditioner symmetric for CG
    pt["schwarz.type"] = "standard"
    if coarse != "none":
        pt["coarsespace.type"] = coarse
        pt[f"{coarse}.eigensolver.nev"] = nev
        pt[f"{coarse}.eigensolver.threshold"] = -1.0


def _gmres(pt, coarse, nev=3, **keys):
    """tests/test_multichip.py:_sharded_parity's settings."""
    pt["solver.type"] = "restartedgmressolver"
    pt["solver.reduction"] = 1e-8
    pt["solver.maxit"] = 300
    pt["coarsespace.type"] = coarse
    pt[f"{coarse}.eigensolver.nev"] = nev
    pt[f"{coarse}.eigensolver.threshold"] = -1.0
    for k, v in keys.items():
        pt[k.replace("__", ".")] = v


# name -> (problem, gridsize, parts, config); every case but "indivisible"
# is solved sharded on the ranks and single-device in the parent
CASES = {
    "one_level_cg": (None, 24, (4, 2), lambda pt: _cg(pt)),
    "geneo_cg": (None, 24, (4, 2), lambda pt: _cg(pt, "geneo")),
    "restricted_geneo": (None, 24, (4, 2), lambda pt: _gmres(pt, "geneo")),
    # 16 subdomains: the slabs of the boundary rows hold narrower rings
    # than the others, so the ring GEVP's padded width must be the batch's
    "geneo_ring": (None, 24, (4, 4), lambda pt: _gmres(pt, "geneo_ring")),
    "msgfem": (None, 24, (4, 2), lambda pt: _gmres(pt, "msgfem")),
    "lobpcg": (None, 24, (4, 2), lambda pt: _gmres(
        pt, "geneo", geneo__eigensolver__type="lobpcg",
        geneo__eigensolver__maxit=60)),
    "gmres_islands": ("islands", 32, (4, 2), lambda pt: _gmres(
        pt, "geneo", nev=4, solver__maxit=200)),
    # restricted GenEO at 16 subdomains, each rank's slab of 4 factored and
    # eigensolved one subdomain at a time (slab size forced to 1)
    "slab_boundary": (None, 24, (4, 4), lambda pt: _gmres(pt, "geneo")),
    "dd": (None, 24, (4, 2), lambda pt: _gmres(
        pt, "geneo", schwarz__subdomain_solver__precision="dd")),
    # the two other coarse-matrix formulas: the slabs' rows (global) or
    # columns (local) of E, gathered
    "matrix_global": (None, 24, (4, 2), lambda pt: _gmres(
        pt, "geneo", coarse_solver__matrix_method="global")),
    "matrix_local": (None, 24, (4, 2), lambda pt: _gmres(
        pt, "geneo", coarse_solver__matrix_method="local")),
    # 6 subdomains do not divide over 4 ranks
    "indivisible": (None, 24, (3, 2), lambda pt: _cg(pt)),
}
JAX_CASES = ("geneo_cg", "gmres_islands")


def _problem(api, problems, name, **dev):
    problem, gridsize, parts, config = CASES[name]
    pt = api.default_ptree()
    pt["gridsize"] = gridsize
    pt["schwarz.subdomain_solver.type"] = "cholesky"
    config(pt)
    prob = problems.PROBLEMS[problem]() if problem else None
    return api.setup_problem(pt, problem=prob, parts=parts, **dev)


def _batched_leading_dims(prec, n_sub):
    """Leading dimensions of every tensor of the preconditioner's
    components that carries one row per subdomain (per its sub2glob)."""
    dims = {}
    for k, q in enumerate(prec.precs):
        n_loc = q.sub2glob.shape[0]
        fields = dict(vars(q))
        if hasattr(q, "factors"):
            fields.update({f"factors.{a}": v
                           for a, v in vars(q.factors).items()})
        for name, v in fields.items():
            if torch.is_tensor(v) and v.ndim >= 1 and v.shape[0] in (
                    n_loc, n_sub) and name != "dualT":
                dims[f"{k}.{name}"] = v.shape[0]
    return dims


def _rank_case(name, mesh):
    """One case on this rank; returns its results (CPU tensors, numbers)."""
    from ddm_tpu_torch.precond import schwarz
    from ddm_tpu_torch.solvers import direct

    p = _problem(tapi, tproblems, name, device="cpu")
    out = {}
    if name == "indivisible":
        try:
            tapi.build_preconditioner(p, mesh=mesh)
        except ValueError as e:
            out["error"] = str(e)
        return out
    seen = {"factor": [], "chunked": []}
    orig = schwarz.factor_batched, direct.chunked_batch, direct.SLAB_BYTES

    def factor_spy(A, *a, **k):
        seen["factor"].append(A.shape[0])
        return orig[0](A, *a, **k)

    def chunked_spy(fn, *arrays, chunk):
        seen["chunked"].append((arrays[0].shape[0], chunk))
        return orig[1](fn, *arrays, chunk=chunk)

    schwarz.factor_batched, direct.chunked_batch = factor_spy, chunked_spy
    if name == "slab_boundary":
        direct.SLAB_BYTES = 1  # one subdomain per slab of the pipeline
    try:
        prec = tapi.build_preconditioner(p, mesh=mesh)
    finally:
        schwarz.factor_batched, direct.chunked_batch, direct.SLAB_BYTES = orig
    res = tapi.solve(p, prec, mesh=mesh)
    out.update(iterations=res.iterations, converged=res.converged,
               x=res.x.clone(), history=res.history, seen=seen)
    if name == "one_level_cg":
        # a preconditioner built without the mesh holds the full batch
        try:
            tapi.solve(p, tapi.build_preconditioner(p), mesh=mesh)
        except ValueError as e:
            out["error"] = str(e)
    if name == "geneo_cg":
        out["dims"] = _batched_leading_dims(prec, p.topo.n_sub)
        coarse = prec.precs[1].coarse  # LU: no coarse_solver.type given
        out["coarse_factor"] = {f.name: getattr(coarse, f.name).clone()
                                for f in dataclasses.fields(coarse)}
    return out


def _rank_main(rank, init_method, out_dir):
    torch.set_num_threads(1)
    mesh = dmesh.init_ranks(rank, W, init_method, device="cpu",
                            timeout=TIMEOUT)
    try:
        results = {name: _rank_case(name, mesh) for name in CASES}
        results["backend"] = mesh.backend
        torch.save(results, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(ranks' results, single-device port results, JAX results)."""
    tmp = tmp_path_factory.mktemp("multidevice")
    ctx = mp.start_processes(
        _rank_main, args=(f"file://{tmp}/rendezvous", str(tmp)), nprocs=W,
        join=False, start_method="spawn")
    try:
        # one thread, as on the ranks: the CPU's matrix products round
        # differently under another thread count (2 threads move the
        # slab-boundary case's x by 1.8e-9)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        single = {}
        try:
            for name in CASES:
                if name != "indivisible":
                    res = tapi.solve(_problem(tapi, tproblems, name,
                                              device="cpu"))
                    single[name] = (res.iterations, res.x)
        finally:
            torch.set_num_threads(threads)
        jax_runs = _jax_runs()
    finally:
        while not ctx.join():
            pass
    ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
             for r in range(W)]
    return ranks, single, jax_runs


def _jax_runs():
    """The JAX package's single-device solves of JAX_CASES (x64, CPU)."""
    import ddm_tpu.api as japi
    from ddm_tpu.fem import problems as jproblems

    out = {}
    for name in JAX_CASES:
        res = japi.solve(_problem(japi, jproblems, name))
        assert bool(res.converged)
        out[name] = (int(res.iterations), np.asarray(res.x))
    return out



def _parity(runs, name, atol=None, slack=0):
    ranks, single, _ = runs
    its, x = single[name]
    r0 = ranks[0][name]
    assert r0["converged"]
    assert abs(r0["iterations"] - its) <= slack, (r0["iterations"], its)
    if atol is not None:
        err = float((r0["x"] - x).abs().max())
        assert err <= atol, err
    return r0


def _jax_parity(runs, name):
    ranks, _, jax_runs = runs
    its_j, x_j = jax_runs[name]
    r0 = ranks[0][name]
    assert r0["iterations"] == its_j, (r0["iterations"], its_j)
    assert np.abs(r0["x"].numpy() - x_j).max() <= 1e-6 * np.abs(x_j).max()


def test_one_level_sharded_matches_single_device(runs):
    assert runs[0][0]["backend"] == "gloo"
    _parity(runs, "one_level_cg", atol=1e-12)


def test_two_level_geneo_sharded_matches_single_device_and_jax(runs):
    _parity(runs, "geneo_cg", atol=1e-10)
    _jax_parity(runs, "geneo_cg")


def test_sharded_prec_state_is_distributed(runs):
    """Every subdomain-batched tensor of each rank's preconditioner holds
    the rank's n_sub / W subdomains; the coarse factor is the same on
    every rank."""
    ranks = runs[0]
    n_loc = 8 // W
    for r in ranks:
        dims = r["geneo_cg"]["dims"]
        assert {"0.sub2glob", "0.pou", "0.factors.chol", "1.V",
                "1.active"} <= set(dims), dims
        assert set(dims.values()) == {n_loc}, dims
    factor = ranks[0]["geneo_cg"]["coarse_factor"]
    assert set(factor) == {"lu", "piv"}
    assert all(torch.equal(r["geneo_cg"]["coarse_factor"][k], v)
               for r in ranks[1:] for k, v in factor.items())


def test_setup_is_sharded_during_build(runs):
    """The fine factorization and the GEVP see the rank's slab as they are
    built, not a full batch cut afterwards."""
    for r in runs[0]:
        seen = r["geneo_cg"]["seen"]
        assert seen["factor"] == [8 // W], seen
        assert seen["chunked"] and all(n == 8 // W
                                       for n, _ in seen["chunked"]), seen


def test_sharded_setup_restricted_geneo(runs):
    _parity(runs, "restricted_geneo")


def test_sharded_setup_geneo_ring(runs):
    """Bit for bit: a ring GEVP padded to a rank's own ring width instead
    of the batch's moves x here by 1.1e-16 only."""
    _parity(runs, "geneo_ring", atol=0.0)


def test_sharded_setup_msgfem(runs):
    _parity(runs, "msgfem")


def test_sharded_setup_lobpcg(runs):
    _parity(runs, "lobpcg", slack=2)


def test_gmres_sharded_two_level_matches_jax(runs):
    _parity(runs, "gmres_islands")
    _jax_parity(runs, "gmres_islands")


def test_sharded_slab_boundary(runs):
    """Each rank's slab of 4 subdomains goes through the GEVP one subdomain
    at a time."""
    for r in runs[0]:
        assert set(r["slab_boundary"]["seen"]["chunked"]) == {(16 // W, 1)}
    _parity(runs, "slab_boundary", atol=1e-9)


def test_sharded_dd_precision(runs):
    """Double-single subdomain inverses (the plain dd_matvec on the CPU)
    under the sharded build and apply."""
    _parity(runs, "dd", atol=1e-10)


@pytest.mark.parametrize("method", ["global", "local"])
def test_sharded_coarse_matrix_methods(runs, method):
    _parity(runs, f"matrix_{method}", atol=1e-10)


def test_full_batch_preconditioner_refused(runs):
    for r in runs[0]:
        msg = r["one_level_cg"]["error"]
        assert "holds 8 subdomains" in msg and "2" in msg, msg


def test_indivisible_subdomain_count_raises(runs):
    for r in runs[0]:
        msg = r["indivisible"]["error"]
        assert "6" in msg and "4 ranks" in msg, msg


def test_iterates_bit_identical_on_all_ranks(runs):
    ranks = runs[0]
    for name in CASES:
        if name == "indivisible":
            continue
        r0 = ranks[0][name]
        for r in ranks[1:]:
            assert r[name]["iterations"] == r0["iterations"], name
            assert torch.equal(r[name]["x"], r0["x"]), name
            assert np.array_equal(r[name]["history"], r0["history"],
                                  equal_nan=True), name


def test_slab_cuts_refuse_another_batch_size():
    """Under setup_sharding an array or topology is the full batch (cut to
    the rank's slab) or that slab already (passed through); any other size
    raises."""
    p = _problem(tapi, tproblems, "one_level_cg", device="cpu")
    m = dmesh.SubdomainMesh(group=None, rank=1, size=W,
                            device=torch.device("cpu"), backend="gloo")
    with dmesh.setup_sharding(m, 8):
        slab = dmesh.local_rows(p.pou)
        assert np.array_equal(slab, p.pou[2:4])
        assert dmesh.local_rows(slab) is slab
        topo = dmesh.local_topology(p.topo)
        assert topo.n_sub == 2 and dmesh.local_topology(topo) is topo
        with pytest.raises(ValueError, match="holds 3 subdomains"):
            dmesh.local_rows(p.pou[:3])
        with pytest.raises(ValueError, match="holds 4 subdomains"):
            dmesh.local_topology(dmesh.slice_topology(p.topo, 0, 4))
