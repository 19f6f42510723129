"""Every full-size path of ``chip_smoke.py`` under the JAX package (the
reference) and under the port, both on the CPU with f64, at
``chip_smoke.FULL``'s size with the ptree keys of ``chip_smoke.PATHS`` or
the example command lines (``CLI_PATHS``, ``NEWTON_PATHS``).

Each case runs each side in its own process (this file run as a script:
``python tests/test_torch_fullsize.py jax|port <path>`` prints one JSON
line: iterations, true relative residual, wall seconds and peak resident
memory), so two multi-GB subdomain batches are never resident at once and
the port's process never imports jax.  The port's iteration count must lie
within 2 of the JAX package's, and ``chip_smoke.py``'s iteration limits
must be the recorded JAX count + 2 (``chip_smoke.JAX_FULL_SIZE``,
``LIMIT_OF``).  Each case takes minutes and several GB (PERF.md section 2):
every case is marked slow, so tier-1's ``-m 'not slow'`` deselects the file.

    python -m pytest -m slow tests/test_torch_fullsize.py -k elast_f64
"""

import json
import os
import resource
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (imports torch, never jax)

SIDE_TIMEOUT_S = 3600
# The JAX package's count can move by one with XLA's CPU thread count (the
# L-shape: 17 on 8 threads, 18 on 4): JAX_FULL_SIZE holds its counts on 8
# cores, and each side runs on 8
JAX_CPUS = 8
JAX_EXAMPLES = os.path.join(ROOT, "ddm_tpu", "examples")


def _newton_case(path):
    return path in chip_smoke.NEWTON_PATHS


def _cli_case(path):
    return path in chip_smoke.CLI_PATHS


def _port_ptree(path, size):
    from ddm_tpu_torch import api as tapi

    return chip_smoke.path_ptree(tapi, path, size)


def _peak_gib():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


# -- the JAX side ----------------------------------------------------------

def _jax():
    """JAX on the CPU with x64 (the platform is set after import: an
    installed plugin may override the environment variable)."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


def _jax_problem(path):
    """The problem of ``path`` at full size built with the JAX package's
    API, as ``chip_smoke.path_problem`` builds it with the port's."""
    import ddm_tpu.api as japi
    from ddm_tpu.config import ParamTree
    from ddm_tpu.core.indexmaps import pou_weights
    from ddm_tpu.core.setup import setup_topology
    from ddm_tpu.core.sparse import jacobi_equilibrate
    from ddm_tpu.fem import problems
    from ddm_tpu.fem.grids import structured_grid

    kind = chip_smoke.PATHS[path][0]
    size, parts = chip_smoke.FULL[kind]
    pt = ParamTree(_port_ptree(path, size).as_dict())
    if kind == "dg":
        # the port's examples/convectiondiffusiondg.setup, equilibrated
        from ddm_tpu.fem.dg import DGDiscretization

        disc = DGDiscretization(structured_grid((size, size)),
                                problems.dg_heterogeneous())
        A, b, g = disc.constrained_system()
        A, b, scale = jacobi_equilibrate(A, b)
        topo, elem_part = setup_topology(disc, overlap=pt.get("overlap", 1),
                                         parts=parts)
        pou = pou_weights(topo, pt.sub("pou").get("type", "standard"),
                          shrink=pt.sub("pou").get("shrink", 0))
        return japi.DDMProblem(disc=disc, topo=topo, A=A, rhs=b, g=g, pou=pou,
                               ptree=pt, elem_part=elem_part, scale=scale)
    if kind == "elast":
        grid = structured_grid((size, size), (0, 0), (3.0, 1.0))
        return japi.setup_problem(pt, problem=problems.steel_rubber_2d(),
                                  grid=grid, parts=parts, n_comp=2)
    if kind == "unstr":
        return japi.setup_problem(pt, grid=japi.make_grid(pt), n_sub=parts)
    if kind == "p2":
        # tests/test_p2.py:test_p2_ddm_solve's steps at full size
        from ddm_tpu.fem.discretize import Discretization

        disc = Discretization(structured_grid((size, size), simplex=True),
                              problems.islands(), degree=2)
        A, rhs, g = disc.constrained_system()
        A, rhs, scale = jacobi_equilibrate(A, rhs)
        topo, elem_part = setup_topology(disc, overlap=pt.get("overlap", 2),
                                         n_sub=parts)
        pou = pou_weights(topo, "distance")
        return japi.DDMProblem(disc=disc, topo=topo, A=A, rhs=rhs, g=g,
                               pou=pou, ptree=pt, elem_part=elem_part,
                               scale=scale)
    return japi.setup_problem(pt, grid=japi.make_grid(pt, dim=len(parts)),
                              parts=parts)


def _jax_unverified(p, M):
    """The JAX package's solve of ``p`` under ``M``, unverified: to the
    Givens estimate's first hit.  Its ``solve_from_config`` passes
    ``solver.verify`` on as the string the parameter tree holds, and the
    string ``"False"`` verifies, so the loop is called with
    ``verify=False`` itself."""
    import jax.numpy as jnp

    from ddm_tpu.solvers import krylov

    sub = p.ptree.sub("solver")
    return krylov.SOLVERS[sub.get("type")](
        krylov.operator_of(p.A), krylov.prec_of(M), p.rhs,
        jnp.zeros_like(p.rhs), reduction=sub.get("reduction", 1e-8),
        maxit=sub.get("maxit", 1000), restart=sub.get("restart", 30),
        verify=False)


def _jax_path(path):
    import jax.numpy as jnp

    import ddm_tpu.api as japi

    t0 = time.perf_counter()
    p = _jax_problem(path)
    M = japi.build_preconditioner(p)
    res = japi.solve(p, M)
    res.x.block_until_ready()
    secs = time.perf_counter() - t0
    true_res = float(jnp.linalg.norm(p.A.mv(res.x) - p.rhs)
                     / jnp.linalg.norm(p.rhs))
    # the iteration at which the Givens estimate first meets the target:
    # the same solve, unverified (the port's KrylovResult.estimate_hit)
    hit = int(_jax_unverified(p, M).iterations)
    return dict(iterations=int(res.iterations), converged=bool(res.converged),
                true_res=true_res, estimate_hit=hit,
                verified_at_hit=chip_smoke.verified_at(japi, p, M, hit),
                n_sub=int(p.topo.n_sub), n_pad=int(p.topo.n_pad), secs=secs)


def _jax_inverse():
    """The JAX package's Schwarz level with explicit f64 inverses, as it
    builds them off the CPU and as the port builds them on the card (on the
    CPU it keeps triangular factors): a perturbation of the size of the
    card's rounding, for the JAX package's own spread."""
    from ddm_tpu.precond import schwarz

    jit = schwarz.factor_batched_jit
    schwarz.factor_batched_jit = lambda solver_type, mode="auto", **kw: jit(
        solver_type, "inverse" if mode == "auto" else mode, **kw)


def _jax_argv(argv):
    """A command line of the port's examples with the JAX package's
    coefficient scripts (the port's are torch rewrites; the inis are
    equal) and without VTK output (it changes no count)."""
    port = os.path.join(ROOT, "ddm_tpu_torch", "examples")
    out = [a.replace(port, JAX_EXAMPLES) for a in argv]
    if "-vtk_filename" in out:
        i = out.index("-vtk_filename")
        del out[i:i + 2]
        out += ["-visualise", "false"]
    return out


def _jax_cli(path):
    """The example of ``path`` as ``ddm_tpu.examples.cli.main`` runs it,
    with its problem and result kept (cli.main returns nothing)."""
    import jax.numpy as jnp

    argv = _jax_argv(chip_smoke.CLI_PATHS[path]())
    i = argv.index("-problem")
    example = argv[i + 1]
    del argv[i:i + 2]
    t0 = time.perf_counter()
    if example == "elasticity":
        from ddm_tpu.examples import linearelasticity

        p, res = linearelasticity.main(argv)
    else:
        from ddm_tpu.examples import poisson
        from ddm_tpu.fem import problems

        argv = poisson.setup_loggers(argv)
        pt = poisson.default_ptree()
        pt["gridsize"] = 64
        pt["subdomains"] = 16
        poisson.apply_cli_overrides(pt, argv)
        poisson.read_ini_file(pt.get("ini_file"), pt)
        poisson.apply_cli_overrides(pt, argv)
        p, res = poisson.run(pt, problems.PROBLEMS[pt.get("problem", "simple")]())
    res.x.block_until_ready()
    secs = time.perf_counter() - t0
    true_res = float(jnp.linalg.norm(p.A.mv(res.x) - p.rhs)
                     / jnp.linalg.norm(p.rhs))
    return dict(iterations=int(res.iterations), converged=bool(res.converged),
                true_res=true_res, n_sub=int(p.topo.n_sub),
                n_pad=int(p.topo.n_pad), secs=secs)


def _jax_newton(path):
    """The nonlinear example under the shipped ini at full size, its inner
    BiCGStab count of every Newton step recorded; the degree and simplex
    keys (the port's example reads them, the JAX example does not) go to
    the JAX discretization by hand."""
    import jax.numpy as jnp

    from ddm_tpu.config import ParamTree
    from ddm_tpu.fem.grids import structured_grid
    from ddm_tpu.fem.nonlinear import NonlinearDiscretization, NonlinearProblem
    from ddm_tpu.solvers.nonlinear_driver import TwoLevelNewtonSolver
    from ddm_tpu_torch.examples.nonlinearpoisson import nonlinear_ptree

    size, n_sub, args = chip_smoke.NEWTON_PATHS[path]
    pt = ParamTree(nonlinear_ptree(chip_smoke.newton_argv(size, n_sub, args))
                   .as_dict())
    eta = pt.get("eta", 10.0)
    nlp = NonlinearProblem(q=lambda u: eta * u * u, dq=lambda u: 2.0 * eta * u,
                           f=lambda x: jnp.sum(x * x, axis=-1))
    t0 = time.perf_counter()
    grid = structured_grid((size, size), simplex=pt.get("simplex", False))
    disc = NonlinearDiscretization(grid, nlp, degree=pt.get("degree", 1))
    solver = TwoLevelNewtonSolver(disc, pt, n_sub=n_sub)
    inner = []
    krylov = solver.krylov

    def counted(*a, **kw):
        r = krylov(*a, **kw)
        inner.append(int(r.iterations))
        return r

    solver.krylov = counted
    res = solver.solve()
    secs = time.perf_counter() - t0
    r, _ = disc.residual_jacobian(res.u)
    return dict(iterations=int(res.iterations), converged=bool(res.converged),
                inner=inner, fresh=float(jnp.linalg.norm(r)),
                defect0=float(res.defect0), true_res=float(
                    jnp.linalg.norm(r)) / float(res.defect0),
                n_sub=int(solver.topo.n_sub), n_pad=int(solver.topo.n_pad),
                secs=secs)


def run_jax(path, inverse=False):
    _jax()
    if inverse:
        _jax_inverse()
    if _newton_case(path):
        out = _jax_newton(path)
    elif _cli_case(path):
        out = _jax_cli(path)
    else:
        out = _jax_path(path)
    return dict(out, peak_gib=_peak_gib())


# -- the port's side, through chip_smoke's own runners ----------------------

def _port_inverse():
    """The port's Schwarz and coarse levels with explicit f64 inverses on
    the CPU, as on the card (on the CPU it keeps triangular factors)."""
    from ddm_tpu_torch.precond import galerkin, schwarz

    def inverse(fb):
        def factor(A, solver_type="lu", mode="auto", **kw):
            return fb(A, solver_type, "inverse" if mode == "auto" else mode,
                      **kw)
        return factor

    for mod in (schwarz, galerkin):
        mod.factor_batched = inverse(mod.factor_batched)


def run_port(path, inverse=False):
    import torch

    from ddm_tpu_torch import api

    if inverse:
        _port_inverse()
    cpu = torch.device("cpu")
    if _newton_case(path):
        size, n_sub, args = chip_smoke.NEWTON_PATHS[path]
        r = chip_smoke.run_newton(chip_smoke.newton_argv(size, n_sub, args), cpu)
        res, solver = r["res"], r["solver"]
        out = dict(iterations=res.iterations, converged=bool(res.converged),
                   inner=[x["inner"] for x in solver.steps], fresh=r["fresh"],
                   defect0=float(res.defect0),
                   true_res=r["fresh"] / float(res.defect0),
                   n_sub=solver.topo.n_sub, n_pad=solver.topo.n_pad)
    else:
        if _cli_case(path):
            r = chip_smoke.run_cli(chip_smoke.CLI_PATHS[path](), cpu)
        else:
            size, parts = chip_smoke.FULL[chip_smoke.PATHS[path][0]]
            r = chip_smoke.run_path(path, size, parts, cpu)
        res, p = r["res"], r["p"]
        out = dict(iterations=res.iterations, converged=bool(res.converged),
                   true_res=r["true_res"], estimate_hit=res.estimate_hit,
                   n_sub=p.topo.n_sub, n_pad=p.topo.n_pad)
        if not _cli_case(path):
            out["verified_at_hit"] = chip_smoke.verified_at(
                api, p, r["M"], res.estimate_hit)
        if "prec_res" in r:
            out["prec_res"] = r["prec_res"]
    return dict(out, secs=r["secs"], peak_gib=_peak_gib())


# -- the swap: each package's system and preconditioner on both iterates --

# the smallest size at which the two packages' verified defects at the
# Givens hit part (ROADMAP.md, queue 3): msgfem_ring_f64 at islands 192^2
SWAP_PATH, SWAP_SIZE = "msgfem_ring_f64", (192, (12, 12))


def run_swap(side, path, out_dir):
    """One package's side of the swap at ``SWAP_SIZE``: the first call
    solves unverified to the Givens estimate's first hit and writes its
    equilibrated system (each row's entries sorted by column), its iterate
    and its residual b - A x there (as its solves compute it) to
    ``out_dir/<side>.npz``; every call measures the residual that the other
    side wrote, when there is one, with its own preconditioner.  Ratios
    are ||M (b - A x)|| / (reduction ||M b||), the verified defect over
    the target."""
    import numpy as np

    chip_smoke.FULL["islands"] = SWAP_SIZE
    size, parts = SWAP_SIZE
    if side == "jax":
        _jax()
        import jax
        import jax.numpy as jnp

        import ddm_tpu.api as api
        p = _jax_problem(path)
        M = api.build_preconditioner(p)
        mv = jax.jit(lambda A, x: A.mv(x))

        def to_np(a):
            return np.asarray(a)

        def norm_m(r):
            return float(jnp.linalg.norm(M.apply(jnp.asarray(r))))
    else:
        import torch

        from ddm_tpu_torch import api
        p = chip_smoke.path_problem(api, path, size, parts,
                                    torch.device("cpu"))
        M = api.build_preconditioner(p)

        def mv(A, x):
            return A.mv(x)

        def to_np(a):
            return a.numpy()

        def norm_m(r):
            return float(torch.linalg.norm(M.apply(torch.as_tensor(r))))
    tol = p.ptree.get("solver.reduction", 1e-8)
    mine = os.path.join(out_dir, f"{side}.npz")
    out = {}
    if not os.path.exists(mine):
        if side == "jax":
            res = _jax_unverified(p, M)
        else:
            p.ptree["solver.verify"] = False
            res = api.solve(p, M)
        hit = int(res.iterations)
        r = p.rhs - mv(p.A, res.x)
        np.savez(mine, A=p.disc.pattern.to_scipy(p.A).sorted_indices().data,
                 b=to_np(p.rhs), x=to_np(res.x), r=to_np(r))
        out.update(hit=hit, verified_at_hit=chip_smoke.verified_at(
            api, p, M, hit), own=norm_m(to_np(r)) / (tol * norm_m(
                to_np(p.rhs))))
    other = os.path.join(out_dir, ("port" if side == "jax" else "jax")
                         + ".npz")
    if os.path.exists(other):
        r_other = np.load(other)["r"]
        out["other_residual"] = norm_m(r_other) / (tol * norm_m(
            to_np(p.rhs)))
    return out


# -- the assembled system at full size, stage by stage ----------------------

# path -> (cells, box upper corner, problem, n_comp): the slab-wise
# assembly's paths (tests/test_torch_assembly_slabs.py), the bar with the
# example's scripted coefficients
SYSTEM_PATHS = {
    "elast_f64": ((256, 256), (3.0, 1.0), "steel_rubber_2d", 2),
    "hex_ov1_f64": ((56, 56, 56), None, "islands", 1),
    "elast3d_f64": ((80, 8, 12), (10.0, 1.0, 1.5), "elasticity", 3),
}


def run_system(path):
    """Both packages' assembled systems of ``path`` at full size in one
    process (A of a few hundred MB each): per stage of
    ``tests/test_torch_assembly_bitwise.py:system_stages``, the number of
    entries that differ, the entries and the largest relative difference."""
    import numpy as np

    _jax()
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_assembly_bitwise import _np, system_stages

    from ddm_tpu.fem import problems as jproblems
    from ddm_tpu.fem.discretize import Discretization as JDiscretization
    from ddm_tpu.fem.grids import structured_grid as j_grid
    from ddm_tpu.fem.scripted import load_elasticity_problem as j_load
    from ddm_tpu_torch.fem import problems as tproblems
    from ddm_tpu_torch.fem.discretize import Discretization as TDiscretization
    from ddm_tpu_torch.fem.grids import structured_grid as t_grid
    from ddm_tpu_torch.fem.scripted import load_elasticity_problem as t_load

    cells, upper, prob, n_comp = SYSTEM_PATHS[path]
    lower = (0.0,) * len(cells) if upper else None
    if prob == "elasticity":
        pj = j_load(os.path.join(JAX_EXAMPLES, "coefficients",
                                 "elasticity_coefficient.py"))
        pt = t_load(chip_smoke.COEFF["elasticity"])
    else:
        pj, pt = getattr(jproblems, prob)(), getattr(tproblems, prob)()
    dj = JDiscretization(j_grid(cells, lower, upper), pj, n_comp=n_comp)
    dt = TDiscretization(t_grid(cells, lower, upper), pt, "cpu",
                         n_comp=n_comp)
    out = {}
    for stage, (a, b) in system_stages(dj, dt).items():
        a, b = _np(a), _np(b)
        out[stage] = [int((a != b).sum()), int(a.size), float(
            np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))]
    return out


# -- which stage sets the Givens hit: each Krylov loop on each package's
# operator and preconditioner -----------------------------------------------

# path -> the sizes at which the table is taken, the smallest first:
# (cells per axis, parts)
LOOP_SIZES = {"geneo_f64": [(192, (12, 12)), (256, (16, 16)),
                            (384, (16, 16))],
              "elast_f64": [(256, (16, 16))]}


def run_loops(path, size, parts):
    """The JAX package's Krylov loop (``gmres_solve`` or ``fgmres_solve``)
    and the port's (``_restarted_gmres``), each on the JAX package's
    operator and preconditioner and on the port's, unverified to the
    Givens estimate's first hit, in one process at ``size`` / ``parts``.
    Each loop is called with ``verify=False`` itself: the JAX package's
    ``solve_from_config`` passes ``solver.verify`` on as the string the
    parameter tree holds, and the string ``"False"`` verifies.  The JAX loop reaches the port's operator and
    preconditioner through ``jax.pure_callback``, the port's loop the JAX
    package's through their jitted calls (numpy to torch CPU tensors).
    Per cell: the hit, and the verified defect there over the target, read
    by the JAX package's M and by the port's (left GMRES: ||M (b - A x)||
    / (reduction ||M b||); flexible GMRES: the true residual, which no M
    reads)."""
    import numpy as np

    _jax()
    import jax
    import jax.numpy as jnp
    import torch

    import ddm_tpu.api as japi
    from ddm_tpu.solvers import krylov as jkrylov
    from ddm_tpu_torch import api as tapi
    from ddm_tpu_torch.solvers import krylov as tkrylov

    kind = chip_smoke.PATHS[path][0]
    chip_smoke.FULL[kind] = (size, parts)
    pj = _jax_problem(path)
    Mj = japi.build_preconditioner(pj)
    pt = chip_smoke.path_problem(tapi, path, size, parts, torch.device("cpu"))
    Mt = tapi.build_preconditioner(pt)
    assert np.array_equal(np.asarray(pj.rhs), pt.rhs.numpy())
    ptree = pt.ptree
    red = ptree.get("solver.reduction", 1e-8)
    flexible = "flexible" in ptree.get("solver.type")
    loop_args = dict(reduction=red, maxit=1000,
                     restart=ptree.get("solver.restart", 30), verify=False)
    j_loop = jkrylov.fgmres_solve if flexible else jkrylov.gmres_solve
    t_loop = tkrylov.fgmres_solve if flexible else tkrylov.gmres_solve

    j_mv = jax.jit(lambda x: pj.A.mv(x))
    j_apply = jax.jit(lambda d: Mj.apply(d))

    def port(fn):  # a port call on numpy, for the JAX side
        return lambda x: fn(torch.from_numpy(np.array(x))).numpy()

    def jaxed(fn):  # a jitted JAX call on torch CPU tensors
        return lambda x: torch.from_numpy(np.array(fn(jnp.asarray(x.numpy()))))

    def callback(fn):
        return jax.tree_util.Partial(lambda x: jax.pure_callback(
            fn, jax.ShapeDtypeStruct(x.shape, x.dtype), x))

    ops = {"jax": (jkrylov.operator_of(pj.A), jkrylov.prec_of(Mj),
                   jaxed(j_mv), jaxed(j_apply)),
           "port": (callback(port(pt.A.mv)), callback(port(Mt.apply)),
                    pt.A.mv, Mt.apply)}
    b = pt.rhs

    def defect(x, M):
        r = b - pt.A.mv(x)
        if flexible:
            return float(torch.linalg.norm(r) / (red * torch.linalg.norm(b)))
        return float(torch.linalg.norm(M(r)) / (red * torch.linalg.norm(M(b))))

    table = {}
    for loop in ("jax", "port"):
        for owner, (jop, jprec, top, tprec) in ops.items():
            if loop == "jax":
                res = j_loop(jop, jprec, pj.rhs, jnp.zeros_like(pj.rhs),
                             **loop_args)
                hit, x = int(res.iterations), torch.from_numpy(
                    np.array(res.x))
            else:
                res = t_loop(top, tprec, b, torch.zeros_like(b), **loop_args)
                hit, x = res.estimate_hit, res.x
            table[f"{loop} loop, {owner} A and M"] = dict(
                hit=hit, by_jax_M=defect(x, ops["jax"][3]),
                by_port_M=defect(x, Mt.apply))
    return dict(size=size, parts=list(parts), flexible=flexible, table=table)


# side -> runner; the "-inverse" sides build explicit f64 inverses
RUNNERS = {"jax": run_jax, "port": run_port, "system": run_system,
           "jax-inverse": lambda path: run_jax(path, inverse=True),
           "port-inverse": lambda path: run_port(path, inverse=True)}


def run_side(side, path, *args):
    """One side of one case in its own process; its JSON result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cpus = sorted(os.sched_getaffinity(0))[:JAX_CPUS]
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), side,
                           path, *args], capture_output=True, text=True,
                          env=env,
                          timeout=SIDE_TIMEOUT_S, cwd=ROOT,
                          preexec_fn=lambda: os.sched_setaffinity(0, cpus))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# -- the cases ---------------------------------------------------------------

# every JAX full-size reference, then the paths that have none
CASES = list(chip_smoke.JAX_FULL_SIZE) + list(chip_smoke.UNMEASURED)


@pytest.mark.slow
@pytest.mark.parametrize("path", CASES)
def test_fullsize_port_matches_jax(path):
    """The port's count within 2 of the JAX package's at full size; the
    JAX count as recorded in chip_smoke.JAX_FULL_SIZE; every limit held
    to it at JAX + its margin."""
    if path in chip_smoke.UNMEASURED:
        pytest.skip(chip_smoke.UNMEASURED[path])
    j = run_side("jax", path)
    t = run_side("port", path)
    print(f"{path}: jax {j}\n{path}: port {t}")
    assert j["converged"] and t["converged"]
    assert abs(t["iterations"] - j["iterations"]) <= 2
    if "inner" in j:
        assert abs(sum(t["inner"]) - sum(j["inner"])) <= 2
    # the recorded count, within the JAX package's own measured spread
    # where a limit's margin takes one (margin - 2)
    recorded = chip_smoke.JAX_FULL_SIZE[path][0]
    for limit, (ref, margin, _) in chip_smoke.LIMIT_OF.items():
        if ref == path:
            assert abs(j["iterations"] - recorded) <= max(margin - 2, 0)
            assert chip_smoke.MAX_ITERS[limit] == recorded + margin


@pytest.mark.slow
@pytest.mark.parametrize("path", list(SYSTEM_PATHS))
def test_fullsize_slab_assembly_is_bit_equal(path):
    """Every stage of the assembled system of the paths whose element
    batches both packages assemble in slabs, bit-equal at full size."""
    out = run_side("system", path)
    print(f"{path}: {out}")
    assert not any(n for n, _, _ in out.values()), out


@pytest.mark.slow
@pytest.mark.parametrize("path,size", [(path, size) for path, sizes in
                                       LOOP_SIZES.items()
                                       for size, _ in sizes])
def test_fullsize_loops_table(path, size):
    """The 2 x 2 table of each Krylov loop on each package's operator and
    preconditioner (PERF.md section 2): every cell's Givens estimate meets
    the target at the same iteration, with a finite verified defect
    there."""
    import math

    out = run_side("loops", path, str(size))
    print(f"{path} {size}: {json.dumps(out)}")
    assert len(out["table"]) == 4
    assert len({cell["hit"] for cell in out["table"].values()}) == 1, out
    for cell in out["table"].values():
        assert cell["hit"] > 0
        assert math.isfinite(cell["by_jax_M"])
        assert math.isfinite(cell["by_port_M"])


@pytest.mark.slow
def test_fullsize_system_is_bit_equal_and_residuals_swap(tmp_path):
    """At msgfem_ring_f64, islands 192^2 / 144: the equilibrated A and b of
    the two packages bit-equal; each side's verified defect at its Givens
    hit, and each side's residual there measured by the other package's
    preconditioner, printed (ROADMAP.md, queue 3; PERF.md section 2)."""
    import numpy as np

    port = run_side("port-swap", SWAP_PATH, str(tmp_path))
    ref = run_side("jax-swap", SWAP_PATH, str(tmp_path))
    port.update(run_side("port-swap", SWAP_PATH, str(tmp_path)))
    print(f"{SWAP_PATH} {SWAP_SIZE}: jax {ref}\n{SWAP_PATH} {SWAP_SIZE}: "
          f"port {port}")
    a, b = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert np.array_equal(a["A"], b["A"]) and np.array_equal(a["b"], b["b"])
    for side in (ref, port):
        assert all(np.isfinite(side[k]) for k in
                   ("verified_at_hit", "own", "other_residual"))


if __name__ == "__main__":
    side, name = sys.argv[1:3]
    if side == "loops":
        size = int(sys.argv[3])
        out = run_loops(name, size, dict(LOOP_SIZES[name])[size])
    elif side.endswith("-swap"):
        out = run_swap(side[:-len("-swap")], name, sys.argv[3])
    else:
        out = RUNNERS[side](name)
    print(json.dumps(out), flush=True)
