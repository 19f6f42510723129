"""Benchmark: two-level GenEO-RAS on heterogeneous Poisson (BASELINE config 2
class), on the CUDA card.

    python -m ddm_tpu_torch.bench

Counterpart of the JAX package's ``bench.py``, function by function.
Prints ONE JSON line on stdout (logs go to stderr):

  {"metric": ..., "value": N, "unit": "s", "vs_baseline": N, ...}

value       = device wall-clock seconds of the full preconditioner setup
              (subdomain extraction + factorization + Neumann assembly +
              batched GenEO eigensolves + coarse matrix + coarse
              factorization) + the GMRES solve to 1e-8, warm (the second
              attempt; the first is ``cold_total_s``), with the card
              synchronized before each clock read.
vs_baseline = best CPU seconds / value.  The CPU baselines run the
              reference's algorithm on the host: per-subdomain sparse LU
              (SuperLU) + per-subdomain dense GEVPs (LAPACK, the same
              congruence-transform math as the device path) + scipy GMRES
              with two-level applies, once with forked worker processes
              standing in for MPI ranks and once sequentially.  dune-ddm
              publishes no numbers of its own (BASELINE.md), so this
              emulation is the baseline.  The baselines run on the same
              problem built by the host CPU (system, equilibration and
              Neumann matrices), as the reference assembles on the CPU,
              untimed: the card's matrices differ in the last bits, and
              on them the elasticity variant's baselines at 64^2/16 took
              66 and 71 iterations against 54 and 54 on the host's (an
              H100 machine's 8-core host, OpenBLAS 0.3.30).

Beside ``bench.py``'s keys (``tpu_geneo_s`` is ``device_geneo_s`` here)
the line carries ``device`` (nvidia-smi's name and power limit, or
"cpu"), ``cpu_count``, the headline's ``iters`` and ``true_rel_res``, the
like-for-like run's ``true_rel_res_geneo``, and both baselines' timings
(``cpu_sequential_baseline``; ``cpu_parallel_baseline``, or why it did not
run).

Config via env, as ``bench.py``: DDM_BENCH_GRIDSIZE (384; 3-D 56;
elasticity 256 / 40), DDM_BENCH_PARTS (16 per axis; 3-D 8),
DDM_BENCH_OVERLAP (2), DDM_BENCH_NEV (8), DDM_BENCH_DIM (2),
DDM_BENCH_PROBLEM (poisson | elasticity), DDM_BENCH_COARSE (geneo_ring;
elasticity geneo), DDM_BENCH_PRECISION (f64 | dd), DDM_BENCH_ORTHO (f64
only: the port has no double-single orthogonalization, another value
raises), DDM_BENCH_SET ("key=val,..." config overrides),
DDM_BENCH_ATTEMPTS (2), DDM_BENCH_LIKE4LIKE (1: also time full geneo).
``bench.py``'s DDM_TPU_BATCH_CHUNK sizes the TPU package's setup slabs and
has no meaning here: the port sizes its slabs by a byte budget
(``solvers/direct.py:SLAB_BYTES``).  Nor does its Newton-Schulz
``newton_rtol``, which the port's exact subdomain inverses ignore: it is
not set.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import os
import sys
import time

import numpy as np
import torch

# a worker that sends nothing for this long fails the baseline run
WORKER_TIMEOUT_S = 900.0
# the baselines' matrices move from the device to the host in slabs of
# this many bytes
HOST_SLAB_BYTES = 1 << 30


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_problem(gridsize, parts, overlap, nev, dim=2, device=None):
    from .api import default_ptree, setup_problem
    from .fem import problems as pm
    from .fem.grids import structured_grid

    pt = default_ptree()
    pt["gridsize"] = gridsize
    pt["overlap"] = overlap
    pt["solver.reduction"] = 1e-8
    # DDM_BENCH_COARSE switches the coarse space.  The headline is
    # geneo_ring (the reference built the ring spaces to cut setup cost,
    # coarse_spaces.hh:502-648); the CPU baselines emulate the reference's
    # default full GenEO, and main() times a like-for-like geneo run too.
    # DDM_BENCH_PROBLEM=elasticity runs the vector-valued steel-rubber
    # configuration (reference: linearelasticity.cc:27-159) with full GenEO.
    problem_kind = os.environ.get("DDM_BENCH_PROBLEM", "poisson")
    cs = os.environ.get(
        "DDM_BENCH_COARSE",
        "geneo" if problem_kind == "elasticity" else "geneo_ring")
    pt["coarsespace.type"] = cs
    if problem_kind == "elasticity":
        # elasticity's two-level M distorts norms by the stiffness contrast:
        # flexible GMRES terminates on the true residual
        pt["solver.type"] = "restartedflexiblegmressolver"
    pt["coarse_solver.type"] = "cholesky"
    pt[f"{cs}.eigensolver.nev"] = nev
    # DDM_BENCH_PRECISION=dd: double-single subdomain and coarse inverses
    # (the dd_matvec kernel), with verified termination (run_device)
    prec = os.environ.get("DDM_BENCH_PRECISION", "f64")
    if prec != "f64":
        pt["schwarz.subdomain_solver.precision"] = prec
        pt["coarse_solver.precision"] = prec
    # bench.py's DDM_BENCH_ORTHO picks the TPU package's double-single
    # orthogonalization; the port orthogonalizes in f64 only
    # (solvers/krylov.py), so any other value is refused
    ortho = os.environ.get("DDM_BENCH_ORTHO", "f64")
    if ortho != "f64":
        raise ValueError(f"DDM_BENCH_ORTHO={ortho!r}: the port "
                         "orthogonalizes in f64 only")
    # extension PCG: 4 f64 polish iterations at accept 1e-6 (bench.py's
    # measured setting; the residual-verified escalation chain stays)
    pt["geneo_ring.extension.maxit64"] = 4
    pt["geneo_ring.extension.tolerance"] = 1e-6
    # DDM_BENCH_SET="key=val,key=val": raw config overrides after all of
    # the above (ints and floats parsed)
    for kv in filter(None, os.environ.get("DDM_BENCH_SET", "").split(",")):
        k, _, v = kv.partition("=")
        for cast in (int, float, str):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        log(f"override: {k} = {v!r}")
        pt[k.strip()] = v
    if problem_kind == "elasticity":
        extent = (3.0, 1.0) if dim == 2 else (3.0, 1.0, 1.5)
        grid = structured_grid((gridsize,) * dim, (0,) * dim, extent)
        prob = (pm.steel_rubber_2d() if dim == 2
                else pm.steel_rubber_bar())
        return setup_problem(pt, problem=prob, grid=grid,
                             parts=(parts,) * dim, n_comp=dim, device=device)
    grid = structured_grid((gridsize,) * dim)
    return setup_problem(pt, problem=pm.islands(), grid=grid,
                         parts=(parts,) * dim, device=device)


def run_device(p, nev, attempts=None, tag=""):
    """Build the preconditioner and solve, ``attempts`` times (default
    DDM_BENCH_ATTEMPTS, 2); returns the last attempt's timings with the
    first's under ``cold``."""
    if attempts is None:
        attempts = max(1, int(os.environ.get("DDM_BENCH_ATTEMPTS", "2")))
    from .api import build_preconditioner
    from .obs.logger import Logger
    from .solvers.krylov import fgmres_solve, gmres_solve

    dev = p.device
    all_timings = []
    for attempt in range(attempts):
        # free the previous attempt's preconditioner before rebuilding
        prec = res = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        _sync(dev)
        t0 = time.perf_counter()
        prec = build_preconditioner(p)
        _sync(dev)
        t1 = time.perf_counter()
        dd_any = (p.ptree.sub("schwarz").sub("subdomain_solver")
                  .get("precision", "f64") != "f64")
        st = p.ptree.get("solver.type", "restartedgmressolver").lower()
        solve_fn = (fgmres_solve
                    if st in ("restartedflexiblegmressolver", "fgmres")
                    else gmres_solve)
        res = solve_fn(
            p.A.mv, prec.apply, p.rhs, torch.zeros_like(p.rhs),
            reduction=1e-8, maxit=400, restart=50,
            # reduced-precision applies decouple the Givens estimate from
            # the true residual: terminate on the verified defect
            verify=dd_any,
        )
        _sync(dev)
        t2 = time.perf_counter()
        true_res = float(torch.linalg.norm(p.A.mv(res.x) - p.rhs)
                         / torch.linalg.norm(p.rhs))
        timings = {
            "setup": t1 - t0, "solve": t2 - t1,
            "iters": int(res.iterations), "converged": bool(res.converged),
            "true_rel_res": true_res,
        }
        all_timings.append(timings)
        log(f"device{tag} attempt {attempt}: {timings}")
    log(Logger.get().report())
    timings["cold"] = dict(all_timings[0])
    return timings


def _subdomain_blocks(p, A_neu, C, k):
    """Subdomain ``k``'s (global dof ids, POU weights, Neumann block, POU-
    scaled B block) on its valid slots: the j-th valid slot of the padded
    dense blocks is global dof ids[j]."""
    loc = np.nonzero(p.topo.valid[k])[0]
    block = np.ix_(loc, loc)
    return (p.topo.sub2glob[k, loc].astype(np.int64),
            np.asarray(p.pou[k, loc]), A_neu[k][block], C[k][block])


def _geneo_vectors(Ak, Ck, pou, nev):
    """One subdomain's ``nev`` GenEO coarse vectors: the dominant
    eigenvectors of the pencil (Ck, Ak) by the device path's dense
    congruence transform (Cholesky of Ak, shifted by 1e-12 of its mean
    diagonal; LAPACK ``eigh`` of L^-1 Ck L^-T), POU-scaled and normalized
    column by column."""
    import scipy.linalg as sla

    eps = 1e-12 * max(np.abs(np.diag(Ak)).mean(), 1.0)
    L = np.linalg.cholesky(Ak + eps * np.eye(Ak.shape[0]))
    Linv = sla.solve_triangular(L, np.eye(Ak.shape[0]), lower=True)
    S = Linv @ Ck @ Linv.T
    _, W = np.linalg.eigh(0.5 * (S + S.T))
    w = pou[:, None] * (Linv.T @ W[:, -nev:][:, ::-1])
    return w / np.maximum(np.linalg.norm(w, axis=0), 1e-300)


def _coarse_lu(basis, Asp, nev):
    """(R, LU factors of E = R A R^T) for ``basis``, the (global ids,
    (n_k, nev) vectors) of every subdomain in order; R is CSR with row
    k * nev + j holding subdomain k's j-th vector."""
    import scipy.sparse as sps
    from scipy.linalg import lu_factor

    R = sps.lil_matrix((len(basis) * nev, Asp.shape[0]))
    for k, (ids, w) in enumerate(basis):
        for j in range(nev):
            R[k * nev + j, ids] = w[:, j]
    R = R.tocsr()
    return R, lu_factor((R @ Asp @ R.T).toarray())


def _worker_main(conn, Asp, sub_ids, sub_pou, A_neu_k, C_k, nev):
    """One baseline worker = a chunk of 'MPI ranks': factor its subdomains,
    solve its GEVPs, then serve preconditioner applies.  Mirrors the
    reference's per-rank code (schwarz.hh solve + coarse restriction dots).
    numpy and scipy only: it runs in a forked child of a process that holds
    a CUDA context and torch's thread pools, and touches neither."""
    import scipy.sparse.linalg as spla

    t0 = time.perf_counter()
    lus = [spla.splu(Asp[ids][:, ids].tocsc()) for ids in sub_ids]
    t_factor = time.perf_counter() - t0

    t0 = time.perf_counter()
    W = [_geneo_vectors(Ak, Ck, pou, nev)
         for Ak, Ck, pou in zip(A_neu_k, C_k, sub_pou)]
    t_eig = time.perf_counter() - t0
    conn.send(("setup", t_factor, t_eig))

    while True:
        msg = conn.recv()
        if msg[0] == "apply":
            d = msg[1]
            n = d.shape[0]
            x = np.zeros(n)
            alpha = np.empty((len(sub_ids), nev))
            for k, ids in enumerate(sub_ids):
                dk = d[ids]
                x[ids] += sub_pou[k] * lus[k].solve(dk)
                alpha[k] = W[k].T @ dk
            conn.send((x, alpha))
        elif msg[0] == "prolong":
            beta = msg[1]
            n = msg[2]
            x = np.zeros(n)
            for k, ids in enumerate(sub_ids):
                x[ids] += W[k] @ beta[k]
            conn.send(x)
        elif msg[0] == "basis":
            conn.send([(ids, w) for ids, w in zip(sub_ids, W)])
        else:
            return


def _to_host(batch, pou=None):
    """Copy a (n_sub, n_pad, n_pad) batch into host numpy slab by slab
    (with ``pou``: scaled in place first, C[i][j] *= pou[i] pou[j]), so
    no second batch is ever allocated on either side of the copy."""
    from .fem.subassembly import scale_matrix_with_pou

    n_sub, n_pad = batch.shape[0], batch.shape[1]
    out = np.empty(tuple(batch.shape), dtype=np.float64)
    slab = max(1, HOST_SLAB_BYTES // (n_pad * n_pad * 8))
    for s in range(0, n_sub, slab):
        part = batch[s:s + slab]
        if pou is not None:
            scale_matrix_with_pou(part, pou[s:s + slab], inplace=True)
        out[s:s + slab] = part.cpu().numpy()
    return out


def _baseline_gevp_mats(p):
    """Host numpy (A_neu, C) for the CPU baselines: the port's Neumann
    matrices of the equilibrated system (region "overlap") and the
    POU-scaled B of ``p`` (the host-built problem), computed ONCE right
    after the problem build and cached on the problem (the reference
    assembles them during FEM assembly, so neither side is charged for
    them).  At 3-D 56^3/512 (n_pad 1728) each batch is 12.2 GB: they move
    into numpy slab by slab."""
    cached = getattr(p, "_baseline_mats", None)
    if cached is not None:
        return cached
    from .coarse.geneo import neumann_matrices

    A_neu_d, B_neu_d = neumann_matrices(p)
    A_neu = _to_host(A_neu_d)
    del A_neu_d
    C = _to_host(B_neu_d, pou=torch.as_tensor(p.pou, device=p.device))
    del B_neu_d
    mats = (A_neu, C)
    object.__setattr__(p, "_baseline_mats", mats)
    return mats


def _recv(conn):
    """A worker's next message; raises if none comes within
    WORKER_TIMEOUT_S (a hung worker fails the run instead of hanging it)."""
    if not conn.poll(WORKER_TIMEOUT_S):
        raise TimeoutError(
            f"a baseline worker sent nothing for {WORKER_TIMEOUT_S:g} s")
    return conn.recv()


def _host_system(p):
    """(A as scipy CSC, b as numpy) of the equilibrated system."""
    return (p.disc.pattern.to_scipy(p.A).tocsc(),
            p.rhs.detach().cpu().numpy())


def run_cpu_baseline_parallel(p, nev, n_workers=None):
    """The reference's deployment model: subdomain work (factorization,
    GEVPs, per-iteration solves + coarse dots) distributed over worker
    PROCESSES like MPI ranks; the coarse solve serialized on the master like
    the reference's rank-0 solve (galerkin_preconditioner.hh:171-183).

    The workers are forked, as in ``bench.py``: they then share the parent's
    arrays without a copy and start in milliseconds, and the wall clock,
    started before they are, charges the baseline its start-up.  They touch
    numpy and scipy only (``_worker_main``), never torch or the CUDA
    context the parent holds.  Every receive has a finite timeout, and the
    workers are ended on the way out whatever happens."""
    import multiprocessing as mp

    import scipy.sparse.linalg as spla
    from scipy.linalg import lu_solve

    if n_workers is None:
        n_workers = min(os.cpu_count() or 1, p.topo.n_sub)
    Asp, b = _host_system(p)
    topo = p.topo
    n = Asp.shape[0]

    A_neu, C = _baseline_gevp_mats(p)

    # chunk subdomains over workers
    chunks = np.array_split(np.arange(topo.n_sub), n_workers)
    ctx = mp.get_context("fork")
    conns, procs = [], []
    try:
        t_wall0 = time.perf_counter()
        for ch in chunks:
            sub_ids, sub_pou, An_k, C_k = zip(
                *(_subdomain_blocks(p, A_neu, C, k) for k in ch))
            parent, child = ctx.Pipe()
            proc = ctx.Process(
                target=_worker_main,
                args=(child, Asp, sub_ids, sub_pou, An_k, C_k, nev),
            )
            proc.start()
            conns.append(parent)
            procs.append(proc)
        for c in conns:
            _recv(c)
        t_setup_wall = time.perf_counter() - t_wall0

        # coarse matrix on master (rank-0 style)
        t0 = time.perf_counter()
        basis = []
        for c in conns:
            c.send(("basis",))
        for c in conns:
            # writable copies: arrays unpickled from a pipe are read-only,
            # which scipy's sparse item assignment refuses (scipy 1.18)
            basis.extend((np.array(ids), np.array(w)) for ids, w in _recv(c))
        _, Elu = _coarse_lu(basis, Asp, nev)
        t_coarse = time.perf_counter() - t0

        def prec_apply(d):
            for c in conns:
                c.send(("apply", d))
            x = np.zeros(n)
            alphas = []
            for c in conns:
                xk, ak = _recv(c)
                x += xk
                alphas.append(ak)
            alpha = np.concatenate(alphas).reshape(-1)
            beta = lu_solve(Elu, alpha).reshape(topo.n_sub, nev)
            bsplit = np.array_split(beta, n_workers)
            for c, bk in zip(conns, bsplit):
                c.send(("prolong", bk, n))
            for c in conns:
                x += _recv(c)
            return x

        M = spla.LinearOperator((n, n), matvec=prec_apply)
        it = [0]
        t0 = time.perf_counter()
        x, info = spla.gmres(Asp, b, rtol=1e-8, atol=0.0, restart=50,
                             maxiter=400, M=M,
                             callback=lambda *_: it.__setitem__(0, it[0] + 1),
                             callback_type="pr_norm")
        t_solve = time.perf_counter() - t0
        for c in conns:
            c.send(("quit",))
        for pr in procs:
            pr.join(timeout=10)
    finally:
        for pr in procs:  # a failed run leaves its workers mid-message
            if pr.is_alive():
                pr.kill()
                pr.join()
    out = {
        "workers": n_workers,
        "setup": t_setup_wall + t_coarse,
        "coarse": t_coarse,
        "solve": t_solve,
        "iters": it[0],
        "converged": info == 0,
        "true_rel_res": float(np.linalg.norm(Asp @ x - b)
                              / np.linalg.norm(b)),
    }
    log(f"cpu parallel baseline ({n_workers} workers, "
        f"{os.cpu_count()} cores): {out}")
    return out


def run_cpu_baseline(p, nev):
    import scipy.sparse.linalg as spla
    from scipy.linalg import lu_solve

    Asp, b = _host_system(p)
    topo = p.topo
    n = Asp.shape[0]

    # Neumann matrices: the device-assembled element sums; the reference
    # assembles these during FEM assembly, so their cost is not charged to
    # either side
    A_neu, C = _baseline_gevp_mats(p)

    t0 = time.perf_counter()
    subids = [topo.sub2glob[k, topo.valid[k]].astype(np.int64)
              for k in range(topo.n_sub)]
    pou_rows = [np.asarray(p.pou[k, topo.valid[k]])
                for k in range(topo.n_sub)]
    lus = [spla.splu(Asp[ids][:, ids].tocsc()) for ids in subids]
    t_factor = time.perf_counter() - t0

    # Per-subdomain GEVPs, solved SEQUENTIALLY as the reference's per-rank
    # architecture does, with the same dense congruence-transform math as
    # the device path (LAPACK quality) rather than scipy's shift-invert
    # eigsh, whose Lanczos basis gives a measurably worse coarse space here
    # (bench.py: at 384^2/256 its GMRES never converged)
    t0 = time.perf_counter()
    basis = []
    for k in range(topo.n_sub):  # one subdomain's blocks at a time
        ids, pou, Ak, Ck = _subdomain_blocks(p, A_neu, C, k)
        basis.append((ids, _geneo_vectors(Ak, Ck, pou, nev)))
    t_eig = time.perf_counter() - t0

    # coarse matrix + factorization
    t0 = time.perf_counter()
    R, Elu = _coarse_lu(basis, Asp, nev)
    t_coarse = time.perf_counter() - t0

    def prec_apply(d):
        x = np.zeros(n)
        for k in range(topo.n_sub):
            x[subids[k]] += pou_rows[k] * lus[k].solve(d[subids[k]])
        alpha = R @ d
        x += R.T @ lu_solve(Elu, alpha)
        return x

    M = spla.LinearOperator((n, n), matvec=prec_apply)
    it = [0]
    t0 = time.perf_counter()
    x, info = spla.gmres(Asp, b, rtol=1e-8, atol=0.0, restart=50,
                         maxiter=400, M=M,
                         callback=lambda *_: it.__setitem__(0, it[0] + 1),
                         callback_type="pr_norm")
    t_solve = time.perf_counter() - t0
    out = {
        "factor": t_factor, "eig": t_eig, "coarse": t_coarse,
        "solve": t_solve, "iters": it[0], "converged": info == 0,
        "setup": t_factor + t_eig + t_coarse,
        # both sides terminate on the preconditioned defect; the true
        # residual makes norm-distorted problems (elasticity) comparable
        "true_rel_res": float(np.linalg.norm(Asp @ x - b)
                              / np.linalg.norm(b)),
    }
    log(f"cpu baseline: {out}")
    return out


def main(argv=None, device=None):
    """Run the benchmark on ``device`` (default: the CUDA card) per the
    DDM_BENCH_* environment; print the JSON line and return it as a dict.
    ``argv`` takes only ``--log-level=<lvl>``."""
    from .api import default_device
    from .examples.solver_bench import device_line
    from .obs.logger import setup_loggers

    rest = setup_loggers(sys.argv[1:] if argv is None else list(argv))
    if rest:
        raise SystemExit(f"unknown arguments {rest}: the benchmark is "
                         "configured by DDM_BENCH_* environment variables")
    device = default_device() if device is None else torch.device(device)
    dim = int(os.environ.get("DDM_BENCH_DIM", "2"))
    problem_kind = os.environ.get("DDM_BENCH_PROBLEM", "poisson")
    # elasticity default 256^2 x 2 comps = 132k dofs: the same n_pad class
    # as the Poisson headline at 256 subdomains
    grid_default = "384" if dim == 2 else "56"
    if problem_kind == "elasticity":
        grid_default = "256" if dim == 2 else "40"
    gridsize = int(os.environ.get("DDM_BENCH_GRIDSIZE", grid_default))
    parts = int(os.environ.get("DDM_BENCH_PARTS", "16" if dim == 2 else "8"))
    overlap = int(os.environ.get("DDM_BENCH_OVERLAP", "2"))
    nev = int(os.environ.get("DDM_BENCH_NEV", "8"))
    card = device_line(device).removeprefix("device ")
    log(f"device: {card}; host cores: {os.cpu_count()}")

    t0 = time.perf_counter()
    p = build_problem(gridsize, parts, overlap, nev, dim=dim, device=device)
    _sync(device)
    host_setup_s = time.perf_counter() - t0
    log(f"host setup: {host_setup_s:.3f}s; n={p.disc.n_dofs} "
        f"n_sub={p.topo.n_sub} n_pad={p.topo.n_pad}")
    # the CPU baselines' problem and GEVP matrices, built by the host as the
    # reference's are (charged to neither side)
    t0 = time.perf_counter()
    p_host = p if device.type == "cpu" else build_problem(
        gridsize, parts, overlap, nev, dim=dim, device="cpu")
    _baseline_gevp_mats(p_host)
    log(f"cpu baselines' problem and Neumann matrices built on the host: "
        f"{time.perf_counter() - t0:.3f}s (untimed)")

    dev_run = run_device(p, nev)

    # like-for-like algorithm comparison: when the headline coarse space is
    # not the CPU baselines' full GenEO, also time geneo on the same problem
    dev_geneo = None
    cs = p.ptree.get("coarsespace.type")
    if cs != "geneo" and os.environ.get("DDM_BENCH_LIKE4LIKE", "1") != "0":
        gc.collect()
        pt2 = copy.deepcopy(p.ptree)
        pt2["coarsespace.type"] = "geneo"
        pt2["geneo.eigensolver.nev"] = nev
        p2 = dataclasses.replace(p, ptree=pt2)
        dev_geneo = run_device(p2, nev, tag=" geneo")
        del p2
        gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cpu_totals = {}
    if (os.cpu_count() or 1) > 1:
        parallel = run_cpu_baseline_parallel(p_host, nev)
        cpu_totals["parallel"] = (parallel["setup"] + parallel["solve"],
                                  f"{parallel['workers']} workers")
    else:
        # a 1-worker "parallel" baseline only measures IPC overhead
        parallel = "skipped: 1 core"
    cpu_seq = run_cpu_baseline(p_host, nev)
    cpu_totals["sequential"] = (cpu_seq["setup"] + cpu_seq["solve"], "1 core")

    dev_total = dev_run["setup"] + dev_run["solve"]
    log(f"device {dev_total:.2f}s | " + " | ".join(
        f"CPU {k} ({d}) {t:.2f}s ({t / dev_total:.2f}x)"
        for k, (t, d) in cpu_totals.items()))
    # vs_baseline: against the best CPU deployment on this host
    best_cpu = min(t for t, _ in cpu_totals.values())
    cold = dev_run.get("cold", dev_run)
    metric_head = ("elasticity_steel_rubber_geneo_ras"
                   if problem_kind == "elasticity"
                   else "poisson_islands_geneo_ras")
    out = {
        "metric": f"{metric_head}_"
                  f"{'x'.join([str(gridsize)] * dim)}_"
                  f"{parts ** dim}sub_setup_solve",
        "value": round(dev_total, 4),
        "unit": "s",
        "vs_baseline": round(best_cpu / dev_total, 3),
        # the warm headline leaves out one-time costs: cold_total_s is the
        # first run's wall-clock (problem build + first build + solve)
        "host_setup_s": round(host_setup_s, 2),
        "cold_total_s": round(
            host_setup_s + cold["setup"] + cold["solve"], 2),
        "cpu_sequential_s": round(cpu_totals["sequential"][0], 2),
        "iters": dev_run["iters"],
        "true_rel_res": dev_run["true_rel_res"],
    }
    if dev_geneo is not None:
        g_total = dev_geneo["setup"] + dev_geneo["solve"]
        out["device_geneo_s"] = round(g_total, 4)
        out["vs_baseline_geneo"] = round(best_cpu / g_total, 3)
        out["iters_geneo"] = dev_geneo["iters"]
        out["true_rel_res_geneo"] = dev_geneo["true_rel_res"]
    out["cpu_parallel_baseline"] = parallel
    out["cpu_sequential_baseline"] = cpu_seq
    out["device"] = card
    out["cpu_count"] = os.cpu_count()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
