#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ddm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and exits non-zero:

1. device — requires CUDA (exits 1 without it, before printing any result)
   and prints ``nvidia-smi --query-gpu=name,power.limit`` for card 0;
2. build — compiles every hand-written kernel of the main paths from
   ``ddm_tpu_torch/csrc`` with nvcc and prints the build time;
3. kernel vs plain — ``dd_matvec`` against its plain PyTorch version at
   (4, 256, 256) q=200, (2, 640, 640), a ragged (3, 177, 177), a ragged
   one-matrix (1, 1001, 1001), small matrices whose plans take clusters of
   3, 5, 6 and 7 blocks, and the coarse shape (1, 2048, 2048), each with
   the launch plan it took; then two launches at the coarse shape,
   which must give the same bits (the column split's cluster reduction runs
   in a fixed order);
4. small-input references at islands 32^2 / 16 subdomains: the geneo dd
   slice and the geneo_ring (R-dd) slice on the card, each against the
   exact f64 slice on the CPU (iterations within 2, solutions within 1e-6);
5. three main paths at islands 384^2 / 256 subdomains, overlap 2, nev 8,
   Cholesky coarse solve, GMRES(50) to 1e-8 with verified termination,
   through the user entry points ``setup_problem -> build_preconditioner
   -> solve -> solution``, each run cold then warm, with the launch and
   route counts zeroed just before and read just after each run:

   * ``geneo_dd``: the GenEO coarse space, double-single subdomain inverses;
   * ``ring_f64`` (R-f64): the geneo_ring coarse space, f64 subdomain
     inverse, the extension by PCG preconditioned with it (the bench keys
     ``geneo_ring.extension.maxit64 = 4``, ``tolerance = 1e-6``);
   * ``ring_dd`` (R-dd): the geneo_ring coarse space, double-single
     subdomain and coarse inverses (the kernel at two shapes), the direct
     extension;

6. the f64 and dd fine-level apply times, and the kernel against its plain
   version at both of R-dd's shapes, on R-dd's own inverses, with
   CUDA-event timings, each with its launch plan, its share of the bound
   and, as a reference line over the same bytes, the f64 cuBLAS matvec of
   the f64 inverse hi + lo (``f64_library_ms``; it computes a different
   function, so ``library_ms`` stays null).

Then one JSON line of per-kernel results, the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile [path ...]

profiles the full-size paths instead (default: all three): one run to warm
up, then one under ``torch.profiler`` with CPU and CUDA activity, a window
per entry point (``setup_problem``, ``build_preconditioner``, ``solve``),
each printed with its wall seconds, device-busy seconds (the union of the
card's kernel and copy intervals), idle share 1 - busy / wall and the
device ops that took the most time.

    python3 chip_smoke.py --plans

times the kernel at R-dd's two shapes on random inputs under several
launch plans (rows per block x column chunks), the default plan first,
each checked against the f64 product; the coarse shape with the L2 flushed
by a write pass (as in phase 6) and by a read pass.
"""

import json
import subprocess
import sys
import time

import torch

# The JAX package's f64 path at full size (its CPU run with x64: islands
# 384^2/256, nev 8, Cholesky coarse solve, GMRES(50) to 1e-8) takes 16 GMRES
# iterations with geneo (true relative residual 4.39e-8) and 15 with
# geneo_ring (1.52e-8).  Each path here must land within 2 of its count.
MAX_ITERS = {"geneo_dd": 16 + 2, "ring_f64": 15 + 2, "ring_dd": 15 + 2}
TRUE_RES_MAX = 1e-7
KERNEL_VS_PLAIN_TOL = 1e-6  # plain version sums f32 partial products
KERNEL_VS_F64_TOL = 1e-12  # kernel accumulates in f64

# One NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM3 rate
# and the FP64 rate outside the tensor cores, which the kernel's FMAs use.
HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 34e12

PATHS = {
    "geneo_f64": ("geneo", {}),  # the CPU reference of geneo_dd
    "geneo_dd": ("geneo", {"schwarz.subdomain_solver.precision": "dd"}),
    "ring_f64": ("geneo_ring", {"geneo_ring.extension.maxit64": 4,
                                "geneo_ring.extension.tolerance": 1e-6}),
    "ring_dd": ("geneo_ring", {"schwarz.subdomain_solver.precision": "dd",
                               "coarse_solver.precision": "dd"}),
}


def fail(msg):
    raise RuntimeError(msg)


def rel_err(y, ref):
    return float((y - ref).abs().max() / ref.abs().max())


def path_ptree(api, path, gridsize):
    coarse, keys = PATHS[path]
    pt = api.default_ptree()
    pt["gridsize"] = gridsize
    pt["overlap"] = 2
    pt["problem"] = "islands"
    pt["solver.reduction"] = 1e-8
    pt["solver.restart"] = 50
    pt["solver.maxit"] = 400
    pt["solver.verify"] = True
    pt["coarsespace.type"] = coarse
    pt[f"{coarse}.eigensolver.nev"] = 8
    pt["coarse_solver.type"] = "cholesky"
    for k, v in keys.items():
        pt[k] = v
    return pt


def run_path(path, gridsize, parts, device):
    """Drive one path once through the entry points, with the kernel's
    launch counts and the ring's route counts zeroed just before and read
    just after.  Returns a dict of the run's objects and counts."""
    from ddm_tpu_torch import api
    from ddm_tpu_torch.coarse import ring
    from ddm_tpu_torch.kernels import ddmatvec
    from ddm_tpu_torch.obs.logger import Logger

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    Logger.reset()
    ddmatvec.dd_matvec_cuda.shapes.clear()
    for k in ring.ROUTES:
        ring.ROUTES[k] = 0
    t0 = time.perf_counter()
    p = api.setup_problem(path_ptree(api, path, gridsize), parts=parts,
                          device=device)
    M = api.build_preconditioner(p)
    res = api.solve(p, M)
    u = api.solution(p, res)
    if cuda:
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    shapes = dict(ddmatvec.dd_matvec_cuda.shapes)
    out = dict(
        p=p, M=M, res=res, u=u, secs=secs,
        launches=sum(shapes.values()), shapes=shapes,
        fine_applies=M.precs[0].applies, coarse_applies=M.precs[1].applies,
        routes=dict(ring.ROUTES),
        events={k: v.total for k, v in Logger.get().events.items()},
        peak_gib=torch.cuda.max_memory_allocated(device) / 2**30 if cuda else 0,
    )
    out["true_res"] = float(torch.linalg.norm(p.A.mv(res.x) - p.rhs)
                            / torch.linalg.norm(p.rhs))
    return out


def phase_split(ev):
    split = {"setup_problem": sum(v for (fam, _), v in ev.items()
                                  if fam == "Setup")}
    for key, label in [(("Schwarz", "extract"), "extract"),
                       (("Schwarz", "factorise"), "factorise"),
                       (("Eigensolver", "assemble Neumann"), "neumann"),
                       (("Eigensolver", "solve GEVP"), "gevp"),
                       (("Eigensolver", "extension"), "extension"),
                       (("GalerkinPrec", "build Matrix"), "coarse_matrix"),
                       (("GalerkinPrec", "factor A0"), "coarse_factor"),
                       (("Solver", "solve"), "solve")]:
        if key in ev:
            split[label] = ev[key]
    return split


def time_ms(fn, reps=20, flush=None):
    """Mean CUDA-event time of ``fn`` over ``reps`` launches after a warm-up.
    With ``flush`` (a callable that overwrites the L2 cache), each launch
    follows a flush and the flush's own time is subtracted, so an input
    smaller than L2 is read from device memory as its caller would."""
    def loop(body):
        body()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            body()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    if flush is None:
        return loop(fn)

    def both():
        flush()
        fn()

    return loop(both) - loop(flush)


def bound_ms(n_sub, q):
    """Least time of y = (hi + lo) @ d on the card for d (n_sub, q): the
    q x q blocks of hi and lo read once (8 bytes per entry), d read and y
    written once, against 4 FP64 flops per entry; returns
    (ms, "bytes" | "operations")."""
    t_bytes = (8 * n_sub * q * q + 16 * n_sub * q) / HBM_BYTES_PER_S
    t_ops = 4 * n_sub * q * q / FP64_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def f64_product(hi, lo, d):
    q = d.shape[1]
    return ((hi[:, :q, :q].double() + lo[:, :q, :q].double())
            @ d[..., None])[..., 0]


def plan_str(pl):
    cluster = f"clusters of {pl.chunks}" if pl.chunks > 1 else "no cluster"
    return (f"{pl.rows} rows x {pl.chunks} chunk(s) of {pl.cols} cols, "
            f"{cluster}, {pl.blocks} blocks")


def check_kernel(ddmatvec, hi, lo, d, label):
    """Kernel against its plain version and the f64 product of the same
    hi/lo; returns the largest absolute difference from the plain version
    and the launch plan the kernel took."""
    y = ddmatvec.dd_matvec_cuda(hi, lo, d)
    ref = ddmatvec.dd_matvec_reference(hi, lo, d)
    n_sub, q = d.shape
    pl = ddmatvec.plan(n_sub, q, ddmatvec.sm_count(d.device))
    e_plain, e_f64 = rel_err(y, ref), rel_err(y, f64_product(hi, lo, d))
    print(f"kernel {label} {tuple(hi.shape)} q={q} [{plan_str(pl)}]: rel err "
          f"vs plain {e_plain:.3e}, vs f64 {e_f64:.3e}", flush=True)
    if not (e_plain <= KERNEL_VS_PLAIN_TOL and e_f64 <= KERNEL_VS_F64_TOL):
        fail(f"dd_matvec kernel disagrees with its plain version ({label})")
    return float((y - ref).abs().max()), pl


def check_path(path, run, r):
    """Print one full-size run's phase split and counts; raise unless it
    converged as required and launched the kernel where its path must."""
    p, res, M = r["p"], r["res"], r["M"]
    print(f"{path} ({run}): " + ", ".join(
        f"{k} {v:.3f} s" for k, v in phase_split(r["events"]).items())
        + f", total {r['secs']:.3f} s, peak mem {r['peak_gib']:.2f} GiB",
        flush=True)
    print(f"{path} ({run}): n_dofs {p.disc.n_dofs}, n_sub {p.topo.n_sub}, "
          f"n_pad {p.topo.n_pad}, iterations {res.iterations}, converged "
          f"{res.converged}, true rel residual {r['true_res']:.3e}, dd_matvec "
          f"launches {r['launches']} by shape {r['shapes']}, applies "
          f"{r['fine_applies']} fine + {r['coarse_applies']} coarse, "
          f"extension routes {r['routes']}", flush=True)
    if not (res.converged and r["true_res"] <= TRUE_RES_MAX
            and res.iterations <= MAX_ITERS[path]):
        fail(f"{path} did not converge as required")
    if not (r["u"].shape == (p.disc.n_dofs,) and bool(torch.isfinite(r["u"]).all())):
        fail("solution is not a finite vector of n_dofs entries")
    n_pad, n_c = p.topo.n_pad, M.precs[1].V.shape[0] * M.precs[1].V.shape[1]
    want = {}  # dd_matvec launches by shape: 3 per dd apply
    if path != "ring_f64":
        want[(p.topo.n_sub, n_pad, n_pad)] = 3 * r["fine_applies"]
    if path == "ring_dd":
        want[(1, n_c, n_c)] = 3 * r["coarse_applies"]
    if not (r["shapes"] == want and all(want.values())):
        fail(f"{path} did not run through the dd_matvec kernel as expected: "
             f"{r['shapes']} != {want}")
    if path == "ring_f64" and not r["routes"]["pcg"] >= 1:
        fail("ring_f64 did not take the PCG extension route")
    if path == "ring_dd" and not r["routes"]["direct"] >= 1:
        fail("ring_dd did not take the direct extension route")


def device_busy(prof):
    """(busy seconds, {name: seconds}) over the device events of a
    ``torch.profiler`` run: the union of the kernel, copy and set
    intervals on the card, and each op's total."""
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        by_name[e.name] = by_name.get(e.name, 0.0) + (t1 - t0) * 1e-6
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy += (t1 - max(t0, end)) * 1e-6
            end = t1
    return busy, by_name


def profiled(label, fn, top=8):
    """Run ``fn`` under the profiler; print its wall and device-busy
    seconds, its idle share 1 - busy / wall and its top device ops."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, by_name = device_busy(prof)
    print(f"  {label}: wall {wall:.4f} s, device busy {busy:.4f} s, idle share "
          f"{1.0 - busy / wall:.3f}", flush=True)
    for name, sec in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {sec:.4f} s  {name[:110]}", flush=True)
    return out


def profile_paths(paths):
    """For each full-size path: one unprofiled run to warm up, then one
    with a profiler window per entry point."""
    from ddm_tpu_torch import api

    dev = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(0)} | torch {torch.__version__}",
          flush=True)
    for path in paths or ["geneo_dd", "ring_f64", "ring_dd"]:
        pt = path_ptree(api, path, 384)
        p = api.setup_problem(pt, parts=(16, 16), device=dev)
        res = api.solve(p, api.build_preconditioner(p))
        del p, res
        print(f"{path} (warm, profiled):", flush=True)
        p = profiled("setup_problem", lambda: api.setup_problem(
            pt, parts=(16, 16), device=dev))
        M = profiled("build_preconditioner", lambda: api.build_preconditioner(p))
        res = profiled("solve", lambda: api.solve(p, M))
        print(f"  iterations {res.iterations}, converged {res.converged}",
              flush=True)
        del p, M, res


# (rows, chunks) per shape for --plans; each list's plan() is timed first
SWEEP = {(256, 848): [(64, 1), (32, 1), (128, 1), (64, 2)],
         (1, 2048): [(64, 1), (16, 1), (8, 1), (32, 2), (16, 2), (8, 2),
                     (64, 4), (16, 4), (8, 4), (64, 8), (32, 8), (16, 8),
                     (8, 8)]}


def sweep_plans():
    """Time the kernel under the plans of SWEEP at R-dd's two shapes."""
    from ddm_tpu_torch.kernels import build, ddmatvec
    from ddm_tpu_torch.solvers.direct import dd_split

    dev = torch.device("cuda", 0)
    build.build("dd_matvec")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush_buf = torch.empty(2 * 50 * 2**20, dtype=torch.uint8, device=dev)
    n_sm = ddmatvec.sm_count(dev)

    def read_flush():  # leaves the L2 full of clean lines
        flush_buf.max()

    for (n_sub, q), plans in SWEEP.items():
        hi, lo = dd_split(torch.randn((n_sub, q, q), generator=gen, device=dev,
                                      dtype=torch.float64))
        d = torch.randn((n_sub, q), generator=gen, device=dev,
                        dtype=torch.float64)
        truth = f64_product(hi, lo, d)
        b_ms, _ = bound_ms(n_sub, q)
        default = ddmatvec.plan(n_sub, q, n_sm)
        tilings = [default] + [t for t in (ddmatvec.tiling(n_sub, q, r, c)
                                           for r, c in plans) if t != default]
        for pl in tilings:
            def fn():  # the C entry point under this plan (not counted)
                y = torch.empty_like(d)
                err = ddmatvec._launcher()(
                    hi.data_ptr(), lo.data_ptr(), d.data_ptr(), y.data_ptr(),
                    n_sub, q, q, pl.rows, pl.chunks, pl.cols,
                    torch.cuda.current_stream(dev).cuda_stream)
                if err != 0:
                    fail(f"dd_matvec launch failed under {pl}: CUDA error {err}")
                return y
            err = rel_err(fn(), truth)
            if err > KERNEL_VS_F64_TOL:
                fail(f"plan {pl} disagrees with the f64 product: {err:.3e}")
            line = f"plan ({n_sub}, {q}, {q}) [{plan_str(pl)}]"
            if pl == default:
                line += " (default)"
            if n_sub == 1:
                ms = time_ms(fn, reps=50, flush=flush_buf.zero_)
                ms_r = time_ms(fn, reps=50, flush=read_flush)
                line += (f": {ms:.4f} ms write-flushed, {ms_r:.4f} ms "
                         f"read-flushed")
            else:
                ms = time_ms(fn)
                line += f": {ms:.4f} ms"
            print(f"{line}, {b_ms / ms:.3f} of the {b_ms:.4f} ms bound, rel err "
                  f"vs f64 {err:.3e}", flush=True)
        if n_sub == 1:  # what one launch costs under the same flushes
            y = torch.empty_like(d)
            ms = time_ms(y.zero_, reps=50, flush=flush_buf.zero_)
            ms_r = time_ms(y.zero_, reps=50, flush=read_flush)
            print(f"launch floor: one-block kernel (zero_ of y) {ms:.4f} ms "
                  f"write-flushed, {ms_r:.4f} ms read-flushed", flush=True)


def main():
    # -- 1. device (CUDA checked by the caller) -----------------------------
    from ddm_tpu_torch.kernels import build, ddmatvec
    from ddm_tpu_torch.solvers.direct import dd_split

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = build.build("dd_matvec")
    print(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s", flush=True)

    # -- 3. kernel vs plain at the test shapes and the coarse shape ---------
    gen = torch.Generator(device=dev).manual_seed(0)
    for n_sub, P, q in [(4, 256, 200), (2, 640, 640), (3, 177, 177),
                        (1, 1001, 1001), (1, 12, 12), (1, 37, 37), (1, 24, 24),
                        (1, 100, 100), (1, 2048, 2048)]:
        A = torch.randn((n_sub, P, P), generator=gen, device=dev,
                        dtype=torch.float64)
        hi, lo = dd_split(A)
        d = torch.randn((n_sub, q), generator=gen, device=dev,
                        dtype=torch.float64)
        check_kernel(ddmatvec, hi, lo, d, "random")
    same = torch.equal(ddmatvec.dd_matvec_cuda(hi, lo, d),
                       ddmatvec.dd_matvec_cuda(hi, lo, d))
    print(f"kernel (1, 2048, 2048): two launches bit-identical: {same}",
          flush=True)
    if not same:
        fail("two launches of dd_matvec on the same inputs differ")
    del A, hi, lo, d

    # -- 4. small-input references: card vs CPU exact f64 -------------------
    cpu = torch.device("cpu")
    for path, ref in (("geneo_dd", "geneo_f64"), ("ring_dd", "ring_f64")):
        g = run_path(path, 32, (4, 4), dev)
        c = run_path(ref, 32, (4, 4), cpu)
        e_small = rel_err(g["u"].cpu(), c["u"])
        n_dd = 3 * g["fine_applies"]
        if path == "ring_dd":
            n_dd += 3 * g["coarse_applies"]
        print(f"small 32^2/16 {path}: card {g['res'].iterations} its, cpu "
              f"{ref} {c['res'].iterations} its, solution rel diff "
              f"{e_small:.3e}, launches {g['launches']} = 3 x "
              f"({g['fine_applies']} fine + {g['coarse_applies']} coarse) "
              f"applies, by shape {g['shapes']}", flush=True)
        if not (g["res"].converged
                and abs(g["res"].iterations - c["res"].iterations) <= 2
                and e_small <= 1e-6 and g["launches"] == n_dd > 0):
            fail(f"small-input {path} on the card disagrees with the CPU")
        del g, c

    # -- 5. main paths at full size, cold then warm ---------------------------
    launches = {}
    for path in ("geneo_dd", "ring_f64", "ring_dd"):
        for run in ("cold", "warm"):
            r = None  # free the last run before this one's peak is taken
            r = run_path(path, 384, (16, 16), dev)
            check_path(path, run, r)
        launches[path] = r["launches"]
        if path == "geneo_dd":
            continue
        # the fine apply of both ring paths: the f64 inverse is read once
        # per apply (1.47 GB), hi + lo three times (3 x 1.47 GB)
        fine = r["M"].precs[0]
        d = torch.randn(r["p"].disc.n_dofs, generator=gen, device=dev,
                        dtype=torch.float64)
        line = f"{path} fine apply: {time_ms(lambda: fine.apply(d)):.4f} ms"
        if path == "ring_f64":
            d_sub = torch.randn(fine.sub2glob.shape, generator=gen, device=dev,
                                dtype=torch.float64)
            ms_inv = time_ms(lambda: fine.factors.solve(d_sub))
            line += (f", of which the f64 inverse matvec {ms_inv:.4f} ms "
                     f"({fine.factors.inv.numel() * 8 / ms_inv / 1e6:.0f} GB/s)")
            del d_sub
        else:
            line += " (3 kernel launches + 2 exact sparse defects)"
        print(line, flush=True)
        del fine, d

    # -- 6. the kernel at R-dd's two shapes, on R-dd's own inverses ----------
    fine, coarse = r["M"].precs
    flush_buf = torch.empty(2 * 50 * 2**20, dtype=torch.uint8, device=dev)
    entries = []
    for label, fac in (("fine", fine.factors), ("coarse", coarse.coarse)):
        hi, lo = fac.inv_hi, fac.inv_lo
        n_sub, P, _ = hi.shape
        dv = torch.randn((n_sub, P), generator=gen, device=dev,
                         dtype=torch.float64)
        abs_err, pl = check_kernel(ddmatvec, hi, lo, dv, f"ring_dd {label}")
        # the coarse inverse (33.6 MB at n_c 2048) fits in the 50 MB L2, but
        # the solve reads it after the fine level's 1.47 GB: flush first
        flush = flush_buf.zero_ if label == "coarse" else None
        ms = time_ms(lambda: ddmatvec.dd_matvec_cuda(hi, lo, dv), flush=flush)
        plain_ms = time_ms(lambda: ddmatvec.dd_matvec_reference(hi, lo, dv),
                           flush=flush)
        inv64 = hi.double() + lo.double()  # the same bytes as hi + lo
        f64_ms = time_ms(lambda: torch.bmm(inv64, dv[..., None]), flush=flush)
        del inv64
        b_ms, b_by = bound_ms(n_sub, P)
        print(f"kernel ring_dd {label} {tuple(hi.shape)} [{plan_str(pl)}]: "
              f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}), {b_ms / ms:.3f} of the bound, "
              f"{8 * n_sub * P * P / ms / 1e6:.0f} GB/s of hi+lo; f64 cuBLAS "
              f"matvec of hi + lo (reference) {f64_ms:.4f} ms", flush=True)
        entries.append({
            "shape": [n_sub, P, P], "launches": r["shapes"][(n_sub, P, P)],
            "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "share_of_bound": b_ms / ms, "f64_library_ms": f64_ms,
            "plan": pl._asdict(),
        })

    # top-level numbers: this slice's main path (R-dd) at its fine shape;
    # each path's total over both shapes stands in launches_by_path
    print(json.dumps({"kernels": [{
        "name": "dd_matvec", "route": "cuda",
        "source": "ddm_tpu_torch/csrc/dd_matvec.cu",
        "replaces": "ddm_tpu/kernels/ddmatvec.py:62",
        **{k: entries[0][k] for k in ("launches", "max_abs_err", "ms",
                                      "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")},
        "launches_by_path": launches,
        "shapes": entries,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    if sys.argv[1:2] == ["--profile"]:
        profile_paths(sys.argv[2:])
    elif sys.argv[1:2] == ["--plans"]:
        sweep_plans()
    else:
        main()
