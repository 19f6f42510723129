#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ddm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and exits non-zero:

1. device — requires CUDA (exits 1 without it, before printing any result)
   and prints ``nvidia-smi --query-gpu=name,power.limit`` for card 0;
2. build — compiles every hand-written kernel of the main path from
   ``ddm_tpu_torch/csrc`` with nvcc and prints the build time;
3. kernel vs plain — ``dd_matvec`` against its plain PyTorch version at
   (4, 256, 256) q=200, (2, 640, 640) and a ragged (3, 177, 177);
4. small-input reference — the dd slice at islands 32^2 / 16 on the card
   against the exact f64 slice on the CPU (iterations within 2, solutions
   within 1e-6);
5. main path — islands 384^2 / 256 subdomains, overlap 2, two-level GenEO
   (nev 8) RAS with double-single subdomain inverses applied by the
   kernel, GMRES(50) to 1e-8, through the user entry points
   ``setup_problem -> build_preconditioner -> solve -> solution``.  Run
   twice (cold, then warm); launch counts are zeroed just before and read
   just after each run;
6. kernel vs plain at the main path's shape (256, n_pad, n_pad), on the
   main path's own inverse, with CUDA-event timings of both.

Then one JSON line of per-kernel results, the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

import torch

# The JAX package's f64 path solves the full-size problem in 16 GMRES
# iterations (its CPU run with x64: islands 384^2/256, geneo nev 8, Cholesky
# coarse solve, GMRES(50) to 1e-8; true relative residual 4.39e-8).  The
# kernel accumulates in f64, so the dd path must land within 2 of that.
MAX_ITERS = 16 + 2
TRUE_RES_MAX = 1e-7
KERNEL_VS_PLAIN_TOL = 1e-6  # plain version sums f32 partial products
KERNEL_VS_F64_TOL = 1e-12  # kernel accumulates in f64


def fail(msg):
    raise RuntimeError(msg)


def rel_err(y, ref):
    return float((y - ref).abs().max() / ref.abs().max())


def slice_ptree(api, gridsize, precision):
    pt = api.default_ptree()
    pt["gridsize"] = gridsize
    pt["overlap"] = 2
    pt["problem"] = "islands"
    pt["solver.reduction"] = 1e-8
    pt["solver.restart"] = 50
    pt["solver.maxit"] = 400
    pt["solver.verify"] = True
    pt["coarsespace.type"] = "geneo"
    pt["geneo.eigensolver.nev"] = 8
    pt["coarse_solver.type"] = "cholesky"
    pt["schwarz.subdomain_solver.precision"] = precision
    return pt


def run_slice(api, ddmatvec, gridsize, parts, device, precision="dd"):
    """Drive the main path once; returns (problem, preconditioner, result,
    solution, kernel launches, fine-level applies, seconds)."""
    if device.type == "cuda":
        torch.cuda.synchronize()
    ddmatvec.dd_matvec_cuda.launches = 0
    t0 = time.perf_counter()
    p = api.setup_problem(slice_ptree(api, gridsize, precision), parts=parts,
                          device=device)
    M = api.build_preconditioner(p)
    res = api.solve(p, M)
    u = api.solution(p, res)
    if device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return (p, M, res, u, ddmatvec.dd_matvec_cuda.launches,
            M.precs[0].applies, secs)


def time_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    # -- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    from ddm_tpu_torch import api
    from ddm_tpu_torch.kernels import build, ddmatvec
    from ddm_tpu_torch.obs.logger import Logger
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

    # -- 3. kernel vs plain at small shapes ---------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    for n_sub, P, q in [(4, 256, 200), (2, 640, 640), (3, 177, 177)]:
        A = torch.randn((n_sub, P, P), generator=gen, device=dev,
                        dtype=torch.float64)
        hi, lo = dd_split(A)
        d = torch.randn((n_sub, q), generator=gen, device=dev,
                        dtype=torch.float64)
        y = ddmatvec.dd_matvec_cuda(hi, lo, d)
        e_plain = rel_err(y, ddmatvec.dd_matvec_reference(hi, lo, d))
        truth = ((hi.double() + lo.double())[:, :q, :q] @ d[..., None])[..., 0]
        e_f64 = rel_err(y, truth)
        print(f"kernel ({n_sub}, {P}, {P}) q={q}: rel err vs plain "
              f"{e_plain:.3e}, vs f64 {e_f64:.3e}", flush=True)
        if not (e_plain <= KERNEL_VS_PLAIN_TOL and e_f64 <= KERNEL_VS_F64_TOL):
            fail("dd_matvec kernel disagrees with its plain version")

    # -- 4. small-input reference: card (dd) vs CPU exact f64 path ---------
    _, _, r_gpu, u_gpu, n_l, n_a, _ = run_slice(api, ddmatvec, 32, (4, 4), dev)
    _, _, r_cpu, u_cpu, _, _, _ = run_slice(
        api, ddmatvec, 32, (4, 4), torch.device("cpu"), precision="f64")
    e_small = rel_err(u_gpu.cpu(), u_cpu)
    print(f"small 32^2/16: card dd {r_gpu.iterations} its, cpu f64 "
          f"{r_cpu.iterations} its, solution rel diff {e_small:.3e}, "
          f"launches {n_l} = 3 x {n_a} applies", flush=True)
    if not (r_gpu.converged and abs(r_gpu.iterations - r_cpu.iterations) <= 2
            and e_small <= 1e-6 and n_l == 3 * n_a > 0):
        fail("small-input slice on the card disagrees with the CPU reference")

    # -- 5. main path at full size, cold then warm ---------------------------
    for run in ("cold", "warm"):
        Logger.reset()
        torch.cuda.reset_peak_memory_stats(dev)
        p, M, res, u, launches, applies, secs = run_slice(
            api, ddmatvec, 384, (16, 16), dev)
        true_res = float(torch.linalg.norm(p.A.mv(res.x) - p.rhs)
                         / torch.linalg.norm(p.rhs))
        ev = {k: v.total for k, v in Logger.get().events.items()}
        setup_s = sum(v for (fam, _), v in ev.items() if fam == "Setup")
        phases = {
            "setup_problem": setup_s,
            "extract": ev[("Schwarz", "extract")],
            "factorise": ev[("Schwarz", "factorise")],
            "neumann": ev[("Eigensolver", "assemble Neumann")],
            "gevp": ev[("Eigensolver", "solve GEVP")],
            "coarse_matrix": ev[("GalerkinPrec", "build Matrix")],
            "coarse_factor": ev[("GalerkinPrec", "factor A0")],
            "solve": ev[("Solver", "solve")],
        }
        print(f"main path ({run}): " + ", ".join(
            f"{k} {v:.3f} s" for k, v in phases.items())
            + f", total {secs:.3f} s, peak mem "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB", flush=True)
        print(f"main path ({run}): n_dofs {p.disc.n_dofs}, n_sub "
              f"{p.topo.n_sub}, n_pad {p.topo.n_pad}, iterations "
              f"{res.iterations}, converged {res.converged}, true rel residual "
              f"{true_res:.3e}, dd_matvec launches {launches} = 3 x {applies} "
              f"Schwarz applies", flush=True)
        if not (res.converged and true_res <= TRUE_RES_MAX
                and res.iterations <= MAX_ITERS):
            fail("main path did not converge as required")
        if not (launches > 0 and launches == 3 * applies):
            fail("main path did not run through the dd_matvec kernel")
        if not (u.shape == (p.disc.n_dofs,) and bool(torch.isfinite(u).all())):
            fail("solution is not a finite vector of n_dofs entries")
        main_launches = launches

    # -- 6. kernel vs plain at the main path's shape ---------------------------
    fac = M.precs[0].factors
    hi, lo = fac.inv_hi, fac.inv_lo
    d = torch.randn((hi.shape[0], hi.shape[1]), generator=gen, device=dev,
                    dtype=torch.float64)
    y = ddmatvec.dd_matvec_cuda(hi, lo, d)
    ref = ddmatvec.dd_matvec_reference(hi, lo, d)
    e_plain = rel_err(y, ref)
    abs_err = float((y - ref).abs().max())
    truth = ((hi.double() + lo.double()) @ d[..., None])[..., 0]
    e_f64 = rel_err(y, truth)
    del truth
    ms = time_ms(lambda: ddmatvec.dd_matvec_cuda(hi, lo, d))
    plain_ms = time_ms(lambda: ddmatvec.dd_matvec_reference(hi, lo, d))
    gbytes = 2 * hi.numel() * 4 / 1e9  # hi + lo, read once
    print(f"kernel {tuple(hi.shape)}: rel err vs plain {e_plain:.3e}, vs f64 "
          f"{e_f64:.3e}; {ms:.4f} ms ({gbytes / ms * 1e3:.0f} GB/s of hi+lo) "
          f"vs plain {plain_ms:.4f} ms", flush=True)
    if not (e_plain <= KERNEL_VS_PLAIN_TOL and e_f64 <= KERNEL_VS_F64_TOL):
        fail("dd_matvec kernel disagrees with its plain version at full size")

    print(json.dumps({"kernels": [{
        "name": "dd_matvec", "route": "cuda",
        "source": "ddm_tpu_torch/csrc/dd_matvec.cu",
        "replaces": "ddm_tpu/kernels/ddmatvec.py:62",
        "launches": main_launches, "max_abs_err": abs_err,
        "ms": ms, "plain_ms": plain_ms,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
