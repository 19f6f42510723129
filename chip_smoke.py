#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ddm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and exits non-zero:

1. device — requires CUDA (exits 1 without it, before printing any result)
   and prints ``nvidia-smi --query-gpu=name,power.limit`` for card 0;
2. build — compiles every hand-written kernel of the main paths from
   ``ddm_tpu_torch/csrc`` with nvcc, and beside it the native host
   topology ``ddm_tpu_torch/_native/ddmcore.cpp`` with g++, and prints
   the build times;
3. kernel vs plain — ``dd_matvec`` against its plain PyTorch version at
   (4, 256, 256) q=200, (2, 640, 640), a ragged (3, 177, 177), a ragged
   one-matrix (1, 1001, 1001), small matrices whose plans take clusters of
   3, 5, 6 and 7 blocks, and the coarse shape (1, 2048, 2048), each with
   the launch plan it took; then two launches at the coarse shape,
   which must give the same bits (the column split's cluster reduction runs
   in a fixed order).  Row by row, the kernel must lie within the plain
   version's worst-case rounding, gamma_(q+1) = (q+1) u / (1 - (q+1) u)
   with u = 2^-24, of (|hi| + |lo|) |d|, and within 1e-12 (relative) of
   the f64 product of hi + lo;
4. small-input references, each on the card against the exact f64 slice
   on the CPU (iterations within 2, the same coarse vectors kept in every
   subdomain, solutions within 1e-6): the
   geneo dd and the geneo_ring (R-dd) slices at islands 32^2 / 16
   subdomains, the 3-D hex dd slice at islands 12^3 / 8 subdomains,
   overlap 2, the
   elasticity dd slice at steel-rubber 32^2 / 16 subdomains, the
   unstructured dd slice on the L-shape below refined once / 8 RCB
   subdomains, the DG dd slice at 16^2 / (2, 2), overlap 1, and tet
   elasticity (the steel-rubber bar on 8 x 2 x 3 Kuhn-tetrahedron cells,
   4 RCB subdomains, three displacement components); then, at islands
   32^2 / 16, f64 on both sides unless named, the coarse spaces
   ``algebraic_geneo``, ``constraint_geneo``, ``msgfem`` (dd on the card:
   the kernel at the fine and the coarse shape), ``msgfem_euclid``,
   ``algebraic_msgfem``, ``msgfem_ring``, ``harmonic_extension``, ``svd``
   and ``geneo`` with ``eigensolver.type = lobpcg`` (card and CPU start
   from the same numpy block); for these nine the iterations are compared
   at the reduction 1e-8 and the solutions in a second run of both sides
   that iterates to the residual floor (at 1e-8 GMRES leaves the weaker
   spaces' solutions up to 2e-4 from a sparse direct solve, farther apart
   than 1e-6); then the GenEO dd slice on islands P2 triangles 16^2 / 8
   RCB subdomains; then the nonlinear example's Newton solve
   (-Δu + 10 u² = |x|², BiCGStab under multiplicative two-level Schwarz
   with LU subdomain and coarse solves, the shipped ini): Q1 16^2 / (2, 2)
   and P2 triangles 8^2 / 4 RCB subdomains with the dd coarse solve on the
   card (Newton counts equal, inner counts within 1 per step, solutions
   within 1e-6), and BASELINE config 5's size, Q1 64^2 / 16, f64 on both
   sides (Newton and inner counts equal); then the example drivers through
   the user's command line ``examples/cli.main``, card against CPU with
   the same iteration counts and solutions within 1e-6: the shipped
   poisson.ini at 32^2 / 16 with the scripted islands file, f64 and dd
   (dd under flexible GMRES, see FGMRES_ARGS; the kernel at the fine and
   the coarse shape on the card), ``modify_subdomain_matrix`` on simple
   32^2 / 4, the f32 subdomain precision on simple 32^2 / 16 (counts
   within 1: the card's and the CPU's f32 sums run in different orders),
   the elasticity example at 8 x 2 x 3 cells / 2 slabs with the scripted
   steel-rubber file, and the DG example at 16^2 / 4 with the symmetric
   scripted file;
   then, on the host, ``build_topology`` on the native route against the
   scipy route at the three full-size grids (islands 384^2 / 256, the
   L-shape refine 4 / 128 RCB, 3-D 56^3 / 512), overlap 2, both times
   printed: every array must be equal, and the native route available;
5. the main paths, nev 8, Cholesky coarse solve, restart 50 to 1e-8 with
   verified termination, through the user entry points ``setup_problem ->
   build_preconditioner -> solve -> solution``, each run cold then warm,
   with the launch and route counts zeroed just before and read just after
   each run.  Three at islands 384^2 / 256 subdomains, overlap 2, nev 8,
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

   then the 3-D hex paths at islands 56^3 (185,193 dofs) / 512 subdomains,
   geneo, GMRES(50):

   * ``hex_ov1_dd``: overlap 1 (n_pad 1000), dd subdomain and coarse
     inverses: the kernel at (512, 1000, 1000) and (1, 4096, 4096);
   * ``hex_ov2_f64``: overlap 2 (n_pad 1728), f64 inverses;
   * ``hex_ov2_dd``: overlap 2, dd inverses: the kernel at
     (512, 1728, 1728);

   and vector-valued elasticity, steel-rubber on [0,3]x[0,1], Q1 on 256^2
   (132,098 dofs) / 256 subdomains, overlap 2, geneo, flexible GMRES(50):

   * ``elast_f64`` and ``elast_dd`` (dd subdomain and coarse inverses);

   the unstructured paths: islands on the L-shape [0,1]^2 minus
   (0.5,1]^2, the 726 triangles of a 22 x 22-cell simplex grid outside the
   removed quadrant, written as a gmsh v2.2 file, read through
   ``make_grid`` (``meshfile``) and refined 4 times (185,856 triangles,
   93,633 P1 dofs), 128 subdomains by recursive coordinate bisection,
   overlap 2, geneo, GMRES(50):

   * ``unstr_f64`` and ``unstr_dd`` (dd subdomain and coarse inverses: the
     kernel at (128, n_pad, n_pad) with a ragged n_pad and (1, 1024, 1024));

   and the DG paths: the convection-diffusion example's problem and
   settings (Q1 SIPG, overlap 1, multiplicative GenEO with nev 6, LU
   subdomain and coarse solvers, standard POU) on 192^2 quads (147,456
   dofs), 144 subdomains (12, 12), GMRES(50), through the example's
   ``setup``:

   * ``dg_f64`` and ``dg_dd`` (dd subdomain and coarse inverses: the kernel
     on nonsymmetric LU inverses at (144, 1280, 1280) and (1, 864, 864));

   and the GenEO dd path on P2 triangles, islands on 192^2 cells (148,225
   dofs) / 256 RCB subdomains, overlap 2, GMRES(50), built by hand as
   tests/test_p2.py does (``setup_problem`` takes no degree):

   * ``p2_geneo_dd`` (dd subdomain and coarse inverses: the kernel at
     (256, 1072, 1072) and (1, 2048, 2048)), held to the JAX package's
     P2 test bound of 40 iterations;

   and five paths of other coarse spaces and of the iterative eigensolver:

   * ``geneo_lobpcg`` (islands 384^2 / 256, geneo with
     ``eigensolver.type = lobpcg``, f64 inverses), ``unstr_lobpcg`` (the
     L-shape, 128 RCB subdomains) and ``hex_ov2_lobpcg`` (56^3 / 512,
     overlap 2), each held to its dense path's count in this run + 2 (18
     for geneo_lobpcg) and, if it misses that at the default LOBPCG
     tolerance 1e-5, recorded and run again at 1e-8; each prints the
     LOBPCG iterations and block widths of every slab;
   * ``msgfem_dd`` (islands 384^2 / 256, msgfem nev 10, dd subdomain and
     coarse inverses: the kernel at (256, 848, 848) and (1, n_c, n_c)) and
     ``msgfem_ring_f64`` (msgfem_ring nev 10, f64 inverse), held to the JAX
     package's test limits 45 and 60;

   then one A/B line per pencil shape, (256, 848), (128, 1968) and
   (512, 1728): the warm dense GEVP seconds of geneo_dd, unstr_f64 and
   hex_ov2_f64 against the warm LOBPCG seconds of the LOBPCG path of the
   same pencils, with the GEVP phase's peak GiB; the two must keep the same
   coarse vectors in every subdomain, and their kept eigenvalues must
   agree to 1e-3 of each subdomain's largest kept one (the bound of the
   JAX package's LOBPCG-against-dense test on a GenEO pencil,
   tests/test_lobpcg.py:203); and ``torch.linalg.eigh``
   of LOBPCG's Rayleigh-Ritz shapes (n_sub, 24, 24) and (n_sub, 48, 48),
   timed against one batched product with the pencil, with the device
   kernels it ran;

   and last the nonlinear paths, 148,225 dofs each, through the example's
   ``main`` with the shipped ini (Newton to 1e-8, BiCGStab, multiplicative,
   LU subdomain and coarse solves), 256 RCB subdomains: ``newton_q1_f64``
   (Q1 on 384^2), ``newton_p2_f64`` and ``newton_p2_dd`` (P2 triangles on
   192^2; dd: the kernel at (1, 1024, 1024) in every coarse apply), each
   printing its Newton and inner counts, defect history and per Newton
   step the extract / factor / Galerkin / BiCGStab seconds.  Each must
   converge, and a fresh residual of its solution must read at most the
   Newton reduction times the first defect; dd must take f64's Newton
   count, with at most 2 inner iterations per Newton step more in all;

   and after them six paths through ``examples/cli.main``, each cold and
   warm, printing the example's split ("Setup problem", "Setup
   preconditioner", "Linear solve", "Visualisation", total), the phase
   split and peaks, the true and the recomputed preconditioned residual
   and the launches by shape: ``poisson_ini_f64`` (the shipped poisson.ini
   at 384^2 / 256 RCB subdomains, 148,225 dofs: islands, multiplicative
   GenEO nev 8, GMRES(100) to 1e-10, and its VTK output, written to a
   temporary directory), ``poisson_ini_dd`` (the same with the scripted
   islands file and dd subdomain and coarse inverses, flexible GMRES),
   ``poisson_simple_f64`` and ``poisson_simple_f32`` (problem simple to
   1e-8; f32: the f32 inverse with exact sparse f64 defect corrections),
   ``elast3d_f64`` and ``elast3d_dd`` (the shipped linearelasticity.ini on
   the steel-rubber bar, 80 x 8 x 12 cells, 28,431 dofs, 40 slabs, the
   scripted coefficients; dd: the kernel at (40, n_pad, n_pad) and
   (1, 240, 240)), each held to the limits of MAX_ITERS,
   CLI_TRUE_RES_MAX and ELAST3D_PREC_RES_MAX; then the direct-solver
   benchmark ``examples/solver_bench.main`` at its defaults (n 512, batch
   16), whose residuals must lie within 1e-8 (1e-3 for the f32 inverse);
   every path of this phase must have built its topology on the native
   route (``core.indexmaps.TOPOLOGY_ROUTES``, zeroed before the phase);

6. after each dd path's warm run, the kernel against its plain version at
   that path's shapes (msgfem_dd: its coarse shape; newton_p2_dd: the
   coarse shape of its last Newton step), on the path's own inverses, with
   CUDA-event
   timings (and, for the ring paths, the f64 and dd fine-level apply
   times), each with its launch plan, its share of the bound
   and the library call that computes the same product, one ``torch.bmm``
   (cuBLAS) of the f64 inverse hi + lo, summed and stored once over the
   same bytes (``library_ms``);
   Then three checks of the pieces that complete the port's parity with
   the JAX package: ``ring_dd`` through ``build_two_level(p, fine=)`` with
   a Schwarz level built once (phase 5's count, its solution bit-equal to
   ``build_two_level(p)`` on the same problem, one ``Schwarz/factorise``
   scope); ``obs.logger.profile_trace`` around one warm ``ring_dd`` solve
   (the Chrome trace it writes under ``build/traces`` must hold as many
   ``dd_matvec`` kernel events as the wrapper counts launches in that
   window; the five device ops that took the most time are printed); and
   ``factor_batched(A)`` at its default (LU, inverse on the card) on a
   nonsymmetric batch at (144, 1280, 1280), its solve within 1e-10 of
   ``torch.linalg.solve``;
7. sharded — ``ring_dd`` at islands 384^2 / 256 on four ranks of one
   process group, spawned by this script (``spawn`` start method, a
   ``file://`` rendezvous, a 300 s collective timeout): NCCL with one rank
   per card when the machine has four cards, else gloo with the four ranks
   on the cards there are (one H100: all on card 0).  Each rank builds
   through ``build_preconditioner(p, mesh=)`` and solves through
   ``solve(p, mesh=)`` with its launch counts zeroed just before and read
   just after, and prints its phase split, peak GiB and fine dd inverse;
   then rank 0, while the others wait at a barrier, holds the kernel
   against its plain version and times it at (64, 848, 848) and
   (1, 2048, 2048) as in phase 6.  Every rank must take phase 5's
   single-device ``ring_dd`` count, reach its true residual limit, hold a
   fine factor batch of 64 and launch the kernel 3 times per apply at
   both shapes; the sharded solution must lie within SOLUTION_TOL of the
   single-device one, and the final iterates must be bit-identical on
   every rank; each rank must have built its topology once, natively.
   A failure on any rank ends the script non-zero;
8. bench — ``python -m ddm_tpu_torch.bench`` at its defaults, a fresh
   process with a timeout (BENCH_TIMEOUT_S), its JSON line printed after
   ``bench:``: islands 384^2 / 256, geneo_ring nev 8 in f64, warm build +
   solve, then full geneo, then the two CPU baselines (forked workers and
   sequential SuperLU + LAPACK GEVPs, on the problem the host builds).
   geneo_ring must take at most 17 iterations and geneo 18, all four runs
   must reach a true relative residual <= 1e-7, and the two baselines must
   converge within one iteration of each other; then the bench's
   elasticity variant at 64^2 / 16 (``DDM_BENCH_PROBLEM=elasticity``,
   full GenEO): at most 47 + 2 iterations on the card and both baselines
   within one of the JAX package's 55.

Then one JSON line of per-kernel results, the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile [path ...]

profiles full-size paths instead (default: the three 2-D ones; the six
example paths by name too): one run to warm
up, then one under ``obs.logger.profile_trace`` (``torch.profiler`` with
CPU and CUDA activity; a Chrome trace per window under ``build/traces``), a
window per entry point (``setup_problem``, ``build_preconditioner``, ``solve``),
each printed with its wall seconds, device-busy seconds (the union of the
card's kernel and copy intervals), idle share 1 - busy / wall and the
device ops that took the most time.

    python3 chip_smoke.py --witness

runs ``elast3d_f64``'s command line and ``unstr_f64`` at full size on the
card and on the host's CPU (f64), each printing its iterations, where the
Givens estimate met the target and its residuals: the CPU witnesses of two
counts that the JAX package has no run of at full size.

    python3 chip_smoke.py --sharded

runs the kernel's build, ``ring_dd`` on card 0 as the reference, then
phase 7 alone (with four cards: NCCL, one rank per card), and holds every
stage of each rank's build (fine dd inverse, ring GEVP, extension, coarse
basis, coarse matrix and inverse, one apply of each level, the final
iterate) against the rows of two single-device builds: the reference and
one whose chunked stages, coarse restriction and prolongation are cut
into slabs of a rank's 64 subdomains.
It prints, for each stage, how many subdomains are bit-equal and the
largest difference.

    python3 chip_smoke.py --setup-profile

profiles ``setup_problem`` of islands 384^2 / 256 with the problem on the
card under ``cProfile``, cold and warm: its wall seconds, the topology
route it took, the cumulative seconds of its host stages
(``build_topology`` and the others of SETUP_PROFILE_FNS) and the functions
with the most time of their own.

    python3 chip_smoke.py --bench

runs phase 8 alone.

    python3 chip_smoke.py --parity

runs ``ring_dd`` at full size and then the three parity checks of phase 5.

    python3 chip_smoke.py --baseline-diag

runs the bench's elasticity variant with the problem on the host CPU
(``bench.main(device="cpu")``), then prints the BLAS and LAPACK libraries
(threadpoolctl, else ``numpy.show_config()``) and, per subdomain, the
singular values of the sequential baseline's kept GenEO vectors and each
vector's part outside the rigid-body span.

    python3 chip_smoke.py --plans

times the kernel at R-dd's two shapes on random inputs under several
launch plans (rows per block x column chunks), the default plan first,
each checked against the f64 product; the coarse shape with the L2 flushed
by a write pass (as in phase 6) and by a read pass.
"""

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

# Iteration limits: the JAX package's f64 count at full size + 2.  Its CPU
# run with x64 of islands 384^2/256 (nev 8, Cholesky coarse solve, GMRES(50)
# to 1e-8) takes 16 iterations with geneo (true relative residual 4.39e-8)
# and 15 with geneo_ring (1.52e-8); its recorded run of 3-D islands 56^3/512
# at overlap 1 takes 19.  The overlap-2 hex paths must stay within 2 of
# hex_ov1_dd's count of this run (set when that path has run).  Elasticity
# 256^2/256 under flexible GMRES: the JAX package's Givens estimate meets
# the target at iteration 46; here the estimate must meet it by 46 + 3 and
# the verified solve end within 100.  The unstructured and DG paths have no
# full-size count of the JAX package (its full-size runs do not fit a
# shared CPU host): their f64 paths are held to the stated bounds below,
# and each dd path to its f64 path's count of this run + 2 (set when that
# path has run).
# msgfem_dd and msgfem_ring_f64 are held to the limits of the JAX package's
# coarse-space test at 48^2/16 (tests/test_coarse_spaces.py:40,42), the
# LOBPCG paths to the count of the dense path on the same pencils + 2.
MAX_ITERS = {"geneo_dd": 16 + 2, "ring_f64": 15 + 2, "ring_dd": 15 + 2,
             "hex_ov1_dd": 19 + 2, "elast_f64": 100, "elast_dd": 100,
             "unstr_f64": 30, "dg_f64": 50, "geneo_lobpcg": 16 + 2,
             "msgfem_dd": 45, "msgfem_ring_f64": 60,
             "p2_geneo_dd": 40}  # tests/test_p2.py:test_p2_ddm_solve
LOBPCG_RETRY_TOL = 1e-8  # tests/test_lobpcg.py:169
ESTIMATE_HIT_MAX = 46 + 3
TRUE_RES_MAX = {"islands": 1e-7, "hex": 1e-7, "elast": 2e-8, "unstr": 1e-7,
                "dg": 1e-7, "tet": 2e-8, "p2": 1e-7}
SOLUTION_TOL = 1e-6  # small-input card solution against the CPU's
# The phase-4 coarse-space checks (TIGHT_CHECKS) compare solutions in a
# second run of both sides at TIGHT_REDUCTION: at 1e-8 GMRES leaves the
# weaker spaces' solutions up to 2e-4 from a sparse direct solve (CPU,
# 32^2/16), so two correct runs may differ by more than SOLUTION_TOL, and
# at 1e-10 still up to 5e-6.  No run meets 1e-12 (the verified residual
# floors near 1e-11): both sides run to maxit (400) and must end at a true
# residual within FLOOR_RES_MAX, where every solution lies within 3e-8 of
# a direct solve (CPU).  Near the floor the iteration counts of two correct
# runs drift apart (by up to 10 at 1e-10 on the CPU under another thread
# count), so the counts are compared at 1e-8.
TIGHT_REDUCTION = 1e-12
FLOOR_RES_MAX = 1e-10
KERNEL_VS_F64_TOL = 1e-12  # kernel accumulates in f64
U32 = 2.0 ** -24  # f32 unit roundoff
EIG_GAP_MAX = 1e-3  # LOBPCG against dense, tests/test_lobpcg.py:203

# One NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM3 rate
# and the FP64 rate outside the tensor cores, which the kernel's FMAs use.
HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 34e12

DD = {"schwarz.subdomain_solver.precision": "dd",
      "coarse_solver.precision": "dd"}
LOBPCG = {"geneo.eigensolver.type": "lobpcg"}
# path -> (problem kind, coarse space, overlap, extra config keys)
PATHS = {
    "geneo_f64": ("islands", "geneo", 2, {}),  # the CPU reference of geneo_dd
    "geneo_dd": ("islands", "geneo", 2,
                 {"schwarz.subdomain_solver.precision": "dd"}),
    "ring_f64": ("islands", "geneo_ring", 2,
                 {"geneo_ring.extension.maxit64": 4,
                  "geneo_ring.extension.tolerance": 1e-6}),
    "ring_dd": ("islands", "geneo_ring", 2, DD),
    "hex_ov1_dd": ("hex", "geneo", 1, DD),
    "hex_ov2_f64": ("hex", "geneo", 2, {}),
    "hex_ov2_dd": ("hex", "geneo", 2, DD),
    "elast_f64": ("elast", "geneo", 2, {}),
    "elast_dd": ("elast", "geneo", 2, DD),
    "unstr_f64": ("unstr", "geneo", 2, {}),
    "unstr_dd": ("unstr", "geneo", 2, DD),
    "dg_f64": ("dg", "geneo", 1, {}),
    "dg_dd": ("dg", "geneo", 1, DD),
    "tet_f64": ("tet", "geneo", 2, {}),
    "tet_dd": ("tet", "geneo", 2, DD),
    "geneo_lobpcg": ("islands", "geneo", 2, dict(LOBPCG)),
    "unstr_lobpcg": ("unstr", "geneo", 2, dict(LOBPCG)),
    "hex_ov2_lobpcg": ("hex", "geneo", 2, dict(LOBPCG)),
    "msgfem_f64": ("islands", "msgfem", 2, {"msgfem.eigensolver.nev": 10}),
    "msgfem_dd": ("islands", "msgfem", 2,
                  {**DD, "msgfem.eigensolver.nev": 10}),
    "msgfem_ring_f64": ("islands", "msgfem_ring", 2,
                        {"msgfem_ring.eigensolver.nev": 10}),
    # the small coarse-space checks (nev as in tests/test_coarse_spaces.py)
    "algebraic_geneo": ("islands", "algebraic_geneo", 2, {}),
    "constraint_geneo": ("islands", "constraint_geneo", 2, {}),
    "msgfem_euclid": ("islands", "msgfem_euclid", 2,
                      {"msgfem_euclid.eigensolver.nev": 10}),
    "algebraic_msgfem": ("islands", "algebraic_msgfem", 2,
                         {"algebraic_msgfem.eigensolver.nev": 10}),
    "harmonic_extension": ("islands", "harmonic_extension", 2, {}),
    "svd": ("islands", "svd", 2, {}),
    # islands on P2 triangles
    "p2_geneo_f64": ("p2", "geneo", 2, {}),
    "p2_geneo_dd": ("p2", "geneo", 2, DD),
}
# phase 4: (path on the card, its reference on the CPU)
SMALL_CHECKS = [("geneo_dd", "geneo_f64"), ("ring_dd", "ring_f64"),
                ("hex_ov2_dd", "hex_ov2_f64"), ("elast_dd", "elast_f64"),
                ("unstr_dd", "unstr_f64"), ("dg_dd", "dg_f64"),
                ("tet_dd", "tet_f64"), ("algebraic_geneo", "algebraic_geneo"),
                ("constraint_geneo", "constraint_geneo"),
                ("msgfem_dd", "msgfem_f64"), ("msgfem_euclid", "msgfem_euclid"),
                ("algebraic_msgfem", "algebraic_msgfem"),
                ("msgfem_ring_f64", "msgfem_ring_f64"),
                ("harmonic_extension", "harmonic_extension"), ("svd", "svd"),
                ("geneo_lobpcg", "geneo_lobpcg"),
                ("p2_geneo_dd", "p2_geneo_f64")]
TIGHT_CHECKS = {"algebraic_geneo", "constraint_geneo", "msgfem_dd",
                "msgfem_euclid", "algebraic_msgfem", "msgfem_ring_f64",
                "harmonic_extension", "svd", "geneo_lobpcg"}
# phase 5, in order: a LOBPCG path after the dense path of its pencils
MAIN_PATHS = ("geneo_dd", "geneo_lobpcg", "ring_f64", "ring_dd", "msgfem_dd",
              "msgfem_ring_f64", "hex_ov1_dd", "hex_ov2_f64", "hex_ov2_lobpcg",
              "hex_ov2_dd", "elast_f64", "elast_dd", "unstr_f64",
              "unstr_lobpcg", "unstr_dd", "dg_f64", "dg_dd", "p2_geneo_dd")
# (dense path, LOBPCG path) on the same pencils, for the A/B lines
GEVP_AB = [("geneo_dd", "geneo_lobpcg"), ("unstr_f64", "unstr_lobpcg"),
           ("hex_ov2_f64", "hex_ov2_lobpcg")]
# problem kind -> (size, decomposition) at full and at small size: cells per
# axis and parts, except for the L-shape (refinements of its mesh file and
# the number of RCB subdomains) and the tet bar (fixed cells, RCB)
FULL = {"islands": (384, (16, 16)), "hex": (56, (8, 8, 8)),
        "elast": (256, (16, 16)), "unstr": (4, 128), "dg": (192, (12, 12)),
        "p2": (192, 256)}
SMALL = {"islands": (32, (4, 4)), "hex": (12, (2, 2, 2)),
         "elast": (32, (4, 4)), "unstr": (1, 8), "dg": (16, (2, 2)),
         "tet": ((8, 2, 3), 4), "p2": (16, 8)}
# the nonlinear example (BASELINE config 5's problem) with its shipped ini
NEWTON_INI = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "ddm_tpu_torch", "examples", "configs",
                          "nonlinearpoisson.ini")
P2_ARGS = ["-degree", "2", "-simplex", "true"]
DD_COARSE = ["-coarse_solver.precision", "dd"]
# path -> (cells per axis, RCB subdomains, further -key value arguments)
NEWTON_PATHS = {"newton_q1_f64": (384, 256, []),
                "newton_p2_f64": (192, 256, P2_ARGS),
                "newton_p2_dd": (192, 256, P2_ARGS + DD_COARSE)}
# phase 4: (label, cells, parts or RCB count, arguments, dd on the card)
NEWTON_SMALL = [("newton_q1_dd", 16, (2, 2), [], True),
                ("newton_p2_dd", 8, 4, P2_ARGS, True),
                ("config5_f64", 64, 16, [], False)]
LSHAPE_CELLS = 22  # coarse L-shape: 22 x 22 cells, the 11 x 11 quadrant removed

# the example drivers through the user's command line, examples/cli.main,
# with the shipped inis and scripted coefficient files
EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "ddm_tpu_torch", "examples")
POISSON_INI = os.path.join(EXAMPLES, "configs", "poisson.ini")
ELAST_INI = os.path.join(EXAMPLES, "configs", "linearelasticity.ini")
COEFF = {name: os.path.join(EXAMPLES, "coefficients", f"{name}_coefficient.py")
         for name in ("poisson", "elasticity",
                      "symmetric_convection_diffusion")}
DD_ARGS = ["-schwarz.subdomain_solver.precision", "dd",
           "-coarse_solver.precision", "dd"]
F32_ARGS = ["-schwarz.subdomain_solver.precision", "f32"]
# The dd islands paths under poisson.ini run flexible GMRES: with the dd
# precisions, left-preconditioned GMRES(100) does not reach the ini's 1e-10
# at scale in the JAX package (CPU, x64: 10 iterations at 32^2/16, 24 at
# 64^2/16, and at 128^2/64 not within 1000, its estimate stalled at
# 2.2e-10), while flexible GMRES takes 7 at all three sizes, as its f64 run
FGMRES_ARGS = ["-solver.type", "restartedflexiblegmressolver"]
# cli consumes the first -problem; the second reaches the Poisson example
# as its problem key
SIMPLE_ARGS = ["-problem", "simple", "-solver.reduction", "1e-8",
               "-visualise", "false"]


def poisson_ini_argv(size, n_sub, *args):
    """cli's Poisson example under the shipped poisson.ini (islands,
    multiplicative restricted Schwarz + GenEO nev 8, GMRES(100) to 1e-10),
    ``size``^2 cells, ``n_sub`` RCB subdomains, then ``args``."""
    return ["-problem", "poisson", "-ini_file", POISSON_INI, "-gridsize",
            str(size), "-subdomains", str(n_sub)] + list(args)


def elast3d_argv(cells, slabs, *args):
    """cli's elasticity example under the shipped linearelasticity.ini
    (overlap 2, GMRES(50) to 1e-6, GenEO nev 6, LU) on the bar
    [0,10]x[0,1]x[0,1.5] with ``cells``, ``slabs`` subdomains along x, the
    scripted steel-rubber coefficients, then ``args``."""
    return (["-problem", "elasticity", "-ini_file", ELAST_INI]
            + [a for axis, c in zip("xyz", cells)
               for a in (f"-cells_{axis}", str(c))]
            + ["-subdomains_x", str(slabs), "-coefficient_file",
               COEFF["elasticity"]] + list(args))


# phase 4: (label, command line, how far apart the card's and the CPU's
# iteration counts may lie); each runs on the card and on the CPU.  f32:
# the f32 sums of the card and of the CPU run in different orders, so
# their counts may differ by one (the solutions are still held to
# SOLUTION_TOL)
CLI_SMALL = [
    ("poisson.ini 32^2/16 scripted f64",
     poisson_ini_argv(32, 16, "-coefficient_file", COEFF["poisson"],
                      "-visualise", "false"), 0),
    ("poisson.ini 32^2/16 scripted dd",
     poisson_ini_argv(32, 16, "-coefficient_file", COEFF["poisson"],
                      "-visualise", "false", *DD_ARGS, *FGMRES_ARGS), 0),
    # RCB cuts the square into the (2, 2) blocks of
    # tests/test_misc.py:test_modify_subdomain_matrix_converges
    ("modify_subdomain_matrix simple 32^2/4",
     ["-problem", "poisson", "-gridsize", "32", "-subdomains", "4",
      "-modify_subdomain_matrix", "true", "-visualise", "false"], 0),
    ("poisson.ini simple 32^2/16 f32",
     poisson_ini_argv(32, 16, *SIMPLE_ARGS, *F32_ARGS), 1),
    ("elasticity 8x2x3 / 2 slabs scripted", elast3d_argv((8, 2, 3), 2), 0),
    ("dg 16^2/4 symmetric scripted",
     ["-problem", "dg", "-gridsize", "16", "-subdomains", "4",
      "-coefficient_file", COEFF["symmetric_convection_diffusion"]], 0),
]
# phase 5: the full-size example paths, in order (each dd or f32 path after
# the f64 path it is held to)
CLI_PATHS = {
    "poisson_ini_f64": lambda: poisson_ini_argv(
        384, 256, "-vtk_filename", os.path.join(tmp_dir(), "poisson_ini.vtu")),
    "poisson_ini_dd": lambda: poisson_ini_argv(
        384, 256, "-coefficient_file", COEFF["poisson"], *DD_ARGS,
        *FGMRES_ARGS, "-visualise", "false"),
    "poisson_simple_f64": lambda: poisson_ini_argv(384, 256, *SIMPLE_ARGS),
    "poisson_simple_f32": lambda: poisson_ini_argv(384, 256, *SIMPLE_ARGS,
                                                   *F32_ARGS),
    "elast3d_f64": lambda: elast3d_argv((80, 8, 12), 40),
    "elast3d_dd": lambda: elast3d_argv((80, 8, 12), 40, *DD_ARGS),
}
# Limits of the example paths, from the JAX package's examples on the CPU
# with x64 (PERF.md section 2).  poisson.ini (islands, 1e-10): 9, 8, 8, 8
# iterations at 32^2/16, 64^2/16, 96^2/36, 128^2/64, so at most 9 + 2; its
# true relative residual over the preconditioned reduction it stopped at
# was 2.23, 0.18, 1.23, 0.34 there, so the true residual must lie within
# 2.24 x the ini's 1e-10.  simple at 1e-8: 6 iterations at all four sizes,
# so at most 6 + 2; its ratio grows as gridsize^2 (left preconditioning:
# 55.7, 207.5, 462.5, 948.8, i.e. 0.0544, 0.0507, 0.0502, 0.0579 x
# gridsize^2), so the true residual must lie within 0.058 x 384^2 x 1e-8.
# The bar under linearelasticity.ini (GMRES(50) to 1e-6): the JAX package
# takes 20 iterations at 80x4x6 / 40 slabs and 19 at 80x6x9 / 40 (there no
# quadrature point falls inside the steel bars), 22 at 40x8x12 / 20 and 32
# at 60x8x12 / 30 (6 and 9 slabs cut the steel; 11.7 GB resident on the
# CPU at 30 slabs), and the port the same counts on the CPU.  The full
# size, 12 slabs cutting steel, has no run of the JAX package; there the
# port takes 45 on the host's CPU (triangular LU factors) and on the card
# (explicit inverses) alike (--witness), so the bar is held to 45 + 2.
# Left-preconditioned GMRES leaves the elasticity system's true residual
# far above its target (the JAX package: 6.66e-2 at 16x4x6 / 4 slabs,
# 2.90e-2 at 80x4x6 / 40, 8.11e-2 at 80x6x9 / 40, rising with the
# cross-section), so the bar is held instead to the residual GMRES
# controls: the preconditioned one, recomputed from the solution, within
# the ini's 1e-6 (on the CPU the port's recomputed value equals the
# solver's estimate to 6 digits at 16x4x6 / 4 and 40x4x6 / 20); its true
# residual is printed.  Each dd or f32 path: its f64 path's count in this
# run + 2 (set when that path has run), and the f64 path's residual limit.
MAX_ITERS.update({"poisson_ini_f64": 9 + 2, "poisson_simple_f64": 6 + 2,
                  "elast3d_f64": 45 + 2})
CLI_TRUE_RES_MAX = {"poisson_ini": 2.24 * 1e-10,
                    "poisson_simple": 0.058 * 384**2 * 1e-8}
ELAST3D_PREC_RES_MAX = 1e-6  # linearelasticity.ini's solver.reduction


def fail(msg):
    raise RuntimeError(msg)


# (eigenvalues, kept mask) of each GenEO GEVP of the current run, on the
# device, appended by the wrapper that record_gevp installs
GEVP_OUT = []


def record_gevp():
    """Wrap the GenEO coarse space's call of the eigensolver dispatch so that
    every run keeps its eigenvalues and kept masks (on the device: no added
    synchronization) for the dense-against-LOBPCG comparison; the solve
    itself is unchanged."""
    from ddm_tpu_torch.coarse import geneo

    solve = geneo.solve_gevp

    def recorded(*args, **kwargs):
        lam, V, active = solve(*args, **kwargs)
        GEVP_OUT.append((lam.clone(), active.clone()))
        return lam, V, active

    geneo.solve_gevp = recorded


def rel_err(y, ref):
    return float((y - ref).abs().max() / ref.abs().max())


def write_lshape_msh(path, cells=LSHAPE_CELLS):
    """The L-shape [0,1]^2 minus (0.5,1]^2 as a gmsh v2.2 ASCII file: the
    triangles of a cells x cells simplex grid outside the removed quadrant
    (the reader drops the nodes no triangle uses).  Returns the number of
    triangles."""
    from ddm_tpu_torch.fem.grids import structured_grid

    g = structured_grid((cells, cells), simplex=True)
    c = g.elem_centroids()
    tris = g.elems[~((c[:, 0] > 0.5) & (c[:, 1] > 0.5))]
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes",
             str(g.n_nodes)]
    lines += [f"{k + 1} {float(x)!r} {float(y)!r} 0.0"
              for k, (x, y) in enumerate(g.nodes)]
    lines += ["$EndNodes", "$Elements", str(len(tris))]
    lines += [f"{k + 1} 2 2 0 1 {a + 1} {b + 1} {c_ + 1}"
              for k, (a, b, c_) in enumerate(tris)]
    lines.append("$EndElements")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return len(tris)


_TMP_DIR = []


def tmp_dir():
    """A temporary directory, made on first use and removed when the
    process ends (the L-shape mesh file, the example's VTK output)."""
    if not _TMP_DIR:
        _TMP_DIR.append(tempfile.TemporaryDirectory(prefix="chip_smoke_"))
    return _TMP_DIR[0].name


def lshape_file():
    """The L-shape mesh file, written on first use."""
    path = os.path.join(tmp_dir(), "lshape.msh")
    if not os.path.exists(path):
        n = write_lshape_msh(path)
        print(f"L-shape mesh: {n} triangles written to a gmsh v2.2 file",
              flush=True)
    return path


def path_ptree(api, path, size, reduction=1e-8):
    kind, coarse, overlap, keys = PATHS[path]
    if kind == "dg":
        from ddm_tpu_torch.examples.convectiondiffusiondg import dg_ptree

        pt = dg_ptree([])  # the example's settings: LU, nev 6, standard POU
    else:
        pt = api.default_ptree()
        pt["problem"] = "islands"
        pt[f"{coarse}.eigensolver.nev"] = 8
        pt["coarse_solver.type"] = "lu" if kind == "tet" else "cholesky"
    if kind == "unstr":
        pt["meshfile"] = lshape_file()
        pt["refine"] = size
    else:
        pt["gridsize"] = size
    pt["overlap"] = overlap
    if kind == "dg":
        # unscaled, the 1e7 diffusion contrast puts the residual floor of
        # an exact f64 solve at 1.6e-7 (96^2) and above: read it scaled
        pt["equilibrate"] = True
    if kind in ("elast", "tet", "dg"):
        # left-preconditioned GMRES converges in the preconditioned norm
        # only: these preconditioners distort norms by the coefficient
        # contrast (the DG paths' true residual stays at 1e-4 there)
        pt["solver.type"] = "restartedflexiblegmressolver"
    pt["solver.reduction"] = reduction
    pt["solver.restart"] = 50
    pt["solver.maxit"] = 400
    pt["solver.verify"] = True
    pt["coarsespace.type"] = coarse
    for k, v in keys.items():
        pt[k] = v
    return pt


def path_problem(api, path, size, parts, device, reduction=1e-8):
    """The problem of one path through its entry point: ``setup_problem``
    for the islands problem on the unit square or cube or on the L-shape
    mesh file (``parts`` an int: that many RCB subdomains), the
    steel-rubber strip on [0,3]x[0,1] or the bar on Kuhn tetrahedra with
    one displacement component per axis; the DG example's ``setup``."""
    from ddm_tpu_torch.fem import problems
    from ddm_tpu_torch.fem.grids import structured_grid

    kind = PATHS[path][0]
    pt = path_ptree(api, path, size, reduction)
    if kind == "dg":
        from ddm_tpu_torch.examples.convectiondiffusiondg import setup

        return setup(pt, device, parts=parts)
    if kind == "elast":
        grid = structured_grid((size, size), (0, 0), (3.0, 1.0))
        return api.setup_problem(pt, problem=problems.steel_rubber_2d(),
                                 grid=grid, parts=parts, n_comp=2,
                                 device=device)
    if kind == "tet":
        grid = structured_grid(size, (0, 0, 0), (10.0, 1.0, 1.5),
                               simplex=True)
        return api.setup_problem(pt, problem=problems.steel_rubber_bar(),
                                 grid=grid, n_sub=parts, n_comp=3,
                                 device=device)
    if kind == "unstr":
        return api.setup_problem(pt, grid=api.make_grid(pt), n_sub=parts,
                                 device=device)
    if kind == "p2":
        return p2_problem(api, pt, size, parts, device)
    return api.setup_problem(pt, grid=api.make_grid(pt, dim=len(parts)),
                             parts=parts, device=device)


def p2_problem(api, pt, size, n_sub, device):
    """Islands on P2 triangles, size^2 cells, ``n_sub`` RCB subdomains,
    Jacobi-equilibrated: the steps of ``setup_problem`` (which takes no
    degree) by hand, in its scopes, as tests/test_p2.py builds it."""
    from ddm_tpu_torch.core.indexmaps import pou_weights
    from ddm_tpu_torch.core.setup import setup_topology
    from ddm_tpu_torch.core.sparse import jacobi_equilibrate
    from ddm_tpu_torch.fem import problems
    from ddm_tpu_torch.fem.discretize import Discretization
    from ddm_tpu_torch.fem.grids import structured_grid
    from ddm_tpu_torch.obs.logger import scoped

    with scoped("Setup", "discretize (host pattern)", device):
        disc = Discretization(structured_grid((size, size), simplex=True),
                              problems.islands(), device, degree=2)
    with scoped("Setup", "assemble + constrain", device):
        A, rhs, g = disc.constrained_system()
    with scoped("Setup", "equilibrate", device):
        A, rhs, scale = jacobi_equilibrate(A, rhs)
    with scoped("Setup", "topology (host)"):
        topo, elem_part = setup_topology(disc, overlap=pt.get("overlap", 2),
                                         n_sub=n_sub)
    with scoped("Setup", "pou (host)"):
        pou = pou_weights(topo, "distance")
    return api.DDMProblem(disc=disc, topo=topo, A=A, rhs=rhs, g=g, pou=pou,
                          ptree=pt, device=device, elem_part=elem_part,
                          scale=scale)


def size_label(path, size, parts):
    kind = PATHS[path][0]
    if kind == "unstr":
        return f"L-shape refine {size} / {parts} RCB"
    if kind == "tet":
        return f"tet bar {size[0]}x{size[1]}x{size[2]} / {parts} RCB"
    if kind == "p2":
        return f"P2 {size}^2 / {parts} RCB"
    return f"{size}^{len(parts)}/{math.prod(parts)}"


def run_path(path, size, parts, device, reduction=1e-8):
    """Drive one path once through the entry points, with the kernel's
    launch counts and the ring's route counts zeroed just before and read
    just after.  Returns a dict of the run's objects and counts."""
    from ddm_tpu_torch import api
    from ddm_tpu_torch.coarse import ring
    from ddm_tpu_torch.eigen import lobpcg
    from ddm_tpu_torch.kernels import ddmatvec
    from ddm_tpu_torch.obs.logger import Logger

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    Logger.reset()
    ddmatvec.dd_matvec_cuda.shapes.clear()
    for k in ring.ROUTES:
        ring.ROUTES[k] = 0
    lobpcg.RUNS.clear()
    GEVP_OUT.clear()
    t0 = time.perf_counter()
    p = path_problem(api, path, size, parts, device, reduction)
    M = api.build_preconditioner(p)
    res = api.solve(p, M)
    u = api.solution(p, res)
    if cuda:
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    shapes = dict(ddmatvec.dd_matvec_cuda.shapes)
    log = Logger.get()
    peak = max(log.peak_bytes, torch.cuda.max_memory_allocated(device)) if cuda else 0
    out = dict(
        p=p, M=M, res=res, u=u, secs=secs,
        launches=sum(shapes.values()), shapes=shapes,
        fine_applies=M.precs[0].applies, coarse_applies=M.precs[1].applies,
        routes=dict(ring.ROUTES), lobpcg=[dict(run) for run in lobpcg.RUNS],
        eig=[(lam.cpu(), act.cpu()) for lam, act in GEVP_OUT],
        events={k: v.total for k, v in log.events.items()},
        peaks={k: v.peak_bytes / 2**30 for k, v in log.events.items()},
        peak_gib=peak / 2**30,
    )
    out["true_res"] = float(torch.linalg.norm(p.A.mv(res.x) - p.rhs)
                            / torch.linalg.norm(p.rhs))
    return out


def newton_argv(size, n_sub, args, dd=False):
    """The example's command line: the shipped ini, ``size``^2 cells,
    ``n_sub`` subdomains, ``args``, and with ``dd`` the dd coarse solve."""
    return (["-ini_file", NEWTON_INI, "-gridsize", str(size), "-subdomains",
             str(n_sub)] + list(args) + (DD_COARSE if dd else []))


def run_newton(argv, device, parts=None):
    """One Newton solve of the nonlinear example through its ``main`` (or,
    with ``parts``, its ``setup`` on that block partition and the solver's
    ``solve``), with the kernel's launch counts zeroed just before and read
    just after; then a fresh residual of the solution.  Returns a dict of
    the run's objects and counts."""
    from ddm_tpu_torch.examples import nonlinearpoisson as example
    from ddm_tpu_torch.kernels import ddmatvec
    from ddm_tpu_torch.obs.logger import Logger

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    Logger.reset()
    ddmatvec.dd_matvec_cuda.shapes.clear()
    t0 = time.perf_counter()
    if parts is None:
        solver, res = example.main(argv, device)
    else:
        solver = example.setup(example.nonlinear_ptree(argv), device, parts)
        res = solver.solve()
    if cuda:
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    shapes = dict(ddmatvec.dd_matvec_cuda.shapes)
    log = Logger.get()
    peak = max(log.peak_bytes, torch.cuda.max_memory_allocated(device)) if cuda else 0
    r, _ = solver.disc.residual_jacobian(res.u)
    return dict(solver=solver, res=res, secs=secs, shapes=shapes,
                launches=sum(shapes.values()), peak_gib=peak / 2**30,
                fresh=float(torch.linalg.norm(r)),
                events={k: v.total for k, v in log.events.items()})


def check_newton(path, run, r, dd):
    """Print one Newton run's counts, defect history, per-step split, peak
    and launches; raise unless it converged, its solution's fresh residual
    meets the Newton target, and it launched the kernel exactly where the
    dd coarse solve must (3 launches per coarse apply)."""
    solver, res = r["solver"], r["res"]
    topo, steps = solver.topo, solver.steps
    reduction = solver.ptree.get("newton.Reduction", 1e-8)
    ev = r["events"]
    split = ", ".join(f"{label} {ev[key]:.3f} s" for key, label in (
        (("Driver", "Setup problem"), "setup"),
        (("Newton", "extraction map (host)"), "extraction map"),
        (("Newton", "residual + Jacobian"), "residual + Jacobian"))
        if key in ev)
    print(f"{path} ({run}): n_dofs {solver.disc.n_dofs}, n_sub {topo.n_sub}, "
          f"n_pad {topo.n_pad}, Newton {res.iterations} its (converged "
          f"{res.converged}), inner {res.linear_iterations} = "
          f"{[x['inner'] for x in steps]}, defects "
          f"{[float(f'{d:.6e}') for d in res.history]}, fresh residual "
          f"{r['fresh']:.3e} (limit {reduction * res.defect0:.3e}), "
          f"{split}, total {r['secs']:.3f} s, peak mem {r['peak_gib']:.2f} GiB, "
          f"dd_matvec launches {r['launches']} by shape {r['shapes']}",
          flush=True)
    for k, x in enumerate(steps, start=1):
        print(f"{path} ({run}) step {k}: inner {x['inner']} (reduction "
              f"{x['reduction']:.3e}), extract {x['extract']:.3f} s, factor "
              f"{x['factor']:.3f} s, galerkin {x['galerkin']:.3f} s, "
              f"bicgstab {x['krylov']:.3f} s, applies {x['fine_applies']} "
              f"fine + {x['coarse_applies']} coarse", flush=True)
    u = res.u
    if not (res.converged and r["fresh"] <= reduction * res.defect0
            and u.shape == (solver.disc.n_dofs,)
            and bool(torch.isfinite(u).all())):
        fail(f"{path} did not converge as required")
    want = {}
    if dd:
        V = solver.prec.precs[1].V
        n_c = V.shape[0] * V.shape[1]
        want[(1, n_c, n_c)] = 3 * sum(x["coarse_applies"] for x in steps)
    if not (r["shapes"] == want and all(want.values())):
        fail(f"{path} did not run through the dd_matvec kernel as expected: "
             f"{r['shapes']} != {want}")


def run_cli(argv, device):
    """One run of ``examples/cli.main`` with ``argv`` on ``device``, with
    the kernel's launch counts zeroed just before and read just after;
    the example's timing table goes to stderr.  Returns a dict of the run's
    objects and counts, as run_path does."""
    from ddm_tpu_torch import api
    from ddm_tpu_torch.examples import cli
    from ddm_tpu_torch.kernels import ddmatvec
    from ddm_tpu_torch.obs.logger import Logger

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    ddmatvec.dd_matvec_cuda.shapes.clear()
    t0 = time.perf_counter()
    p, res = cli.main(list(argv), device)
    u = api.solution(p, res)
    if cuda:
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    shapes = dict(ddmatvec.dd_matvec_cuda.shapes)
    M = p.prec  # the preconditioner the example built
    precs = getattr(M, "precs", (M,))
    log = Logger.get()
    peak = max(log.peak_bytes, torch.cuda.max_memory_allocated(device)) if cuda else 0
    r = p.rhs - p.A.mv(res.x)
    out = dict(
        p=p, M=M, precs=precs, res=res, u=u, secs=secs,
        launches=sum(shapes.values()), shapes=shapes,
        fine_applies=precs[0].applies,
        coarse_applies=precs[1].applies if len(precs) > 1 else 0,
        events={k: v.total for k, v in log.events.items()},
        peaks={k: v.peak_bytes / 2**30 for k, v in log.events.items()},
        peak_gib=peak / 2**30,
        true_res=float(torch.linalg.norm(r) / torch.linalg.norm(p.rhs)),
        prec_res=float(torch.linalg.norm(M.apply(r))
                       / torch.linalg.norm(M.apply(p.rhs))),
    )
    return out


def cli_dd_launches(argv, r):
    """dd_matvec launches by shape that a run of ``argv`` on the card must
    make: 3 per dd apply at the fine and at the coarse shape (none on the
    CPU, where the wrapper runs the kernel's plain version)."""
    p, precs = r["p"], r["precs"]
    want = {}
    if p.device.type != "cuda":
        return want
    if "-schwarz.subdomain_solver.precision" in argv and argv[
            argv.index("-schwarz.subdomain_solver.precision") + 1] == "dd":
        want[(p.topo.n_sub, p.topo.n_pad, p.topo.n_pad)] = 3 * r["fine_applies"]
    if "-coarse_solver.precision" in argv and r["coarse_applies"]:
        V = precs[1].V
        n_c = V.shape[0] * V.shape[1]
        want[(1, n_c, n_c)] = 3 * r["coarse_applies"]
    return want


DRIVER = [(("Driver", "Setup problem"), "setup problem"),
          (("Driver", "Setup preconditioner"), "setup preconditioner"),
          (("Driver", "Linear solve"), "linear solve"),
          (("Driver", "Visualisation"), "visualisation"),
          (("Total", "total time"), "driver total")]


def check_cli_path(path, run, r, argv):
    """Print one full-size example run's driver and phase split, peaks and
    counts; raise unless it converged within its limits and ran the kernel
    (dd) or the f32 inverse (f32) where it must."""
    from ddm_tpu_torch.solvers.direct import SparseRefinedInverse

    p, res, ev = r["p"], r["res"], r["events"]
    kind = path.rsplit("_", 1)[0]
    print(f"{path} ({run}): driver " + ", ".join(
        f"{label} {ev[key]:.3f} s" for key, label in DRIVER if key in ev)
        + "; " + ", ".join(f"{k} {v:.3f} s"
                           for k, v in phase_split(ev).items())
        + f", total {r['secs']:.3f} s, peak mem {r['peak_gib']:.2f} GiB",
        flush=True)
    setup_peak = max(v for (fam, _), v in r["peaks"].items() if fam == "Setup")
    print(f"{path} ({run}): peak GiB by phase: setup_problem "
          f"{setup_peak:.2f}, " + ", ".join(
              f"{label} {r['peaks'][key]:.2f}" for key, label in PHASES
              if key in r["peaks"]), flush=True)
    print(f"{path} ({run}): n_dofs {p.disc.n_dofs}, n_sub {p.topo.n_sub}, "
          f"n_pad {p.topo.n_pad}, iterations {res.iterations}, converged "
          f"{res.converged}, true rel residual {r['true_res']:.3e}, "
          f"recomputed preconditioned reduction {r['prec_res']:.3e}, "
          f"dd_matvec launches {r['launches']} by shape {r['shapes']}, "
          f"applies {r['fine_applies']} fine + {r['coarse_applies']} coarse",
          flush=True)
    if kind == "elast3d":
        within = r["prec_res"] <= ELAST3D_PREC_RES_MAX
    else:
        within = r["true_res"] <= CLI_TRUE_RES_MAX[kind]
    if not (res.converged and within and res.iterations <= MAX_ITERS[path]
            and r["u"].shape == (p.disc.n_dofs,)
            and bool(torch.isfinite(r["u"]).all())):
        fail(f"{path} did not converge as required")
    want = cli_dd_launches(argv, r)
    if not (r["shapes"] == want and all(want.values())):
        fail(f"{path} did not run through the dd_matvec kernel as expected: "
             f"{r['shapes']} != {want}")
    factors = r["precs"][0].factors
    if path.endswith("f32") != isinstance(factors, SparseRefinedInverse) or (
            path.endswith("f32") and not (factors.inv32.dtype == torch.float32
                                          and factors.inv32.device == p.device)):
        fail(f"{path}: fine level {type(factors).__name__}, expected the f32 "
             f"inverse exactly on the f32 path")


def profile_cli(path):
    """--profile for an example path: one run to warm up, then one in
    which the example's calls of ``setup_problem``, ``build_preconditioner``
    and ``solve`` each run under their own profiler window."""
    import importlib

    dev = torch.device("cuda", 0)
    argv = CLI_PATHS[path]()
    run_cli(argv, dev)
    name = "linearelasticity" if path.startswith("elast3d") else "poisson"
    driver = importlib.import_module(f"ddm_tpu_torch.examples.{name}")
    saved = {}
    for fn in ("setup_problem", "build_preconditioner", "solve"):
        saved[fn] = orig = getattr(driver, fn)
        setattr(driver, fn, lambda *a, _f=orig, _n=fn, **kw: profiled(
            _n, lambda: _f(*a, **kw)))
    print(f"{path} (warm, profiled):", flush=True)
    try:
        r = run_cli(argv, dev)
    finally:
        for fn, orig in saved.items():
            setattr(driver, fn, orig)
    print(f"  iterations {r['res'].iterations}, converged "
          f"{r['res'].converged}", flush=True)


PHASES = [(("Schwarz", "extract"), "extract"),
          (("Schwarz", "factorise"), "factorise"),
          (("Eigensolver", "assemble Neumann"), "neumann"),
          (("Eigensolver", "harmonic basis"), "harmonic_basis"),
          (("Eigensolver", "reduced pencil"), "reduced_pencil"),
          (("Eigensolver", "solve GEVP"), "gevp"),
          (("Eigensolver", "constraint solve"), "constraint"),
          (("Eigensolver", "extension"), "extension"),
          (("GalerkinPrec", "build Matrix"), "coarse_matrix"),
          (("GalerkinPrec", "factor A0"), "coarse_factor"),
          (("Solver", "solve"), "solve")]


def phase_split(ev):
    split = {"setup_problem": sum(v for (fam, _), v in ev.items()
                                  if fam == "Setup")}
    for key, label in PHASES:
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


def f64_product(hi, lo, d, absolute=False):
    """(hi + lo) @ d in f64, or with ``absolute`` (|hi| + |lo|) |d|, over
    slabs of 64 matrices (1.5 GB of f64 at 1728^2 each)."""
    q = d.shape[1]
    out = []
    for i in range(0, d.shape[0], 64):
        h, l = hi[i:i + 64, :q, :q], lo[i:i + 64, :q, :q]
        x = d[i:i + 64]
        if absolute:
            h, l, x = h.abs(), l.abs(), x.abs()
        m = h.double()
        m += l
        out.append((m @ x[..., None])[..., 0])
        del m
    return torch.cat(out)


def plain_rounding(q):
    """Worst-case |plain - exact| / ((|hi| + |lo|) |d|) of one row: the
    plain version's f32 sums of q products err by at most
    gamma_q = q u / (1 - q u) of the sum of their magnitudes, in any order
    of summation (u = 2^-24); its f32 add of the two lo-order sums, the lo
    dl term it drops, d's split and the f64 kernel's own error stay within
    one more u, hence gamma_(q+1)."""
    n = q + 1
    return n * U32 / (1 - n * U32)


def plan_str(pl):
    cluster = f"clusters of {pl.chunks}" if pl.chunks > 1 else "no cluster"
    return (f"{pl.rows} rows x {pl.chunks} chunk(s) of {pl.cols} cols, "
            f"{cluster}, {pl.blocks} blocks")


def check_kernel(ddmatvec, hi, lo, d, label):
    """Kernel against its plain version, row by row within the plain
    version's rounding bound, and against the f64 product of the same
    hi/lo; returns the largest absolute difference from the plain version
    and the launch plan the kernel took."""
    y = ddmatvec.dd_matvec_cuda(hi, lo, d)
    ref = ddmatvec.dd_matvec_reference(hi, lo, d)
    n_sub, q = d.shape
    pl = ddmatvec.plan(n_sub, q, ddmatvec.sm_count(d.device))
    scale = f64_product(hi, lo, d, absolute=True)
    # a row of zero magnitudes gives 0 from both versions
    e_plain = float(((y - ref).abs()
                     / scale.clamp(min=torch.finfo(scale.dtype).tiny)).max())
    bound = plain_rounding(q)
    e_f64 = rel_err(y, f64_product(hi, lo, d))
    print(f"kernel {label} {tuple(hi.shape)} q={q} [{plan_str(pl)}]: err vs "
          f"plain {e_plain:.3e} of (|hi|+|lo|)|d| (rounding bound "
          f"{bound:.3e}), rel err vs f64 {e_f64:.3e}", flush=True)
    if not (e_plain <= bound and e_f64 <= KERNEL_VS_F64_TOL):
        fail(f"dd_matvec kernel disagrees with its plain version ({label})")
    return float((y - ref).abs().max()), pl


def is_lobpcg(path):
    return any(k.endswith("eigensolver.type") and v == "lobpcg"
               for k, v in PATHS[path][3].items())


def misses_only_iterations(path, r):
    """A LOBPCG path that converged to its residual but over its iteration
    limit (the case that is rerun at LOBPCG_RETRY_TOL)."""
    return (is_lobpcg(path) and r["res"].converged
            and r["true_res"] <= TRUE_RES_MAX[PATHS[path][0]]
            and r["res"].iterations > MAX_ITERS[path])


def check_path(path, run, r):
    """Print one full-size run's phase split, peaks and counts; raise
    unless it converged as required and launched the kernel where its path
    must."""
    p, res, M = r["p"], r["res"], r["M"]
    kind, _, _, keys = PATHS[path]
    print(f"{path} ({run}): " + ", ".join(
        f"{k} {v:.3f} s" for k, v in phase_split(r["events"]).items())
        + f", total {r['secs']:.3f} s, peak mem {r['peak_gib']:.2f} GiB",
        flush=True)
    setup_peak = max(v for (fam, _), v in r["peaks"].items() if fam == "Setup")
    print(f"{path} ({run}): peak GiB by phase: setup_problem "
          f"{setup_peak:.2f}, " + ", ".join(
              f"{label} {r['peaks'][key]:.2f}" for key, label in PHASES
              if key in r["peaks"]), flush=True)
    print(f"{path} ({run}): n_dofs {p.disc.n_dofs}, n_sub {p.topo.n_sub}, "
          f"n_pad {p.topo.n_pad}, iterations {res.iterations} (estimate met "
          f"the target at {res.estimate_hit}), converged {res.converged}, "
          f"true rel residual {r['true_res']:.3e}, dd_matvec "
          f"launches {r['launches']} by shape {r['shapes']}, applies "
          f"{r['fine_applies']} fine + {r['coarse_applies']} coarse, "
          f"extension routes {r['routes']}", flush=True)
    if r["lobpcg"]:
        print(f"{path} ({run}): LOBPCG over {len(r['lobpcg'])} slab(s): "
              + "; ".join(f"slab {i}: widths {x['widths']}, iterations "
                          f"{x['iterations']}, escalations "
                          f"{len(x['widths']) - 1}"
                          for i, x in enumerate(r["lobpcg"])), flush=True)
    if bool(r["lobpcg"]) != is_lobpcg(path):
        fail(f"{path} ran LOBPCG {len(r['lobpcg'])} times, expected "
             f"{'some' if is_lobpcg(path) else 'none'}")
    if not (res.converged and r["true_res"] <= TRUE_RES_MAX[kind]
            and res.iterations <= MAX_ITERS[path]):
        fail(f"{path} did not converge as required")
    if kind == "elast" and not 0 < res.estimate_hit <= ESTIMATE_HIT_MAX:
        fail(f"{path}: the Givens estimate met the target at iteration "
             f"{res.estimate_hit}, limit {ESTIMATE_HIT_MAX}")
    if not (r["u"].shape == (p.disc.n_dofs,) and bool(torch.isfinite(r["u"]).all())):
        fail("solution is not a finite vector of n_dofs entries")
    n_pad, n_c = p.topo.n_pad, M.precs[1].V.shape[0] * M.precs[1].V.shape[1]
    want = {}  # dd_matvec launches by shape: 3 per dd apply
    if keys.get("schwarz.subdomain_solver.precision") == "dd":
        want[(p.topo.n_sub, n_pad, n_pad)] = 3 * r["fine_applies"]
    if keys.get("coarse_solver.precision") == "dd":
        want[(1, n_c, n_c)] = 3 * r["coarse_applies"]
    if not (r["shapes"] == want and all(want.values())):
        fail(f"{path} did not run through the dd_matvec kernel as expected: "
             f"{r['shapes']} != {want}")
    if path == "ring_f64" and not r["routes"]["pcg"] >= 1:
        fail("ring_f64 did not take the PCG extension route")
    if path == "ring_dd" and not r["routes"]["direct"] >= 1:
        fail("ring_dd did not take the direct extension route")


def time_kernel(ddmatvec, path, precs, shapes, flush_buf, gen,
                levels=("fine", "coarse")):
    """The kernel against its plain version and the f64 product at the
    shapes of a dd path (of its ``levels``), on that path's own inverses
    (``precs``: its fine and coarse preconditioners), with CUDA-event
    times; ``shapes`` holds the path's launches by shape.  Returns one
    entry per shape for the kernels line."""
    fine, coarse = precs
    entries = []
    for label, fac in (("fine", fine.factors), ("coarse", coarse.coarse)):
        if label not in levels or not hasattr(fac, "inv_hi"):
            continue
        hi, lo = fac.inv_hi, fac.inv_lo
        n_sub, P, _ = hi.shape
        dv = torch.randn((n_sub, P), generator=gen, device=hi.device,
                         dtype=torch.float64)
        abs_err, pl = check_kernel(ddmatvec, hi, lo, dv, f"{path} {label}")
        # a coarse inverse may fit in the 50 MB L2 (33.6 MB at n_c 2048),
        # but the solve reads it after the fine level's gigabytes: flush
        flush = flush_buf.zero_ if label == "coarse" else None
        reps = 20 if n_sub * P * P < 2**29 else 5
        ms = time_ms(lambda: ddmatvec.dd_matvec_cuda(hi, lo, dv), reps=reps,
                     flush=flush)
        plain_ms = time_ms(lambda: ddmatvec.dd_matvec_reference(hi, lo, dv),
                           reps=reps, flush=flush)
        inv64 = hi.double()  # the same bytes as hi + lo
        inv64 += lo
        f64_ms = time_ms(lambda: torch.bmm(inv64, dv[..., None]), reps=reps,
                         flush=flush)
        del inv64
        b_ms, b_by = bound_ms(n_sub, P)
        print(f"kernel {path} {label} {tuple(hi.shape)} [{plan_str(pl)}]: "
              f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}), {b_ms / ms:.3f} of the bound, "
              f"{8 * n_sub * P * P / ms / 1e6:.0f} GB/s of hi+lo; library "
              f"call (torch.bmm of the f64 hi + lo) {f64_ms:.4f} ms",
              flush=True)
        entries.append({
            "path": path, "shape": [n_sub, P, P],
            "launches": shapes[(n_sub, P, P)],
            "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": f64_ms,
            "share_of_bound": b_ms / ms,
            "plan": pl._asdict(),
        })
    return entries


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
    """Run ``fn`` under ``obs.logger.profile_trace`` (its Chrome trace goes
    to TRACE_DIR); print its wall and device-busy seconds, its idle share
    1 - busy / wall and its top device ops."""
    from ddm_tpu_torch.obs.logger import profile_trace

    torch.cuda.synchronize()
    with profile_trace(TRACE_DIR) as tr:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, by_name = device_busy(tr.prof)
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
        if path in CLI_PATHS:
            profile_cli(path)
            continue
        size, parts = FULL[PATHS[path][0]]
        p = path_problem(api, path, size, parts, dev)
        res = api.solve(p, api.build_preconditioner(p))
        del p, res
        print(f"{path} (warm, profiled):", flush=True)
        p = profiled("setup_problem", lambda: path_problem(
            api, path, size, parts, dev))
        M = profiled("build_preconditioner", lambda: api.build_preconditioner(p))
        res = profiled("solve", lambda: api.solve(p, M))
        print(f"  iterations {res.iterations}, converged {res.converged}",
              flush=True)
        del p, M, res


def eigh_probe(dev, gen):
    """``torch.linalg.eigh`` of LOBPCG's Rayleigh-Ritz batches (the Gram
    and the projected pencil, (n_sub, 3m, 3m) at m = 8 and, after one nev
    doubling, 16) at the main paths' slab sizes, against one batched product
    of a pencil with the trial block, with the device kernels eigh ran."""
    from torch.profiler import ProfilerActivity, profile

    for n_sub, p, k in ((256, 848, 24), (256, 848, 48), (51, 1968, 24),
                        (67, 1728, 24)):
        G = torch.randn((n_sub, k, k), generator=gen, device=dev,
                        dtype=torch.float64)
        G = G @ G.mT + k * torch.eye(k, device=dev, dtype=torch.float64)
        ms_eigh = time_ms(lambda: torch.linalg.eigh(G))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.linalg.eigh(G)
            torch.cuda.synchronize()
        _, by_name = device_busy(prof)
        kernels = sorted(by_name, key=lambda n: -by_name[n])[:3]
        A = torch.randn((n_sub, p, p), generator=gen, device=dev,
                        dtype=torch.float64)
        S = torch.randn((n_sub, p, k), generator=gen, device=dev,
                        dtype=torch.float64)
        ms_mm = time_ms(lambda: A @ S, reps=5)
        print(f"eigh ({n_sub}, {k}, {k}): {ms_eigh:.4f} ms, kernels "
              f"{[n[:60] for n in kernels]}; one product ({n_sub}, {p}, {p}) "
              f"@ ({n_sub}, {p}, {k}): {ms_mm:.4f} ms (bytes bound "
              f"{8 * n_sub * p * p / HBM_BYTES_PER_S * 1e3:.4f} ms)", flush=True)
        del A, S, G


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


def witness():
    """--witness: two full-size f64 counts that have no run of the JAX
    package at their size, each on the card and on the host's CPU (the
    port's triangular factors there, explicit inverses on the card):
    ``elast3d_f64``'s command line through ``examples/cli.main``, and
    ``unstr_f64`` through the entry points."""
    print(f"device: {torch.cuda.get_device_name(0)} | torch {torch.__version__}",
          flush=True)
    for dev in (torch.device("cuda", 0), torch.device("cpu")):
        r = run_cli(CLI_PATHS["elast3d_f64"](), dev)
        res = r["res"]
        print(f"witness elast3d_f64 on {dev.type}: iterations "
              f"{res.iterations}, estimate hit {res.estimate_hit}, converged "
              f"{res.converged}, recomputed preconditioned reduction "
              f"{r['prec_res']:.4e}, true rel residual {r['true_res']:.4e}, "
              f"{r['secs']:.1f} s", flush=True)
        del r, res
        size, parts = FULL["unstr"]
        r = run_path("unstr_f64", size, parts, dev)
        res = r["res"]
        print(f"witness unstr_f64 on {dev.type}: iterations {res.iterations}, "
              f"estimate hit {res.estimate_hit}, converged {res.converged}, "
              f"defect {res.defect:.4e} against the target "
              f"{res.defect0 * 1e-8:.4e}, true rel residual "
              f"{r['true_res']:.4e}, {r['secs']:.1f} s", flush=True)
        del r, res


def check_cli_small(dev, cpu):
    """Phase 4's example checks: each of CLI_SMALL on the card against the
    CPU."""
    for label, argv, slack in CLI_SMALL:
        g = run_cli(argv, dev)
        c = run_cli(argv, cpu)
        e_small = rel_err(g["u"].cpu(), c["u"])
        want = cli_dd_launches(argv, g)
        f32 = "f32" in argv
        print(f"small {label} (n_pad {g['p'].topo.n_pad}): card "
              f"{g['res'].iterations} its (true rel residual "
              f"{g['true_res']:.3e}), cpu {c['res'].iterations} its, solution "
              f"rel diff {e_small:.3e}, fine level "
              f"{type(g['precs'][0].factors).__name__}, launches "
              f"{g['launches']} by shape {g['shapes']}", flush=True)
        if not (g["res"].converged and c["res"].converged
                and abs(g["res"].iterations - c["res"].iterations) <= slack
                and e_small <= SOLUTION_TOL and g["shapes"] == want
                and all(want.values())
                and (type(g["precs"][0].factors).__name__
                     == "SparseRefinedInverse") == f32):
            fail(f"small {label} on the card disagrees with the CPU")
        del g, c


def run_cli_paths(dev, gen, flush_buf, launches):
    """Phase 5's example paths, cold then warm, each checked; the kernel
    timed at the dd paths' shapes.  Records each path's launches in
    ``launches``; returns the kernel entries."""
    from ddm_tpu_torch.kernels import ddmatvec

    entries = []
    for path, make_argv in CLI_PATHS.items():
        for run in ("cold", "warm"):
            r = None
            argv = make_argv()
            r = run_cli(argv, dev)
            check_cli_path(path, run, r, argv)
        if "-vtk_filename" in argv:
            vtu = argv[argv.index("-vtk_filename") + 1]
            with open(vtu) as f:
                names = sorted(set(re.findall(r'Name="([^"]+)"', f.read())))
            print(f"{path}: VTK file {os.path.getsize(vtu)} bytes, fields "
                  f"{names}", flush=True)
            os.remove(vtu)
        launches[path] = r["launches"]
        if path.endswith("_f64"):
            for other in ("_dd", "_f32"):
                MAX_ITERS[path.replace("_f64", other)] = r["res"].iterations + 2
        if "_dd" in path:
            entries += time_kernel(ddmatvec, path, r["precs"], r["shapes"],
                                   flush_buf, gen)
        r = None
    return entries


SHARDED_RANKS = 4
SHARDED_TIMEOUT_S = 300  # one collective; a rank that diverges ends the run


def sharded_rank(rank, world, init_method, out_dir, device, size, parts,
                 stages=False):
    """One rank of phase 7: ``ring_dd`` at ``size``/``parts`` through
    ``build_preconditioner(p, mesh=)`` and ``solve(p, mesh=)``, with the
    kernel's launch counts zeroed just before and read just after; then,
    on rank 0 while the others wait at a barrier, the kernel against its
    plain version and timed at the rank's shapes (on the card).  Writes its
    results to ``out_dir``, with ``stages`` its build's stages too
    (:func:`ring_stages`)."""
    import datetime
    import hashlib

    import torch.distributed as dist

    from ddm_tpu_torch import api
    from ddm_tpu_torch.coarse import ring
    from ddm_tpu_torch.core import indexmaps
    from ddm_tpu_torch.core import mesh as dmesh
    from ddm_tpu_torch.kernels import ddmatvec
    from ddm_tpu_torch.obs.logger import Logger

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh = dmesh.init_ranks(
        rank, world, init_method, device=device,
        timeout=datetime.timedelta(seconds=SHARDED_TIMEOUT_S))
    dev = mesh.device
    cuda = dev.type == "cuda"
    if stages:
        record_ring_stages()
    try:
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        Logger.reset()
        for routes in (ring.ROUTES, indexmaps.TOPOLOGY_ROUTES):
            for k in routes:
                routes[k] = 0
        ddmatvec.dd_matvec_cuda.shapes.clear()
        t0 = time.perf_counter()
        p = path_problem(api, "ring_dd", size, parts, dev)
        M = api.build_preconditioner(p, mesh=mesh)
        res = api.solve(p, M, mesh=mesh)
        u = api.solution(p, res)
        if cuda:
            torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        shapes = dict(ddmatvec.dd_matvec_cuda.shapes)
        log = Logger.get()
        fine, coarse = M.precs
        xs = mesh.all_gather(res.x[None])  # every rank's final iterate
        out = dict(
            rank=rank, backend=mesh.backend, device=str(dev), secs=secs,
            iterations=res.iterations, converged=res.converged,
            true_res=float(torch.linalg.norm(p.A.mv(res.x) - p.rhs)
                           / torch.linalg.norm(p.rhs)),
            x_sha=hashlib.sha256(res.x.cpu().numpy().tobytes()).hexdigest(),
            same_as_all=all(torch.equal(xs[0], x) for x in xs),
            shapes=shapes, routes=dict(ring.ROUTES),
            topology_routes=dict(indexmaps.TOPOLOGY_ROUTES),
            split=phase_split({k: v.total for k, v in log.events.items()}),
            # the scopes fold the allocator's peak into the logger's and
            # reset it (obs/logger.py): the peak is the larger of the two
            peak_gib=max(log.peak_bytes, torch.cuda.max_memory_allocated(dev))
            / 2**30 if cuda else 0.0,
            factor_shape=tuple(fine.factors.inv_hi.shape),
            fine_inv_gb=(fine.factors.inv_hi.nbytes
                         + fine.factors.inv_lo.nbytes) / 1e9,
            fine_applies=fine.applies, coarse_applies=coarse.applies,
            n_c=coarse.V.shape[1] * p.topo.n_sub,
            u=u.cpu() if rank == 0 else None, kernels=[])
        del xs
        if stages:
            torch.save(ring_stages(p, M, res),
                       os.path.join(out_dir, f"rank{rank}_stages.pt"))
        if rank == 0 and cuda:
            flush_buf = torch.empty(2 * 50 * 2**20, dtype=torch.uint8,
                                    device=dev)
            gen = torch.Generator(device=dev).manual_seed(0)
            out["kernels"] = time_kernel(ddmatvec, "ring_dd_sharded", M.precs,
                                         shapes, flush_buf, gen)
        mesh.barrier()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_sharded(ring_ref, launches, device=None, size=None, parts=None,
                stage_refs=None):
    """Phase 7: ``ring_dd`` (default: at full size, on the card) on
    SHARDED_RANKS ranks of one process group (NCCL with a card per rank,
    else gloo on the cards there are), spawned here; held to the
    single-device run's count (``ring_ref``), its true residual limit and
    its solution, with the iterates bit-identical on every rank.  Returns
    the kernel entries of rank 0's shapes.  ``device="cpu"`` with a small
    ``size``/``parts`` rehearses it on the CPU.  ``stage_refs`` (label ->
    :func:`ring_stages` of a single-device build) prints each rank's
    stages against them (:func:`compare_stages`)."""
    import torch.multiprocessing as mp

    world = SHARDED_RANKS
    cuda = device is None or torch.device(device).type == "cuda"
    if size is None:
        size, parts = FULL["islands"]
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    out_dir = tempfile.mkdtemp(dir=tmp_dir())
    t0 = time.perf_counter()
    mp.start_processes(sharded_rank, nprocs=world, start_method="spawn",
                       args=(world, f"file://{out_dir}/rendezvous", out_dir,
                             device, size, parts, stage_refs is not None))
    wall = time.perf_counter() - t0
    rs = [torch.load(os.path.join(out_dir, f"rank{k}.pt"), weights_only=False)
          for k in range(world)]
    r0 = rs[0]
    print(f"sharded ring_dd (islands {size}^2/{math.prod(parts)}, {world} "
          f"ranks, backend {r0['backend']}, devices "
          f"{[r['device'] for r in rs]}): {wall:.3f} s for the spawn and "
          f"every rank's run", flush=True)
    for r in rs:
        print(f"sharded rank {r['rank']}: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in r["split"].items())
            + f", total {r['secs']:.3f} s, peak {r['peak_gib']:.2f} GiB, "
            f"fine dd inverse {tuple(r['factor_shape'])} "
            f"{r['fine_inv_gb']:.3f} GB, iterations {r['iterations']}, "
            f"true rel residual {r['true_res']:.3e}, dd_matvec launches by "
            f"shape {r['shapes']}, applies {r['fine_applies']} fine + "
            f"{r['coarse_applies']} coarse, extension routes {r['routes']}, "
            f"topology routes {r['topology_routes']}, "
            f"final iterate sha256 {r['x_sha'][:16]}", flush=True)
    e = rel_err(r0["u"], ring_ref["u"])
    same = (all(r["same_as_all"] for r in rs)
            and len({r["x_sha"] for r in rs}) == 1)
    print(f"sharded ring_dd: {r0['iterations']} iterations against the "
          f"single-device {ring_ref['iterations']}, solution rel diff "
          f"{e:.3e} from the single-device one (limit {SOLUTION_TOL:g}), "
          f"final iterates bit-identical on all ranks: {same}", flush=True)
    if stage_refs is not None:
        compare_stages(stage_refs, out_dir, world, math.prod(parts))
    n_loc = math.prod(parts) // world
    for r in rs:
        n_pad = r["factor_shape"][1]
        # 3 launches per dd apply at each level; none on the CPU
        want = {(n_loc, n_pad, n_pad): 3 * r["fine_applies"],
                (1, r["n_c"], r["n_c"]): 3 * r["coarse_applies"]} if cuda else {}
        if not (r["converged"] and r["iterations"] == ring_ref["iterations"]
                and r["true_res"] <= TRUE_RES_MAX["islands"]
                and r["factor_shape"][0] == n_loc
                and r["shapes"] == want and all(want.values())
                and r["routes"]["direct"] >= 1
                and r["topology_routes"] == {"native": 1, "python": 0}):
            fail(f"sharded ring_dd rank {r['rank']} did not run as the "
                 f"single-device path: {r['iterations']} iterations, true "
                 f"rel residual {r['true_res']:.3e}, factor batch "
                 f"{r['factor_shape']}, launches {r['shapes']} (want {want}), "
                 f"routes {r['routes']}, topology routes "
                 f"{r['topology_routes']}")
    if not (e <= SOLUTION_TOL and same):
        fail("the sharded ring_dd solution differs from the single-device "
             "one or between ranks")
    launches["ring_dd_sharded"] = sum(r0["shapes"].values())
    return r0["kernels"]


# the ring coarse space's GEVP and extension outputs of the current run,
# set by the wrappers that record_ring_stages installs
RING_STAGES = {}


def record_ring_stages():
    """Wrap the ring coarse space's eigensolve and extension so that a run
    keeps their outputs (eigenvalues, ring eigenvectors, extended basis);
    the build itself is unchanged."""
    from ddm_tpu_torch.coarse import ring

    gevp, extension = ring.solve_gevp, ring._ring_extension

    def recorded_gevp(*args, **kwargs):
        lam, V, active = gevp(*args, **kwargs)
        RING_STAGES.update(gevp_lam=lam.clone(), gevp_V=V.clone())
        return lam, V, active

    def recorded_extension(*args, **kwargs):
        ext = extension(*args, **kwargs)
        RING_STAGES["extension"] = ext.clone()
        return ext

    ring.solve_gevp, ring._ring_extension = recorded_gevp, recorded_extension


# stages of ring_stages with one row per subdomain, in build order; the
# others are replicated
SLAB_STAGES = ("fine_inv_hi", "fine_inv_lo", "gevp_lam", "gevp_V",
               "extension", "V", "alpha")


def in_slabs(fn, k, *batches):
    """``fn`` over slabs of ``k`` subdomains of ``batches``, concatenated:
    a batched product as a rank of ``k`` subdomains takes it."""
    return torch.cat([fn(*(b[i:i + k] for b in batches))
                      for i in range(0, batches[0].shape[0], k)])


def coarse_apply_in_slabs(G, d, k):
    """``GalerkinPreconditioner.apply`` of a single-device build with its
    restriction and prolongation taken in slabs of ``k`` subdomains, as
    the ranks take them (their all-gathers only move bits)."""
    from ddm_tpu_torch.precond.extract import (gather_subdomain,
                                               scatter_add_subdomain)

    d_sub = gather_subdomain(d, G.sub2glob)
    alpha = in_slabs(lambda V, x: (V @ x[:, :, None])[:, :, 0], k, G.V, d_sub)
    beta = G._coarse_solve(alpha.reshape(-1)).reshape(alpha.shape)
    x_sub = in_slabs(lambda V, y: (V.mT @ y[:, :, None])[:, :, 0], k, G.V,
                     beta)
    return scatter_add_subdomain(x_sub, G.dualT)


def ring_stages(p, M, res, slab=None):
    """The stages of a ``ring_dd`` build (RING_STAGES of its run) and of
    its solve, on the CPU: the coarse restriction ``alpha`` of a vector
    drawn from seed 0, one apply of each level to it (on a sharded build,
    every rank calls this together), and the final iterate.  ``slab``: a
    single-device build's restriction and coarse apply taken in slabs of
    that many subdomains (:func:`coarse_apply_in_slabs`)."""
    from ddm_tpu_torch.precond.extract import gather_subdomain

    fine, coarse = M.precs
    gen = torch.Generator().manual_seed(0)
    v = torch.randn(p.rhs.shape, generator=gen,
                    dtype=torch.float64).to(p.rhs.device)
    out = dict(RING_STAGES, fine_inv_hi=fine.factors.inv_hi,
               fine_inv_lo=fine.factors.inv_lo, V=coarse.V, E=coarse.E_mat)
    # the coarse dd inverse on the card, its Cholesky factor on the CPU
    out.update({f"coarse_{k}": x for k, x in vars(coarse.coarse).items()
                if torch.is_tensor(x)})
    d_sub = gather_subdomain(v, coarse.sub2glob)
    out["alpha"] = in_slabs(lambda V, x: (V @ x[:, :, None])[:, :, 0],
                            slab or d_sub.shape[0], coarse.V, d_sub)
    out.update(fine_apply=fine.apply(v),
               coarse_apply=(coarse.apply(v) if slab is None
                             else coarse_apply_in_slabs(coarse, v, slab)),
               x=res.x)
    return {k: x.cpu() for k, x in out.items()}


def stage_diff(a, ref):
    """(bit-equal rows, rows, largest |a - ref|, that over the largest
    |ref|) of two stages of one shape (a vector is one row)."""
    rows = a.shape[0] if a.ndim > 1 else 1
    a, ref = a.double().reshape(rows, -1), ref.double().reshape(rows, -1)
    d = float((a - ref).abs().max())
    return (int((a == ref).all(1).sum()), rows, d,
            d / (float(ref.abs().max()) or 1.0))


def compare_stages(refs, out_dir, world, n_sub):
    """Print each rank's stages against the same rows of every reference
    in ``refs`` (label -> ring_stages of a single-device build).  The
    eigenvectors and the bases take the reference's sign per vector first:
    a flipped vector spans the same coarse space."""
    k = n_sub // world
    for r in range(world):
        got = torch.load(os.path.join(out_dir, f"rank{r}_stages.pt"))
        for name, a in got.items():  # in build order
            line = []
            for label, ref in refs.items():
                b = (ref[name][r * k:(r + 1) * k] if name in SLAB_STAGES
                     else ref[name])
                if a.shape != b.shape:
                    line.append(f"{label}: shape {tuple(b.shape)}")
                    continue
                a_s = a
                if name in ("gevp_V", "extension", "V"):
                    a_s = torch.where((a * b).sum(-1, keepdim=True) < 0, -a, a)
                eq, rows, d, rel = stage_diff(a_s, b)
                line.append(f"{label}: {eq}/{rows} bit-equal, max abs diff "
                            f"{d:.3e} (rel {rel:.3e})")
            print(f"stage rank {r} {name} {tuple(a.shape)}: "
                  + "; ".join(line), flush=True)
        del got


def sharded_only():
    """``--sharded``: the kernel's build, ``ring_dd`` on one card as the
    reference, then phase 7 alone."""
    from ddm_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    build.build("dd_matvec")
    size, parts = FULL["islands"]
    record_ring_stages()
    refs = {}
    for label in ("single", "single@slab"):
        r = run_single_ring(size, parts, dev, label == "single@slab")
        check_path("ring_dd", label, r)
        refs[label] = ring_stages(
            r["p"], r["M"], r["res"],
            math.prod(parts) // SHARDED_RANKS if label == "single@slab"
            else None)
        if label == "single":
            ring_ref = dict(iterations=r["res"].iterations, u=r["u"].cpu())
        r = None
    launches = {}
    run_sharded(ring_ref, launches, stage_refs=refs)
    print(f"launches by path: {launches}", flush=True)


def run_single_ring(size, parts, device, at_slab=False):
    """``ring_dd`` on one device; ``at_slab``: with every chunked stage
    (``solvers/direct.py:chunked_batch``) cut into slabs of a sharded
    rank's subdomains, so that it sees the batches the ranks see."""
    from ddm_tpu_torch.solvers import direct

    chunk = direct.batch_chunk_size
    if at_slab:
        k = math.prod(parts) // SHARDED_RANKS
        direct.batch_chunk_size = lambda *a, **kw: min(chunk(*a, **kw), k)
    try:
        return run_path("ring_dd", size, parts, device)
    finally:
        direct.batch_chunk_size = chunk


def islands_topology_inputs(grid, n_sub=None, parts=None):
    """The inputs of ``build_topology`` for islands on ``grid``, built on
    the host as ``setup_problem`` builds them (``core.setup``)."""
    from ddm_tpu_torch.core.setup import partition_elements, topology_inputs
    from ddm_tpu_torch.fem import problems
    from ddm_tpu_torch.fem.discretize import Discretization

    disc = Discretization(grid, problems.islands(), torch.device("cpu"))
    return topology_inputs(
        disc, partition_elements(disc, n_sub=n_sub, parts=parts))


TOPOLOGY_FIELDS = ("n_pad", "sub2glob", "valid", "owner", "boundary",
                   "bdist", "g2l_keys", "g2l_locs", "sizes")


def check_native_topology():
    """Before phase 5: ``build_topology`` on the native route against the
    scipy route at the three full sizes of the main paths' grids (islands
    384^2 / 256, the L-shape refine 4 / 128 RCB, 3-D 56^3 / 512), overlap
    2; every array must be equal.  Raises if the native route is
    unavailable."""
    import numpy as np

    from ddm_tpu_torch import _native, api
    from ddm_tpu_torch.core.indexmaps import build_topology
    from ddm_tpu_torch.fem.grids import structured_grid

    _native.load()  # the g++ build stays out of the native times
    size, parts = FULL["islands"]
    hsize, hparts = FULL["hex"]
    usize, un_sub = FULL["unstr"]
    cases = [
        (f"islands {size}^2/{math.prod(parts)}",
         lambda: islands_topology_inputs(structured_grid((size, size)),
                                         parts=parts)),
        (f"L-shape refine {usize} / {un_sub} RCB",
         lambda: islands_topology_inputs(
             api.make_grid(path_ptree(api, "unstr_f64", usize)),
             n_sub=un_sub)),
        (f"3-D {hsize}^3/{math.prod(hparts)}",
         lambda: islands_topology_inputs(structured_grid((hsize,) * 3),
                                         parts=hparts)),
    ]
    for label, inputs in cases:
        adj, M0, owner = inputs()
        t0 = time.perf_counter()
        nat = build_topology(adj, M0, owner, 2, use_native=True)
        t_nat = time.perf_counter() - t0
        t0 = time.perf_counter()
        py = build_topology(adj, M0, owner, 2, use_native=False)
        t_py = time.perf_counter() - t0
        differ = [f for f in TOPOLOGY_FIELDS
                  if not np.array_equal(getattr(nat, f), getattr(py, f))]
        print(f"topology {label}, overlap 2 (n_pad {nat.n_pad}): native "
              f"{t_nat:.3f} s, python {t_py:.3f} s ({t_py / t_nat:.2f}x), "
              f"every array equal: {not differ}", flush=True)
        if differ:
            fail(f"native topology of {label} differs from the scipy "
                 f"route in {differ}")


# phase 8: python -m ddm_tpu_torch.bench at its defaults (islands 384^2/256,
# geneo_ring nev 8, f64): bench.py's headline limit, the like-for-like
# geneo limit (MAX_ITERS["geneo_dd"]), the true residual limit of its four
# runs, and the two CPU baselines within one iteration of each other
BENCH_CMD = [sys.executable, "-m", "ddm_tpu_torch.bench"]
BENCH_TIMEOUT_S = 420
BENCH_MAX_ITERS = {"iters": MAX_ITERS["ring_f64"],
                   "iters_geneo": MAX_ITERS["geneo_dd"]}
BENCH_TRUE_RES_MAX = 1e-7


# phase 8 also runs the bench's elasticity variant at 64^2 / 16 (steel-rubber
# strip, full GenEO nev 8, flexible GMRES): the JAX package's device path
# takes 47 iterations there and its sequential CPU baseline 55 (both on the
# CPU, bench.py's functions); the port's two baselines, on the problem the
# host builds, must take 55 within one
ELAST_BENCH_ENV = {"DDM_BENCH_PROBLEM": "elasticity",
                   "DDM_BENCH_GRIDSIZE": "64", "DDM_BENCH_PARTS": "4"}
ELAST_BENCH_MAX_ITERS = 47 + 2
ELAST_JAX_BASELINE_ITERS = 55


def run_bench(env=None):
    """Phase 8: the benchmark entry point as a user runs it, a fresh
    process with a timeout, at its defaults or with the ``DDM_BENCH_*``
    variables of ``env``; prints its JSON line prefixed ``bench:`` and its
    summary lines, and raises unless the counts and residuals hold: at the
    defaults BENCH_MAX_ITERS and the two baselines within one iteration of
    each other, for the elasticity variant ELAST_BENCH_MAX_ITERS on the
    card and both baselines within one of the JAX package's
    ELAST_JAX_BASELINE_ITERS.  Returns its wall seconds."""
    import json as json_mod

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        BENCH_CMD, cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=BENCH_TIMEOUT_S,
        env={**os.environ, **(env or {})})
    wall = time.perf_counter() - t0
    tag = "bench" if not env else "bench " + ",".join(
        f"{k.removeprefix('DDM_BENCH_').lower()}={v}" for k, v in env.items())
    for line in proc.stderr.splitlines():
        if line.startswith(("device", "host setup", "cpu ")):
            print(f"{tag} log: {line}", flush=True)
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or len(lines) != 1:
        print(proc.stderr[-4000:], file=sys.stderr, flush=True)
        fail(f"python -m ddm_tpu_torch.bench ({tag}) exited "
             f"{proc.returncode} with {len(lines)} lines on stdout")
    print(f"{tag}: {lines[0]}", flush=True)
    out = json_mod.loads(lines[0])
    seq, par = out["cpu_sequential_baseline"], out["cpu_parallel_baseline"]
    res = [out["true_rel_res"], out.get("true_rel_res_geneo"),
           seq["true_rel_res"], par["true_rel_res"]]
    elast = bool(env) and env.get("DDM_BENCH_PROBLEM") == "elasticity"
    limits = ({"iters": ELAST_BENCH_MAX_ITERS} if elast else BENCH_MAX_ITERS)
    head = ("geneo" if elast else "geneo_ring")
    like4like = ("" if "iters_geneo" not in out
                 else f"geneo {out['iters_geneo']} (limit "
                      f"{limits['iters_geneo']}), ")
    print(f"{tag}: {wall:.1f} s in all; {head} {out['iters']} its "
          f"(limit {limits['iters']}), {like4like}CPU "
          f"sequential {seq['iters']}, parallel {par['iters']} "
          f"({par['workers']} workers, {out['cpu_count']} cores)"
          + (f" (the JAX package's sequential baseline: "
             f"{ELAST_JAX_BASELINE_ITERS})" if elast else "")
          + "; true rel residuals "
          + ", ".join(f"{r:.3e}" for r in res if r is not None)
          + f" (limit {BENCH_TRUE_RES_MAX:g})", flush=True)
    if not (all(out[k] <= v for k, v in limits.items())
            and all(r <= BENCH_TRUE_RES_MAX for r in res if r is not None)
            and seq["converged"] and par["converged"]
            and (abs(seq["iters"] - par["iters"]) <= 1 if not elast else
                 all(abs(b["iters"] - ELAST_JAX_BASELINE_ITERS) <= 1
                     for b in (seq, par)))):
        fail(f"the benchmark's counts or residuals ({tag}) are over their "
             "limits")
    return wall


# the default-LU check: factor_batched(A) at the DG fine shape
DEFAULT_LU_SHAPE = (144, 1280, 1280)
DEFAULT_LU_TOL = 1e-10
TRACE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "traces")


def check_two_level_fine(dev, ring_iterations):
    """``ring_dd`` at full size through ``build_two_level(p, fine=)`` with
    a Schwarz level built once beforehand, against ``build_two_level(p)``
    on the same problem in this process: phase 5's iteration count, a
    bit-equal solution, the given level reused, and one
    ``Schwarz/factorise`` scope in all.  Returns (problem, preconditioner)
    for the trace check."""
    from ddm_tpu_torch import api
    from ddm_tpu_torch.obs.logger import Logger
    from ddm_tpu_torch.precond.schwarz import build_schwarz
    from ddm_tpu_torch.precond.two_level import build_two_level

    size, parts = FULL["islands"]
    p = path_problem(api, "ring_dd", size, parts, dev)
    M0 = build_two_level(p)
    res0 = api.solve(p, M0)
    del M0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    Logger.reset()
    t0 = time.perf_counter()
    fine = build_schwarz(p.A, p.topo, p.pou, p.ptree)
    M = build_two_level(p, fine=fine)
    res = api.solve(p, M)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    builds = Logger.get().events[("Schwarz", "factorise")].count
    same = torch.equal(res.x, res0.x)
    print(f"ring_dd through build_two_level(p, fine=): {res.iterations} its "
          f"(phase 5: {ring_iterations}, fine=None here: {res0.iterations}), "
          f"solution bit-equal to fine=None: {same}, Schwarz/factorise "
          f"scopes {builds}, fine level reused: {M.precs[0] is fine}, "
          f"build + solve {secs:.3f} s", flush=True)
    if not (res.converged and res.iterations == ring_iterations
            and res0.iterations == ring_iterations and same and builds == 1
            and M.precs[0] is fine):
        fail("build_two_level(p, fine=) differs from the fine=None build")
    return p, M


def check_profile_trace(p, M):
    """``obs.logger.profile_trace`` around one warm solve of ``p`` with
    ``M`` (``ring_dd``): the Chrome trace it writes under TRACE_DIR must
    hold as many ``dd_matvec`` kernel events as the wrapper counted
    launches in the same window; prints the five device ops that took the
    most time."""
    from ddm_tpu_torch import api
    from ddm_tpu_torch.kernels import ddmatvec
    from ddm_tpu_torch.obs.logger import profile_trace

    api.solve(p, M)
    torch.cuda.synchronize()
    ddmatvec.dd_matvec_cuda.shapes.clear()
    t0 = time.perf_counter()
    with profile_trace(TRACE_DIR) as tr:
        res = api.solve(p, M)
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    shapes = dict(ddmatvec.dd_matvec_cuda.shapes)
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    n_events = sum(1 for e in device if e["cat"] == "kernel"
                   and "dd_matvec_kernel" in e.get("name", ""))
    by_name = {}
    for e in device:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    print(f"profile_trace around one warm ring_dd solve ({res.iterations} "
          f"its, {secs:.3f} s with the trace written to "
          f"{os.path.relpath(tr.path)}): dd_matvec kernel events "
          f"{n_events}, wrapper launches {sum(shapes.values())} by shape "
          f"{shapes}; top device ops:", flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
        print(f"    {ms:.4f} ms  {name[:110]}", flush=True)
    if not (n_events == sum(shapes.values()) > 0 and len(shapes) == 2):
        fail("the trace's dd_matvec events differ from the launch count")


def parity_checks(dev, gen, ring_iterations):
    """The checks of the pieces that complete the port's parity with the
    JAX package, on the card: ``build_two_level(p, fine=)`` and
    ``profile_trace`` on ``ring_dd`` at full size, then the default
    ``factor_batched``."""
    p, M = check_two_level_fine(dev, ring_iterations)
    check_profile_trace(p, M)
    del p, M
    torch.cuda.empty_cache()
    check_default_lu(dev, gen)


def check_default_lu(dev, gen):
    """``factor_batched(A)`` at its default solver (LU) and mode (inverse
    on the card) on a nonsymmetric batch at DEFAULT_LU_SHAPE: its solve
    within DEFAULT_LU_TOL (relative, per subdomain) of
    ``torch.linalg.solve`` on the same batch."""
    from ddm_tpu_torch.solvers.direct import BatchedInverse, factor_batched

    n_sub, P, _ = DEFAULT_LU_SHAPE
    A = torch.randn(DEFAULT_LU_SHAPE, generator=gen, device=dev,
                    dtype=torch.float64) / P ** 0.5
    A.diagonal(dim1=1, dim2=2).add_(2.0)  # eigenvalues in |z - 2| <~ 1
    b = torch.randn((n_sub, P), generator=gen, device=dev, dtype=torch.float64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fac = factor_batched(A)
    x = fac.solve(b)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ref = torch.linalg.solve(A, b)
    err = float((torch.linalg.norm(x - ref, dim=1)
                 / torch.linalg.norm(ref, dim=1)).max())
    asym = float((A - A.mT).abs().max() / A.abs().max())
    print(f"factor_batched(A) at its defaults on a nonsymmetric card batch "
          f"{DEFAULT_LU_SHAPE} (|A - A^T| / |A| = {asym:.2f}): "
          f"{type(fac).__name__}, factor + solve {secs:.3f} s, solve error "
          f"against torch.linalg.solve {err:.3e} (limit {DEFAULT_LU_TOL:g})",
          flush=True)
    if not (isinstance(fac, BatchedInverse) and err <= DEFAULT_LU_TOL
            and asym > 1e-2):
        fail("the default factor_batched does not solve a nonsymmetric batch")


def baseline_diag():
    """The bench's elasticity variant (ELAST_BENCH_ENV) with the problem on
    this host's CPU (``bench.main(device="cpu")``), then in the same
    process the BLAS and LAPACK libraries (threadpoolctl, else numpy's
    build configuration) and, for each subdomain, the singular values of
    the sequential baseline's kept GenEO vectors (each of unit norm) and
    each vector's part outside the span of the subdomain's rigid-body
    modes (in the equilibrated, POU-scaled variables of the vectors)."""
    import numpy as np
    import scipy

    from ddm_tpu_torch import bench
    from ddm_tpu_torch.coarse.pou_space import rigid_body_modes

    os.environ.update(ELAST_BENCH_ENV)
    out = bench.main([], device="cpu")
    print(f"elasticity 64^2/16 on the CPU: device path {out['iters']} its, "
          f"CPU sequential {out['cpu_sequential_baseline']['iters']}, "
          f"parallel {out['cpu_parallel_baseline']['iters']} (the JAX "
          f"package's sequential baseline: {ELAST_JAX_BASELINE_ITERS})",
          flush=True)
    print(f"numpy {np.__version__}, scipy {scipy.__version__}", flush=True)
    try:
        import threadpoolctl
    except ImportError:
        np.show_config()
    else:
        for lib in threadpoolctl.threadpool_info():
            print(f"threadpoolctl: {lib['user_api']} {lib['internal_api']} "
                  f"{lib.get('version')} ({lib['num_threads']} threads) "
                  f"{lib['filepath']}", flush=True)
    nev = int(os.environ.get("DDM_BENCH_NEV", "8"))
    p = bench.build_problem(int(ELAST_BENCH_ENV["DDM_BENCH_GRIDSIZE"]),
                            int(ELAST_BENCH_ENV["DDM_BENCH_PARTS"]), 2, nev,
                            device="cpu")
    A_neu, C = bench._baseline_gevp_mats(p)
    rigid = np.stack(rigid_body_modes(p.disc.grid.nodes, 2), axis=1)
    scale = p.scale.numpy()
    for k in range(p.topo.n_sub):
        ids, pou, Ak, Ck = bench._subdomain_blocks(p, A_neu, C, k)
        W = bench._geneo_vectors(Ak, Ck, pou, nev)
        Q, _ = np.linalg.qr(pou[:, None] * rigid[ids] / scale[ids, None])
        outside = np.linalg.norm(W - Q @ (Q.T @ W), axis=0)
        sv = np.linalg.svd(W, compute_uv=False)
        print(f"subdomain {k}: singular values of the kept vectors "
              f"{sv.min():.4f}-{sv.max():.4f}; part outside the rigid span "
              + " ".join(f"{v:.3f}" for v in outside), flush=True)


SETUP_PROFILE_FNS = ("build_topology", "setup_topology", "assembly_plan",
                     "boundary_nodes", "constrained_system", "pou_weights")


def setup_profile(device="cuda"):
    """``--setup-profile``: ``cProfile`` of ``setup_problem`` for islands
    384^2 / 256 subdomains with the problem on the card (or on
    ``device``), cold (the first call in the process) and warm, each with
    its wall seconds, the cumulative seconds of the host stages in
    SETUP_PROFILE_FNS and the functions that took the most time of their
    own."""
    import cProfile
    import pstats

    from ddm_tpu_torch import api
    from ddm_tpu_torch.core.indexmaps import TOPOLOGY_ROUTES

    dev = torch.device(device)
    size, parts = FULL["islands"]
    for run in ("cold", "warm"):
        for k in TOPOLOGY_ROUTES:
            TOPOLOGY_ROUTES[k] = 0
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        p = path_problem(api, "ring_dd", size, parts, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        prof.disable()
        wall = time.perf_counter() - t0
        stats = pstats.Stats(prof).stats
        cum = {}
        for (_, _, fn), (_, _, _, ct, _) in stats.items():
            if fn in SETUP_PROFILE_FNS:
                cum[fn] = cum.get(fn, 0.0) + ct
        print(f"setup_problem profile ({run}, islands {size}^2/"
              f"{math.prod(parts)}, n_pad {p.topo.n_pad}, topology routes "
              f"{TOPOLOGY_ROUTES}): {wall:.3f} s; "
              + ", ".join(f"{fn} {cum.get(fn, 0.0):.3f} s "
                          f"({cum.get(fn, 0.0) / wall:.1%})"
                          for fn in SETUP_PROFILE_FNS), flush=True)
        own = sorted(stats.items(), key=lambda kv: -kv[1][2])[:8]
        print("  most own time: " + "; ".join(
            f"{os.path.basename(f)}:{line} {fn} {tt:.3f} s"
            for (f, line, fn), (_, _, tt, _, _) in own), flush=True)
        del p


def run_solver_bench(dev):
    """The batched direct-solver benchmark at its defaults; raise if a
    factorization's residual is over its limit."""
    from ddm_tpu_torch.examples import solver_bench

    for row in solver_bench.main([], dev)[:-1]:
        # f64: the blocks' cond(A) ~ 3 leaves rounding-level residuals; the
        # f32 inverse keeps f32's rounding
        limit = 1e-3 if row["name"].endswith("f32") else 1e-8
        if not row["resid"] <= limit:
            fail(f"solver_bench {row['name']}: residual {row['resid']:.2e} "
                 f"over {limit:g}")


def main():
    # -- 1. device (CUDA checked by the caller) -----------------------------
    from concurrent.futures import ThreadPoolExecutor

    from ddm_tpu_torch import _native
    from ddm_tpu_torch.core.indexmaps import TOPOLOGY_ROUTES
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
    def timed(fn, *args):
        t0 = time.perf_counter()
        return fn(*args), time.perf_counter() - t0

    # nvcc for the kernel and g++ for the native topology, started together
    with ThreadPoolExecutor(2) as ex:
        builds = [ex.submit(timed, build.build, "dd_matvec"),
                  ex.submit(timed, _native.build)]
        for lib, secs in (f.result() for f in builds):
            print(f"build: {lib.name} in {secs:.2f} s", flush=True)

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
    record_gevp()
    for path, ref in SMALL_CHECKS:
        size, parts = SMALL[PATHS[path][0]]
        g = run_path(path, size, parts, dev)
        c = run_path(ref, size, parts, cpu)
        tight = "reduction 1e-08"
        e_small = rel_err(g["u"].cpu(), c["u"])
        if path in TIGHT_CHECKS:
            gt = run_path(path, size, parts, dev, TIGHT_REDUCTION)
            ct = run_path(ref, size, parts, cpu, TIGHT_REDUCTION)
            tight = (f"at reduction {TIGHT_REDUCTION:g}: card "
                     f"{gt['res'].iterations} its (true rel residual "
                     f"{gt['true_res']:.3e}), cpu {ct['res'].iterations} "
                     f"its ({ct['true_res']:.3e})")
            e_small = rel_err(gt["u"].cpu(), ct["u"])
            if not max(gt["true_res"], ct["true_res"]) <= FLOOR_RES_MAX:
                fail(f"small-input {path} did not reach the residual floor "
                     f"(true rel residual <= {FLOOR_RES_MAX:g})")
            del gt, ct
        kept_g = g["M"].precs[1].active.cpu()
        kept_c = c["M"].precs[1].active
        keys = PATHS[path][3]
        n_dd = 0
        if "schwarz.subdomain_solver.precision" in keys:
            n_dd += 3 * g["fine_applies"]
        if "coarse_solver.precision" in keys:
            n_dd += 3 * g["coarse_applies"]
        print(f"small {size_label(path, size, parts)} {path} (n_pad "
              f"{g['p'].topo.n_pad}): card "
              f"{g['res'].iterations} its (true rel residual "
              f"{g['true_res']:.3e}), cpu {ref} {c['res'].iterations} its, "
              f"kept {int(kept_g.sum())} / {int(kept_c.sum())} coarse "
              f"vectors (same in every subdomain: "
              f"{torch.equal(kept_g, kept_c)}), "
              f"solution rel diff {e_small:.3e} ({tight}), launches "
              f"{g['launches']} = "
              f"3 x ({g['fine_applies']} fine + {g['coarse_applies']} coarse) "
              f"applies, by shape {g['shapes']}", flush=True)
        if g["lobpcg"]:
            print(f"  LOBPCG iterations by slab: card "
                  f"{[x['iterations'] for x in g['lobpcg']]}, cpu "
                  f"{[x['iterations'] for x in c['lobpcg']]}", flush=True)
        if not (g["res"].converged
                and abs(g["res"].iterations - c["res"].iterations) <= 2
                and torch.equal(kept_g, kept_c)
                and e_small <= SOLUTION_TOL and g["launches"] == n_dd
                and bool(g["lobpcg"]) == is_lobpcg(path)):
            fail(f"small-input {path} on the card disagrees with the CPU")
        del g, c

    # the nonlinear example: the card (dd coarse solve where named) against
    # the exact f64 run on the CPU
    for label, size, parts, args, dd in NEWTON_SMALL:
        blocks = parts if isinstance(parts, tuple) else None
        argv = newton_argv(size, math.prod(blocks) if blocks else parts, args)
        g = run_newton(argv + (DD_COARSE if dd else []), dev, blocks)
        c = run_newton(argv, cpu, blocks)
        gs, cs = g["solver"].steps, c["solver"].steps
        e_small = rel_err(g["res"].u.cpu(), c["res"].u)
        inner_g = [x["inner"] for x in gs]
        inner_c = [x["inner"] for x in cs]
        print(f"small Newton {label} ({size}^2, {parts}, n_pad "
              f"{g['solver'].topo.n_pad}): card {g['res'].iterations} its, "
              f"inner {inner_g}, cpu {c['res'].iterations} its, inner "
              f"{inner_c}, solution rel diff {e_small:.3e}, fresh residual "
              f"{g['fresh']:.3e} / {c['fresh']:.3e}, launches "
              f"{g['launches']} by shape {g['shapes']}", flush=True)
        same_inner = (inner_g == inner_c if not dd else
                      len(inner_g) == len(inner_c) and all(
                          abs(a - b) <= 1 for a, b in zip(inner_g, inner_c)))
        n_dd = 3 * sum(x["coarse_applies"] for x in gs) if dd else 0
        if not (g["res"].converged and c["res"].converged
                and g["res"].iterations == c["res"].iterations and same_inner
                and e_small <= SOLUTION_TOL and g["launches"] == n_dd):
            fail(f"small Newton {label} on the card disagrees with the CPU")
        del g, c

    # the example drivers through cli.main: the card against the CPU
    check_cli_small(dev, cpu)

    # -- the native host topology against the scipy route at full size ---
    check_native_topology()

    # -- 5. main paths at full size, cold then warm; 6. their kernel shapes --
    for k in TOPOLOGY_ROUTES:
        TOPOLOGY_ROUTES[k] = 0
    flush_buf = torch.empty(2 * 50 * 2**20, dtype=torch.uint8, device=dev)
    launches, entries, gevp = {}, [], {}
    for path in MAIN_PATHS:
        size, parts = FULL[PATHS[path][0]]
        for run in ("cold", "warm"):
            r = None  # free the last run before this one's peak is taken
            r = run_path(path, size, parts, dev)
            if run == "cold" and misses_only_iterations(path, r):
                print(f"{path} (cold): {r['res'].iterations} iterations at "
                      f"the default LOBPCG tolerance, over the limit "
                      f"{MAX_ITERS[path]}; running it at tolerance "
                      f"{LOBPCG_RETRY_TOL:g} instead", flush=True)
                PATHS[path][3]["geneo.eigensolver.tolerance"] = LOBPCG_RETRY_TOL
                r = None
                r = run_path(path, size, parts, dev)
            check_path(path, run, r)
        launches[path] = r["launches"]
        if path == "ring_dd":  # the reference of the sharded phase
            ring_ref = dict(iterations=r["res"].iterations, u=r["u"].cpu())
        gevp[path] = dict(
            secs=r["events"][("Eigensolver", "solve GEVP")],
            peak=r["peaks"][("Eigensolver", "solve GEVP")],
            shape=(r["p"].topo.n_sub, r["p"].topo.n_pad),
            iterations=r["res"].iterations, lobpcg=r["lobpcg"],
            eig=r["eig"][0] if r["eig"] else None)
        if path == "hex_ov1_dd":
            for ov2 in ("hex_ov2_f64", "hex_ov2_dd"):
                MAX_ITERS[ov2] = r["res"].iterations + 2
        if path == "hex_ov2_f64":
            MAX_ITERS["hex_ov2_lobpcg"] = r["res"].iterations + 2
        if path in ("unstr_f64", "dg_f64"):
            MAX_ITERS[path.replace("f64", "dd")] = r["res"].iterations + 2
        if path == "unstr_f64":
            MAX_ITERS["unstr_lobpcg"] = r["res"].iterations + 2
        if path in ("ring_f64", "ring_dd"):
            # the fine apply of both ring paths: the f64 inverse is read once
            # per apply (1.47 GB), hi + lo three times (3 x 1.47 GB)
            fine = r["M"].precs[0]
            d = torch.randn(r["p"].disc.n_dofs, generator=gen, device=dev,
                            dtype=torch.float64)
            line = f"{path} fine apply: {time_ms(lambda: fine.apply(d)):.4f} ms"
            if path == "ring_f64":
                d_sub = torch.randn(fine.sub2glob.shape, generator=gen,
                                    device=dev, dtype=torch.float64)
                ms_inv = time_ms(lambda: fine.factors.solve(d_sub))
                line += (f", of which the f64 inverse matvec {ms_inv:.4f} ms "
                         f"({fine.factors.inv.numel() * 8 / ms_inv / 1e6:.0f} GB/s)")
                del d_sub
            else:
                line += " (3 kernel launches + 2 exact sparse defects)"
            print(line, flush=True)
            del fine, d
        if path == "msgfem_dd":  # its fine shape is ring_dd's
            entries += time_kernel(ddmatvec, path, r["M"].precs, r["shapes"],
                                   flush_buf, gen, levels=("coarse",))
        elif path != "geneo_dd":  # its one shape is ring_dd's fine shape
            entries += time_kernel(ddmatvec, path, r["M"].precs, r["shapes"],
                                   flush_buf, gen)
    r = None

    # the dense GEVP against LOBPCG on the same pencils (warm runs)
    for dense, lob in GEVP_AB:
        d, g = gevp[dense], gevp[lob]
        (lam_d, kept_d), (lam_l, kept_l) = d["eig"], g["eig"]
        same = torch.equal(kept_d, kept_l)
        # kept eigenvalues against each subdomain's largest kept one (the
        # near-zero ones of floating subdomains have no relative accuracy)
        top = torch.where(kept_d, lam_d.abs(), 0.0).amax(1, keepdim=True)
        both = kept_d & kept_l
        gap = float(((lam_l - lam_d).abs() / top)[both].max())
        print(f"GEVP A/B {d['shape']}: dense {d['secs']:.3f} s ({dense}, "
              f"{d['iterations']} its, GEVP peak {d['peak']:.2f} GiB), LOBPCG "
              f"{g['secs']:.3f} s ({lob}, {g['iterations']} its, GEVP peak "
              f"{g['peak']:.2f} GiB), LOBPCG / dense {g['secs'] / d['secs']:.3f}"
              f"; LOBPCG iterations by slab "
              f"{[x['iterations'] for x in g['lobpcg']]}, widths "
              f"{[x['widths'] for x in g['lobpcg']]}; kept {int(kept_d.sum())}"
              f" / {int(kept_l.sum())} (same in every subdomain: {same}), "
              f"largest kept-eigenvalue gap {gap:.3e} of the subdomain's "
              f"largest (limit {EIG_GAP_MAX:g})", flush=True)
        if not (same and gap <= EIG_GAP_MAX):
            fail(f"{lob}'s LOBPCG eigenpairs disagree with {dense}'s dense "
                 f"ones on the same pencils")
    eigh_probe(dev, gen)

    # the nonlinear paths, cold then warm
    newton = {}
    for path, (size, n_sub, args) in NEWTON_PATHS.items():
        dd = "-coarse_solver.precision" in args
        for run in ("cold", "warm"):
            r = None
            r = run_newton(newton_argv(size, n_sub, args), dev)
            check_newton(path, run, r, dd)
        res = r["res"]
        newton[path] = (res.iterations, res.linear_iterations)
        launches[path] = r["launches"]
        if dd:
            f64_its, f64_inner = newton[path.replace("_dd", "_f64")]
            if not (res.iterations == f64_its
                    and res.linear_iterations <= f64_inner + 2 * f64_its):
                fail(f"{path} took {res.iterations} Newton steps and "
                     f"{res.linear_iterations} inner iterations, against "
                     f"f64's {f64_its} and {f64_inner} (+ 2 per step)")
            entries += time_kernel(ddmatvec, path, r["solver"].prec.precs,
                                   r["shapes"], flush_buf, gen,
                                   levels=("coarse",))
    r = None

    # the example paths through cli.main, then the direct-solver benchmark
    entries += run_cli_paths(dev, gen, flush_buf, launches)
    run_solver_bench(dev)
    print(f"phase 5 topology routes: {TOPOLOGY_ROUTES}", flush=True)
    if not (TOPOLOGY_ROUTES["native"] > 0 and TOPOLOGY_ROUTES["python"] == 0):
        fail("a phase 5 path built its topology on the scipy route")

    # -- ring_dd through build_two_level(fine=) and under profile_trace;
    # factor_batched at its default ------------------------------------
    del flush_buf
    t0 = time.perf_counter()
    parity_checks(dev, gen, ring_ref["iterations"])
    print(f"phase 5 parity checks: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # -- 7. sharded: ring_dd over SHARDED_RANKS ranks --------------------
    entries += run_sharded(ring_ref, launches)

    # -- 8. bench: python -m ddm_tpu_torch.bench at its defaults, then its
    # elasticity variant -----------------------------------------------
    for env in (None, ELAST_BENCH_ENV):
        print(f"phase 8 bench{' ' + str(env) if env else ''}: "
              f"{run_bench(env):.1f} s", flush=True)

    # top-level numbers: the ring_dd path at its fine shape (the first
    # entry); every path's shapes stand in "shapes", each path's total over
    # its shapes in launches_by_path
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
    elif sys.argv[1:2] == ["--witness"]:
        witness()
    elif sys.argv[1:2] == ["--sharded"]:
        sharded_only()
    elif sys.argv[1:2] == ["--setup-profile"]:
        setup_profile()
    elif sys.argv[1:2] == ["--bench"]:
        for bench_env in (None, ELAST_BENCH_ENV):
            run_bench(bench_env)
    elif sys.argv[1:2] == ["--baseline-diag"]:
        baseline_diag()
    elif sys.argv[1:2] == ["--parity"]:
        dev0 = torch.device("cuda", 0)
        size0, parts0 = FULL["islands"]
        parity_checks(dev0, torch.Generator(device=dev0).manual_seed(0),
                      run_path("ring_dd", size0, parts0, dev0)[
                          "res"].iterations)
    else:
        main()
