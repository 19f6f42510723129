"""The example drivers of the PyTorch port against the JAX package: the
Poisson example under the shipped ``poisson.ini`` (built-in and scripted
islands, and ``simple`` with the f32 subdomain precision), its VTK output,
the ``-problem`` dispatch of ``cli``, the elasticity and DG examples with
scripted coefficients, the direct-solver benchmark, and the files copied
from the JAX package.

Inputs are made from numpy or the shipped scripts.  Tolerances: iteration
counts equal; solutions within 1e-8 relative (under poisson.ini at 32^2,
GMRES to 1e-10, the port's islands solution lies 7.6e-10 from a sparse
direct solve, and the JAX package's 7.2e-10 from the port's), f32 ones
within 1e-6 (the f32 products sum in another order); VTK fields within
1e-10 of the largest entry, coarse-basis vectors up to sign within 1e-8.
The JAX side stays small (n_pad <= 256) and each JAX result is computed
once per module.

The JAX package is imported inside the tests that compare with it, so the
``cuda`` test runs on a machine with a card and no jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_examples.py
"""

import os
import re

import numpy as np
import pytest
import torch

from blas_threads import one_blas_thread  # noqa: E402,F401

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = {pkg: os.path.join(ROOT, pkg, "examples", "configs")
           for pkg in ("ddm_tpu", "ddm_tpu_torch")}
COEFFS = {pkg: os.path.join(ROOT, pkg, "examples", "coefficients")
          for pkg in ("ddm_tpu", "ddm_tpu_torch")}
INI_NAMES = ["poisson.ini", "linearelasticity.ini", "pdelab_example.ini",
             "convectiondiffusiondg.ini", "nonlinearpoisson.ini"]

# case -> (command line after -ini_file poisson.ini -gridsize 32, scripted
# coefficient file or None); poisson.ini: islands, GMRES(100) to 1e-10,
# multiplicative GenEO nev 8, 16 RCB subdomains
POISSON_CASES = {
    "islands": ([], None),
    "scripted": ([], "poisson_coefficient.py"),
    "simple_f32": (["-problem", "simple", "-solver.reduction", "1e-8",
                    "-schwarz.subdomain_solver.precision", "f32"], None),
}
# the VTK debug run of tests/test_misc.py:test_visualise_debug_fields on
# islands: on its default problem (simple) the debug subdomain's second
# GenEO eigenvalue is 1 (1 + 1e-12), a many-fold one whose eigenvector no
# two eigensolvers pick alike; islands' two are 3.9e-6 and 3.0e-5
VTK_ARGS = ["-gridsize", "16", "-subdomains", "4", "-visualise", "true",
            "-coarsespace.type", "geneo", "-geneo.eigensolver.nev", "2",
            "-geneo.eigensolver.threshold", "-1", "-debug_rank", "1",
            "-problem", "islands"]


def poisson_argv(pkg, case):
    args, coeff = POISSON_CASES[case]
    argv = ["-ini_file", os.path.join(CONFIGS[pkg], "poisson.ini"),
            "-gridsize", "32", "-visualise", "false"] + args
    if coeff:
        argv += ["-coefficient_file", os.path.join(COEFFS[pkg], coeff)]
    return argv


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


class _Recorder:
    """Replace ``module.write_vtu`` with a wrapper that keeps the fields it
    was given and then writes the file."""

    def __init__(self, module):
        self.module, self.write = module, module.write_vtu
        self.fields = None

    def __enter__(self):
        def recorded(path, grid, point_data=None, cell_data=None):
            self.fields = ({k: np.asarray(v) for k, v in point_data.items()},
                           {k: np.asarray(v) for k, v in cell_data.items()})
            self.write(path, grid, point_data, cell_data)

        self.module.write_vtu = recorded
        return self

    def __exit__(self, *exc):
        self.module.write_vtu = self.write
        return False


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's runs, once: ``examples.poisson.run`` for each
    case of POISSON_CASES, the VTK debug run, the elasticity and DG
    examples with scripted coefficients, and the convection-diffusion
    problem through ``cli`` (the default Cholesky subdomain solver on a
    nonsymmetric matrix)."""
    from ddm_tpu.examples import convectiondiffusiondg as jdg
    from ddm_tpu.examples import linearelasticity as jel
    from ddm_tpu.examples import poisson as jpoisson
    from ddm_tpu.fem import problems as jproblems
    from ddm_tpu.fem import vtk as jvtk
    from ddm_tpu.fem.scripted import load_problem

    out = {}
    for case, (args, coeff) in POISSON_CASES.items():
        pt = jpoisson.default_ptree()
        argv = poisson_argv("ddm_tpu", case)
        jpoisson.apply_cli_overrides(pt, argv)
        jpoisson.read_ini_file(pt.get("ini_file"), pt)
        jpoisson.apply_cli_overrides(pt, argv)
        problem = (load_problem(pt.get("coefficient_file")) if coeff
                   else jproblems.PROBLEMS[pt.get("problem")]())
        p, res = jpoisson.run(pt, problem)
        out[case] = (int(res.iterations), np.asarray(jpoisson.solution(p, res)))
    vtu = tmp_path_factory.mktemp("jax_vtk") / "dbg.vtu"
    with _Recorder(jvtk) as rec:
        jpoisson.main(VTK_ARGS + ["-vtk_filename", str(vtu)])
    out["vtk"] = (vtu.read_text(), rec.fields)
    _, res = jel.main(elasticity_argv("ddm_tpu"))
    out["elasticity"] = (int(res.iterations), np.asarray(res.x))
    _, res = jdg.main(dg_argv("ddm_tpu"))
    out["dg"] = (int(res.iterations), np.asarray(res.x))
    p, res = jpoisson.run(*_cd_ptree(jpoisson))
    out["convection_diffusion"] = (int(res.iterations),
                                   np.asarray(jpoisson.solution(p, res)))
    return out


def elasticity_argv(pkg):
    """The elasticity example at 8 x 2 x 3 cells, 2 slabs, under the
    shipped linearelasticity.ini, with the scripted steel-rubber file."""
    return ["-ini_file", os.path.join(CONFIGS[pkg], "linearelasticity.ini"),
            "-cells_x", "8", "-cells_y", "2", "-cells_z", "3",
            "-subdomains_x", "2", "-coefficient_file",
            os.path.join(COEFFS[pkg], "elasticity_coefficient.py")]


def dg_argv(pkg):
    """The DG example at 16^2 / 4 with the symmetric coefficient file."""
    return ["-gridsize", "16", "-subdomains", "4", "-coefficient_file",
            os.path.join(COEFFS[pkg], "symmetric_convection_diffusion_coefficient.py")]


def _cd_ptree(mod):
    """What ``cli -problem convection_diffusion -gridsize 16 -subdomains
    4`` hands the Poisson example: (ptree, problem)."""
    pt = mod.default_ptree()
    pt["gridsize"] = 16
    pt["subdomains"] = 4
    pt["visualise"] = False
    return pt, mod.pm.checkerboard_convection_diffusion()


@pytest.mark.parametrize("case", list(POISSON_CASES))
def test_poisson_main_matches_jax(case, jax_runs):
    """``examples.poisson.main`` under the copied poisson.ini at 32^2 / 16:
    the JAX package's ``run``'s iteration count (9 for islands, built in
    and scripted; 6 for simple in f32 at 1e-8) and solution."""
    from ddm_tpu_torch.api import solution
    from ddm_tpu_torch.examples import poisson

    p, res = poisson.main(poisson_argv("ddm_tpu_torch", case), device="cpu")
    it_j, u_j = jax_runs[case]
    assert p.topo.n_sub == 16 and p.topo.n_pad == 176
    assert res.converged and res.iterations == it_j
    tol = 1e-6 if case.endswith("f32") else 1e-8
    assert _rel(solution(p, res).numpy(), u_j) <= tol


def test_visualise_fields_match_jax(tmp_path, jax_runs):
    """tests/test_misc.py:test_visualise_debug_fields on the port: the same
    field names as the JAX package's file, every global and debug-subdomain
    field within 1e-10, the coarse-basis vectors up to sign within 1e-8."""
    from ddm_tpu_torch.examples import poisson
    from ddm_tpu_torch.fem import vtk

    vtu = tmp_path / "dbg.vtu"
    with _Recorder(vtk) as rec:
        poisson.main(VTK_ARGS + ["-vtk_filename", str(vtu)], device="cpu")
    text_j, (point_j, cell_j) = jax_runs["vtk"]
    point_t, cell_t = rec.fields
    names = set(re.findall(r'Name="([^"]+)"', vtu.read_text()))
    assert names == set(re.findall(r'Name="([^"]+)"', text_j))
    assert {"solution", "rhs", "pou", "pou_sum", "ovlp_subdomain",
            "basis_vec_0000", "basis_vec_0001", "ring_region"} <= names
    assert point_t.keys() == point_j.keys()
    for name, ref in point_j.items():
        got = point_t[name]
        scale = max(np.abs(ref).max(), 1.0)
        if name.startswith("basis_vec_"):
            err = min(np.abs(got - ref).max(), np.abs(got + ref).max())
            assert err <= 1e-8 * scale, name
        else:
            assert np.abs(got - ref).max() <= 1e-10 * scale, name
    assert np.array_equal(cell_t["partition"], cell_j["partition"])


CLI_ARGS = {
    "poisson": ["-gridsize", "8", "-subdomains", "4"],
    "dg": ["-gridsize", "8", "-subdomains", "4"],
    "elasticity": ["-cells_x", "8", "-cells_y", "2", "-cells_z", "3",
                   "-subdomains_x", "2"],
    "nonlinear_poisson": ["-gridsize", "8", "-subdomains", "4"],
}
CLI_NAMES = {"poisson": "poisson", "convection_diffusion": "poisson",
             "islands": "poisson", "beams": "poisson", "dg": "dg",
             "convection_diffusion_dg": "dg", "elasticity": "elasticity",
             "linear_elasticity": "elasticity",
             "nonlinear_poisson": "nonlinear_poisson",
             "nonlinear": "nonlinear_poisson"}


@pytest.mark.parametrize("name", list(CLI_NAMES))
def test_cli_problem_names(name):
    """Every ``-problem`` name of the JAX package's cli reaches its
    example at a tiny size and converges; the Poisson names set the
    problem the JAX cli sets."""
    from ddm_tpu_torch.examples import cli

    obj, res = cli.main(["-problem", name] + CLI_ARGS[CLI_NAMES[name]],
                        device="cpu")
    assert res.converged
    if CLI_NAMES[name] == "poisson":
        want = {"convection_diffusion": "checkerboard_cd",
                "islands": "islands", "beams": "beams"}.get(name, "simple")
        assert obj.ptree.get("problem", "simple") == want


def test_cli_unknown_problem_exits():
    from ddm_tpu_torch.examples import cli

    with pytest.raises(SystemExit):
        cli.main(["-problem", "heat"], device="cpu")


def test_cli_convection_diffusion_matches_jax(jax_runs):
    """The nonsymmetric convection-diffusion matrix under the default
    Cholesky subdomain solver at 16^2 / 4: both packages factor its
    symmetric part (jnp.linalg.cholesky symmetrizes its input), the JAX
    count (196) and solution."""
    from ddm_tpu_torch.api import solution
    from ddm_tpu_torch.examples import cli

    p, res = cli.main(["-problem", "convection_diffusion", "-gridsize", "16",
                       "-subdomains", "4"], device="cpu")
    it_j, u_j = jax_runs["convection_diffusion"]
    assert res.converged and res.iterations == it_j
    assert _rel(solution(p, res).numpy(), u_j) <= 1e-8


def test_elasticity_driver_matches_jax(jax_runs):
    """The 3-D steel-rubber bar example at 8 x 2 x 3 cells, 2 slabs, the
    shipped ini and the scripted coefficient file: the JAX count (6)."""
    from ddm_tpu_torch.examples import linearelasticity

    p, res = linearelasticity.main(elasticity_argv("ddm_tpu_torch"),
                                   device="cpu")
    it_j, x_j = jax_runs["elasticity"]
    assert p.topo.n_sub == 2 and p.disc.n_dofs == 9 * 3 * 4 * 3
    assert res.converged and res.iterations == it_j
    assert _rel(res.x.numpy(), x_j) <= 1e-8


def test_dg_example_scripted_matches_jax(jax_runs):
    """The DG example with the symmetric convection-diffusion file at
    16^2 / 4 RCB subdomains: the JAX count and solution."""
    from ddm_tpu_torch.examples import convectiondiffusiondg

    p, res = convectiondiffusiondg.main(dg_argv("ddm_tpu_torch"), device="cpu")
    it_j, x_j = jax_runs["dg"]
    assert res.converged and res.iterations == it_j
    assert _rel(res.x.numpy(), x_j) <= 1e-8


def test_solver_bench_runs():
    """The benchmark at -n 64 -batch 2 -resolves 2: four modes and the
    SuperLU row; the f64 modes solve to 1e-8, the f32 inverse to 1e-3."""
    from ddm_tpu_torch.examples import solver_bench

    rows = solver_bench.main(["-n", "64", "-batch", "2", "-resolves", "2"],
                             device="cpu")
    assert [r["name"] for r in rows] == [m[0] for m in solver_bench.MODES] + [
        "scipy SuperLU (seq)"]
    for r in rows[:-1]:
        assert r["resid"] <= (1e-3 if r["name"].endswith("f32") else 1e-8)
        assert r["factor_ms"] > 0 and r["resolve_ms"] > 0


def test_examples_need_cuda_unless_asked(monkeypatch):
    from ddm_tpu_torch.examples import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("poisson", "elasticity"):
        with pytest.raises(RuntimeError):
            cli.main(["-problem", name] + CLI_ARGS[name])


@pytest.mark.parametrize("name", INI_NAMES)
def test_copied_ini_files(name):
    """Each copied ini equals the JAX package's below its first line (the
    comment that says where it comes from)."""
    lines = {pkg: open(os.path.join(CONFIGS[pkg], name)).read().split("\n")
             for pkg in CONFIGS}
    assert lines["ddm_tpu_torch"][1:] == lines["ddm_tpu"][1:]


def test_copied_vtk_module():
    paths = [os.path.join(ROOT, pkg, "fem", "vtk.py") for pkg in CONFIGS]
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "dd"])
def test_cuda_poisson_main_reduced_precision(precision, cuda_device):
    """``examples.poisson.main`` at 32^2 / 16 (simple, 1e-8) with the f32
    or dd subdomain precision on the card against the f64 run on the CPU:
    iterations within 1, solutions within 1e-6; dd launches the kernel 3
    times per Schwarz apply."""
    from ddm_tpu_torch.api import solution
    from ddm_tpu_torch.examples import poisson
    from ddm_tpu_torch.kernels import ddmatvec

    argv = poisson_argv("ddm_tpu_torch", "simple_f32")[:-2]
    ddmatvec.dd_matvec_cuda.shapes.clear()
    pg, rg = poisson.main(
        argv + ["-schwarz.subdomain_solver.precision", precision],
        device=cuda_device)
    launches = sum(ddmatvec.dd_matvec_cuda.shapes.values())
    pc, rc = poisson.main(argv, device="cpu")
    assert rg.converged and abs(rg.iterations - rc.iterations) <= 1
    assert _rel(solution(pg, rg).cpu().numpy(), solution(pc, rc).numpy()) <= 1e-6
    assert (launches > 0) == (precision == "dd")
