"""The port's GMRES loops on the JAX package's own operator and
preconditioner, against the JAX package's loops on the same: islands
32^2 / 16 subdomains, geneo nev 8, GMRES(50) and flexible GMRES(50) to
1e-8 (``test_torch_slice.py``'s configuration).

At full size each package's loop, on either package's operator and
preconditioner, meets the target at the same iteration (PERF.md section
2).  Here both loops run on the JAX package's jitted ``A.mv`` and
``M.apply`` (numpy to torch CPU tensors) and must take the same count:
unverified, the Givens estimate's first hit; verified, the count of the
restarts' recomputed defects.  Each loop is called with ``verify`` as a
bool: the JAX package's ``solve_from_config`` passes ``solver.verify`` on
as the string its parameter tree holds, and the string ``"False"``
verifies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddm_tpu.api as japi
from ddm_tpu.fem import problems as jproblems
from ddm_tpu.solvers import krylov as jkrylov
from ddm_tpu_torch.solvers import krylov as tkrylov

from blas_threads import one_blas_thread  # noqa: E402,F401

torch.set_num_threads(2)

LOOPS = {"gmres": (jkrylov.gmres_solve, tkrylov.gmres_solve),
         "fgmres": (jkrylov.fgmres_solve, tkrylov.fgmres_solve)}


@pytest.fixture(scope="module")
def problem():
    """The JAX package's problem, preconditioner and their jitted calls."""
    pt = japi.default_ptree()
    pt["gridsize"] = 32
    pt["overlap"] = 2
    pt["coarsespace.type"] = "geneo"
    pt["geneo.eigensolver.nev"] = 8
    pt["coarse_solver.type"] = "cholesky"
    p = japi.setup_problem(pt, problem=jproblems.islands(), parts=(4, 4))
    M = japi.build_preconditioner(p)
    mv, apply = jax.jit(lambda x: p.A.mv(x)), jax.jit(lambda d: M.apply(d))

    def torched(fn):
        return lambda x: torch.from_numpy(
            np.array(fn(jnp.asarray(x.numpy()))))

    return p, M, torched(mv), torched(apply)


@pytest.mark.parametrize("loop", list(LOOPS))
@pytest.mark.parametrize("verify", [False, True])
def test_port_loop_on_jax_operator_takes_jax_count(problem, loop, verify):
    p, M, mv, apply = problem
    j_loop, t_loop = LOOPS[loop]
    args = dict(reduction=1e-8, maxit=400, restart=50, verify=verify)
    rj = j_loop(jkrylov.operator_of(p.A), jkrylov.prec_of(M), p.rhs,
                jnp.zeros_like(p.rhs), **args)
    b = torch.from_numpy(np.array(p.rhs))
    rt = t_loop(mv, apply, b, torch.zeros_like(b), **args)
    assert bool(rj.converged) and rt.converged
    assert rt.iterations == int(rj.iterations), (rt.iterations,
                                                 int(rj.iterations))
    if not verify:
        assert rt.estimate_hit == int(rj.iterations)
