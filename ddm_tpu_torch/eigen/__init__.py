"""Eigensolver subsystem, dispatched by config like the reference's
solve_gevp (dune/ddm/eigensolvers/eigensolvers.hh:14-38).  Only the dense
path is ported; the iterative (LOBPCG) types of ``ddm_tpu/eigen`` are not."""

from .dense_gevp import cholqr2, solve_gevp_dense  # noqa: F401
from .params import EigensolverParams  # noqa: F401

_DENSE_NAMES = {"spectra", "dense", "auto"}


def solve_gevp(A, C, params: EigensolverParams):
    """Solve the batched SPD pencil A v = lambda C v, keeping the smallest
    eigenpairs per ``params``.  Returns (lam, V, active) with the
    (n_sub, params.max_kept) layout.  ``auto`` is dense: the TPU package's
    dense/LOBPCG crossover is at p = 2048, above every ported case."""
    if params.type.lower() not in _DENSE_NAMES:
        raise ValueError(f"eigensolver type '{params.type}' is not ported")
    return solve_gevp_dense(A, C, params)
