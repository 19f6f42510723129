"""Eigensolver subsystem, dispatched by config like the reference's
solve_gevp (dune/ddm/eigensolvers/eigensolvers.hh:14-38).  The dense path
is ported, for SPD and for indefinite (``spd=False``) pencils; the
iterative (LOBPCG) types of ``ddm_tpu/eigen`` are not."""

from .dense_gevp import cholqr2, solve_gevp_dense  # noqa: F401
from .params import EigensolverParams  # noqa: F401

_DENSE_NAMES = {"spectra", "dense", "auto"}


def solve_gevp(A, C, params: EigensolverParams, spd: bool = True):
    """Solve the batched pencil A v = lambda C v, keeping the smallest
    eigenpairs per ``params``.  Returns (lam, V, active) with the
    (n_sub, params.max_kept) layout.  ``auto`` is dense: the TPU package's
    dense/LOBPCG crossover is at p = 2048, above every ported case, and it
    takes the dense path for indefinite pencils at any size.  ``spd=False``
    (DG Neumann pencils) factors A by an eigendecomposition."""
    if params.type.lower() not in _DENSE_NAMES:
        raise ValueError(f"eigensolver type '{params.type}' is not ported")
    # slabs of subdomains: the transform holds about ten pencil-sized
    # temporaries (regularized A, factor, its inverse, S, all of S's
    # eigenvectors, the library's workspace) to keep max_kept vectors each;
    # the indefinite branch's eigh of A adds its symmetric part and Q
    from ..solvers.direct import batch_chunk_size, chunked_batch

    return chunked_batch(
        lambda a, c: solve_gevp_dense(a, c, params, spd=spd), A, C,
        chunk=batch_chunk_size(A.shape[-1], live_buffers=10 if spd else 12))
