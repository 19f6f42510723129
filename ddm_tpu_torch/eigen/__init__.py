"""Eigensolver subsystem: the batched dense GEVP and batched LOBPCG,
dispatched by config like the reference's solve_gevp
(dune/ddm/eigensolvers/eigensolvers.hh:14-38 — there only Type::Spectra
is implemented; the "KrylovSchur" type its configs name maps to the
iterative path here)."""

from .dense_gevp import cholqr2, solve_gevp_dense  # noqa: F401
from .params import EigensolverParams  # noqa: F401

_DENSE_NAMES = {"spectra", "dense"}
_ITERATIVE_NAMES = {"krylovschur", "lobpcg", "lanczos", "blocklanczos"}

# Dense/iterative crossover of eigensolver.type=auto, in subdomain size p:
# the JAX package's value, measured on a TPU v5e; kept for parity.  The
# H100's own dense and LOBPCG times stand in PERF.md.
AUTO_CROSSOVER_P = 2048


def solve_gevp_dense_slabs(A, C, params: EigensolverParams, spd: bool = True):
    """The dense solver over slabs of subdomains: the transform holds about
    ten pencil-sized temporaries (regularized A, factor, its inverse, S,
    all of S's eigenvectors, the library's workspace) to keep max_kept
    vectors each; the indefinite branch's eigh of A adds its symmetric part
    and Q."""
    from ..solvers.direct import batch_chunk_size, chunked_batch

    return chunked_batch(
        lambda a, c: solve_gevp_dense(a, c, params, spd=spd), A, C,
        chunk=batch_chunk_size(A.shape[-1], live_buffers=10 if spd else 12))


def solve_gevp(A, C, params: EigensolverParams, spd: bool = True,
               prec_inv=None):
    """Solve the batched pencil A v = lambda C v, keeping the smallest
    eigenpairs per ``params`` (``eigensolver.type``).  Returns (lam, V,
    active) with the (n_sub, params.max_kept) layout of both backends.

    * ``spectra``/``dense``: the congruence-transform dense solver, full
      spectrum, deterministic; ``spd=False`` (DG Neumann pencils) factors A
      by an eigendecomposition.
    * ``krylovschur``/``lobpcg``/``lanczos``/``blocklanczos``: batched
      LOBPCG with the reference's adaptive nev/threshold escalation
      (lobpcg.py), preconditioned by ``prec_inv`` (default: the regularized
      A-inverse of each slab).  SPD pencils only.
    * ``auto``: dense for p <= AUTO_CROSSOVER_P or a non-SPD pencil, else
      LOBPCG.
    """
    t = params.type.lower()
    if t == "auto":
        p = A.shape[-1]
        t = "spectra" if (p <= AUTO_CROSSOVER_P or not spd) else "lobpcg"
    if t in _DENSE_NAMES:
        return solve_gevp_dense_slabs(A, C, params, spd=spd)
    if t in _ITERATIVE_NAMES:
        if not spd:
            raise ValueError(
                "the iterative eigensolver requires an SPD pencil; "
                "indefinite problems must use eigensolver.type=spectra"
            )
        from ..solvers.direct import batch_chunk_size, chunked_batch
        from .lobpcg import lobpcg_gevp_adaptive

        # slabs of subdomains: per slab the regularized A, the start of
        # the preconditioner (its own regularized A) and the preconditioner
        # are alive beside the pencils, and the factorization's slabs
        # beside those
        extra = () if prec_inv is None else (prec_inv,)
        return chunked_batch(
            lambda a, c, *pi: lobpcg_gevp_adaptive(
                a, c, params, prec_inv=pi[0] if pi else None),
            A, C, *extra,
            chunk=batch_chunk_size(A.shape[-1], live_buffers=4))
    raise ValueError(f"Unknown eigensolver type '{params.type}'")
