"""Batched dense generalized eigensolver for GenEO-type pencils.

Counterpart of the exact-f64 path of ``ddm_tpu/eigen/dense_gevp.py``
(reference: the per-subdomain Spectra shift-invert Lanczos,
dune/ddm/eigensolvers/spectra.hh:28-256).  All subdomain pencils

    A v = lambda C v,  A SPSD (Neumann), C SPSD (POU-scaled Neumann)

solve at once through the inverted-pencil congruence transform

    L = chol(A + sigma*C + eps*I),  S = L^{-1} C L^{-T},
    eigh(S) -> mu (ascending),  lambda = 1/mu - sigma,  v = L^{-T} w,

so the largest mu are the smallest lambda.  ``sigma`` is the exact spectral
C-shift of ``EigensolverParams.shift``.  For indefinite A (``spd=False``:
DG Neumann sums, which lose cross-boundary penalty coupling) the congruence
factor is A^{-1/2} = diag(max(d, eps)^{-1/2}) Q^T from an ``eigh`` of A's
symmetric part instead of a Cholesky factor: negative A-modes are clipped
to eps and surface as small lambda, i.e. they join the coarse space.  The
TPU package's f32 seed, staged whitening and subspace refinement were TPU
speed paths and are left out; ``eigensolver.precision``/``whiten``/``seed_*`` keys are accepted and
ignored.  ``torch.linalg.eigh`` is a plain library call, as the JAX package
leaves its eigh to XLA.
"""

from __future__ import annotations

import numpy as np
import torch

from .params import EigensolverParams


def _eigh(S: torch.Tensor):
    """``torch.linalg.eigh`` of the batch S.  On the CPU, MKL's syevd does
    not converge on some rank-deficient pencils whose rows are mostly zero
    (msgfem's reduced pencils at islands 384^2/256: rank 50 of 848, under
    any thread count); there numpy's LAPACK decomposes the batch, as the
    JAX package's CPU eigh (LAPACK through scipy) does on the same
    matrices."""
    try:
        return torch.linalg.eigh(S)
    except torch.linalg.LinAlgError:
        if S.device.type != "cpu":
            raise
        mu, W = np.linalg.eigh(S.numpy())
        return torch.from_numpy(mu), torch.from_numpy(W)


def cholqr2(W: torch.Tensor) -> torch.Tensor:
    """Orthonormalize the columns of a batch of tall blocks (n_sub, p, k)
    by two rounds of column-normalized shifted CholQR."""
    k = W.shape[-1]
    eye = torch.eye(k, dtype=W.dtype, device=W.device)
    shift = (1e-14 if W.dtype == torch.float64 else 1e-6) * k
    tiny = 1e-300 if W.dtype == torch.float64 else 1e-30
    for _ in range(2):
        nrm = torch.sqrt(torch.sum(W * W, dim=1, keepdim=True))
        W = W / torch.clamp(nrm, min=tiny)
        G = W.mT @ W + shift * eye
        L = torch.linalg.cholesky(G)
        Linv = torch.linalg.solve_triangular(L, eye.expand_as(G), upper=False)
        W = W @ Linv.mT
    return W


def solve_gevp_dense(
    A: torch.Tensor,
    C: torch.Tensor,
    params: EigensolverParams,
    reg: float = 1e-12,
    spd: bool = True,
):
    """Solve the batched pencil (A, C), keeping the smallest-lambda
    eigenpairs; ``spd=False`` takes the eigendecomposition factor of A.

    A, C: (n_sub, p, p) symmetric.  Returns (lam (n_sub, m), V (n_sub, m, p)
    eigenvectors as rows, active (n_sub, m) bool) with m = params.max_kept.
    Selection mirrors spectra.hh:157-189: threshold > 0 keeps lambda <
    threshold (at least 1, at most nev_max); threshold <= 0 keeps exactly
    nev."""
    n_sub, p, _ = A.shape
    m = min(params.max_kept, p)
    sigma = float(max(params.shift, 0.0))
    if sigma > 0.0:
        A = A + sigma * C
    # regularization scaled by the mean diagonal
    scale = torch.mean(torch.abs(torch.diagonal(A, dim1=1, dim2=2)), dim=1)
    eps = reg * torch.clamp(scale, min=1.0)
    if spd:
        eye = torch.eye(p, dtype=A.dtype, device=A.device)
        Areg = A.clone()
        Areg.diagonal(dim1=1, dim2=2).add_(eps[:, None])
        L = torch.linalg.cholesky(Areg)
        del Areg
        Linv = torch.linalg.solve_triangular(L, eye.expand_as(A), upper=False)
        del L
    else:
        d, Q = _eigh(0.5 * (A + A.mT))
        d = torch.clamp(d, min=eps[:, None])
        # any square root serves the congruence: A^{-1/2} = d^{-1/2} Q^T
        Linv = Q.mT / torch.sqrt(d)[:, :, None]
        del d, Q
    S = Linv @ C @ Linv.mT
    S = 0.5 * (S + S.mT)
    mu, Wt = _eigh(S)
    del S
    # top-m mu == smallest-m lambda; reorder so lambda ascends
    mu_sel = mu[:, -m:].flip(1)  # (n_sub, m)
    W_sel = Wt[:, :, -m:].flip(2)  # (n_sub, p, m)
    mu_floor = 1e-300
    lam = 1.0 / torch.clamp(mu_sel, min=mu_floor) - sigma
    V = torch.einsum("sqp,sqk->skp", Linv, W_sel)  # v = L^{-T} w, as rows

    if params.threshold > 0:
        keep = lam < params.threshold
        keep[:, 0] = True  # at least one vector per subdomain (spectra.hh:162)
        keep = torch.cumprod(keep.to(torch.int32), dim=1).to(torch.bool)
    else:
        keep = torch.ones((n_sub, m), dtype=torch.bool, device=A.device)
    # degenerate pencils: mu at the floor means lambda -> inf (padding,
    # Dirichlet, or common-kernel modes) — drop them
    keep = keep & (mu_sel > 1e3 * mu_floor)
    if params.threshold <= 0:
        keep[:, 0] = True
    return lam, V, keep
