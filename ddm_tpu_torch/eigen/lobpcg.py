"""Batched LOBPCG for generalized eigenproblems.

Counterpart of ``ddm_tpu/eigen/lobpcg.py``: the iterative alternative to
the full dense transform (dense_gevp.py), LOBPCG over the whole subdomain
batch at once.  Every step is a batched tall-skinny product or a small
dense Rayleigh-Ritz ``eigh``; the reference's own dev tree had a block
Lanczos / Krylov-Schur subsystem whose headers are missing from its
snapshot (its examples name "KrylovSchur", examples/poisson.ini:45).

Solves A v = lambda C v for the ``m`` smallest finite lambda, batched over
(n_sub, p, p) pencils, preconditioned with an (approximate) inverse of A.
The iteration runs on the reversed pencil C x = mu A x (mu = 1/lambda,
largest mu = the GenEO targets) with the regularized SPD A as the metric:
C is PSD-singular for GenEO (zero off the overlap) and cannot serve as it.

The arithmetic is the JAX package's, guards included (its Gram shift,
drop cut, zeroing of non-finite ``eigh`` output, column-normalized
residuals, per-subdomain quality with a stall guard, best-or-last
iterate).  Its ``jax.lax.while_loop`` is a Python loop here that reads the
stop condition on the host once per iteration (``torch.linalg.eigh``
synchronizes with the host on the card in any case), and its
``jax.random`` start block is drawn from ``numpy.random.default_rng``, so
the card and the CPU start from the same block.
"""

from __future__ import annotations

import numpy as np
import torch

from .params import EigensolverParams


def _eps(dtype) -> float:
    return 1e-12 if dtype == torch.float64 else 1e-6


def _finite(t: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(t), t, 0.0)


def _rayleigh_ritz(S, C, A, eps):
    """Rayleigh-Ritz on the batched trial space S (n_sub, p, k) for the
    reversed pencil C x = mu A x: returns (mu (n_sub, k), coeff
    (n_sub, k, k)) sorted ascending, with A-orthonormalization of the basis
    built in (whitening against G = S^T A S; near-null trial directions are
    dropped and appear as mu = 0, at the bottom of the order)."""
    G = S.mT @ (A @ S)
    H = S.mT @ (C @ S)
    G = 0.5 * (G + G.mT)
    # a relative diagonal shift breaks degenerate clusters of exact zeros
    # in G (the zero start P block) without moving the drop decision
    gscale = torch.clamp(
        torch.amax(torch.abs(torch.diagonal(G, dim1=1, dim2=2)), dim=1),
        min=eps)
    G = G + torch.diag_embed((1e-14 * gscale)[:, None].expand(-1, G.shape[-1]))
    w, Q = torch.linalg.eigh(G)
    w, Q = _finite(w), _finite(Q)
    good = w > torch.clamp(torch.amax(w, dim=1, keepdim=True), min=eps) * 1e-12
    W = torch.where(good[:, None, :],
                    Q / torch.sqrt(torch.clamp(w, min=eps))[:, None, :], 0.0)
    Hw = W.mT @ H @ W
    mu, Z = torch.linalg.eigh(0.5 * (Hw + Hw.mT))
    return _finite(mu), W @ _finite(Z)


def _colnorm(X: torch.Tensor) -> torch.Tensor:
    """(n_sub, k) 2-norms of the columns of X (n_sub, p, k)."""
    return torch.sqrt(torch.sum(X * X, dim=1))


def lobpcg_gevp(
    A: torch.Tensor,
    C: torch.Tensor,
    X0: torch.Tensor,
    prec_inv: torch.Tensor | None = None,
    m: int | None = None,
    maxit: int = 50,
    tol: float = 1e-6,
):
    """Batched LOBPCG.

    A, C: (n_sub, p, p); X0: (n_sub, p, m) start block; prec_inv: optional
    (n_sub, p, p) preconditioner (approximate A^{-1}); ``m``: the block
    width, X0's when None (any other width raises ``ValueError``: the
    iteration keeps the start block's width).  Returns (lam
    (n_sub, m) ascending, V (n_sub, m, p), residual norms (n_sub, m),
    iterations taken).

    Stops when every block vector of every subdomain satisfies
    ||C x - mu A x|| <= tol * (||C x|| + |mu| ||A x||), at ``maxit``, or
    when every subdomain has gone 3 iterations without its quality
    improving (LOBPCG without soft locking degrades when iterated past
    convergence); each subdomain then returns the better of its best and
    its last iterate."""
    n_sub, p, width = X0.shape
    if m is not None and m != width:
        raise ValueError(f"m = {m} is not the start block's width {width}")
    m = width
    eps = _eps(A.dtype)
    # regularize A exactly like the dense path: keeps the metric SPD on
    # floating (Neumann-singular) subdomains
    scale = torch.mean(torch.abs(torch.diagonal(A, dim1=1, dim2=2)), dim=1)
    A = A + torch.diag_embed(
        (1e-12 * torch.clamp(scale, min=1.0))[:, None].expand(-1, p))

    def mu_of(X, AX, CX):
        return (torch.sum(X * CX, dim=1)
                / torch.clamp(torch.sum(X * AX, dim=1), min=eps))

    def quality(mu):
        # per subdomain: log1p follows the decades the large ritz values
        # (the targets) climb and ignores the noise of the small ones
        return torch.sum(torch.log1p(torch.clamp(mu, min=0.0)), dim=1)

    X, P, Xb = X0, torch.zeros_like(X0), X0
    qb = torch.full((n_sub,), -torch.inf, dtype=A.dtype, device=A.device)
    stall = torch.zeros((n_sub,), dtype=torch.int32, device=A.device)
    it = 0
    go = True
    while it < maxit and go:
        AX, CX = A @ X, C @ X
        mu = mu_of(X, AX, CX)
        q = quality(mu)
        better = q > qb
        Xb = torch.where(better[:, None, None], X, Xb)
        qb = torch.maximum(q, qb)
        stall = torch.where(better, 0, stall + 1)
        R = CX - mu[:, None, :] * AX
        denom = _colnorm(CX) + torch.abs(mu) * _colnorm(AX)
        maxres = torch.amax(_colnorm(R) / torch.clamp(denom, min=eps))
        Wd = prec_inv @ R if prec_inv is not None else R
        # column-normalized preconditioned residuals: on floating
        # subdomains prec ~ A_reg^{-1} amplifies the near-null component
        # to ~1/reg, and the Gram matrix would span ~1e24
        Wd = Wd / torch.clamp(_colnorm(Wd), min=eps)[:, None, :]
        S = torch.cat([X, Wd, P], dim=2)  # (n_sub, p, 3m)
        _, coeff = _rayleigh_ritz(S, C, A, eps)
        Cm = coeff[:, :, -m:].flip(2)  # the largest m of the reversed pencil
        Xn = S @ Cm
        Cp = Cm.clone()
        Cp[:, :m, :] = 0.0  # implicit P: the W and P part of the update
        Pn = S @ Cp
        X = Xn / torch.clamp(_colnorm(Xn), min=eps)[:, None, :]
        P = Pn / torch.clamp(_colnorm(Pn), min=1.0)[:, None, :]
        it += 1
        go = bool(((maxres > tol) & torch.any(stall < 3)).item())

    # final ritz data, per subdomain, from whichever iterate measures best
    def ritz(Xc):
        AXc, CXc = A @ Xc, C @ Xc
        return mu_of(Xc, AXc, CXc), AXc, CXc

    mu_l, AX_l, CX_l = ritz(X)
    mu_b, AX_b, CX_b = ritz(Xb)
    use_last = quality(mu_l) >= quality(mu_b)
    X = torch.where(use_last[:, None, None], X, Xb)
    mu = torch.where(use_last[:, None], mu_l, mu_b)
    AX = torch.where(use_last[:, None, None], AX_l, AX_b)
    CX = torch.where(use_last[:, None, None], CX_l, CX_b)
    rn = _colnorm(CX - mu[:, None, :] * AX)
    # back to the GenEO orientation: lambda = 1/mu ascending; mu at the
    # floor (C-null trial directions) maps to lambda = +inf (inactive)
    lam = torch.where(mu > eps, 1.0 / torch.clamp(mu, min=eps), torch.inf)
    lam, order = torch.sort(lam, dim=1, stable=True)
    rn = torch.gather(rn, 1, order)
    X = torch.gather(X, 2, order[:, None, :].expand(-1, p, -1))
    return lam, X.mT, rn, it


def _default_prec(A: torch.Tensor) -> torch.Tensor:
    """Regularized explicit A-inverse: the batched analogue of the
    reference's reuse of the subdomain factorization inside the eigensolve
    (spectra.hh:42-62)."""
    from ..solvers.direct import factor_batched

    scale = torch.mean(torch.abs(torch.diagonal(A, dim1=1, dim2=2)), dim=1)
    Areg = A + torch.diag_embed(
        (1e-10 * torch.clamp(scale, min=1.0))[:, None].expand(-1, A.shape[-1]))
    return factor_batched(Areg, "cholesky", mode="inverse").inv


# per-process record of the adaptive runs: one dict per call (slab) with the
# block widths tried and the iterations each took
RUNS: list[dict] = []


def lobpcg_gevp_adaptive(
    A: torch.Tensor,
    C: torch.Tensor,
    params: EigensolverParams,
    prec_inv: torch.Tensor | None = None,
):
    """LOBPCG with the reference's adaptive selection (spectra_gevp_op,
    spectra.hh:111-215).

    * start block from ``numpy.random.default_rng(params.seed)``, drawn
      anew at each width;
    * the block width starts at max(nev, blocksize); with ``threshold > 0``,
      while some subdomain's largest computed eigenvalue stays below the
      threshold the width doubles (spectra.hh:185) up to ``max_kept``;
    * returns (lam, V, active) in the (n_sub, params.max_kept) layout of
      the dense solver, with its threshold-prefix selection.

    Each call appends {"widths", "iterations"} to :data:`RUNS`."""
    n_sub, p, _ = A.shape
    m_out = min(params.max_kept, p)
    if prec_inv is None:
        prec_inv = _default_prec(A)
    m = min(max(params.nev, params.blocksize), p, m_out)
    run = {"widths": [], "iterations": []}
    RUNS.append(run)
    while True:
        X0 = np.random.default_rng(params.seed).standard_normal((n_sub, p, m))
        lam, V, _, it = lobpcg_gevp(
            A, C, torch.as_tensor(X0, dtype=A.dtype, device=A.device),
            prec_inv=prec_inv, maxit=params.maxit, tol=params.tolerance)
        run["widths"].append(m)
        run["iterations"].append(it)
        if params.threshold <= 0 or m >= m_out:
            break
        if bool((lam[:, -1] >= params.threshold).all()):
            break
        m = min(2 * m, m_out)

    if m < m_out:  # pad to the static output width
        lam = torch.cat([lam, lam.new_full((n_sub, m_out - m), torch.inf)], 1)
        V = torch.cat([V, V.new_zeros((n_sub, m_out - m, p))], 1)
    if params.threshold > 0:
        keep = lam < params.threshold
        keep[:, 0] = True  # at least one (spectra.hh:162)
        keep = torch.cumprod(keep.to(torch.int32), dim=1).to(torch.bool)
    else:
        keep = torch.ones((n_sub, m_out), dtype=torch.bool, device=A.device)
    keep = keep & torch.isfinite(lam)
    keep[:, 0] |= params.threshold <= 0
    return lam, V, keep
