"""Batched dense direct solvers for subdomain problems.

Counterpart of ``ddm_tpu/solvers/direct.py`` (reference: the UMFPACK /
CHOLMOD subdomain factorizations, dune/ddm/schwarz.hh:85-92, and the
multi-RHS resolve, dune/ddm/eigensolvers/umfpack.hh:132-251).  Subdomain
matrices arrive as a padded dense batch (n_sub, p, p) whose padding
diagonal is 1.  Factor once at setup, apply per Krylov iteration.

Only the exact f64 constructions are ported: the TPU package's f32-seeded
Newton inverse, blocked Cholesky / triangular inverse and batch caps were
TPU workarounds; their config keys are accepted and ignored by the callers.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.ddmatvec import dd_matvec

_CHOL_NAMES = {"cholesky", "cholmod"}


def resolve_solver_type(solver_type: str) -> str:
    """Map reference solver names to the factorization used here."""
    if solver_type.lower() in _CHOL_NAMES:
        return "cholesky"
    raise ValueError(
        f"subdomain solver type '{solver_type}' is not ported (cholesky only)"
    )


@dataclass
class BatchedCholesky:
    chol: torch.Tensor  # (n_sub, p, p) lower factors

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """b: (n_sub, p) or (n_sub, p, k)."""
        bb = b[..., None] if b.ndim == 2 else b
        y = torch.linalg.solve_triangular(self.chol, bb, upper=False)
        x = torch.linalg.solve_triangular(self.chol.mT, y, upper=True)
        return x[..., 0] if b.ndim == 2 else x


@dataclass
class BatchedInverse:
    """Explicit subdomain inverses: apply = one batched matvec pass."""

    inv: torch.Tensor  # (n_sub, p, p)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        if b.ndim == 2:
            return (self.inv @ b[..., None])[..., 0]
        return self.inv @ b


def dd_split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split f64 into a double-single (hi, lo) f32 pair: hi + lo == a to
    ~2^-48 relative."""
    hi = a.to(torch.float32)
    lo = (a - hi.to(torch.float64)).to(torch.float32)
    return hi, lo


@dataclass
class BatchedInverseDD:
    """Explicit subdomain inverses in double-single storage (half the bytes
    of f64 per apply), applied with :func:`kernels.ddmatvec.dd_matvec`,
    plus ``steps`` rounds of exact sparse-f64 defect correction

        x <- x + (hi + lo) (b - A_sub x)

    with A_sub x computed exactly from the subdomain's sparse rows
    (reference analogue: the blockwise iterative refinement of
    dune/ddm/eigensolvers/umfpack.hh:42-129)."""

    inv_hi: torch.Tensor  # (n_sub, p, p) float32
    inv_lo: torch.Tensor  # (n_sub, p, p) float32
    sub_vals: torch.Tensor | None = None  # (n_sub, p, m) f64 sparse rows
    sub_cols: torch.Tensor | None = None  # (n_sub, p, m) int64, dummy == p
    steps: int = 0

    def _amul(self, x: torch.Tensor) -> torch.Tensor:
        """Exact f64 A_sub @ x via the sparse rows; x: (n_sub, p)."""
        n_sub, p = x.shape
        pad = torch.cat([x, x.new_zeros((n_sub, 1))], dim=1)
        xs = torch.gather(pad, 1, self.sub_cols.reshape(n_sub, -1))
        return (self.sub_vals * xs.reshape(self.sub_cols.shape)).sum(dim=2)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        x = dd_matvec(self.inv_hi, self.inv_lo, b)
        for _ in range(self.steps):
            r = b - self._amul(x)
            x = x + dd_matvec(self.inv_hi, self.inv_lo, r)
        return x


def pack_inverse(inv: torch.Tensor, store_dtype=None):
    """Wrap an explicit inverse batch: None -> f64 BatchedInverse,
    "dd" -> double-single BatchedInverseDD."""
    if store_dtype == "dd":
        hi, lo = dd_split(inv)
        return BatchedInverseDD(inv_hi=hi, inv_lo=lo)
    if store_dtype is not None:
        raise ValueError(f"store_dtype '{store_dtype}' is not ported")
    return BatchedInverse(inv=inv)


def factor_batched(
    A: torch.Tensor,
    solver_type: str = "cholesky",
    mode: str = "auto",
    store_dtype=None,
):
    """Factor a batch of SPD dense subdomain matrices (n_sub, p, p).

    mode: "factors" keeps the Cholesky factors (two triangular solves per
    apply), "inverse" forms the explicit inverse L^{-T} L^{-1} (one batched
    matvec per apply, exactly symmetric), "auto" takes factors for CPU
    tensors and inverses for CUDA tensors — on the card the apply is then a
    bandwidth-bound matvec instead of 2p dependent substitution steps.
    store_dtype: None (f64) or "dd" (inverse mode only)."""
    resolve_solver_type(solver_type)
    if mode == "auto":
        mode = "factors" if A.device.type == "cpu" else "inverse"
    chol = torch.linalg.cholesky(A)
    if mode == "factors":
        if store_dtype is not None:
            raise ValueError("store_dtype needs mode='inverse'")
        return BatchedCholesky(chol=chol)
    if mode != "inverse":
        raise ValueError(f"unknown factorization mode '{mode}'")
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    linv = torch.linalg.solve_triangular(chol, eye.expand_as(A), upper=False)
    del chol
    return pack_inverse(linv.mT @ linv, store_dtype)
