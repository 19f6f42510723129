"""Batched dense direct solvers for subdomain problems.

Counterpart of ``ddm_tpu/solvers/direct.py`` (reference: the UMFPACK /
CHOLMOD subdomain factorizations, dune/ddm/schwarz.hh:85-92, and the
multi-RHS resolve, dune/ddm/eigensolvers/umfpack.hh:132-251).  Subdomain
matrices arrive as a padded dense batch (n_sub, p, p) whose padding
diagonal is 1.  Factor once at setup, apply per Krylov iteration.

Cholesky for SPD matrices and partial-pivoting LU for general ones.  Only
the exact f64 constructions are ported: the TPU package's f32-seeded
Newton inverse, blocked Cholesky / triangular inverse and batch caps were
TPU workarounds; their config keys are accepted and ignored by the callers.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.ddmatvec import dd_matvec

_LU_NAMES = {"lu", "umfpack", "superlu", "strumpack"}
_CHOL_NAMES = {"cholesky", "cholmod"}


def resolve_solver_type(solver_type: str) -> str:
    """Map reference solver names to the factorization used here:
    "cholesky" or "lu" (the JAX package's QR stands in for LU on the TPU
    only and is not ported)."""
    st = solver_type.lower()
    if st in _CHOL_NAMES:
        return "cholesky"
    if st in _LU_NAMES:
        return "lu"
    raise ValueError(f"Unknown subdomain solver type '{solver_type}'")


@dataclass
class BatchedLU:
    lu: torch.Tensor  # (n_sub, p, p) packed L and U
    piv: torch.Tensor  # (n_sub, p) int32 pivots

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """b: (n_sub, p) or (n_sub, p, k)."""
        bb = b[..., None] if b.ndim == 2 else b
        x = torch.linalg.lu_solve(self.lu, self.piv, bb)
        return x[..., 0] if b.ndim == 2 else x


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


SLAB_BYTES = 6 << 30  # device memory one slab's temporaries may take


def batch_chunk_size(p: int, live_buffers: int) -> int:
    """How many (p, p) f64 subdomain blocks go through a dense setup
    pipeline at once when the pipeline holds ``live_buffers`` chunk-sized
    temporaries: as many as keep them inside ``SLAB_BYTES``."""
    return max(1, SLAB_BYTES // max(8 * p * p * live_buffers, 1))


def chunked_batch(fn, *arrays, chunk: int):
    """Apply the batched ``fn`` (tensors split along axis 0 -> a tuple of
    batch-leading tensors) over slabs of ``chunk`` subdomains, writing each
    slab's results into preallocated outputs, so only one slab's
    temporaries are alive beside the inputs and the results.  One call when
    the batch fits in a slab."""
    n = arrays[0].shape[0]
    if chunk >= n:
        return fn(*arrays)
    outs = None
    for i in range(0, n, chunk):
        part = fn(*(a[i:i + chunk] for a in arrays))
        if outs is None:
            outs = tuple(x.new_empty((n,) + x.shape[1:]) for x in part)
        for out, x in zip(outs, part):
            out[i:i + chunk] = x
        del part
    return outs


def factor_batched(
    A: torch.Tensor,
    solver_type: str = "cholesky",
    mode: str = "auto",
    store_dtype=None,
):
    """Factor a batch of dense subdomain matrices (n_sub, p, p): SPD ones
    by Cholesky, general ones by LU, per ``solver_type``.

    mode: "factors" keeps the triangular factors (two triangular solves per
    apply), "inverse" forms the explicit inverse (L^{-T} L^{-1}, exactly
    symmetric, for Cholesky; a solve against I for LU; one batched matvec
    per apply), "auto" takes factors for CPU
    tensors and inverses for CUDA tensors — on the card the apply is then a
    bandwidth-bound matvec instead of 2p dependent substitution steps.
    store_dtype: None (f64) or "dd" (inverse mode only)."""
    st = resolve_solver_type(solver_type)
    if mode == "auto":
        mode = "factors" if A.device.type == "cpu" else "inverse"
    if mode not in ("factors", "inverse"):
        raise ValueError(f"unknown factorization mode '{mode}'")
    if store_dtype not in (None, "dd"):
        raise ValueError(f"store_dtype '{store_dtype}' is not ported")
    if mode == "factors":
        if store_dtype is not None:
            raise ValueError("store_dtype needs mode='inverse'")
        if st == "cholesky":
            return BatchedCholesky(chol=torch.linalg.cholesky(A))
        return BatchedLU(*_lu_factor(A))

    def inverse(a):
        eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
        if st == "lu":
            # lu_solve returns column-major storage; the dd kernel reads
            # row-major rows, and an LU inverse is not symmetric
            inv = torch.linalg.lu_solve(*_lu_factor(a),
                                        eye.expand_as(a)).contiguous()
        else:
            linv = torch.linalg.solve_triangular(
                torch.linalg.cholesky(a), eye.expand_as(a), upper=False)
            inv = linv.mT @ linv
        return dd_split(inv) if store_dtype == "dd" else (inv,)

    # slabs of subdomains: beside A and the stored inverse only one slab's
    # factor, triangular inverse and product (and the dd split's f64
    # temporaries) are alive, not whole batches of them
    out = chunked_batch(inverse, A,
                        chunk=batch_chunk_size(A.shape[-1], live_buffers=6))
    if store_dtype == "dd":
        return BatchedInverseDD(inv_hi=out[0], inv_lo=out[1])
    return BatchedInverse(inv=out[0])


def _lu_factor(A: torch.Tensor):
    if A.device.type == "cpu":
        # one matrix at a time: the batched CPU getrf of some PyTorch/MKL
        # builds fails (DLASWP) under several threads
        pairs = [torch.linalg.lu_factor(a) for a in A]
        return (torch.stack([f[0] for f in pairs]),
                torch.stack([f[1] for f in pairs]))
    return torch.linalg.lu_factor(A)
