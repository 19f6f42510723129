"""Batched dense direct solvers for subdomain problems.

Counterpart of ``ddm_tpu/solvers/direct.py`` (reference: the UMFPACK /
CHOLMOD subdomain factorizations, dune/ddm/schwarz.hh:85-92, and the
multi-RHS resolve, dune/ddm/eigensolvers/umfpack.hh:132-251).  Subdomain
matrices arrive as a padded dense batch (n_sub, p, p) whose padding
diagonal is 1.  Factor once at setup, apply per Krylov iteration.

Cholesky for SPD matrices and partial-pivoting LU for general ones.  Only
the exact f64 constructions are ported (an explicit inverse is always
formed in f64, then stored in f64, double-single or f32): the TPU
package's f32-seeded Newton inverse, blocked Cholesky / triangular inverse
and batch caps were TPU workarounds; their config keys are accepted and
ignored by the callers.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.ddmatvec import dd_matvec, tf32_off

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

    inv: torch.Tensor  # (n_sub, p, p) f64, or f32 (store_dtype)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """b: (n_sub, p) or (n_sub, p, k), f64; an f32 inverse is applied
        in full f32 (TF32 off) to b rounded to f32."""
        bb = (b[..., None] if b.ndim == 2 else b).to(self.inv.dtype)
        with tf32_off():
            x = self.inv @ bb
        return (x[..., 0] if b.ndim == 2 else x).to(b.dtype)


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
    dune/ddm/eigensolvers/umfpack.hh:42-129).  ``solve`` takes b of shape
    (n_sub, p) or, refining k columns at once, (n_sub, p, k)."""

    inv_hi: torch.Tensor  # (n_sub, p, p) float32
    inv_lo: torch.Tensor  # (n_sub, p, p) float32
    sub_vals: torch.Tensor | None = None  # (n_sub, p, m) f64 sparse rows
    sub_cols: torch.Tensor | None = None  # (n_sub, p, m) int64, dummy == p
    steps: int = 0

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        x = dd_matvec(self.inv_hi, self.inv_lo, b)
        for _ in range(self.steps):
            r = b - sparse_amul(self.sub_vals, self.sub_cols, x)
            x = x + dd_matvec(self.inv_hi, self.inv_lo, r)
        return x


@dataclass
class SparseRefinedInverse:
    """f32 explicit subdomain inverses plus ``steps`` rounds of defect
    correction with the exact sparse f64 subdomain residual

        x <- x + X32 (b - A_sub x)

    (``ddm_tpu/solvers/direct.py:SparseRefinedInverse``; reference: the
    blockwise iterative refinement of
    dune/ddm/eigensolvers/umfpack.hh:42-129).  The f32 product is a
    batched matvec in full f32 (TF32 off, as the JAX package's einsum on
    the CPU); several right-hand sides are refined column by column."""

    inv32: torch.Tensor  # (n_sub, p, p) float32
    sub_vals: torch.Tensor  # (n_sub, p, m) f64 sparse rows of A_sub
    sub_cols: torch.Tensor  # (n_sub, p, m) int64 local cols, dummy == p
    steps: int = 2

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        if b.ndim == 3:
            return torch.stack([self.solve(b[..., k])
                                for k in range(b.shape[-1])], dim=-1)
        fast = BatchedInverse(self.inv32).solve
        x = fast(b)
        for _ in range(self.steps):
            r = b - sparse_amul(self.sub_vals, self.sub_cols, x)
            x = x + fast(r)
        return x


def sparse_amul(sub_vals: torch.Tensor, sub_cols: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """Exact f64 A_sub @ x from the subdomains' sparse rows (vals and
    local cols (n_sub, p, m), dummy column p); x: (n_sub, p) or, for k
    right-hand sides, (n_sub, p, k)."""
    if x.ndim == 3:
        return torch.stack([sparse_amul(sub_vals, sub_cols, x[..., j])
                            for j in range(x.shape[2])], dim=-1)
    n_sub, p = x.shape
    pad = torch.cat([x, x.new_zeros((n_sub, 1))], dim=1)
    xs = torch.gather(pad, 1, sub_cols.reshape(n_sub, -1))
    return (sub_vals * xs.reshape(sub_cols.shape)).sum(dim=2)


_STORE_DTYPES = (None, "dd", torch.float32)


def pack_inverse(inv: torch.Tensor, store_dtype=None):
    """Wrap an explicit inverse batch: None -> f64 BatchedInverse,
    "dd" -> double-single BatchedInverseDD, torch.float32 -> an f32
    BatchedInverse."""
    if store_dtype not in _STORE_DTYPES:
        raise ValueError(f"store_dtype '{store_dtype}' is not ported")
    if store_dtype == "dd":
        hi, lo = dd_split(inv)
        return BatchedInverseDD(inv_hi=hi, inv_lo=lo)
    return BatchedInverse(inv=inv if store_dtype is None
                          else inv.to(store_dtype))


SLAB_BYTES = 6 << 30  # device memory one slab's temporaries may take


def batch_chunk_size(p: int, dtype_bytes: int = 8, live_buffers: int = 20,
                     budget_bytes: int | None = None) -> int:
    """How many (p, p) subdomain blocks of ``dtype_bytes`` per entry go
    through a dense setup pipeline at once when the pipeline holds
    ``live_buffers`` chunk-sized temporaries: as many as keep them inside
    ``budget_bytes`` (default ``SLAB_BYTES``).  The JAX package's
    ``DDM_TPU_BATCH_CHUNK`` override is not read."""
    if budget_bytes is None:
        budget_bytes = SLAB_BYTES
    return max(1, budget_bytes // max(p * p * dtype_bytes * live_buffers, 1))


def chunked_batch(fn, *arrays, chunk: int | None = None):
    """Apply the batched ``fn`` (tensors split along axis 0 -> a tuple of
    batch-leading tensors) over slabs of ``chunk`` subdomains (default
    :func:`batch_chunk_size` of the first tensor's blocks), writing each
    slab's results into preallocated outputs, so only one slab's
    temporaries are alive beside the inputs and the results.  One call when
    the batch fits in a slab."""
    n = arrays[0].shape[0]
    if chunk is None:
        chunk = batch_chunk_size(arrays[0].shape[-1],
                                 arrays[0].element_size())
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
    solver_type: str = "lu",
    mode: str = "auto",
    refine_steps: int | None = None,
    store_dtype=None,
    symmetrize: bool = True,
):
    """Factor a batch of dense subdomain matrices (n_sub, p, p): SPD ones
    by Cholesky, general ones by LU, per ``solver_type``.

    mode: "factors" keeps the triangular factors (two triangular solves per
    apply), "inverse" forms the explicit inverse (L^{-T} L^{-1}, exactly
    symmetric, for Cholesky; a solve against I for LU; one batched matvec
    per apply), "auto" takes factors for CPU
    tensors and inverses for CUDA tensors — on the card the apply is then a
    bandwidth-bound matvec instead of 2p dependent substitution steps.
    refine_steps: the JAX package's Newton polish of the inverse, a TPU
    workaround that is off there by default; only None and 0 (no polish)
    are accepted.
    store_dtype: None (f64), "dd" or torch.float32 (inverse mode only).
    symmetrize: Cholesky factors (A + A^T) / 2, as ``jnp.linalg.cholesky``
    does in the JAX package (bit-equal to A when A is symmetric; a
    nonsymmetric A, convection-diffusion under the default Cholesky
    solver, is factored as the JAX package factors it); False reads A's
    lower triangle, as the Galerkin coarse factor does (ROADMAP queue 3)."""
    st = resolve_solver_type(solver_type)
    if mode == "auto":
        mode = "factors" if A.device.type == "cpu" else "inverse"
    if mode not in ("factors", "inverse"):
        raise ValueError(f"unknown factorization mode '{mode}'")
    if store_dtype not in _STORE_DTYPES:
        raise ValueError(f"store_dtype '{store_dtype}' is not ported")
    if refine_steps:
        raise ValueError("refine_steps > 0 (Newton polish) is not ported")
    if mode == "factors":
        if store_dtype is not None:
            raise ValueError("store_dtype needs mode='inverse'")
        if st == "cholesky":
            return BatchedCholesky(chol=torch.linalg.cholesky(
                (A + A.mT) * 0.5 if symmetrize else A))
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
                torch.linalg.cholesky((a + a.mT) * 0.5 if symmetrize else a),
                eye.expand_as(a), upper=False)
            inv = linv.mT @ linv
        if store_dtype == "dd":
            return dd_split(inv)
        return (inv if store_dtype is None else inv.to(store_dtype),)

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
