"""Sparse matrices in padded row-major ELL format, and fixed-order sums.

Counterpart of ``ddm_tpu/core/sparse.py``.  Every row holds ``m`` (column,
value) slots; padding slots point at the dummy column ``n`` with value 0,
so SpMV is one gather, one multiply and one row sum.  The TPU package's
slot-major (transposed) layout, its stencil-offset slot assignment and its
tiled gathers were TPU layout rules and are not carried over: the layout
here is plain row-major ``(n, m)`` with the rows' entries packed in column
order.

Assembly sums several element contributions into one slot.  On a GPU an
atomic scatter-add sums them in a different order on every run, so every
such sum here goes through a :class:`SumPlan`: a host-built (target, fixed
list of sources) table, applied as one gather and one sum over a fixed axis.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class SumPlan:
    """Deterministic scatter-add: ``out.view(-1)[targets[u]] = sum_k
    src.view(-1)[dual[u, k]]`` with the sources of each target summed in
    ascending source order.  ``dual`` pads with ``n_src``, the index of a
    zero appended to the source."""

    targets: torch.Tensor  # (U,) int64 distinct target positions
    dual: torch.Tensor  # (U, K) int64 source positions, pad == n_src
    n_src: int

    @staticmethod
    def build(src_idx: np.ndarray, tgt_idx: np.ndarray, n_src: int,
              device) -> "SumPlan":
        """Plan for adding ``src[src_idx[i]]`` into ``out[tgt_idx[i]]``.
        The index arrays come from the host; the sort that groups them by
        target (then by source) runs on ``device``, where tens of millions
        of entries (3-D Neumann sums) take milliseconds."""
        src = torch.as_tensor(np.asarray(src_idx, dtype=np.int64).reshape(-1),
                              device=device)
        tgt = torch.as_tensor(np.asarray(tgt_idx, dtype=np.int64).reshape(-1),
                              device=device)
        # two stable sorts = one lexicographic (target, source) order
        src, order = torch.sort(src, stable=True)
        tgt, order = torch.sort(tgt[order], stable=True)
        src = src[order]
        del order
        targets, counts = torch.unique_consecutive(tgt, return_counts=True)
        K = int(counts.max()) if counts.numel() else 1
        start = torch.cumsum(counts, 0) - counts
        seg = torch.repeat_interleave(
            torch.arange(targets.numel(), device=device), counts)
        pos = torch.arange(tgt.numel(), device=device) - start[seg]
        dual = torch.full((targets.numel(), K), n_src, dtype=torch.int64,
                          device=device)
        dual[seg, pos] = src
        return SumPlan(targets=targets, dual=dual, n_src=n_src)

    def sums(self, src: torch.Tensor) -> torch.Tensor:
        """(U,) per-target sums of the flattened ``src``."""
        flat = torch.cat([src.reshape(-1), src.new_zeros(1)])
        return flat[self.dual].sum(dim=1)

    def scatter(self, src: torch.Tensor, size: int) -> torch.Tensor:
        """Dense (size,) result: the per-target sums, zeros elsewhere."""
        out = src.new_zeros(size)
        out[self.targets] = self.sums(src)
        return out


@dataclass
class SparseELL:
    """Device sparse matrix, padded ELL, row-major.

    cols: (n, m) int64, padding slots == n (dummy column)
    vals: (n, m) float64
    """

    cols: torch.Tensor
    vals: torch.Tensor

    @property
    def n(self) -> int:
        return self.cols.shape[0]

    @property
    def m(self) -> int:
        return self.cols.shape[1]

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x.  x: (n,) or (n, k)."""
        xp = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
        if x.ndim == 1:
            return (self.vals * xp[self.cols]).sum(dim=1)
        return torch.einsum("nm,nmk->nk", self.vals, xp[self.cols])

    def diagonal(self) -> torch.Tensor:
        row = torch.arange(self.n, device=self.cols.device)[:, None]
        return torch.where(self.cols == row, self.vals, 0.0).sum(dim=1)

    def rows_dense_gather(self, rows: torch.Tensor):
        """(vals, cols) of the given global rows: rows (...,) -> (..., m)."""
        return self.vals[rows], self.cols[rows]


@dataclass
class EllPattern:
    """Host-side symbolic pattern + assembly plan.

    n : matrix size
    m : padded row width (max nnz per row)
    cols : (n, m) int64 column ids, padding == n (host)
    coo2slot : (n_coo,) int64 flat row-major ELL slot (row * m + pos) of
               each COO entry passed to :meth:`from_coo`, in original order
    rows_csr / cols_csr / slot_csr : the unique entries in CSR order and
               their flat ELL slots
    """

    n: int
    m: int
    cols: np.ndarray
    coo2slot: np.ndarray
    rows_csr: np.ndarray
    cols_csr: np.ndarray
    slot_csr: np.ndarray

    @staticmethod
    def from_coo(rows: np.ndarray, cols: np.ndarray, n: int) -> "EllPattern":
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        uniq, inverse = np.unique(rows * n + cols, return_inverse=True)
        urows = uniq // n
        ucols = uniq % n
        row_nnz = np.bincount(urows, minlength=n)
        m = int(row_nnz.max()) if row_nnz.size else 1
        row_start = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(row_nnz, out=row_start[1:])
        pos = np.arange(uniq.size) - row_start[urows]
        slot = urows * m + pos
        ell_cols = np.full((n, m), n, dtype=np.int64)
        ell_cols[urows, pos] = ucols
        return EllPattern(
            n=n, m=m, cols=ell_cols, coo2slot=slot[inverse.reshape(-1)],
            rows_csr=urows, cols_csr=ucols, slot_csr=slot,
        )

    def assembly_plan(self, device) -> SumPlan:
        """Plan summing COO values (in from_coo order) into ELL slots."""
        return SumPlan.build(
            np.arange(self.coo2slot.size), self.coo2slot,
            self.coo2slot.size, device,
        )

    def assemble(self, coo_vals: torch.Tensor, plan: SumPlan) -> SparseELL:
        """Sum COO values (in from_coo order) into a SparseELL."""
        flat = plan.scatter(coo_vals, self.n * self.m)
        return SparseELL(
            cols=torch.as_tensor(self.cols, device=coo_vals.device),
            vals=flat.reshape(self.n, self.m),
        )

    def to_scipy(self, ell: SparseELL):
        import scipy.sparse as sps

        vals = ell.vals.detach().cpu().numpy().reshape(-1)[self.slot_csr]
        return sps.csr_matrix(
            (vals, (self.rows_csr, self.cols_csr)), shape=(self.n, self.n)
        )


def jacobi_equilibrate(ell: SparseELL, b: torch.Tensor):
    """Symmetric Jacobi equilibration: A' = D^{-1/2} A D^{-1/2},
    b' = D^{-1/2} b.  Returns (A', b', scale) with ``scale = D^{-1/2}``; the
    solution transforms back as x = scale * x'."""
    diag = ell.diagonal()
    scale = torch.where(diag > 0, 1.0 / torch.sqrt(torch.abs(diag)), 1.0)
    sp = torch.cat([scale, scale.new_zeros(1)])
    vals = ell.vals * scale[:, None] * sp[ell.cols]
    return dataclasses.replace(ell, vals=vals), b * scale, scale


def eliminate_dirichlet(
    ell: SparseELL, dmask: torch.Tensor, symmetric: bool = True
) -> SparseELL:
    """Symmetric Dirichlet elimination (reference semantics,
    examples/pdelab_helper.hh:33-46): Dirichlet rows become identity rows;
    with ``symmetric``, Dirichlet columns of the other rows are zeroed."""
    d = dmask.to(torch.bool)
    dp = torch.cat([d, d.new_zeros(1)])  # the padding column is never Dirichlet
    row_d = d[:, None]
    col_d = dp[ell.cols]
    row = torch.arange(ell.n, device=ell.cols.device)[:, None]
    is_diag = ell.cols == row
    vals = torch.where(row_d, is_diag.to(ell.vals.dtype), ell.vals)
    if symmetric:
        vals = torch.where(~row_d & col_d, 0.0, vals)
    return dataclasses.replace(ell, vals=vals)
