"""Sparse matrices in padded row-major ELL format, and fixed-order sums.

Counterpart of ``ddm_tpu/core/sparse.py``.  Every row holds ``m`` (column,
value) slots; padding slots point at the dummy column ``n`` with value 0,
so SpMV is a gather and a multiply-add per slot.  The slots are the JAX
package's (its stencil-offset assignment where the pattern is a stencil,
else the rows' entries packed in column order), so each row sums in the
same order and gives the same bits on the CPU; the TPU package's
slot-major (transposed) layout and tiled gathers were TPU layout rules and
are not carried over: the layout here is row-major ``(n, m)``.

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
    def build(src_idx: np.ndarray | torch.Tensor,
              tgt_idx: np.ndarray | torch.Tensor, n_src: int,
              device) -> "SumPlan":
        """Plan for adding ``src[src_idx[i]]`` into ``out[tgt_idx[i]]``.
        The index arrays come from the host or lie on ``device``; the sort
        that groups them by target (then by source) runs on ``device``,
        where tens of millions of entries (3-D Neumann sums) take
        milliseconds."""
        src = torch.as_tensor(src_idx, dtype=torch.int64,
                              device=device).reshape(-1)
        tgt = torch.as_tensor(tgt_idx, dtype=torch.int64,
                              device=device).reshape(-1)
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
        """(U,) per-target sums of the flattened ``src``, each added left to
        right in ascending source order, as the JAX package's scatter-adds
        (``.at[].add``) sum them on XLA's CPU."""
        flat = torch.cat([src.reshape(-1), src.new_zeros(1)])
        out = flat[self.dual[:, 0]]
        for k in range(1, self.dual.shape[1]):
            out = out + flat[self.dual[:, k]]
        return out

    def scatter(self, src: torch.Tensor, size: int) -> torch.Tensor:
        """Dense (size,) result: the per-target sums, zeros elsewhere."""
        out = src.new_zeros(size)
        out[self.targets] = self.sums(src)
        return out


# XLA's CPU backend sums a reduction over more than _WINDOW terms in
# windows of _WINDOW (read with tests/xla_sum_trees.py's method)
_WINDOW = 32


def _reduce_windows(m: int) -> list:
    """The windows in which XLA's CPU backend sums a reduction of ``m`` >
    32 terms: the terms padded to a multiple of 32, half the padding (the
    smaller half) in front, each window's terms in order."""
    total = -(-m // _WINDOW) * _WINDOW
    lo = (total - m) // 2
    return [[k for k in range(w - lo, w - lo + _WINDOW) if 0 <= k < m]
            for w in range(0, total, _WINDOW)]


@dataclass
class SparseELL:
    """Device sparse matrix, padded ELL, row-major.

    cols: (n, m) int64, padding slots == n (dummy column)
    vals: (n, m) float64
    offsets: the column offset of each slot (col = row + offsets[k]) where
        the pattern is a stencil (:meth:`EllPattern.from_coo`), else None
    fix_rows: (n_fix,) int64 rows of a stencil pattern that deviate from it
    """

    cols: torch.Tensor
    vals: torch.Tensor
    offsets: tuple | None = None
    fix_rows: torch.Tensor | None = None

    @property
    def n(self) -> int:
        return self.cols.shape[0]

    @property
    def m(self) -> int:
        return self.cols.shape[1]

    def mv(self, x: torch.Tensor, fused: bool = True) -> torch.Tensor:
        """y = A @ x.  x: (n,) or (n, k).

        Each row is summed over its slots in slot order, as the JAX
        package's SpMV is on XLA's CPU, so the two give the same bits
        there.  ``fused`` (as inside the JAX package's jitted solves) adds
        each product with one rounding, a fused multiply-add
        (``torch.addcmul``); a stencil row starts with slot 0 fused into the
        product of slot 1, the other rows with the product of slot 0.
        ``fused=False`` (as the JAX package's eager calls) rounds every
        product, then adds.  Rows of more than 32 slots that are not
        stencil rows (3-D elasticity's 81) XLA sums in windows of 32
        (:func:`_reduce_windows`), each window left to right, then the
        windows, every product rounded, in its jitted solves as well.  No
        atomics: the order is fixed on every device."""
        xp = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
        xg = xp[self.cols]  # (n, m) or (n, m, k): one gather for all slots

        def slot(k, rows=slice(None)):
            v = self.vals[rows, k]
            return (v if x.ndim == 1 else v[:, None]), xg[rows, k]

        def chain(rows=slice(None), stencil=False):
            if not stencil and self.m > _WINDOW and x.ndim == 1:
                y = None
                for window in _reduce_windows(self.m):
                    part = torch.mul(*slot(window[0], rows))
                    for k in window[1:]:
                        part = part + torch.mul(*slot(k, rows))
                    y = part if y is None else y + part
                return y
            if not fused:
                y = torch.mul(*slot(0, rows))
                for k in range(1, self.m):
                    y = y + torch.mul(*slot(k, rows))
                return y
            if stencil and self.m > 1:
                y = torch.addcmul(torch.mul(*slot(1, rows)), *slot(0, rows))
                first = 2
            else:
                y, first = torch.mul(*slot(0, rows)), 1
            for k in range(first, self.m):
                y = torch.addcmul(y, *slot(k, rows))
            return y

        if self.offsets is None:
            return chain()
        y = chain(stencil=True)
        if self.fix_rows is not None and self.fix_rows.numel():
            y[self.fix_rows] = chain(self.fix_rows)
        return y

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
    m : padded row width
    cols : (n, m) int64 column ids, padding == n (host)
    coo2slot : (n_coo,) int64 flat row-major ELL slot (row * m + pos) of
               each COO entry passed to :meth:`from_coo`, in original order
    rows_csr / cols_csr / slot_csr : the unique entries in CSR order and
               their flat ELL slots
    offsets / fix_rows : the stencil layout (:meth:`_aligned_slots`), or
               None for a packed pattern
    """

    n: int
    m: int
    cols: np.ndarray
    coo2slot: np.ndarray
    rows_csr: np.ndarray
    cols_csr: np.ndarray
    slot_csr: np.ndarray
    offsets: tuple | None = None
    fix_rows: np.ndarray | None = None

    @staticmethod
    def _aligned_slots(urows, ucols, n: int, m_packed: int):
        """The JAX package's slot assignment for stencil patterns: entries
        whose column offset ``col - row`` is common get the slot of that
        offset (ascending), so slot k holds column ``row + offsets[k]``
        wherever present and a grid-boundary row leaves the missing
        neighbours' slots as padding; rare offsets pack into trailing slots
        and their rows are ``fix_rows``.  The same slots give the same
        summation order in each row (:meth:`SparseELL.mv`).  Returns
        (ent_slot, m, offsets, fix_rows), or None when the pattern is not
        a stencil (the rows' entries are then packed in column order)."""
        ovals, oinv, ocounts = np.unique(
            ucols - urows, return_inverse=True, return_counts=True)
        aligned_sel = (ocounts >= max(32, 0.05 * n)) & (
            np.abs(ovals) <= max(1, n // 2))
        n_aligned = int(aligned_sel.sum())
        if not (0 < n_aligned <= 32):
            return None
        slot_of_oval = np.full(ovals.size, -1, np.int64)
        slot_of_oval[aligned_sel] = np.arange(n_aligned)
        ent_slot = slot_of_oval[oinv.reshape(-1)]
        extra = ent_slot < 0
        if extra.any():
            erows = urows[extra]
            er_nnz = np.bincount(erows, minlength=n)
            n_extra = int(er_nnz.max())
            estart = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(er_nnz, out=estart[1:])
            # the unique entries are row-major: a row's extras are adjacent
            ent_slot[extra] = n_aligned + np.arange(erows.size) - estart[erows]
            fix_rows = np.unique(erows)
        else:
            n_extra = 0
            fix_rows = np.zeros((0,), np.int64)
        m = n_aligned + n_extra
        if m > m_packed + 8 or fix_rows.size > 0.1 * n:
            return None
        offsets = tuple(int(d) for d in ovals[aligned_sel]) + (0,) * n_extra
        return ent_slot, m, offsets, fix_rows

    @staticmethod
    def from_coo(rows: np.ndarray, cols: np.ndarray, n: int) -> "EllPattern":
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        uniq, inverse = np.unique(rows * n + cols, return_inverse=True)
        urows = uniq // n
        ucols = uniq % n
        row_nnz = np.bincount(urows, minlength=n)
        m = int(row_nnz.max()) if row_nnz.size else 1
        aligned = EllPattern._aligned_slots(urows, ucols, n, m)
        if aligned is not None:
            pos, m, offsets, fix_rows = aligned
        else:
            row_start = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(row_nnz, out=row_start[1:])
            pos = np.arange(uniq.size) - row_start[urows]
            offsets = fix_rows = None
        slot = urows * m + pos
        ell_cols = np.full((n, m), n, dtype=np.int64)
        ell_cols[urows, pos] = ucols
        return EllPattern(
            n=n, m=m, cols=ell_cols, coo2slot=slot[inverse.reshape(-1)],
            rows_csr=urows, cols_csr=ucols, slot_csr=slot,
            offsets=offsets, fix_rows=fix_rows,
        )

    def _ell(self, vals: torch.Tensor) -> SparseELL:
        device = vals.device
        return SparseELL(
            cols=torch.as_tensor(self.cols, device=device), vals=vals,
            offsets=self.offsets,
            fix_rows=None if self.fix_rows is None
            else torch.as_tensor(self.fix_rows, device=device),
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
        return self._ell(flat.reshape(self.n, self.m))

    def from_scipy_vals(self, sp_csr, device) -> SparseELL:
        """A SparseELL on ``device`` carrying the values of a scipy matrix
        with this pattern (host path: Matrix Market input, tests)."""
        import scipy.sparse as sps

        a = sps.csr_matrix(sp_csr)
        vals = np.zeros((self.n * self.m,))
        vals[self.slot_csr] = np.asarray(a[self.rows_csr, self.cols_csr]).ravel()
        return self._ell(torch.as_tensor(vals.reshape(self.n, self.m),
                                         device=device))

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
    # The scale on the host, in numpy's bits, 1 / sqrt each rounded once,
    # as the JAX package's ops round it: on every device the same bits
    # (torch's CPU sqrt misses the correctly rounded root on 0.8 % of
    # inputs, CUDA's rsqrt on 39 % of the islands 384^2 diagonal), for one
    # copy of n doubles each way at setup.
    d = diag.cpu().numpy()
    with np.errstate(divide="ignore"):
        s = np.where(d > 0, 1.0 / np.sqrt(np.abs(d)), 1.0)
    scale = torch.as_tensor(s, device=diag.device)
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
