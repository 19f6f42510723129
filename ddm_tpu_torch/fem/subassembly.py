"""Per-subdomain Neumann matrix assembly.

Counterpart of ``ddm_tpu/fem/subassembly.py`` (reference: the AssembleWrapper
correction capture, examples/assemblewrapper.hh:27-490, and
assemble_overlapping_matrices, examples/pdelab_helper.hh:113-436).  With the
whole mesh resident, the subdomain Neumann matrix is assembled directly as

    A_neu^(i) = sum of element matrices over elements fully inside S_i

(or inside a masked region of S_i): a host-built table of (subdomain,
element) stamps and one fixed-order sum of the global element-matrix batch
into dense (n_sub, n_pad, n_pad) blocks.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps
import torch

from ..core.indexmaps import DDMTopology
from ..core.sparse import SumPlan


def subdomain_stamp_lists(
    dofs: np.ndarray,
    topo: DDMTopology,
    dof_mask: np.ndarray | None = None,
):
    """Host: per subdomain, the assembly stamps (element dof tuples
    ``dofs[s] (nl,)``) fully inside its (masked) dof set.

    dof_mask: optional (n_sub, n_pad) bool restricting the region (e.g.
    bdist <= 2*overlap for the overlap-region Neumann matrix B_neu).
    Returns (sub_elems (n_sub, max_e) int64 padded with n_stamps,
             sub_locs (n_sub, max_e, nl) int32 padded with n_pad)."""
    n_e, nl = dofs.shape
    n_sub, n_pad = topo.sub2glob.shape
    n = topo.n_glob

    # inside(k, e) <=> every dof of stamp e lies in (the masked) subdomain k
    if dof_mask is None:
        M = (topo.membership > 0).astype(np.int32).tocsr()
    else:
        mk, ml = np.nonzero(np.asarray(dof_mask, bool) & topo.valid)
        cols = topo.sub2glob[mk, ml].astype(np.int64)
        M = sps.csr_matrix(
            (np.ones(mk.size, np.int32), (mk, cols)), shape=(n_sub, n)
        )
    inc = sps.csr_matrix(
        (
            np.ones(n_e * nl, np.int32),
            (dofs.reshape(-1).astype(np.int64), np.repeat(np.arange(n_e), nl)),
        ),
        shape=(n, n_e),
    )
    C = (M @ inc).tocsr()
    C.data[C.data != nl] = 0
    C.eliminate_zeros()
    sub_of, elem_of = C.nonzero()  # row-major: grouped by subdomain
    counts = np.diff(C.indptr)
    max_e = max(int(counts.max()) if counts.size else 1, 1)

    sub_elems = np.full((n_sub, max_e), n_e, dtype=np.int64)
    sub_locs = np.full((n_sub, max_e, nl), n_pad, dtype=np.int32)
    pos = np.arange(sub_of.size) - np.repeat(C.indptr[:-1], counts)
    sub_elems[sub_of, pos] = elem_of
    sub_locs[sub_of, pos] = topo.lookup(sub_of[:, None], dofs[elem_of])
    return sub_elems, sub_locs


def neumann_plan(sub_elems: np.ndarray, sub_locs: np.ndarray, n_e: int,
                 n_pad: int, device) -> SumPlan:
    """Host: the fixed-order plan summing element-matrix entries
    ``Ke[e, i, j]`` into ``A[s, loc_i, loc_j]`` for every stamp listed in
    :func:`subdomain_stamp_lists` (padding stamps dropped)."""
    n_sub, max_e, nl = sub_locs.shape
    s, slot = np.nonzero(sub_elems < n_e)
    e = sub_elems[s, slot]
    locs = sub_locs[s, slot].astype(np.int64)  # (n_st, nl)
    src = (e[:, None, None] * nl + np.arange(nl)[None, :, None]) * nl \
        + np.arange(nl)[None, None, :]
    tgt = (s[:, None, None] * n_pad + locs[:, :, None]) * n_pad \
        + locs[:, None, :]
    return SumPlan.build(src, tgt, n_e * nl * nl, device)


def neumann_dense(Ke: torch.Tensor, plan: SumPlan, n_sub: int,
                  n_pad: int) -> torch.Tensor:
    """Device: dense Neumann batch (n_sub, n_pad, n_pad) from the global
    element matrices Ke (n_e, nl, nl) through :func:`neumann_plan`."""
    return plan.scatter(Ke, n_sub * n_pad * n_pad).reshape(n_sub, n_pad, n_pad)


def eliminate_dirichlet_dense(
    A: torch.Tensor, dmask_sub: torch.Tensor,
    unit_diag_padding: torch.Tensor | None = None,
) -> torch.Tensor:
    """Symmetric Dirichlet elimination on a dense subdomain batch
    (pdelab_helper.hh:33-46 semantics: Dirichlet rows/cols -> identity).

    dmask_sub: (n_sub, n_pad) bool.  unit_diag_padding: optional (n_sub,
    n_pad) bool mask of slots that additionally get a unit diagonal."""
    d = dmask_sub.to(torch.bool)
    keep = ~(d[:, :, None] | d[:, None, :])
    A = torch.where(keep, A, 0.0)
    if unit_diag_padding is not None:
        d = d | unit_diag_padding
    return A + torch.diag_embed(d.to(A.dtype))


def scale_matrix_with_pou(C: torch.Tensor, pou: torch.Tensor) -> torch.Tensor:
    """C[i][j] *= pou[i]*pou[j] (reference: detail::scale_matrix_with_pou,
    coarse_spaces.hh:74-96), batched."""
    return C * pou[:, :, None] * pou[:, None, :]
