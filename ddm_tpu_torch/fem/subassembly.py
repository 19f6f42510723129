"""Per-subdomain Neumann matrix assembly.

Counterpart of ``ddm_tpu/fem/subassembly.py`` (reference: the AssembleWrapper
correction capture, examples/assemblewrapper.hh:27-490, and
assemble_overlapping_matrices, examples/pdelab_helper.hh:113-436).  With the
whole mesh resident, the subdomain Neumann matrix is assembled directly as

    A_neu^(i) = sum of element matrices over elements fully inside S_i

(or inside a masked region of S_i): a host-built table of (subdomain,
element) stamps and one fixed-order sum of the global element-matrix batch
into dense (n_sub, n_pad, n_pad) blocks; or, as the reference captures it,
by subtraction: the overlapping Dirichlet matrix minus the stamps that
cross the region's boundary (:func:`crossing_stamp_lists`,
:func:`subtract_stamps`).
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


def crossing_stamp_lists(
    dofs: np.ndarray,
    topo: DDMTopology,
    dof_mask: np.ndarray | None = None,
):
    """Host: per subdomain, the stamps PARTIALLY inside its (masked) dof set
    — the Neumann *correction* stamps (the subtraction form of the
    reference's AssembleWrapper capture, examples/assemblewrapper.hh:27-490:
    A_glob restricted to the region minus the contributions of the elements
    that cross its boundary).

    Returns (sub_elems, sub_locs) as :func:`subdomain_stamp_lists` does,
    except that the stamps have 1..nl-1 dofs inside, and dof slots OUTSIDE
    the (masked) set map to the dump slot ``n_pad``."""
    n_e, nl = dofs.shape
    n_sub, n_pad = topo.sub2glob.shape
    n = topo.n_glob

    inset_keys = None  # None: in-set == in-subdomain (lookup >= 0)
    if dof_mask is None:
        M = (topo.membership > 0).astype(np.int32).tocsr()
    else:
        mk, ml = np.nonzero(np.asarray(dof_mask, bool) & topo.valid)
        cols = topo.sub2glob[mk, ml].astype(np.int64)
        # the sorted (k, dof) keys of the set
        inset_keys = np.sort(mk.astype(np.int64) * (n + 1) + cols)
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
    C.data[C.data == nl] = 0  # drop the stamps fully inside
    C.eliminate_zeros()
    sub_of, elem_of = C.nonzero()
    counts = np.diff(C.indptr)
    max_e = max(int(counts.max()) if counts.size else 1, 1)

    sub_elems = np.full((n_sub, max_e), n_e, dtype=np.int64)
    sub_locs = np.full((n_sub, max_e, nl), n_pad, dtype=np.int32)
    pos = np.arange(sub_of.size) - np.repeat(C.indptr[:-1], counts)
    sub_elems[sub_of, pos] = elem_of
    locs = topo.lookup(sub_of[:, None], dofs[elem_of])
    if inset_keys is None:
        locs = np.where(locs < 0, n_pad, locs)
    else:
        key = sub_of[:, None].astype(np.int64) * (n + 1) + dofs[elem_of]
        p = np.searchsorted(inset_keys, key)
        p = np.minimum(p, max(inset_keys.size - 1, 0))
        ok = (inset_keys[p] == key) & (locs >= 0)
        locs = np.where(ok, locs, n_pad)
    sub_locs[sub_of, pos] = locs.astype(np.int32)
    return sub_elems, sub_locs


def subtract_stamps(A: torch.Tensor, Ks: torch.Tensor,
                    sub_locs: np.ndarray) -> torch.Tensor:
    """In place: A[s, loc_i, loc_j] -= Ks[s, e, i, j] for every stamp slot
    of :func:`crossing_stamp_lists` whose two dofs are both inside (slots at
    the dump ``n_pad`` drop out), each entry's stamps subtracted one at a
    time in (s, e, i, j) order, as the JAX package's scatter-add takes them
    on XLA's CPU.  A: (n_sub, n_pad, n_pad) contiguous; Ks (n_sub, max_e,
    nl, nl); the plan is built on A's device."""
    n_sub, n_pad, _ = A.shape
    locs = torch.as_tensor(sub_locs, dtype=torch.int64, device=A.device)
    inside = (locs[:, :, :, None] < n_pad) & (locs[:, :, None, :] < n_pad)
    s_idx = torch.arange(n_sub, device=A.device)[:, None, None, None]
    tgt = (s_idx * n_pad + locs[:, :, :, None]) * n_pad + locs[:, :, None, :]
    src = torch.nonzero(inside.reshape(-1)).squeeze(1)
    plan = SumPlan.build(src, tgt.reshape(-1)[src], Ks.numel(), A.device)
    del locs, inside, tgt, src
    neg = torch.cat([(-Ks).reshape(-1), Ks.new_zeros(1)])
    flat = A.view(-1)
    acc = flat[plan.targets]
    for k in range(plan.dual.shape[1]):
        acc = acc + neg[plan.dual[:, k]]
    flat[plan.targets] = acc
    return A


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
    unit_diag_padding: torch.Tensor | None = None, inplace: bool = False,
) -> torch.Tensor:
    """Symmetric Dirichlet elimination on a dense subdomain batch
    (pdelab_helper.hh:33-46 semantics: Dirichlet rows/cols -> identity).

    dmask_sub: (n_sub, n_pad) bool.  unit_diag_padding: optional (n_sub,
    n_pad) bool mask of slots that additionally get a unit diagonal.
    ``inplace`` overwrites ``A`` (a batch its caller no longer needs)
    instead of making three batch-sized temporaries."""
    d = dmask_sub.to(torch.bool)
    A = A if inplace else A.clone()
    A.masked_fill_(d[:, :, None], 0.0)
    A.masked_fill_(d[:, None, :], 0.0)
    if unit_diag_padding is not None:
        d = d | unit_diag_padding
    A.diagonal(dim1=1, dim2=2).add_(d.to(A.dtype))
    return A


def scale_matrix_with_pou(C: torch.Tensor, pou: torch.Tensor,
                          inplace: bool = False) -> torch.Tensor:
    """C[i][j] *= pou[i]*pou[j] (reference: detail::scale_matrix_with_pou,
    coarse_spaces.hh:74-96), batched; ``inplace`` overwrites ``C``."""
    if inplace:
        return C.mul_(pou[:, :, None]).mul_(pou[:, None, :])
    return C * pou[:, :, None] * pou[:, None, :]
