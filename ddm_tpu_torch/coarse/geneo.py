"""GenEO coarse space (Generalized Eigenproblems in the Overlaps).

Counterpart of ``ddm_tpu/coarse/geneo.py`` (reference: GenEOCoarseSpace,
dune/ddm/coarsespaces/coarse_spaces.hh:268-333): per subdomain, solve

    A_neu v = lambda (D B_neu D) v

with A_neu the subdomain Neumann matrix, B_neu the overlap-region Neumann
matrix and D the partition of unity, then POU-scale and normalize the kept
eigenvectors.  All subdomain pencils solve as one batched GEVP
(eigen/__init__.py:solve_gevp, dense or LOBPCG by ``eigensolver.type``).

Also the algebraic variant (Al Daas, Jolivet, Rees, doi 10.1137/22M1469833;
reference: detail::build_algebraic_neumann, coarse_spaces.hh:98-206), whose
Neumann matrix comes from matrix data alone, and the constrained variant,
whose eigenvectors are extended A_dir-harmonically into the interior
(ConstraintGenEOCoarseSpace, coarse_spaces.hh:425-481).

The Neumann matrices are assembled by summing the assembly stamps (element
matrices; for DG also face blocks) inside each (region of each) subdomain —
the TPU package's "sum" path; its subtraction fast path needs the rect
canvas, which is not ported.  Indefinite pencils (DG) take the eigensolver's
``spd=False`` branch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ParamTree
from ..core.indexmaps import extraction_map
from ..eigen import solve_gevp
from ..eigen.params import EigensolverParams
from ..fem.subassembly import (
    eliminate_dirichlet_dense,
    neumann_dense,
    neumann_plan,
    scale_matrix_with_pou,
    subdomain_stamp_lists,
)
from ..obs.logger import scoped
from ..precond.extract import extract_subdomain_dense, gather_subdomain
from .basis import CoarseBasis, finalize_basis


def _stamp_sum(p, groups, dof_mask) -> torch.Tensor:
    """Dense (n_sub, n_pad, n_pad) sum of the assembly stamps fully inside
    each subdomain (or inside its ``dof_mask`` region, host bool
    (n_sub, n_pad)), in the variables of ``p.A`` (equilibration applied).
    ``groups`` is ``disc.neumann_stamps()``: each group of (dof tuples,
    blocks) goes through its own fixed-order plan, and the groups add in
    list order."""
    topo, device = p.topo, p.device
    A = None
    for dofs, K in groups:
        se, sl = subdomain_stamp_lists(dofs, topo, dof_mask=dof_mask)
        plan = neumann_plan(se, sl, dofs.shape[0], topo.n_pad, device)
        part = neumann_dense(K, plan, topo.n_sub, topo.n_pad)
        A = part if A is None else A.add_(part)
        del part, plan
    if p.scale is not None:
        sub2glob = torch.as_tensor(topo.sub2glob.astype(np.int64), device=device)
        A = scale_matrix_with_pou(A, gather_subdomain(p.scale, sub2glob),
                                  inplace=True)
    return A


def dirichlet_mask_sub(p) -> torch.Tensor:
    """(n_sub, n_pad) bool on ``p.device``: the subdomain Dirichlet masks."""
    topo = p.topo
    sub2glob = torch.as_tensor(topo.sub2glob.astype(np.int64), device=p.device)
    dmask = gather_subdomain(p.disc.dirichlet_mask.to(torch.float64),
                             sub2glob) > 0
    return dmask & torch.as_tensor(topo.valid, device=p.device)


def neumann_matrices(p, region_b: str = "overlap"):
    """(A_neu, B_neu) dense batches for DDMProblem ``p``, in the same
    (optionally equilibrated) variables as ``p.A``.  ``region_b``:
    "overlap" makes B_neu the Neumann matrix of the overlap region (dofs
    with boundary distance <= 2*overlap, reference NeumannRegion::Overlap),
    "all" makes B == A (without A's unit diagonal on the padding)."""
    topo = p.topo
    with scoped("Eigensolver", "assemble Neumann", p.device):
        groups = p.disc.neumann_stamps()
        A_neu = _stamp_sum(p, groups, None)
        B_neu = None
        if region_b != "all":
            B_neu = _stamp_sum(p, groups, topo.bdist <= 2 * topo.overlap)
        del groups
        dmask_sub = dirichlet_mask_sub(p)
        pad = ~torch.as_tensor(topo.valid, device=p.device)
        # the batches are fresh sums: eliminate in place
        if B_neu is None:
            B_neu = eliminate_dirichlet_dense(A_neu, dmask_sub, inplace=True)
            A_neu = B_neu + torch.diag_embed(pad.to(B_neu.dtype))
        else:
            A_neu = eliminate_dirichlet_dense(A_neu, dmask_sub,
                                              unit_diag_padding=pad,
                                              inplace=True)
            B_neu = eliminate_dirichlet_dense(B_neu, dmask_sub, inplace=True)
    return A_neu, B_neu


def dirichlet_dense(p):
    """Dense batch of the overlapping Dirichlet matrices A_dir (in the
    variables of ``p.A``, unit diagonal on the padding) and the subdomain
    Dirichlet masks (n_sub, n_pad) bool.  Used by the extension, msgfem,
    svd and constrained GenEO coarse spaces."""
    topo, device = p.topo, p.device
    local_cols = extraction_map(topo, p.A.cols.cpu().numpy()).astype(np.int64)
    A_dir = extract_subdomain_dense(
        p.A, torch.as_tensor(topo.sub2glob.astype(np.int64), device=device),
        torch.as_tensor(topo.valid, device=device),
        torch.as_tensor(local_cols, device=device))
    return A_dir, dirichlet_mask_sub(p)


def algebraic_neumann(p):
    """Matrix-only Neumann approximation (Al Daas/Jolivet/Rees): A_neu =
    A_dir - diag(corrections), the correction of row i the sum of |A[i, j]|
    over the couplings j outside the subdomain, at non-Dirichlet rows
    (coarse_spaces.hh:98-206 semantics, computed globally).  Returns
    (A_neu, A_dir)."""
    topo, device = p.topo, p.device
    A_dir, dmask = dirichlet_dense(p)
    sub2glob = torch.as_tensor(topo.sub2glob.astype(np.int64), device=device)
    row_vals, _ = p.A.rows_dense_gather(torch.clamp(sub2glob, max=p.A.n - 1))
    # |row| in total minus |row| inside the subdomain: the diagonal is in
    # both, the difference is the off-subdomain couplings
    corr = torch.abs(row_vals).sum(dim=2) - torch.abs(A_dir).sum(dim=2)
    del row_vals
    valid = torch.as_tensor(topo.valid, device=device)
    corr = torch.where(dmask | ~valid, 0.0, corr)
    return A_dir - torch.diag_embed(corr), A_dir


def region_neumann(p, dof_mask) -> torch.Tensor:
    """Neumann matrix of a sub-region: the element stamps fully inside the
    per-subdomain dof mask (host bool (n_sub, n_pad)), kept at full padded
    size with zeros outside the region, Dirichlet rows/cols eliminated
    (reference: the ring assembly path, examples/pdelab_helper.hh:343-396;
    the JAX package's ``method="sum"``)."""
    A = _stamp_sum(p, p.disc.neumann_stamps(), np.asarray(dof_mask, bool))
    return eliminate_dirichlet_dense(A, dirichlet_mask_sub(p), inplace=True)


def geneo_coarse_space(
    p, ptree: ParamTree, algebraic: bool = False, constrained: bool = False,
) -> CoarseBasis:
    """p: api.DDMProblem.  Config subtree ``geneo.eigensolver`` (or
    ``algebraic_geneo.eigensolver`` / ``constraint_geneo.eigensolver``).

    ``algebraic``: A_neu from :func:`algebraic_neumann`, B = A_dir (the
    disabled AlgebraicGenEOCoarseSpace, coarse_spaces.hh:369-377), solved as
    an indefinite pencil.  ``constrained``: each eigenvector's interior
    (dofs off the subdomain boundary) is replaced by its A_dir-harmonic
    extension X_i = -A_ii^{-1} A_ib X_b, one batched masked solve (the
    shipped reference builds this callback but discards it,
    eigensolvers.hh:26-38)."""
    prefix = ("algebraic_geneo" if algebraic
              else "constraint_geneo" if constrained else "geneo")
    params = EigensolverParams.from_ptree(ptree.sub(f"{prefix}.eigensolver"))
    pou = torch.as_tensor(p.pou, dtype=torch.float64, device=p.device)
    if algebraic:
        A_neu, B = algebraic_neumann(p)
    else:
        A_neu, B = neumann_matrices(p)
    C = scale_matrix_with_pou(B, pou, inplace=True)
    del B
    spd = (not algebraic) and getattr(p.disc, "definite", True)
    with scoped("Eigensolver", "solve GEVP", p.device):
        _, V, active = solve_gevp(A_neu, C, params, spd=spd)
    del A_neu, C
    valid = torch.as_tensor(p.topo.valid, device=p.device)
    if constrained:
        from .extension import energy_minimal_extension

        with scoped("Eigensolver", "constraint solve", p.device):
            A_dir, _ = dirichlet_dense(p)
            interior = valid & ~torch.as_tensor(p.topo.boundary,
                                                device=p.device)
            V = energy_minimal_extension(A_dir, interior, V, "cholesky")
            V = torch.where(active[:, :, None], V, 0.0)
    return finalize_basis(V, pou, valid, active)
