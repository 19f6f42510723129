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

The Neumann matrices are assembled as the JAX package assembles them:
where the stamps sum to the operator and the operator is a stencil, by
subtraction (the extracted Dirichlet matrix minus the stamps that cross the
region's boundary, in XLA's order, so both packages give the same bits on
the CPU), else by summing the assembly stamps (element matrices; for DG
also face blocks) inside each (region of each) subdomain.  Indefinite
pencils (DG) take the eigensolver's ``spd=False`` branch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ParamTree
from ..core.indexmaps import extraction_map
from ..eigen import solve_gevp
from ..eigen.params import EigensolverParams
from ..fem.subassembly import (
    crossing_stamp_lists,
    eliminate_dirichlet_dense,
    neumann_dense,
    neumann_plan,
    scale_matrix_with_pou,
    subdomain_stamp_lists,
    subtract_stamps,
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


def _subtract_ok(p) -> bool:
    """Whether the JAX package takes its subtraction path for ``p``: the
    stamps sum to the operator (``stamps_cover_operator``) and the operator
    is a stencil without deviating rows (there the JAX package's topology
    takes its rectangular canvas, which the port does not need)."""
    A = p.A
    return (getattr(p.disc, "stamps_cover_operator", False)
            and A.offsets is not None
            and (A.fix_rows is None or A.fix_rows.numel() == 0))


def _neumann_method(p, method: str) -> bool:
    """True for the subtraction path: ``method`` "auto" (as the JAX
    package chooses), "subtract" or "sum"."""
    if method == "auto":
        return _subtract_ok(p)
    if method == "subtract":
        if not getattr(p.disc, "stamps_cover_operator", False):
            raise ValueError("subtraction path preconditions not met")
        return True
    if method != "sum":
        raise ValueError(f"unknown Neumann method '{method}'")
    return False


def _dirichlet_extracted(p) -> torch.Tensor:
    """The overlapping Dirichlet matrices A_dir of ``p.A`` (in its
    variables), zero on the padding, contiguous."""
    topo, device = p.topo, p.device
    local_cols = torch.as_tensor(
        extraction_map(topo, p.A.cols.cpu().numpy()).astype(np.int64),
        device=device)
    return extract_subdomain_dense(
        p.A, torch.as_tensor(topo.sub2glob.astype(np.int64), device=device),
        torch.as_tensor(topo.valid, device=device), local_cols,
        unit_padding_diag=False).contiguous()


def _masked_subtract(p, A_dir, dof_mask, groups) -> torch.Tensor:
    """Region Neumann matrix by subtraction: A_dir restricted to the masked
    dof pairs (``dof_mask`` host bool (n_sub, n_pad), None for the whole
    subdomain) minus the stamps that cross the region's boundary, scaled
    into the variables of ``p.A`` on the small stamp blocks.  Consumes
    A_dir when ``dof_mask`` is None."""
    topo, device = p.topo, p.device
    if dof_mask is None:
        A = A_dir
    else:
        bm = torch.as_tensor(np.asarray(dof_mask, bool) & topo.valid,
                             device=device)
        A = torch.where(bm[:, :, None] & bm[:, None, :], A_dir, 0.0)
    s_sub = None
    if p.scale is not None:
        sub2glob = torch.as_tensor(topo.sub2glob.astype(np.int64),
                                   device=device)
        s_sub = gather_subdomain(p.scale, sub2glob)
    for dofs, K in groups:
        ce, cl = crossing_stamp_lists(dofs, topo, dof_mask=dof_mask)
        nl = K.shape[-1]
        Kp = torch.cat([K, K.new_zeros((1, nl, nl))])
        Ks = Kp[torch.as_tensor(ce, device=device)]  # (n_sub, max_e, nl, nl)
        if s_sub is not None:
            sp = torch.cat([s_sub, s_sub.new_zeros((s_sub.shape[0], 1))],
                           dim=1)
            n_sub, max_e, _ = cl.shape
            sl = torch.gather(sp, 1, torch.as_tensor(
                cl.astype(np.int64), device=device).reshape(n_sub, -1)
            ).reshape(n_sub, max_e, nl)
            Ks = Ks * sl[..., :, None] * sl[..., None, :]
        A = subtract_stamps(A, Ks, cl)
    return A


def dirichlet_mask_sub(p) -> torch.Tensor:
    """(n_sub, n_pad) bool on ``p.device``: the subdomain Dirichlet masks."""
    topo = p.topo
    sub2glob = torch.as_tensor(topo.sub2glob.astype(np.int64), device=p.device)
    dmask = gather_subdomain(p.disc.dirichlet_mask.to(torch.float64),
                             sub2glob) > 0
    return dmask & torch.as_tensor(topo.valid, device=p.device)


def neumann_matrices(p, region_b: str = "overlap", method: str = "auto"):
    """(A_neu, B_neu) dense batches for DDMProblem ``p``, in the same
    (optionally equilibrated) variables as ``p.A``.  ``region_b``:
    "overlap" makes B_neu the Neumann matrix of the overlap region (dofs
    with boundary distance <= 2*overlap, reference NeumannRegion::Overlap),
    "all" makes B == A (without A's unit diagonal on the padding).
    ``method``: "auto" takes the subtraction path where the JAX package
    does, "subtract" and "sum" force a path."""
    topo = p.topo
    with scoped("Eigensolver", "assemble Neumann", p.device):
        groups = p.disc.neumann_stamps()
        B_neu = None
        ovlp = topo.bdist <= 2 * topo.overlap
        if _neumann_method(p, method):
            A_dir = _dirichlet_extracted(p)
            if region_b != "all":
                B_neu = _masked_subtract(p, A_dir, ovlp, groups)
            A_neu = _masked_subtract(p, A_dir, None, groups)
            del A_dir
        else:
            A_neu = _stamp_sum(p, groups, None)
            if region_b != "all":
                B_neu = _stamp_sum(p, groups, ovlp)
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


def region_neumann(p, dof_mask, method: str = "auto") -> torch.Tensor:
    """Neumann matrix of a sub-region: the element stamps fully inside the
    per-subdomain dof mask (host bool (n_sub, n_pad)), kept at full padded
    size with zeros outside the region, Dirichlet rows/cols eliminated
    (reference: the ring assembly path, examples/pdelab_helper.hh:343-396).
    ``method`` as in :func:`neumann_matrices`."""
    groups = p.disc.neumann_stamps()
    mask = np.asarray(dof_mask, bool)
    if _neumann_method(p, method):
        A = _masked_subtract(p, _dirichlet_extracted(p), mask, groups)
    else:
        A = _stamp_sum(p, groups, mask)
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
