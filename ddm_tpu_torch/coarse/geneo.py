"""GenEO coarse space (Generalized Eigenproblems in the Overlaps).

Counterpart of ``ddm_tpu/coarse/geneo.py`` (reference: GenEOCoarseSpace,
dune/ddm/coarsespaces/coarse_spaces.hh:268-333): per subdomain, solve

    A_neu v = lambda (D B_neu D) v

with A_neu the subdomain Neumann matrix, B_neu the overlap-region Neumann
matrix and D the partition of unity, then POU-scale and normalize the kept
eigenvectors.  All subdomain pencils solve as one batched dense GEVP.

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
from ..precond.extract import gather_subdomain
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


def neumann_matrices(p):
    """(A_neu, B_neu) dense batches for DDMProblem ``p``, in the same
    (optionally equilibrated) variables as ``p.A``; B_neu is the Neumann
    matrix of the overlap region (dofs with boundary distance <=
    2*overlap, reference NeumannRegion::Overlap)."""
    topo = p.topo
    with scoped("Eigensolver", "assemble Neumann", p.device):
        groups = p.disc.neumann_stamps()
        A_neu = _stamp_sum(p, groups, None)
        B_neu = _stamp_sum(p, groups, topo.bdist <= 2 * topo.overlap)
        del groups
        dmask_sub = dirichlet_mask_sub(p)
        valid = torch.as_tensor(topo.valid, device=p.device)
        # both batches are fresh sums: eliminate in place
        A_neu = eliminate_dirichlet_dense(A_neu, dmask_sub,
                                          unit_diag_padding=~valid,
                                          inplace=True)
        B_neu = eliminate_dirichlet_dense(B_neu, dmask_sub, inplace=True)
    return A_neu, B_neu


def region_neumann(p, dof_mask) -> torch.Tensor:
    """Neumann matrix of a sub-region: the element stamps fully inside the
    per-subdomain dof mask (host bool (n_sub, n_pad)), kept at full padded
    size with zeros outside the region, Dirichlet rows/cols eliminated
    (reference: the ring assembly path, examples/pdelab_helper.hh:343-396;
    the JAX package's ``method="sum"``)."""
    A = _stamp_sum(p, p.disc.neumann_stamps(), np.asarray(dof_mask, bool))
    return eliminate_dirichlet_dense(A, dirichlet_mask_sub(p), inplace=True)


def geneo_coarse_space(p, ptree: ParamTree) -> CoarseBasis:
    """p: api.DDMProblem.  Config subtree: ``geneo.eigensolver``."""
    params = EigensolverParams.from_ptree(ptree.sub("geneo.eigensolver"))
    pou = torch.as_tensor(p.pou, dtype=torch.float64, device=p.device)
    A_neu, B_neu = neumann_matrices(p)
    C = scale_matrix_with_pou(B_neu, pou, inplace=True)
    del B_neu
    with scoped("Eigensolver", "solve GEVP", p.device):
        _, V, active = solve_gevp(A_neu, C, params,
                                  spd=getattr(p.disc, "definite", True))
    valid = torch.as_tensor(p.topo.valid, device=p.device)
    return finalize_basis(V, pou, valid, active)
