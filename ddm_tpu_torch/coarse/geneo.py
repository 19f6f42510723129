"""GenEO coarse space (Generalized Eigenproblems in the Overlaps).

Counterpart of ``ddm_tpu/coarse/geneo.py`` (reference: GenEOCoarseSpace,
dune/ddm/coarsespaces/coarse_spaces.hh:268-333): per subdomain, solve

    A_neu v = lambda (D B_neu D) v

with A_neu the subdomain Neumann matrix, B_neu the overlap-region Neumann
matrix and D the partition of unity, then POU-scale and normalize the kept
eigenvectors.  All subdomain pencils solve as one batched dense GEVP.

The Neumann matrices are assembled by summing the element matrices inside
each (region of each) subdomain — the TPU package's "sum" path; its
subtraction fast path needs the rect canvas, which is not ported.
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


def neumann_matrices(p):
    """(A_neu, B_neu) dense batches for DDMProblem ``p``, in the same
    (optionally equilibrated) variables as ``p.A``; B_neu is the Neumann
    matrix of the overlap region (dofs with boundary distance <=
    2*overlap, reference NeumannRegion::Overlap)."""
    disc, topo, device = p.disc, p.topo, p.device
    with scoped("Eigensolver", "assemble Neumann", device):
        (dofs, Ke), = disc.neumann_stamps()
        n_e = dofs.shape[0]
        sub2glob = torch.as_tensor(topo.sub2glob.astype(np.int64), device=device)
        valid = torch.as_tensor(topo.valid, device=device)
        ovlp_mask = topo.bdist <= 2 * topo.overlap
        mats = []
        for mask in (None, ovlp_mask):
            se, sl = subdomain_stamp_lists(dofs, topo, dof_mask=mask)
            plan = neumann_plan(se, sl, n_e, topo.n_pad, device)
            mats.append(neumann_dense(Ke, plan, topo.n_sub, topo.n_pad))
        A_neu, B_neu = mats
        if p.scale is not None:
            s_sub = gather_subdomain(p.scale, sub2glob)
            A_neu = scale_matrix_with_pou(A_neu, s_sub)
            B_neu = scale_matrix_with_pou(B_neu, s_sub)
        dmask_sub = gather_subdomain(
            disc.dirichlet_mask.to(torch.float64), sub2glob
        ) > 0
        A_neu = eliminate_dirichlet_dense(A_neu, dmask_sub,
                                          unit_diag_padding=~valid)
        B_neu = eliminate_dirichlet_dense(B_neu, dmask_sub)
    return A_neu, B_neu


def geneo_coarse_space(p, ptree: ParamTree) -> CoarseBasis:
    """p: api.DDMProblem.  Config subtree: ``geneo.eigensolver``."""
    params = EigensolverParams.from_ptree(ptree.sub("geneo.eigensolver"))
    pou = torch.as_tensor(p.pou, dtype=torch.float64, device=p.device)
    A_neu, B_neu = neumann_matrices(p)
    C = scale_matrix_with_pou(B_neu, pou)
    del B_neu
    with scoped("Eigensolver", "solve GEVP", p.device):
        _, V, active = solve_gevp(A_neu, C, params)
    valid = torch.as_tensor(p.topo.valid, device=p.device)
    return finalize_basis(V, pou, valid, active)
