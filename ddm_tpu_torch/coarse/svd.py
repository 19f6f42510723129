"""SVD coarse space.

Counterpart of ``ddm_tpu/coarse/svd.py`` (reference:
coarse_spaces.hh:1268-1407).  The basis is the first n left singular
vectors of T = D A_ii^{-1} A_{i,Gamma} (the POU on the interior rows times
the interior solve of the boundary couplings).  The reference builds T
column by column with UMFPACK and runs Eigen's BDC-SVD per rank; here T
forms as one batched masked LU solve and ``torch.linalg.svd`` runs over the
whole subdomain batch.

Config subtree ``svd_coarse_space``: ``n`` (default 10), ``mult_pou``
(default false: the U columns are orthonormal already).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ParamTree
from ..solvers.direct import factor_batched
from .basis import CoarseBasis, finalize_basis
from .extension import masked_operator
from .geneo import dirichlet_dense


def _svd_operator(p):
    """T = D A_ii^{-1} A_{i,Gamma} as one batched masked solve.  Returns
    (T, interior mask)."""
    topo, device = p.topo, p.device
    A_dir, dmask = dirichlet_dense(p)
    dmask_np = dmask.cpu().numpy()
    boundary = np.asarray(topo.boundary)
    im = torch.as_tensor(topo.valid & ~boundary & ~dmask_np, device=device)
    bm = torch.as_tensor(topo.valid & boundary & ~dmask_np, device=device)
    ib = im[:, :, None] & bm[:, None, :]
    Aib = torch.where(ib, A_dir, 0.0)
    fac = factor_batched(masked_operator(A_dir, im), "lu", mode="factors")
    del A_dir
    T = torch.where(ib, fac.solve(Aib), 0.0)
    pou = torch.as_tensor(p.pou, dtype=torch.float64, device=device)
    return T * pou[:, :, None], im


def svd_coarse_space(p, ptree: ParamTree) -> CoarseBasis:
    sub = ptree.sub("svd_coarse_space")
    nev = sub.get("n", 10)
    T, im = _svd_operator(p)
    U, _, _ = torch.linalg.svd(T, full_matrices=False)
    V = torch.where(im[:, None, :], U[:, :, :nev].mT, 0.0)
    active = torch.ones(V.shape[:2], dtype=torch.bool, device=V.device)
    if sub.get("mult_pou", False):
        pou = torch.as_tensor(p.pou, dtype=torch.float64, device=p.device)
        valid = torch.as_tensor(p.topo.valid, device=p.device)
        return finalize_basis(V, pou, valid, active)
    return CoarseBasis(V=V, active=active)


def singular_values(p) -> np.ndarray:
    """Diagnostic: the singular values of T per subdomain (the reference
    writes them to singular_values_<rank>.txt, coarse_spaces.hh:1387-1391)."""
    T, _ = _svd_operator(p)
    return torch.linalg.svdvals(T).cpu().numpy()
