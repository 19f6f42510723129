"""Galerkin coarse correction: x += R^T (R A R^T)^{-1} R d.

Counterpart of ``ddm_tpu/precond/galerkin.py`` (reference:
dune/ddm/galerkin_preconditioner.hh:47-363).  The coarse matrix is built from
the overlapping subdomain pairs only (``pairs`` method),

    E[(i,k),(j,l)] = v_ik^T A^(i) v_jl,

exact for bases that vanish on subdomain boundaries (every POU-finalized
space does).  It is factored once; the apply restricts with V, solves the
coarse system with ``refine`` steps of iterative refinement against the
stored E, prolongs and scatter-adds in fixed order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..coarse.basis import CoarseBasis
from ..config import ParamTree
from ..core.indexmaps import DDMTopology, dual_scatter_map, extraction_map
from ..core.sparse import SparseELL
from ..obs.logger import scoped
from ..solvers.direct import factor_batched
from .extract import extract_subdomain_dense, gather_subdomain, scatter_add_subdomain


def _pairs_maps(topo: DDMTopology):
    """Host: overlapping pairs (pi, pj) and m_pair (n_pairs, n_pad), the
    j-local slot of subdomain i's p-th dof (n_pad where absent)."""
    M = topo.membership.astype(np.int32)
    inter = (M @ M.T).tocoo()
    pi = inter.row.astype(np.int64)
    pj = inter.col.astype(np.int64)
    rows = np.minimum(topo.sub2glob[pi], topo.n_glob)
    m_pair = topo.lookup(pj[:, None], rows)
    m_pair = np.where((m_pair < 0) | ~topo.valid[pi], topo.n_pad, m_pair)
    return pi, pj, m_pair.astype(np.int64)


def galerkin_coarse_matrix_pairs(
    A_sub: torch.Tensor, topo: DDMTopology, basis: CoarseBasis,
) -> torch.Tensor:
    """Pairwise-local coarse matrix (reference: the neighbor-pair dot
    products, galerkin_preconditioner.hh:279-328), (n_c, n_c) dense with
    n_c = n_sub * nev.  Pair blocks are disjoint, so they are placed with a
    plain (non-accumulating) index write."""
    n_sub, nev, _ = basis.V.shape
    device = A_sub.device
    pi, pj, m_pair = (torch.as_tensor(a, device=device)
                      for a in _pairs_maps(topo))
    V = basis.V
    W = A_sub @ V.mT  # (n_sub, n_pad, nev): A^(i) v_ik
    Vpad = torch.cat([V, V.new_zeros((n_sub, nev, 1))], dim=2)
    Vj_on_i = Vpad[pj[:, None, None], torch.arange(nev, device=device)[None, :, None],
                   m_pair[:, None, :]]  # (n_pairs, nev, n_pad): v_jl on S_i
    # E_pair[x, k, l] = (A^(i) v_ik) . v_jl  ->  E[(j,l), (i,k)]
    E_pair = torch.einsum("xpk,xlp->xkl", W[pi], Vj_on_i)
    ar = torch.arange(nev, device=device)
    rows = (pj[:, None, None] * nev + ar[None, None, :]).expand_as(E_pair)
    cols = (pi[:, None, None] * nev + ar[None, :, None]).expand_as(E_pair)
    nc = n_sub * nev
    E = V.new_zeros((nc, nc))
    E[rows.reshape(-1), cols.reshape(-1)] = E_pair.reshape(-1)
    return E


def _mask_inactive(E: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Decouple inactive (padding) coarse dofs: zero rows/cols, unit diag."""
    a = active.reshape(-1)
    E = torch.where(a[:, None] & a[None, :], E, 0.0)
    return E + torch.diag((~a).to(E.dtype))


@dataclass
class GalerkinPreconditioner:
    sub2glob: torch.Tensor  # (n_sub, n_pad)
    V: torch.Tensor  # (n_sub, nev_max, n_pad)
    active: torch.Tensor  # (n_sub, nev_max)
    coarse: object  # factorization of E[None] with .solve((1, n_c))
    dualT: torch.Tensor  # (K, n) gather-dual of the scatter
    E_mat: torch.Tensor | None = None  # kept for iterative refinement
    refine: int = 0

    def _coarse_solve(self, rhs: torch.Tensor) -> torch.Tensor:
        y = self.coarse.solve(rhs[None])[0]
        for _ in range(self.refine):
            y = y + self.coarse.solve((rhs - self.E_mat @ y)[None])[0]
        return y

    def apply(self, d: torch.Tensor) -> torch.Tensor:
        n_sub, nev, _ = self.V.shape
        d_sub = gather_subdomain(d, self.sub2glob)
        alpha = (self.V @ d_sub[:, :, None])[:, :, 0]  # restriction
        beta = self._coarse_solve(alpha.reshape(-1)).reshape(n_sub, nev)
        x_sub = (self.V.mT @ beta[:, :, None])[:, :, 0]  # prolongation
        return scatter_add_subdomain(x_sub, self.dualT)


def build_galerkin(
    ell: SparseELL,
    topo: DDMTopology,
    basis: CoarseBasis,
    ptree: ParamTree | None = None,
    subtree_name: str = "coarse_solver",
) -> GalerkinPreconditioner:
    """Coarse matrix (pairs method) + Cholesky factorization.  Config keys
    (subtree ``coarse_solver``): ``type`` (mandatory; cholesky / cholmod;
    with ``ptree`` None, cholesky — the TPU package's LU default is not
    ported), ``refine`` (iterative-refinement steps per coarse solve,
    default 2).
    The TPU knobs ``newton_rtol`` and ``construction`` are accepted and
    ignored; ``precision = dd`` (the double-single coarse solve) is not
    ported."""
    ptree = ptree or ParamTree({subtree_name: {"type": "cholesky"}})
    sub = ptree.sub(subtree_name)
    if "type" not in sub:
        raise KeyError(
            f"You must specify the solver in the subtree {subtree_name} "
            "using the key 'type'"
        )
    if sub.get("precision", "f64") != "f64":
        raise NotImplementedError("the double-single coarse solve is not ported")
    if sub.get("matrix_method", "pairs") != "pairs" or not basis.boundary_vanishing:
        raise NotImplementedError("only the pairs coarse matrix is ported")
    device = ell.vals.device
    s2g = torch.as_tensor(topo.sub2glob.astype(np.int64), device=device)
    with scoped("GalerkinPrec", "build Matrix", device):
        local_cols = torch.as_tensor(
            extraction_map(topo, ell.cols.cpu().numpy()).astype(np.int64),
            device=device,
        )
        valid = torch.as_tensor(topo.valid, device=device)
        A_sub = extract_subdomain_dense(ell, s2g, valid, local_cols)
        E = galerkin_coarse_matrix_pairs(A_sub, topo, basis)
        del A_sub
        E = _mask_inactive(E, basis.active)
    with scoped("GalerkinPrec", "factor A0", device):
        coarse = factor_batched(E[None], sub.get("type"))
    refine = int(sub.get("refine", 2))
    return GalerkinPreconditioner(
        sub2glob=s2g, V=basis.V, active=basis.active, coarse=coarse,
        dualT=torch.as_tensor(dual_scatter_map(topo).astype(np.int64),
                              device=device),
        E_mat=E if refine > 0 else None, refine=refine,
    )
