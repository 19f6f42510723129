"""Galerkin coarse correction: x += R^T (R A R^T)^{-1} R d.

Counterpart of ``ddm_tpu/precond/galerkin.py`` (reference:
dune/ddm/galerkin_preconditioner.hh:47-363).  The coarse matrix is built
from the overlapping subdomain pairs only (``pairs`` method),

    E[(i,k),(j,l)] = v_ik^T A^(i) v_jl,

exact for bases that vanish on subdomain boundaries (every POU-finalized
space does), as the true Galerkin product v_ik^T A v_jl with the global
operator (``global`` method, always exact), or by the reference's own
formula over all subdomain pairs (``local`` method, the transpose of the
pairs formula's product with A^(i)).  It is factored once; the
apply restricts with V, solves the
coarse system with ``refine`` steps of iterative refinement against the
stored E, prolongs and scatter-adds in fixed order (under
``core.mesh.setup_sharding``: restricts its slab, gathers the coarse
defect, solves replicated and prolongs its slab).  With
``coarse_solver.precision = dd`` an explicit coarse inverse is stored as a
double-single pair and applied through ``kernels/ddmatvec.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..coarse.basis import CoarseBasis
from ..config import ParamTree
from ..core.indexmaps import DDMTopology, dual_scatter_map, extraction_map
from ..core.mesh import SubdomainMesh, active_setup, local_topology, replicate
from ..core.sparse import SparseELL
from ..obs.logger import scoped
from ..solvers.direct import BatchedInverse, factor_batched, pack_inverse
from .extract import extract_subdomain_dense, gather_subdomain, scatter_add_subdomain


def _basis_products(V: torch.Tensor, sub2glob: torch.Tensor, n: int,
                    apply, group: int | None, V_all: torch.Tensor | None = None,
                    sub2glob_all: torch.Tensor | None = None) -> torch.Tensor:
    """(n_rows, n_c) with entry [(i,k),(j,l)] = v_ik . (apply(v_jl) on S_i),
    i over the subdomains of ``V`` (and ``sub2glob``), j over those of
    ``V_all`` (and ``sub2glob_all``; default: the same batch, n_c =
    n_rows): a rank's row block of the full matrix when ``V`` is its slab.

    Loops over groups of subdomains j: the group's bases are placed into a
    global multi-RHS block U (n, g*nev), ``apply`` maps it to the
    row subdomains' local (n_rows, n_pad, g*nev) block, which is dotted
    with their bases.  ``group`` defaults to what keeps that block near
    256 MB at the full batch."""
    if V_all is None:
        V_all, sub2glob_all = V, sub2glob
    n_sub, nev, n_pad = V_all.shape
    if group is None:
        group = 2**25 // max(n_sub * n_pad * nev, 1)
    group = max(1, min(group, n_sub))
    cols = []
    for g0 in range(0, n_sub, group):
        Vg = V_all[g0:g0 + group]  # (g, nev, n_pad)
        g = Vg.shape[0]
        # within a subdomain the dofs are distinct, so this is a plain
        # write; padding slots (zero vectors) all land in the dummy row n
        U = V.new_zeros((n + 1, g, nev))
        member = torch.arange(g, device=V.device)[:, None]
        U[sub2glob_all[g0:g0 + group], member] = Vg.permute(0, 2, 1)
        W_sub = apply(U[:n].reshape(n, g * nev))  # (n_rows, n_pad, g*nev)
        cols.append(torch.einsum("skp,spl->skl", V, W_sub))
    return torch.cat(cols, dim=2).reshape(V.shape[0] * nev, n_sub * nev)


def galerkin_coarse_matrix(
    ell: SparseELL, sub2glob: torch.Tensor, basis: CoarseBasis,
    group: int | None = None, V_all: torch.Tensor | None = None,
    sub2glob_all: torch.Tensor | None = None,
) -> torch.Tensor:
    """True Galerkin E[(i,k),(j,l)] = v_ik^T A v_jl, (n_c, n_c) dense: one
    SpMV per group of subdomains, gathered back to all subdomains.  With
    ``V_all``/``sub2glob_all`` (the full batch) and ``basis`` a rank's
    slab: the slab's rows of E."""
    return _basis_products(
        basis.V, sub2glob, ell.n,
        lambda U: gather_subdomain(ell.mv(U), sub2glob), group,
        V_all, sub2glob_all)


def galerkin_coarse_matrix_local(
    A_sub: torch.Tensor, sub2glob: torch.Tensor, basis: CoarseBasis,
    n_glob: int, group: int | None = None, V_all: torch.Tensor | None = None,
    sub2glob_all: torch.Tensor | None = None,
) -> torch.Tensor:
    """Reference-formula coarse matrix E[(j,l),(i,k)] = v_ik^T A^(i) v_jl
    with A^(i) the dense overlapping subdomain matrix
    (galerkin_preconditioner.hh:279-328 semantics): the transpose of
    :func:`galerkin_coarse_matrix` with A^(i) in place of A, which it
    equals for bases that vanish on subdomain boundaries.  With
    ``V_all``/``sub2glob_all`` and a rank's slab of ``A_sub`` and
    ``basis``: the slab's columns of E."""
    return _basis_products(
        basis.V, sub2glob, n_glob,
        lambda U: A_sub @ gather_subdomain(U, sub2glob), group,
        V_all, sub2glob_all).T


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
    V_all: torch.Tensor | None = None, lo: int = 0,
) -> torch.Tensor:
    """Pairwise-local coarse matrix (reference: the neighbor-pair dot
    products, galerkin_preconditioner.hh:279-328), (n_c, n_c) dense with
    n_c = n_sub * nev.  Pair blocks are disjoint, so they are placed with a
    plain (non-accumulating) index write.

    With ``A_sub`` and ``basis`` a rank's slab of subdomains ``lo ...``
    and ``V_all`` the full batch of bases (pair (i, j) reads neighbour j's
    basis on subdomain i): the slab's columns of E, (n_c, n_loc * nev),
    from the pairs whose i lies in the slab."""
    n_loc, nev, _ = basis.V.shape
    V_all = basis.V if V_all is None else V_all
    n_sub = V_all.shape[0]
    device = A_sub.device
    pi, pj, m_pair = _pairs_maps(topo)
    if n_loc != n_sub:
        keep = (pi >= lo) & (pi < lo + n_loc)
        pi, pj, m_pair = pi[keep] - lo, pj[keep], m_pair[keep]
    pi, pj, m_pair = (torch.as_tensor(a, device=device)
                      for a in (pi, pj, m_pair))
    W = A_sub @ basis.V.mT  # (n_loc, n_pad, nev): A^(i) v_ik
    Vpad = torch.cat([V_all, V_all.new_zeros((n_sub, nev, 1))], dim=2)
    Vj_on_i = Vpad[pj[:, None, None], torch.arange(nev, device=device)[None, :, None],
                   m_pair[:, None, :]]  # (n_pairs, nev, n_pad): v_jl on S_i
    # E_pair[x, k, l] = (A^(i) v_ik) . v_jl  ->  E[(j,l), (i,k)]
    E_pair = torch.einsum("xpk,xlp->xkl", W[pi], Vj_on_i)
    ar = torch.arange(nev, device=device)
    rows = (pj[:, None, None] * nev + ar[None, None, :]).expand_as(E_pair)
    cols = (pi[:, None, None] * nev + ar[None, :, None]).expand_as(E_pair)
    E = V_all.new_zeros((n_sub * nev, n_loc * nev))
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
    dualT: torch.Tensor  # (K, n) gather-dual of the scatter (full batch)
    E_mat: torch.Tensor | None = None  # kept for iterative refinement
    refine: int = 0
    applies: int = 0  # number of apply() calls so far
    # the ranks over the subdomain batch when sub2glob, V and active are
    # this rank's slab (core/mesh.py); coarse and E_mat are replicated
    mesh: SubdomainMesh | None = None

    def _coarse_solve(self, rhs: torch.Tensor) -> torch.Tensor:
        y = self.coarse.solve(rhs[None])[0]
        for _ in range(self.refine):
            y = y + self.coarse.solve((rhs - self.E_mat @ y)[None])[0]
        return y

    def apply(self, d: torch.Tensor) -> torch.Tensor:
        self.applies += 1
        nev = self.V.shape[1]
        d_sub = gather_subdomain(d, self.sub2glob)
        alpha = (self.V @ d_sub[:, :, None])[:, :, 0]  # restriction
        if self.mesh is not None:
            # the full coarse defect on every rank, solved replicated; each
            # rank prolongs its own slab
            alpha = self.mesh.all_gather(alpha)
        beta = self._coarse_solve(alpha.reshape(-1)).reshape(-1, nev)
        if self.mesh is not None:
            lo, hi = self.mesh.slab(beta.shape[0])
            beta = beta[lo:hi]
        x_sub = (self.V.mT @ beta[:, :, None])[:, :, 0]  # prolongation
        if self.mesh is not None:
            x_sub = self.mesh.all_gather(x_sub)
        return scatter_add_subdomain(x_sub, self.dualT)


def build_galerkin(
    ell: SparseELL,
    topo: DDMTopology,
    basis: CoarseBasis,
    ptree: ParamTree | None = None,
    subtree_name: str = "coarse_solver",
    method: str = "global",
    A_sub: torch.Tensor | None = None,
) -> GalerkinPreconditioner:
    """Coarse matrix + factorization.  ``method``: ``global`` (always
    exact), ``pairs`` (exact for boundary-vanishing bases) or ``local`` (the
    reference's formula on the dense subdomain matrices).  ``A_sub``: the
    dense subdomain batch that ``pairs`` and ``local`` read (the rank's
    slab under ``setup_sharding``), extracted from ``ell`` when None.
    Config keys (subtree
    ``coarse_solver``): ``type`` (mandatory; cholesky / cholmod / lu /
    umfpack / superlu; with ``ptree`` None, lu), ``refine``
    (iterative-refinement steps per coarse solve, default 2).
    ``precision`` = f64|dd: dd stores an explicit coarse inverse
    (``BatchedInverse``, the CUDA default) as a double-single pair applied by
    the ``dd_matvec`` kernel — 1 + ``refine`` launches per coarse solve; the
    CPU keeps Cholesky factors, where the key changes nothing, as in the JAX
    package on the CPU.
    The TPU knobs ``newton_rtol`` and ``construction`` are accepted and
    ignored.

    Under ``setup_sharding`` ``basis`` is the rank's slab: the rank
    extracts its slab of subdomain matrices, gathers the bases and their
    activity masks of all ranks, computes its slab's rows (``global``) or
    columns (``pairs``, ``local``) of E and gathers the rest, so every rank
    holds the single-device E and factors it itself."""
    ptree = ptree or ParamTree({subtree_name: {"type": "lu"}})
    sub = ptree.sub(subtree_name)
    if "type" not in sub:
        raise KeyError(
            f"You must specify the solver in the subtree {subtree_name} "
            "using the key 'type'"
        )
    precision = sub.get("precision", "f64")
    if precision not in ("f64", "dd"):
        raise ValueError(f"coarse precision '{precision}' is not ported")
    if method not in ("pairs", "global", "local"):
        raise ValueError(f"unknown coarse-matrix method '{method}'")
    device = ell.vals.device
    ctx = active_setup()
    topo_l = local_topology(topo)

    def t(a):
        return torch.as_tensor(a, device=device)

    s2g = t(topo_l.sub2glob.astype(np.int64))
    s2g_all = s2g if ctx is None else t(topo.sub2glob.astype(np.int64))
    with scoped("GalerkinPrec", "build Matrix", device):
        V_all = replicate(basis.V)
        if method == "global":
            E = galerkin_coarse_matrix(ell, s2g, basis, V_all=V_all,
                                       sub2glob_all=s2g_all)
            if ctx is not None:
                E = ctx.mesh.all_gather(E)  # the slabs' rows
        else:
            if A_sub is None:
                local_cols = t(extraction_map(
                    topo_l, ell.cols.cpu().numpy()).astype(np.int64))
                A_sub = extract_subdomain_dense(ell, s2g, t(topo_l.valid),
                                                local_cols)
                del local_cols
            if method == "pairs":
                lo = ctx.lo if ctx is not None else 0
                E = galerkin_coarse_matrix_pairs(A_sub, topo, basis,
                                                 V_all=V_all, lo=lo)
            else:
                E = galerkin_coarse_matrix_local(
                    A_sub, s2g, basis, ell.n, V_all=V_all,
                    sub2glob_all=s2g_all)
            del A_sub
            if ctx is not None:  # the slabs' columns
                E = ctx.mesh.all_gather(E.mT.contiguous()).mT
        del V_all
        E = _mask_inactive(E, replicate(basis.active))
    with scoped("GalerkinPrec", "factor A0", device):
        # the lower triangle of E, not (E + E^T) / 2 as the JAX package:
        # E is symmetric to 4e-16 and the two factors' applies lie equally
        # near the JAX package's (ROADMAP queue 3)
        coarse = factor_batched(E[None], sub.get("type"), symmetrize=False)
        if precision == "dd" and isinstance(coarse, BatchedInverse):
            coarse = pack_inverse(coarse.inv, "dd")
    refine = int(sub.get("refine", 2))
    return GalerkinPreconditioner(
        sub2glob=s2g, V=basis.V, active=basis.active, coarse=coarse,
        dualT=t(dual_scatter_map(topo).astype(np.int64)),
        E_mat=E if refine > 0 else None, refine=refine,
        mesh=ctx.mesh if ctx is not None else None,
    )
