"""Ring coarse spaces: eigenproblems restricted to the overlap ring, plus an
energy-minimal extension to the interior.

Counterpart of ``ddm_tpu/coarse/ring.py``.  ``geneo_ring`` (reference:
GenEORingCoarseSpace, coarse_spaces.hh:502-648): the per-subdomain
eigenproblem shrinks from subdomain size to the size of the overlap ring
(bdist <= 2*overlap + 1, NeumannRegion::ExtendedOverlap), and its
eigenvectors are extended energy-minimally inward, with Dirichlet data one
layer inside the ring's inner boundary (coarse_spaces.hh:572-598).
``msgfem_ring`` (MsGFEMRingCoarseSpace, coarse_spaces.hh:913-1163): the
MsGFEM reduced pencil on the ring (bdist <= 2*overlap), with the ring's
A-harmonic parameter basis at compact size, then the same extension.  The
reference's ring index bookkeeping becomes boolean masks on the padded
subdomain batch plus host compaction maps.

``ROUTES`` counts the extension routes taken in this process: ``pcg``
(accepted PCG solves), ``direct`` (compact Cholesky solves) and
``escalations`` (PCG attempts rejected by their residual check).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ParamTree
from ..core.indexmaps import extraction_map
from ..core.mesh import batch_max
from ..eigen import solve_gevp
from ..eigen.params import EigensolverParams
from ..fem.subassembly import scale_matrix_with_pou
from ..obs.logger import scoped, warn
from .basis import CoarseBasis, finalize_basis
from .extension import (
    compact_maps,
    compact_mat,
    energy_minimal_extension_pcg,
    energy_minimal_extension_sparse,
    expand_rows,
    extension_inverse_of,
    harmonic_parameter_basis_compact,
)
from .geneo import dirichlet_mask_sub, region_neumann

ROUTES = {"pcg": 0, "direct": 0, "escalations": 0}


def _adjacent_to(
    topo, local_cols: np.ndarray, target_mask: np.ndarray, within: np.ndarray
) -> np.ndarray:
    """(n_sub, n_pad) bool: dofs in ``within`` with a matrix-graph neighbour
    in ``target_mask``.  ``local_cols`` is the subdomain-local extraction map
    (core/indexmaps.py:extraction_map of the problem's column array)."""
    tm = np.concatenate([target_mask, np.zeros((topo.n_sub, 1), bool)], axis=1)
    hit = np.take_along_axis(
        tm, local_cols.reshape(topo.n_sub, -1), axis=1
    ).reshape(local_cols.shape)
    return within & hit.any(axis=2)


def _ring_extension(p, ptree, ext_cfg, ext_free, data, fine, local_cols=None):
    """Energy-minimal extension for ring spaces, dispatching on
    ``<cs>.extension.mode``:

    * ``pcg`` / ``auto`` (default): CG on the compacted free block,
      preconditioned by the fine level's explicit f64 subdomain inverse.
      Each attempt is verified (its largest relative residual is read on the
      host) and escalates mixed -> f64 PCG -> direct when it misses
      ``tolerance``; without a usable inverse the direct route runs at once.
    * ``direct``: batched Cholesky (LU when the discretization is not
      definite) of the free block at compact size (the reference's dedicated
      factorization, energy_minimal_extension.hh:78-88).
    """
    mode = ext_cfg.get("mode", "auto")
    accept = float(ext_cfg.get("tolerance", 1e-8))
    precision = ext_cfg.get("precision", "mixed")
    Minv = extension_inverse_of(fine, p, ptree) if mode != "direct" else None
    if Minv is not None:
        maxit = int(ext_cfg.get("maxit", 40))
        attempts = [dict(maxit=int(ext_cfg.get("maxit64", 16)),
                         maxit32=int(ext_cfg.get("maxit32", maxit)))
                    ] if precision == "mixed" else []
        attempts.append(dict(maxit=maxit, maxit32=0))
        for att in attempts:
            ext, rel = energy_minimal_extension_pcg(
                p.A, p.topo, ext_free, data, Minv, local_cols=local_cols, **att,
            )
            worst = batch_max(float(rel.max()))  # every rank escalates
            if worst <= accept:
                ROUTES["pcg"] += 1
                return ext
            ROUTES["escalations"] += 1
            warn(
                "ring extension PCG (maxit={}, maxit32={}) stalled (max rel "
                "residual {:.2e} > {:.0e}); escalating",
                att["maxit"], att["maxit32"], worst, accept,
            )
    ROUTES["direct"] += 1
    return energy_minimal_extension_sparse(
        p.A, p.topo, ext_free, data, local_cols=local_cols,
        solver_type="cholesky" if getattr(p.disc, "definite", True) else "lu",
    )


def geneo_ring_coarse_space(p, ptree: ParamTree, fine=None) -> CoarseBasis:
    """p: api.DDMProblem.  Config subtrees ``geneo_ring.eigensolver`` and
    ``geneo_ring.extension``; ``fine`` is the fine Schwarz level, whose
    explicit f64 inverse (when it holds one) preconditions the extension."""
    topo, device = p.topo, p.device
    # the JAX package raises the refinement budget of its mixed-precision
    # GEVP for ring pencils (EigensolverParams.with_refine); the exact f64
    # GEVP here reads no refinement keys
    params = EigensolverParams.from_ptree(ptree.sub("geneo_ring.eigensolver"))
    ext_cfg = ptree.sub("geneo_ring.extension")
    valid = topo.valid
    local_cols = extraction_map(topo, p.A.cols.cpu().numpy())

    ring = valid & (topo.bdist <= 2 * topo.overlap + 1)
    not_ring = valid & ~ring
    # inner ring boundary: ring dofs with a neighbour outside the ring
    irb = _adjacent_to(topo, local_cols, not_ring, ring)
    # layer one inside the ring: ring\irb dofs adjacent to irb
    inside_rb = _adjacent_to(topo, local_cols, irb, ring & ~irb)
    # extension free set: interior + inner ring boundary
    ext_free = not_ring | irb

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    # the pencil at ring size: the reason for the ring space
    idx, cval, pos, _ = compact_maps(ring)
    idx_t, cval_t, pos_t = t(idx).long(), t(cval), t(pos).long()
    with scoped("Eigensolver", "assemble Neumann", device):
        A_rc = compact_mat(region_neumann(p, ring), idx_t)
    A_rc = torch.where(cval_t[:, :, None] & cval_t[:, None, :], A_rc, 0.0)
    # floating ring pencils: identity on the compact padding slots
    A_eig = A_rc + torch.diag_embed((~cval_t).to(A_rc.dtype))
    pou = torch.as_tensor(p.pou, dtype=torch.float64, device=device)
    mod_pou = torch.where(t(ring & ~irb), pou, 0.0)
    C = scale_matrix_with_pou(A_rc, torch.gather(mod_pou, 1, idx_t))
    del A_rc

    with scoped("Eigensolver", "solve GEVP", device):
        _, V_c, active = solve_gevp(A_eig, C, params,
                                    spd=getattr(p.disc, "definite", True))
    del A_eig, C
    V_ring = expand_rows(V_c, pos_t)

    data = torch.where(t(inside_rb)[:, None, :], V_ring, 0.0)
    with scoped("Eigensolver", "extension", device):
        ext = _ring_extension(p, ptree, ext_cfg, ext_free, data, fine,
                              local_cols)
    valid_t = t(valid)
    combined = torch.where(t(ext_free)[:, None, :], ext, V_ring)
    combined = torch.where(valid_t[:, None, :], combined, 0.0)
    return finalize_basis(combined, pou, valid_t, active)


def msgfem_ring_coarse_space(p, ptree: ParamTree, fine=None) -> CoarseBasis:
    """p: api.DDMProblem.  Config subtrees ``msgfem_ring.eigensolver`` and
    ``msgfem_ring.extension``; ``fine`` as in
    :func:`geneo_ring_coarse_space`."""
    topo, device = p.topo, p.device
    # as in geneo_ring_coarse_space, the JAX package's larger refinement
    # budget (with_refine) has no reader in the exact f64 GEVP here
    params = EigensolverParams.from_ptree(ptree.sub("msgfem_ring.eigensolver"))
    ext_cfg = ptree.sub("msgfem_ring.extension")
    shrink = ptree.sub("pou").get("shrink", 0)
    valid, ov = topo.valid, topo.overlap
    ring_width = 2 * ov - 2 * shrink
    boundary = np.asarray(topo.boundary)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    ring = valid & (topo.bdist <= 2 * ov)
    inside_rb = ring & (topo.bdist == 2 * ov)  # innermost ring layer
    dmask = dirichlet_mask_sub(p).cpu().numpy()
    # dof classes within the ring (coarse_spaces.hh:986-1001)
    bnd_class = ring & (boundary | inside_rb) & ~dmask
    int_class = ring & ~bnd_class & ~dmask

    # everything at ring size (host compaction maps)
    idx, cval, pos, _ = compact_maps(ring & ~dmask)
    idx_t, cval_t, pos_t = t(idx).long(), t(cval), t(pos).long()
    with scoped("Eigensolver", "assemble Neumann", device):
        A_rc = compact_mat(region_neumann(p, ring), idx_t)
    A_rc = torch.where(cval_t[:, :, None] & cval_t[:, None, :], A_rc, 0.0)
    pou = torch.as_tensor(p.pou, dtype=torch.float64, device=device)
    # mod_pou is zero at bdist >= shrink + ring_width (coarse_spaces.hh:971-973)
    mod_pou = torch.where(t(topo.bdist < shrink + ring_width), pou, 0.0)
    B_c = scale_matrix_with_pou(A_rc, torch.gather(mod_pou, 1, idx_t))

    int_c = torch.gather(t(int_class), 1, idx_t) & cval_t
    par_c = torch.gather(t(bnd_class), 1, idx_t) & cval_t
    pidx, pval, _, _ = compact_maps(par_c.cpu().numpy())
    pidx_t, pval_t = t(pidx).long(), t(pval)

    with scoped("Eigensolver", "harmonic basis", device):
        A_con = A_rc + torch.diag_embed((~cval_t).to(A_rc.dtype))
        Hc = harmonic_parameter_basis_compact(A_con, int_c, pidx_t, pval_t)
        del A_con
    with scoped("Eigensolver", "reduced pencil", device):
        # Hc^T A Hc at (r_pad, b_pad), in f64 (the JAX package measured a
        # double-single formation to NaN the GEVP on this near-singular
        # pencil)
        Ahat = Hc.mT @ (A_rc @ Hc)
        Bhat = Hc.mT @ (B_c @ Hc)
        del A_rc, B_c
        Ahat = 0.5 * (Ahat + Ahat.mT)
        Bhat = 0.5 * (Bhat + Bhat.mT)
        Ahat = Ahat + torch.diag_embed((~pval_t).to(Ahat.dtype))

    with scoped("Eigensolver", "solve GEVP", device):
        _, W, active = solve_gevp(Ahat, Bhat, params,
                                  spd=getattr(p.disc, "definite", True))
    del Ahat, Bhat
    V_ring = expand_rows(torch.einsum("sqb,skb->skq", Hc, W), pos_t)

    # the extension from the bdist == shrink + ring_width - 1 layer
    ext_bnd = valid & (topo.bdist == shrink + ring_width - 1)
    ext_free = valid & (topo.bdist > shrink + ring_width - 1)
    data = torch.where(t(ext_bnd)[:, None, :], V_ring, 0.0)
    with scoped("Eigensolver", "extension", device):
        ext = _ring_extension(p, ptree, ext_cfg, ext_free, data, fine)
    valid_t = t(valid)
    combined = torch.where(t(ext_free)[:, None, :], ext, V_ring)
    combined = torch.where(valid_t[:, None, :], combined, 0.0)
    return finalize_basis(combined, pou, valid_t, active)
