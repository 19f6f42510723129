"""Energy-minimal (discrete-harmonic) extension, batched.

Counterpart of ``ddm_tpu/coarse/extension.py`` (reference:
EnergyMinimalExtension, dune/ddm/energy_minimal_extension.hh:36-229): given
Dirichlet data u_b on a constraint set, solve A_ff u_f = -A_fb u_b on the
free set f, for every basis vector of every subdomain at once.  The free set
is a per-subdomain mask on the padded subdomain batch; the solves run at the
compacted free-set size f_pad.

Two routes, as in the JAX package:

* direct — :func:`energy_minimal_extension_sparse`: the free block is cut
  straight from the global sparse operator and factored by batched Cholesky;
* PCG — :func:`energy_minimal_extension_pcg`: CG on the free block,
  preconditioned by the free-free block of the fine Schwarz level's explicit
  f64 subdomain inverse (no second factorization), returning per-vector
  residuals so the caller can verify and escalate.

Also the Schur-identity extension through the inverse
(:func:`inverse_harmonic_extension`, which no coarse space calls: its error
grows as eps * cond(A)^2) and the harmonic parameter bases of the msgfem
spaces (:func:`harmonic_parameter_basis` and its column-compacted form).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.indexmaps import extraction_map
from ..core.mesh import batch_max
from ..kernels.ddmatvec import tf32_off
from ..solvers.direct import BatchedInverse, factor_batched


def compact_maps(mask: np.ndarray):
    """Host-side compaction of a per-subdomain dof mask.

    mask (n_sub, n_pad) bool -> (idx, cvalid, pos, r_pad) with idx
    (n_sub, r_pad) int32 listing the masked dofs in slot order (0-padded),
    cvalid (n_sub, r_pad) marking real slots, and pos (n_sub, n_pad) the
    inverse map (position in idx, r_pad where unmasked).  The stable sort
    fixes the slot order, and with it which eigenvector lands where.  Under
    ``core.mesh.setup_sharding`` r_pad is the whole batch's, as on one
    device."""
    mask = np.asarray(mask, dtype=bool)
    n_sub, n_pad = mask.shape
    counts = mask.sum(axis=1)
    r_pad = max(batch_max(int(counts.max())), 1)
    order = np.argsort(~mask, axis=1, kind="stable")
    idx = order[:, :r_pad].astype(np.int32)
    cvalid = np.arange(r_pad)[None, :] < counts[:, None]
    idx = np.where(cvalid, idx, 0).astype(np.int32)
    pos_full = np.empty((n_sub, n_pad), np.int32)
    np.put_along_axis(
        pos_full, order, np.arange(n_pad, dtype=np.int32)[None, :], axis=1
    )
    pos = np.where(mask, pos_full, r_pad).astype(np.int32)
    return idx, cvalid, pos, r_pad


def compact_mat(B: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(n_sub, p, p) -> (n_sub, r_pad, r_pad): rows and columns at ``idx``
    (n_sub, r_pad) int64."""
    r_pad = idx.shape[1]
    B1 = torch.gather(B, 1, idx[:, :, None].expand(-1, -1, B.shape[2]))
    return torch.gather(B1, 2, idx[:, None, :].expand(-1, r_pad, -1))


def expand_rows(Vc: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """(n_sub, k, r_pad) compact vectors -> (n_sub, k, n_pad) full-size
    (zeros off the compacted set).  pos (int64) from :func:`compact_maps`."""
    Vp = torch.cat([Vc, Vc.new_zeros(Vc.shape[:2] + (1,))], dim=2)
    return torch.gather(Vp, 2, pos[:, None, :].expand(-1, Vc.shape[1], -1))


def masked_operator(A: torch.Tensor, free_mask: torch.Tensor) -> torch.Tensor:
    """A with identity rows/cols outside ``free_mask`` (n_sub, p) — the
    batched equivalent of extracting the A_ff block."""
    f = free_mask.to(torch.bool)
    keep = f[:, :, None] & f[:, None, :]
    return torch.where(keep, A, 0.0) + torch.diag_embed((~f).to(A.dtype))


def energy_minimal_extension(
    A: torch.Tensor,
    free_mask: torch.Tensor,
    U_bnd: torch.Tensor,
    solver_type: str = "lu",
) -> torch.Tensor:
    """Extend boundary data energy-minimally into the free set (dense form).

    A: (n_sub, p, p) dense subdomain (Dirichlet) matrices; free_mask
    (n_sub, p); U_bnd (n_sub, nev, p) whose values OUTSIDE free_mask are the
    Dirichlet data; ``solver_type`` factors the free block (an
    ``factor_batched`` solver name).  Returns (n_sub, nev, p): the data on
    the constraint set, the extension on the free set."""
    f = free_mask.to(torch.bool)
    Ub = torch.where(f[:, None, :], 0.0, U_bnd)
    R = -torch.einsum("spq,skq->skp", A, Ub)
    R = torch.where(f[:, None, :], R, 0.0)
    fac = factor_batched(masked_operator(A, f), solver_type, mode="factors")
    Z = fac.solve(R.mT).mT
    return Ub + torch.where(f[:, None, :], Z, 0.0)


def _free_rows(ell, topo, free_mask, local_cols):
    """The free-row block of the overlapping Dirichlet matrices, at compact
    free-set size, straight from the global operator.

    Returns (f, fval, idx, pos, rect, Aff) on ``ell``'s device: f (n_sub,
    n_pad) the free mask, fval (n_sub, f_pad) the real compact slots, idx
    (n_sub, f_pad) and pos (n_sub, n_pad) the compaction and expansion maps
    (:func:`compact_maps`), rect (n_sub, f_pad, n_pad) the free
    rows against every subdomain-local column, and Aff (n_sub, f_pad,
    f_pad) the free-free block with identity on the padding slots.

    Within a row the kept columns are distinct, so the rows are placed with
    a plain scatter; dropped couplings land in the dump column n_pad, which
    is cut off."""
    device = ell.vals.device
    f_np = np.asarray(free_mask, bool) & topo.valid
    n_sub, n_pad = f_np.shape
    idx, fval, pos, f_pad = compact_maps(f_np)
    if local_cols is None:
        local_cols = extraction_map(topo, ell.cols.cpu().numpy())
    lc_f = np.take_along_axis(local_cols, idx[:, :, None], axis=1)
    rows_g = np.minimum(np.take_along_axis(topo.sub2glob, idx, axis=1),
                        ell.n - 1)

    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    fval_t = t(fval, torch.bool)
    idx_t = t(idx)
    vals, _ = ell.rows_dense_gather(t(rows_g))  # (n_sub, f_pad, m)
    vals = vals * fval_t[:, :, None]
    rect = vals.new_zeros((n_sub, f_pad, n_pad + 1))
    rect.scatter_(2, t(lc_f), vals)
    rect = rect[:, :, :n_pad]
    Aff = torch.gather(rect, 2, idx_t[:, None, :].expand(-1, f_pad, -1))
    keep = fval_t[:, :, None] & fval_t[:, None, :]
    Aff = torch.where(keep, Aff, 0.0) + torch.diag_embed((~fval_t).to(Aff.dtype))
    return t(f_np, torch.bool), fval_t, idx_t, t(pos), rect, Aff


def energy_minimal_extension_sparse(
    ell,
    topo,
    free_mask: np.ndarray,
    U_bnd: torch.Tensor,
    local_cols: np.ndarray | None = None,
    solver_type: str = "cholesky",
) -> torch.Tensor:
    """Energy-minimal extension extracted straight from the global sparse
    operator and factored at compact free-set size (the direct route), by
    ``solver_type`` (``lu`` for a nonsymmetric operator).

    Equals ``energy_minimal_extension(A_dir, free, U_bnd)`` with A_dir the
    overlapping Dirichlet extraction of ``ell``, without building the dense
    (n_sub, p, p) batch.  ell: SparseELL; topo: DDMTopology; free_mask:
    host bool (n_sub, n_pad); U_bnd (n_sub, nev, n_pad) with data read
    outside free_mask; ``local_cols`` the extraction map (computed here when
    absent)."""
    f, fval, _, pos, rect, Aff = _free_rows(ell, topo, free_mask, local_cols)
    Ub = torch.where(f[:, None, :], 0.0, U_bnd)
    R = -torch.einsum("sfp,skp->sfk", rect, Ub)  # (n_sub, f_pad, nev)
    del rect
    Z = factor_batched(Aff, solver_type, mode="factors").solve(R)
    Z = Z.mT * fval[:, None, :]
    return Ub + expand_rows(Z, pos)


def _pcg_blocks(A, M, B, maxit: int, X0=None):
    """Batched preconditioned CG: solve A X = B for every (subdomain, rhs)
    pair at once.  A, M: (s, f, f) SPD (M = explicit preconditioner);
    B: (s, f, k).  Returns (X, rel) with rel (s, k) the final true-residual
    norms relative to the columns of B (0 where B = 0).

    Runs exactly ``maxit`` iterations, as the JAX package's fixed-length
    loop does: converged columns freeze through the ``live`` mask instead of
    ending the loop, so the iterates are the same."""
    b2 = torch.sum(B * B, dim=1)  # (s, k)
    if X0 is None:
        X0 = torch.zeros_like(B)
        R = B
    else:
        R = B - A @ X0
    X = X0
    Z = M @ R
    P = Z
    rz = torch.sum(R * Z, dim=1)
    for _ in range(maxit):
        Q = A @ P
        pq = torch.sum(P * Q, dim=1)
        live = (rz > 0.0) & (pq > 0.0)
        alpha = torch.where(live, rz / torch.where(pq > 0.0, pq, 1.0), 0.0)
        X = X + alpha[:, None, :] * P
        R = R - alpha[:, None, :] * Q
        Z = M @ R
        rz_new = torch.sum(R * Z, dim=1)
        beta = torch.where(live, rz_new / torch.where(rz > 0.0, rz, 1.0), 0.0)
        P = Z + beta[:, None, :] * P
        rz = rz_new
    # true residual (the recurrence R drifts once columns converge)
    Rt = B - A @ X
    rel = torch.sqrt(torch.sum(Rt * Rt, dim=1) / torch.where(b2 > 0.0, b2, 1.0))
    return X, torch.where(b2 > 0.0, rel, 0.0)


def _pcg_blocks_mixed(A, M, B, maxit32: int, maxit64: int):
    """Two-stage PCG: an f32 stage (full-precision f32 products, TF32 off)
    down to its ~eps32*cond residual floor, then a warm-started f64 polish
    that recomputes R = B - A X0 in f64, so the f32 stage only shortens the
    f64 work and never biases the answer."""
    f32 = torch.float32
    with tf32_off():
        X32, _ = _pcg_blocks(A.to(f32), M.to(f32), B.to(f32), maxit32)
    return _pcg_blocks(A, M, B, maxit64, X0=X32.to(B.dtype))


def energy_minimal_extension_pcg(
    ell,
    topo,
    free_mask: np.ndarray,
    U_bnd: torch.Tensor,
    Minv: torch.Tensor,
    local_cols: np.ndarray | None = None,
    maxit: int = 60,
    maxit32: int = 0,
):
    """Energy-minimal extension by preconditioned CG on the compact free
    block, with P = (A^{-1})_ff, the free-free block of the fine level's
    explicit f64 subdomain inverse ``Minv`` (n_sub, n_pad, n_pad).  For SPD
    A, (A^{-1})_ff = (A_ff - A_fc A_cc^{-1} A_cf)^{-1}, so P A_ff is the
    identity up to a boundary-strip correction and CG contracts fast; the
    residual is controlled, so noise in the inverse slows the rate only.

    Returns (U, rel): the contract of :func:`energy_minimal_extension_sparse`
    plus the final relative residual per (subdomain, vector), so callers can
    verify and fall back to the direct route.  ``maxit32 > 0`` prepends an
    f32 stage of that many iterations (:func:`_pcg_blocks_mixed`); 0 runs
    pure f64."""
    f, fval, idx, pos, rect, Aff = _free_rows(ell, topo, free_mask, local_cols)
    Ub = torch.where(f[:, None, :], 0.0, U_bnd)
    R = -torch.einsum("sfp,skp->sfk", rect, Ub) * fval[:, :, None]
    del rect
    keep = fval[:, :, None] & fval[:, None, :]
    Mff = torch.where(keep, compact_mat(Minv, idx), 0.0)
    Mff = Mff + torch.diag_embed((~fval).to(Mff.dtype))
    if maxit32 > 0:
        Z, rel = _pcg_blocks_mixed(Aff, Mff, R, int(maxit32), int(maxit))
    else:
        Z, rel = _pcg_blocks(Aff, Mff, R, int(maxit))
    Z = Z.mT * fval[:, None, :]
    return Ub + expand_rows(Z, pos), rel


def extension_inverse_of(fine, p, ptree) -> torch.Tensor | None:
    """The fine Schwarz level's explicit f64 subdomain inverse, when it is
    the exact inverse of the same overlapping Dirichlet matrices the
    extension would factor; None otherwise (double-single inverses,
    Cholesky factors — the CPU's default — modified subdomain matrices,
    indefinite problems)."""
    if fine is None:
        return None
    if ptree.get("modify_subdomain_matrix", False):
        return None
    if not getattr(p.disc, "definite", True):
        return None
    if ptree.sub("schwarz").sub("subdomain_solver").get("type", "") not in (
        "cholesky", "cholmod",
    ):
        return None
    factors = getattr(fine, "factors", None)
    if not isinstance(factors, BatchedInverse):
        return None
    if factors.inv.dtype != torch.float64:
        return None
    return factors.inv


def inverse_harmonic_extension(
    Minv: torch.Tensor,
    free_mask: torch.Tensor,
    U_bnd: torch.Tensor,
    c_mask: np.ndarray,
) -> torch.Tensor:
    """Energy-minimal extension through the subdomain inverse (Schur
    identity), without a second factorization of A.

    For SPD A with M = A^{-1} and the dofs split into f (free) and c
    (complement): -A_ff^{-1} A_fc = M_fc M_cc^{-1}, so the extension is
    u = M z with M_cc z_c = u_c and z zero off c; only the small complement
    block M_cc is factored.  Minv (n_sub, p, p) the f64 inverse; free_mask
    (n_sub, p); U_bnd (n_sub, nev, p) with data read outside free_mask;
    c_mask host bool (n_sub, p), the complement (valid & ~free).  The
    contract of :func:`energy_minimal_extension`."""
    f = free_mask.to(torch.bool)
    Ub = torch.where(f[:, None, :], 0.0, U_bnd)
    c_idx, cval, _, _ = compact_maps(c_mask)
    c_idx = torch.as_tensor(c_idx, device=Minv.device).long()
    cval = torch.as_tensor(cval, device=Minv.device)
    keep = cval[:, :, None] & cval[:, None, :]
    Mcc = torch.where(keep, compact_mat(Minv, c_idx), 0.0)
    Mcc = Mcc + torch.diag_embed((~cval).to(Mcc.dtype))
    Uc = torch.gather(Ub, 2, c_idx[:, None, :].expand(-1, Ub.shape[1], -1))
    Uc = torch.where(cval[:, None, :], Uc, 0.0)
    Zc = factor_batched(Mcc, "cholesky", mode="factors").solve(Uc.mT)
    # back to full size (zero off c; the padding slots land in row p,
    # which is cut off), then one wide product with the inverse
    n_sub, p, _ = Minv.shape
    rows = torch.where(cval, c_idx, p)[:, :, None].expand(-1, -1, Zc.shape[-1])
    z = Zc.new_zeros((n_sub, p + 1, Zc.shape[-1])).scatter_(1, rows, Zc)
    U = (Minv @ z[:, :p]).mT
    return Ub + torch.where(f[:, None, :], U, 0.0)


def compact_cols(B: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(n_sub, p, q) -> (n_sub, p, b_pad): the columns at ``idx``
    (n_sub, b_pad) int64."""
    return torch.gather(B, 2, idx[:, None, :].expand(-1, B.shape[1], -1))


def harmonic_parameter_basis_compact(
    A_con: torch.Tensor,
    int_mask: torch.Tensor,
    par_idx: torch.Tensor,
    par_valid: torch.Tensor,
    solver_type: str = "lu",
) -> torch.Tensor:
    """Column-compacted :func:`harmonic_parameter_basis`: Hc (n_sub, p,
    b_pad) with u = Hc @ w for parameter data w at the dofs listed in
    ``par_idx`` (n_sub, b_pad) int64, ``par_valid`` marking the real slots.
    The solve carries b_pad right-hand sides instead of p mostly-zero ones
    (reference: the ring_dofs vectors of MsGFEMRingCoarseSpace,
    coarse_spaces.hh:966-1096)."""
    i = int_mask.to(torch.bool)
    Aip = compact_cols(torch.where(i[:, :, None], A_con, 0.0), par_idx)
    Aip = torch.where(par_valid[:, None, :], Aip, 0.0)
    fac = factor_batched(masked_operator(A_con, i), solver_type,
                         mode="factors")
    X = -fac.solve(Aip)
    X = torch.where(i[:, :, None] & par_valid[:, None, :], X, 0.0)
    p = A_con.shape[-1]
    E = ((torch.arange(p, device=A_con.device)[None, :, None]
          == par_idx[:, None, :]) & par_valid[:, None, :])
    return X + E.to(A_con.dtype)


def harmonic_parameter_basis(
    A_con: torch.Tensor,
    int_mask: torch.Tensor,
    par_mask: torch.Tensor,
    solver_type: str = "lu",
) -> torch.Tensor:
    """Implicit basis of the A-harmonic space: Hfull (n_sub, p, p) with
    u = Hfull @ w for parameter data w supported on ``par_mask``; the
    columns outside par_mask are zero.

    Hfull = [X; I] with X = -A_ii^{-1} A_i,par: the constraint
    (A_con u)_i = 0 on ``int_mask`` solved for all unit parameter data at
    once (the batched replacement of the reference's saddle-point Lagrange
    blocks, coarse_spaces.hh:763-778)."""
    i = int_mask.to(torch.bool)
    b = par_mask.to(torch.bool)
    Aip = torch.where(i[:, :, None] & b[:, None, :], A_con, 0.0)
    fac = factor_batched(masked_operator(A_con, i), solver_type,
                         mode="factors")
    X = -fac.solve(Aip)
    X = torch.where(i[:, :, None] & b[:, None, :], X, 0.0)
    return X + torch.diag_embed(b.to(A_con.dtype))
