"""Krylov solvers with ISTL-matching semantics, in torch.

Counterpart of ``ddm_tpu/solvers/krylov.py`` (reference: the ISTL solver
factory's ``cgsolver``, ``restartedgmressolver``,
``restartedflexiblegmressolver`` and ``bicgstabsolver``):

* converged when defect < reduction * defect0, or defect < 1e-30 absolute;
* CG measures the true residual every iteration (ISTL CGSolver);
* GMRES is left-preconditioned; its defect is the preconditioned residual
  from the Givens recurrence; each restart cycle starts from the recomputed
  preconditioned residual (ISTL RestartedGMResSolver); flexible GMRES is
  right-preconditioned, keeps the preconditioned basis Z and measures the
  true residual; BiCGStab checks the true residual after each half-step.
  The Arnoldi step is
  two-pass classical Gram-Schmidt (CGS2) on the device; the small Hessenberg
  system (Givens rotations, back substitution) lives on the host, in the
  same f64 arithmetic.

``op`` and ``prec`` are plain callables on (n,) tensors.  The loops are
Python loops; every iteration reads one small vector back to the host for
the convergence test.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

_ABS_LIMIT = 1e-30


@dataclass
class KrylovResult:
    x: torch.Tensor
    iterations: int
    converged: bool
    defect0: float
    defect: float
    history: np.ndarray  # (maxit + 1,) defect per iteration, nan-padded
    # GMRES variants: the iteration at which the Givens estimate first met
    # the target (0: never, or CG); under verified termination the solver
    # may go on past it
    estimate_hit: int = 0
    # BiCGStab: stopped on ISTL's breakdown guard (rho, omega or h)
    breakdown: bool = False


def _norm(x: torch.Tensor) -> float:
    return float(torch.sqrt(torch.dot(x, x)))


def cg_solve(
    op: Callable, prec: Callable | None, b: torch.Tensor, x0: torch.Tensor,
    reduction: float = 1e-8, maxit: int = 1000,
) -> KrylovResult:
    """Preconditioned CG, ISTL CGSolver semantics."""
    prec = prec or (lambda d: d)
    x = x0
    r = b - op(x0)
    p = prec(r)
    rho = torch.dot(p, r)
    def0 = _norm(r)
    hist = np.full(maxit + 1, np.nan)
    hist[0] = def0
    target = max(reduction * def0, _ABS_LIMIT)
    defect, it = def0, 0
    while defect > target and it < maxit:
        q = op(p)
        alpha = rho / torch.dot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        defect = _norm(r)
        it += 1
        hist[it] = defect
        z = prec(r)
        rho2 = torch.dot(z, r)
        p = z + (rho2 / rho) * p
        rho = rho2
    return KrylovResult(x=x, iterations=it, converged=defect <= target,
                        defect0=def0, defect=defect, history=hist)


def _restarted_gmres(op, prec, b, x0, reduction, maxit, restart, verify,
                     flexible):
    """Restarted GMRES, left-preconditioned or flexible (right-
    preconditioned with the solution basis Z kept).  The defect is the
    norm of ``resid(x)``: the preconditioned residual on the left, the true
    residual in the flexible form."""
    prec = prec or (lambda d: d)
    n = b.shape[0]

    def resid(x):
        r = b - op(x)
        return r if flexible else prec(r)

    def0 = _norm(resid(x0))
    target = max(reduction * def0, _ABS_LIMIT)
    hist = np.full(maxit + 1, np.nan)
    hist[0] = def0
    first_hit = []  # iteration of the estimate's first pass under the target

    def cycle(x, it):
        """One restart cycle of at most ``restart`` steps."""
        w = resid(x)
        beta = _norm(w)
        V = b.new_zeros((restart + 1, n))
        V[0] = w / max(beta, _ABS_LIMIT)
        Z = b.new_zeros((restart, n)) if flexible else V
        H = np.zeros((restart + 1, restart))
        cs = np.zeros(restart)
        sn = np.zeros(restart)
        s = np.zeros(restart + 1)
        s[0] = beta
        defect = beta
        k = 0  # steps taken in this cycle
        done = beta <= target
        while k < restart and not done:
            j = k
            if flexible:
                Z[j] = prec(V[j])
                w = op(Z[j])
            else:
                w = prec(op(V[j]))
            Vj = V[: j + 1]
            c1 = Vj @ w
            w = w - c1 @ Vj
            c2 = Vj @ w
            w = w - c2 @ Vj
            hjp = torch.sqrt(torch.dot(w, w))
            V[j + 1] = w / torch.clamp(hjp, min=_ABS_LIMIT)
            hcol = np.zeros(restart + 1)
            hcol[: j + 1] = (c1 + c2).cpu().numpy()
            hcol[j + 1] = float(hjp)
            for i in range(j):  # apply the existing Givens rotations
                t = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                hcol[i + 1] = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                hcol[i] = t
            denom = math.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            cs[j] = hcol[j] / max(denom, _ABS_LIMIT)
            sn[j] = hcol[j + 1] / max(denom, _ABS_LIMIT)
            hcol[j], hcol[j + 1] = denom, 0.0
            s[j + 1] = -sn[j] * s[j]
            s[j] = cs[j] * s[j]
            H[:, j] = hcol
            defect = abs(s[j + 1])
            it += 1
            k += 1
            hist[min(it, maxit)] = defect
            done = defect <= target or it >= maxit
            if defect <= target and not first_hit:
                first_hit.append(it)
        # back substitution for the k steps taken
        y = np.zeros(restart)
        for jj in range(k - 1, -1, -1):
            num = s[jj] - (H[jj] * y).sum()
            y[jj] = num / (1.0 if H[jj, jj] == 0 else H[jj, jj])
        yt = torch.as_tensor(y[:k], dtype=b.dtype, device=b.device)
        return x + yt @ Z[:k], it, defect

    x, it, defect = x0, 0, def0
    while defect > target and it < maxit:
        x, it, defect = cycle(x, it)
        if verify:
            defect = _norm(resid(x))
            if flexible:
                # keep history and final defect consistent: under a dd
                # preconditioner the estimate can sit far below the defect
                hist[min(it, maxit)] = defect
    return KrylovResult(x=x, iterations=it, converged=defect <= target,
                        defect0=def0, defect=defect, history=hist,
                        estimate_hit=first_hit[0] if first_hit else 0)


def gmres_solve(
    op: Callable, prec: Callable | None, b: torch.Tensor, x0: torch.Tensor,
    reduction: float = 1e-8, maxit: int = 1000, restart: int = 30,
    verify: bool = False,
) -> KrylovResult:
    """Left-preconditioned restarted GMRES (ISTL RestartedGMResSolver).

    verify: after each restart cycle, terminate on the recomputed
    preconditioned defect instead of the Givens estimate.  Needed when the
    preconditioner apply carries reduced-precision noise (the dd subdomain
    solve): below that noise the estimate decouples from the true residual
    and reports false convergence."""
    return _restarted_gmres(op, prec, b, x0, reduction, maxit, restart,
                            verify, flexible=False)


def fgmres_solve(
    op: Callable, prec: Callable | None, b: torch.Tensor, x0: torch.Tensor,
    reduction: float = 1e-8, maxit: int = 1000, restart: int = 30,
    verify: bool = False,
) -> KrylovResult:
    """Flexible (right-preconditioned) restarted GMRES (ISTL
    RestartedFlexibleGMResSolver).  The recurrence tracks the true residual
    and the preconditioner enters only through the solution basis Z, so a
    norm-distorting or inexact preconditioner does not cap the attainable
    accuracy as it does on the left.  ``verify``: terminate each cycle on
    the recomputed true residual."""
    return _restarted_gmres(op, prec, b, x0, reduction, maxit, restart,
                            verify, flexible=True)


_BREAKDOWN_EPS = 1e-80  # ISTL BiCGSTABSolver's EPSILON breakdown guard


def bicgstab_solve(
    op: Callable, prec: Callable | None, b: torch.Tensor, x0: torch.Tensor,
    reduction: float = 1e-8, maxit: int = 1000,
) -> KrylovResult:
    """Preconditioned BiCGStab, ISTL BiCGSTABSolver semantics (dune-istl
    solvers.hh):

    * half-step accounting: the true residual norm is checked after the
      first half-step (x += alpha p_hat) and after the stabilization
      half-step, like ISTL's ``it += .5``; convergence at a half-step stops
      there, and ``iterations`` is ceil(half-steps / 2), as ISTL reports;
    * breakdown: |rho| or |omega| of the previous step, or |h| = <rt, v>,
      at or below ISTL's EPSILON = 1e-80 stops the iteration with
      ``breakdown`` set (ISTL throws SolverAbort)."""
    prec = prec or (lambda d: d)
    eps = _BREAKDOWN_EPS
    x = x0
    r = b - op(x0)
    rt = r
    def0 = _norm(r)
    target = max(reduction * def0, _ABS_LIMIT)
    hist = np.full(maxit + 1, np.nan)
    hist[0] = def0
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho = alpha = omega = 1.0
    defect, half, brk = def0, 0, False
    while defect > target and half < 2 * maxit:
        if abs(rho) <= eps or abs(omega) <= eps:
            brk = True
            break
        rho_new = float(torch.dot(rt, r))
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = prec(p)
        v = op(phat)
        h = float(torch.dot(rt, v))
        rho = rho_new
        if abs(h) <= eps:
            brk = True
            break
        alpha = rho_new / h
        x = x + alpha * phat
        r = r - alpha * v  # s
        half += 1
        defect = _norm(r)
        hist[(half + 1) // 2] = defect
        if defect <= target or half >= 2 * maxit:
            break
        shat = prec(r)
        t = op(shat)
        tt = float(torch.dot(t, t))
        omega = float(torch.dot(t, r)) / (1.0 if abs(tt) <= eps else tt)
        x = x + omega * shat
        r = r - omega * t
        half += 1
        defect = _norm(r)
        hist[(half + 1) // 2] = defect
    return KrylovResult(x=x, iterations=(half + 1) // 2,
                        converged=defect <= target and not brk, defect0=def0,
                        defect=defect, history=hist, breakdown=brk)


SOLVERS = {
    "cgsolver": cg_solve,
    "cg": cg_solve,
    "restartedgmressolver": gmres_solve,
    "gmres": gmres_solve,
    "restartedflexiblegmressolver": fgmres_solve,
    "fgmres": fgmres_solve,
    "bicgstabsolver": bicgstab_solve,
    "bicgstab": bicgstab_solve,
}


def solve_from_config(op, prec, b, x0, ptree, subtree_name: str = "solver"):
    """Dispatch like the ISTL solver factory (Dune::getSolverFromFactory).

    GMRES and flexible GMRES terminate on the verified defect when ``solver.verify`` says so
    or, by default, when a subdomain or coarse solve runs in reduced
    precision.  ``solver.ortho`` (the TPU package's double-single
    orthogonalization) is accepted; orthogonalization here is always f64."""
    sub = ptree.sub(subtree_name)
    stype = sub.get("type")
    if stype not in SOLVERS:
        raise ValueError(f"solver type '{stype}' is not ported")
    kwargs = dict(reduction=sub.get("reduction", 1e-8),
                  maxit=sub.get("maxit", 1000))
    if SOLVERS[stype] in (gmres_solve, fgmres_solve):
        kwargs["restart"] = sub.get("restart", 30)
        if "verify" in sub:
            kwargs["verify"] = sub.get("verify", False)
        else:
            fine_p = ptree.sub("schwarz").sub("subdomain_solver").get(
                "precision", "f64")
            coarse_p = ptree.sub("coarse_solver").get("precision", "f64")
            kwargs["verify"] = fine_p != "f64" or coarse_p != "f64"
    return SOLVERS[stype](op, prec, b, x0, **kwargs)
