"""Krylov solvers with ISTL-matching semantics, in torch.

Counterpart of ``ddm_tpu/solvers/krylov.py`` (reference: the ISTL solver
factory's ``cgsolver`` and ``restartedgmressolver``):

* converged when defect < reduction * defect0, or defect < 1e-30 absolute;
* CG measures the true residual every iteration (ISTL CGSolver);
* GMRES is left-preconditioned; its defect is the preconditioned residual
  from the Givens recurrence; each restart cycle starts from the recomputed
  preconditioned residual (ISTL RestartedGMResSolver).  The Arnoldi step is
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
    prec = prec or (lambda d: d)
    n = b.shape[0]
    def0 = _norm(prec(b - op(x0)))
    target = max(reduction * def0, _ABS_LIMIT)
    hist = np.full(maxit + 1, np.nan)
    hist[0] = def0

    def cycle(x, it):
        """One restart cycle of at most ``restart`` steps."""
        w = prec(b - op(x))
        beta = _norm(w)
        V = b.new_zeros((restart + 1, n))
        V[0] = w / max(beta, _ABS_LIMIT)
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
        # back substitution for the k steps taken
        y = np.zeros(restart)
        for jj in range(k - 1, -1, -1):
            num = s[jj] - (H[jj] * y).sum()
            y[jj] = num / (1.0 if H[jj, jj] == 0 else H[jj, jj])
        yt = torch.as_tensor(y[:k], dtype=b.dtype, device=b.device)
        return x + yt @ V[:k], it, defect

    x, it, defect = x0, 0, def0
    while defect > target and it < maxit:
        x, it, est = cycle(x, it)
        defect = _norm(prec(b - op(x))) if verify else est
    return KrylovResult(x=x, iterations=it, converged=defect <= target,
                        defect0=def0, defect=defect, history=hist)


SOLVERS = {
    "cgsolver": cg_solve,
    "cg": cg_solve,
    "restartedgmressolver": gmres_solve,
    "gmres": gmres_solve,
}


def solve_from_config(op, prec, b, x0, ptree, subtree_name: str = "solver"):
    """Dispatch like the ISTL solver factory (Dune::getSolverFromFactory).

    GMRES terminates on the verified defect when ``solver.verify`` says so
    or, by default, when a subdomain or coarse solve runs in reduced
    precision.  ``solver.ortho`` (the TPU package's double-single
    orthogonalization) is accepted; orthogonalization here is always f64."""
    sub = ptree.sub(subtree_name)
    stype = sub.get("type")
    if stype not in SOLVERS:
        raise ValueError(f"solver type '{stype}' is not ported")
    kwargs = dict(reduction=sub.get("reduction", 1e-8),
                  maxit=sub.get("maxit", 1000))
    if SOLVERS[stype] is gmres_solve:
        kwargs["restart"] = sub.get("restart", 30)
        if "verify" in sub:
            kwargs["verify"] = sub.get("verify", False)
        else:
            fine_p = ptree.sub("schwarz").sub("subdomain_solver").get(
                "precision", "f64")
            coarse_p = ptree.sub("coarse_solver").get("precision", "f64")
            kwargs["verify"] = fine_p != "f64" or coarse_p != "f64"
    return SOLVERS[stype](op, prec, b, x0, **kwargs)
